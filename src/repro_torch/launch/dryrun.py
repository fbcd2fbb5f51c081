"""Multi-pod dry-run: trace every (arch x shape x mesh) cell's step for
rank 0 of a 16 x 16 (or 2 x 16 x 16) mesh and write a JSON record per cell.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
        --shape train_4k [--multi-pod] [--no-analysis]
    PYTHONPATH=src python -m repro_torch.launch.roofline

Nothing is allocated and nothing is sent: the process joins a fake
process group of 256 or 512 ranks (``torch.testing``'s ``FakeStore``; its
collectives return at once) as rank 0, builds its shard of the state on
fake tensors, and runs the step once under ``hlo_analysis.trace``, which
records the local op stream.  The record keeps the reference's keys:
``memory`` (per-device argument, output, temp, alias, peak bytes),
``cost_reported`` (FLOPs, bytes accessed), ``collectives_reported``
(operand bytes per kind), ``fits_hbm`` (peak against one H100's 80 GB)
and ``corrected``, the reference's k = 1 / k = 2 group extrapolation
(``total = c1 + (n_groups - 1) * (c2 - c1)``): eager code has no loop
counted once, so it must equal the full-depth count, which the record
lets one check.  ``lower_seconds`` is the time to build the fake state,
``compile_seconds`` the time of the traced step (the work standing in for
XLA's compile).  Records go to ``benchmarks/results/dryrun_torch/``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Optional

import torch

from repro_torch.configs import (SHAPES, applicability, get_config,
                                 get_shape, list_archs)
from repro_torch.distributed import sharding as shd
from repro_torch.launch import hlo_analysis, steps
from repro_torch.launch.inputs import cache_capacity, input_specs
from repro_torch.models import model
from repro_torch.optim.adamw import OptConfig

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "benchmarks", "results", "dryrun_torch")
HBM_BYTES = 80 * 10 ** 9          # one H100 80GB HBM3


def _ctx_kwargs(args) -> dict:
    kw = {}
    if args and getattr(args, "remat", None):
        kw["remat"] = args.remat
    if args and getattr(args, "loss_chunk", 0):
        kw["loss_chunk"] = args.loss_chunk
    if args and getattr(args, "microbatches", 0):
        kw["microbatches"] = args.microbatches
    if args and getattr(args, "profile", None):
        kw["sharding_profile"] = args.profile
    return kw


def fake_world(world: int, device_type: str = "cpu", multi_pod=None):
    """Join a fake process group of ``world`` ranks as rank 0 (replacing
    any fake group of another size) and return the production mesh of
    that size (or, for other sizes, a (1, world) data x model mesh)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_mesh
    if dist.is_initialized():
        if dist.get_world_size() == world:
            pass
        else:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    if world == 512:
        return make_mesh((2, 16, 16), ("pod", "data", "model"), device_type)
    if world == 256:
        return make_mesh((16, 16), ("data", "model"), device_type)
    return make_mesh((1, world), ("data", "model"), device_type)


def _fake_shards(abstract_tree, plc_tree, mesh, device):
    """DTensors of fake local shards (shape and dtype only)."""
    from torch.distributed.tensor import DTensor

    def one(t, plc):
        loc = torch.empty(shd.local_shape(t.shape, plc, mesh), dtype=t.dtype,
                          device=device)
        return DTensor.from_local(loc, mesh, plc, run_check=False)

    if isinstance(abstract_tree, dict):
        return {k: _fake_shards(v, plc_tree[k], mesh, device)
                for k, v in abstract_tree.items()}
    return one(abstract_tree, plc_tree)


def lower_cell(cfg, shape, mesh, ctx):
    """Trace the cell's step on fake shards.  Returns (OpTrace, seconds
    spent building the fake state)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    specs = input_specs(cfg, shape)
    dev = torch.device(mesh.device_type)
    profile = ctx.sharding_profile
    with FakeTensorMode(allow_non_fake_inputs=True):
        t0 = time.perf_counter()
        if shape.kind == "train":
            step = steps.build_train_step(cfg, OptConfig(), ctx)
            state = _fake_shards(steps.abstract_state(cfg),
                                 steps.state_shardings(cfg, mesh, profile),
                                 mesh, dev)
            batch = _batch(specs["batch"], mesh, shape, dev)
            setup = time.perf_counter() - t0
            _, rec = hlo_analysis.trace(step, state, batch)
            return rec, setup
        params = _fake_shards(model.init_abstract(cfg),
                              steps.param_shardings(cfg, mesh, profile),
                              mesh, dev)
        cap = cache_capacity(cfg, shape.seq_len)
        if shape.kind == "prefill":
            step = steps.build_prefill_step(cfg, ctx, cap)
            batch = _batch(specs["batch"], mesh, shape, dev)
            setup = time.perf_counter() - t0
            _, rec = hlo_analysis.trace(step, params, batch)
            return rec, setup
        step = steps.build_decode_step(cfg, ctx)
        cache = _fake_shards(specs["cache"],
                             steps.cache_shardings(cfg, mesh,
                                                   shape.global_batch, cap,
                                                   profile), mesh, dev)
        tokens = _batch({"tokens": specs["tokens"]}, mesh, shape,
                        dev)["tokens"]
        setup = time.perf_counter() - t0
        _, rec = hlo_analysis.trace(step, params, cache, tokens,
                                    shape.seq_len - 1)
        return rec, setup


def _batch(abstract, mesh, shape, dev):
    sh = shd.input_shardings(abstract, mesh, shape.global_batch)
    return _fake_shards(abstract, {k: shd.placements(v, mesh)
                                   for k, v in sh.items()}, mesh, dev)


def _analysis_cfg(cfg, k: int):
    """Reduced-depth same-width config: k full pattern groups + same rest."""
    pat_len = len(cfg.block_pattern)
    rest = cfg.n_layers % pat_len
    return dataclasses.replace(cfg, n_layers=k * pat_len + rest)


def _measure(rec) -> dict:
    return {**hlo_analysis.cost_metrics(rec),
            "coll": hlo_analysis.collective_bytes(rec)["total"]}


def analyze_cell(arch: str, shape_name: str, multi_pod: bool,
                 args=None) -> dict:
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "kind": shape.kind}
    ok, reason = applicability(cfg, shape)
    if not ok:
        record.update(status="skip", reason=reason)
        return record

    mesh = fake_world(512 if multi_pod else 256)
    ctx = steps.make_context(mesh=mesh, **_ctx_kwargs(args))
    n_dev = mesh.size()
    pat_len = len(cfg.block_pattern)
    n_groups = cfg.n_layers // pat_len

    rec, t_lower = lower_cell(cfg, shape, mesh, ctx)
    mem = hlo_analysis.memory_metrics(rec)
    cost = hlo_analysis.cost_metrics(rec)
    coll = hlo_analysis.collective_bytes(rec)
    common = dict(status="ok", n_devices=n_dev,
                  n_params=model.n_params(cfg),
                  n_active_params=model.n_active_params(cfg),
                  lower_seconds=round(t_lower, 2),
                  compile_seconds=round(rec.seconds, 2), memory=mem,
                  fits_hbm=mem["peak_bytes"] <= HBM_BYTES,
                  cost_reported=cost, collectives_reported=coll)
    if args is not None and getattr(args, "no_analysis", False):
        record.update(common, corrected={"skipped": True})
        return record
    try:
        c = {k: _measure(lower_cell(_analysis_cfg(cfg, k), shape, mesh,
                                    ctx)[0]) for k in (1, 2)}
        corrected = {}
        for key in ("flops", "bytes_accessed"):
            corrected[key] = c[1][key] + (n_groups - 1) * (c[2][key]
                                                           - c[1][key])
        corrected["collective_bytes"] = c[1]["coll"] + \
            (n_groups - 1) * (c[2]["coll"] - c[1]["coll"])
        corrected["per_group_flops"] = c[2]["flops"] - c[1]["flops"]
    except Exception as e:                                   # noqa: BLE001
        corrected = {"error": f"{type(e).__name__}: {e}"}
    record.update(common, corrected=corrected)
    return record


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description="multi-pod dry-run")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--remat", default="full",
                    choices=["none", "dots", "full"])
    ap.add_argument("--loss-chunk", type=int, default=0)
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--no-analysis", action="store_true",
                    help="skip the k=1/k=2 reduced-depth correction pass")
    ap.add_argument("--profile", default=None,
                    choices=["tp", "zero-sp", "serve", "legacy"])
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    import logging
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    os.makedirs(args.out, exist_ok=True)
    archs = list_archs() if args.all or not args.arch else [args.arch]
    shapes = sorted(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) \
        else [args.multi_pod]

    failures = 0
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                cell = f"{arch}__{shape_name}__{'2x16x16' if mp else '16x16'}"
                if args.tag:
                    cell += f"__{args.tag}"
                try:
                    rec = analyze_cell(arch, shape_name, mp, args)
                except Exception:                            # noqa: BLE001
                    rec = {"arch": arch, "shape": shape_name,
                           "mesh": "2x16x16" if mp else "16x16",
                           "status": "error",
                           "error": traceback.format_exc(limit=3)}
                    failures += 1
                with open(os.path.join(args.out, cell + ".json"), "w") as f:
                    json.dump(rec, f, indent=1)
                status = rec["status"]
                if status == "ok":
                    gib = rec["memory"]["peak_bytes"] / 2 ** 30
                    print(f"[{status}] {cell} peak={gib:.2f}GiB/dev"
                          f" trace={rec['compile_seconds']}s"
                          f" flops/dev={rec['cost_reported']['flops']:.3e}")
                    print("  memory:", rec["memory"])
                    print("  cost:", rec["cost_reported"])
                    print("  corrected:", rec["corrected"])
                elif status == "skip":
                    print(f"[skip] {cell}: {rec['reason']}")
                else:
                    print(f"[ERROR] {cell}\n{rec['error']}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
