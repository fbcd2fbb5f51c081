#!/usr/bin/env python3
"""The port's mesh across several cards: sharded train steps against the
one-device step, and the compressed data-parallel trainer, on NCCL.

    python3 tools/mesh_nccl_check.py [--ranks 4]
    PYTHONPATH=src python3 tools/mesh_nccl_check.py --cpu   # gloo, reduced

Spawns one process per card (``torch.multiprocessing``, spawn), joins
them in an NCCL group over ``tcp://localhost`` and, on the meshes 2 x 2
and 1 x 4, runs one train step of each configuration below at full width
(depth cut as listed) from seed 0 on every rank: the sharded step on
DTensor state (``tp`` profile) and, on every rank, the one-device step
from the same weights and batch (pipeline batch 0, 8 x 256; MoE at
capacity factor E/k, so no expert drops).  It prints
their losses and grad norms, the relative differences, each gradient
leaf's largest difference over that leaf's largest entry (the gradients
the two steps hand to AdamW, the worst leaf named), and the median
of MEASURED further sharded steps (host clock between synchronisations).
Then ``FleetTrainer(mesh=2x2, grad_compression=True)`` (two data ranks:
the int8 + error-feedback mean) runs 3 steps.  Rank 0 prints one JSON
line per case.  ``--cpu`` runs the same on a gloo group with reduced
configurations (a check of the script itself).

The float64 case starts from the float32 case's weights, widened (the
draws are float32 either way), and runs every float32 cast of the model
in float64 (``layers.f32``).  After it, rank 0 prints one line per
gradient leaf: the float64 sharded step's distance from the float64
one-device step, and the distances of both float32 steps (sharded and
one-device) from it, each over the float64 leaf's largest entry.  A
float32 gap that float64 closes to rounding is summation order; one that
float64 keeps is a wrong path.

Exits non-zero when a case is outside its bounds (``BOUNDS``: the mesh's
limits of PERF.md section 2): float32 loss and grad norm within 1e-5
relative and every gradient leaf within 2e-5 of its largest entry; bf16
loss and grad norm within 1e-2 relative (its leaves are printed, not
bounded: each side rounds to bf16 on its own); float64 within 1e-12 and
1e-10.  Every case runs and is printed before the verdict.
"""
import argparse
import dataclasses
import json
import logging
import os
import socket
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

# (arch, layers, dtype); None keeps the configuration's depth
CASES = (("smollm-360m", None, "bfloat16"),
         ("smollm-360m", 4, "float32"),
         ("qwen2.5-3b", 4, "float32"),
         ("olmoe-1b-7b", 4, "float32"),
         ("rwkv6-7b", 4, "float32"),
         ("rwkv6-7b", 4, "float64"),
         ("recurrentgemma-2b", 4, "float32"))
MESHES = ((2, 2), (1, 4))
BATCH, SEQ = 8, 256
MEASURED = 3
# dtype -> (loss and grad-norm relative bound, gradient-leaf bound or None)
BOUNDS = {"float32": (1e-5, 2e-5), "bfloat16": (1e-2, None),
          "float64": (1e-12, 1e-10)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _paths(tree, prefix=""):
    """Leaf paths of a nested dict in ``model._tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _paths(tree[k], f"{prefix}/{k}" if prefix else k)]
    return [prefix]


def _rank(rank: int, world: int, port: int, cpu: bool) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import FleetTrainer
    from repro_torch.models import model
    from repro_torch.optim import adamw

    if cpu:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    else:
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda", rank)
    dist.init_process_group("gloo" if cpu else "nccl",
                            init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    kind = "cpu" if cpu else "cuda"
    opt = adamw.OptConfig(warmup_steps=2)
    b, s = (8, 16) if cpu else (BATCH, SEQ)

    def sync():
        if not cpu:
            torch.cuda.synchronize()

    def report(row):
        if rank == 0:
            print(json.dumps(row), flush=True)

    # the gradients each train step hands to AdamW, whole on every rank
    stepped = {}
    update = adamw.update

    def spy_update(opt_cfg, grads, opt_state, params):
        stepped["grads"] = [g.full_tensor() if hasattr(g, "full_tensor")
                            else g.clone() for g in model._tree_leaves(grads)]
        return update(opt_cfg, grads, opt_state, params)

    adamw.update = spy_update
    failures = []
    f32_grads = {}       # arch -> (one-device, sharded) float32 gradients

    def dist_max(a, b):
        """Each leaf's largest |a - b| over b's largest entry."""
        return [float((x.double() - y.double()).abs().max())
                / max(float(y.double().abs().max()), 1e-300)
                for x, y in zip(a, b)]

    try:
        for shape in MESHES:
            mesh = make_mesh(shape, device_type=kind)
            for arch, layers, dtype in CASES:
                cfg = get_config(arch)
                if cpu:
                    cfg = reduced_config(cfg)
                cfg = dataclasses.replace(
                    cfg, dtype=dtype,
                    n_layers=layers if layers and not cpu else cfg.n_layers)
                gen = torch.Generator(device=dev).manual_seed(0)
                params = model.init(cfg, gen, dev)
                batch = {k: v.to(dev) for k, v in Pipeline(
                    cfg, DataConfig(b, s)).batch(0).items()}
                # no expert drops: the mesh's capacity is per data shard
                kw = ({"moe_capacity_factor": cfg.n_experts / cfg.top_k}
                      if cfg.is_moe else {})
                plain = S.build_train_step(cfg, opt,
                                           S.make_context(dev, **kw))
                # the step returns new parameters and leaves its input's
                st, m0 = plain({"params": params,
                                "opt": adamw.init(params)}, batch)
                del st
                g0 = stepped.pop("grads")
                pp = shd.distribute_tree(params, S.param_shardings(cfg, mesh),
                                         mesh)
                specs = shd.input_shardings(batch, mesh, b)
                bd = {k: shd.distribute(v, shd.placements(specs[k], mesh),
                                        mesh) for k, v in batch.items()}
                step = S.build_train_step(cfg, opt,
                                          S.make_context(mesh=mesh, **kw))
                state = {"params": pp, "opt": adamw.init(pp)}
                state, m1 = step(state, bd)
                g1 = stepped.pop("grads")
                errs = dist_max(g1, g0)
                worst = max(range(len(errs)), key=errs.__getitem__)
                if dtype == "float32" and rank == 0 and any(
                        c[0] == arch and c[2] == "float64" for c in CASES):
                    f32_grads[arch] = ([g.cpu() for g in g0],
                                       [g.cpu() for g in g1])
                if dtype == "float64" and rank == 0 and arch in f32_grads:
                    want = [g.cpu() for g in g0]
                    plain32, mesh32 = f32_grads.pop(arch)
                    rows = zip(_paths(params), errs,
                               dist_max(mesh32, want), dist_max(plain32, want))
                    for path, e64, e_mesh, e_plain in rows:
                        report({"mesh": "x".join(map(str, shape)),
                                "arch": cfg.name, "leaf": path,
                                "f64_mesh": e64, "f32_mesh": e_mesh,
                                "f32_plain": e_plain})
                    del want, plain32, mesh32
                del g0, g1
                times = []
                for _ in range(MEASURED):
                    sync()
                    t0 = time.perf_counter()
                    state, _ = step(state, bd)
                    sync()
                    times.append(time.perf_counter() - t0)
                vals = {k: (float(m1[k]), float(m0[k]))
                        for k in ("loss", "grad_norm")}
                rel = {k: abs(v[0] - v[1]) / abs(v[1])
                       for k, v in vals.items()}
                row = {"mesh": "x".join(map(str, shape)), "arch": cfg.name,
                       "layers": cfg.n_layers, "dtype": dtype,
                       **{f"{k}_mesh": v[0] for k, v in vals.items()},
                       **{f"{k}_plain": v[1] for k, v in vals.items()},
                       **{f"{k}_rel": r for k, r in rel.items()},
                       "leaf_err": errs[worst],
                       "leaf_worst": _paths(params)[worst],
                       "step_ms_median": 1e3 * float(np.median(times)),
                       "peak_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                                   if not cpu else None)}
                rel_max, leaf_max = BOUNDS[dtype]
                bad = [k for k, r in rel.items() if not r <= rel_max]
                if leaf_max is not None and not errs[worst] <= leaf_max:
                    bad.append("leaf_err")
                row["ok"] = not bad
                report(row)
                if bad:
                    failures.append(f"{row['arch']} {dtype} at {row['mesh']}"
                                    f": {', '.join(bad)}")
                del state, pp, params
                if not cpu:
                    torch.cuda.empty_cache()
        adamw.update = update
        mesh = make_mesh((2, 2), device_type=kind)
        cfg = get_config("smollm-360m")
        cfg = reduced_config(cfg) if cpu else dataclasses.replace(
            cfg, n_layers=4, dtype="float32")
        tr = FleetTrainer(cfg, steps_total=3, data_cfg=DataConfig(b, s),
                          opt_cfg=opt, grad_compression=True, mesh=mesh)
        state = tr.run()
        ef = max(float(t.to_local().abs().max())
                 for t in model._tree_leaves(state["ef"]))
        report({"fleet": "2x2", "compressed": tr._compressed,
                "losses": tr.report.losses, "ef_max": ef})
    finally:
        dist.destroy_process_group()
    if failures and rank == 0:
        print(f"mesh_nccl_check: FAIL: {'; '.join(failures)}", flush=True)
        sys.exit(1)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    import torch
    import torch.multiprocessing as mp
    if not args.cpu:
        if torch.cuda.device_count() < args.ranks:
            raise SystemExit(f"needs {args.ranks} cards, found "
                             f"{torch.cuda.device_count()}")
        import subprocess
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    mp.start_processes(_rank, args=(args.ranks, _free_port(), args.cpu),
                       nprocs=args.ranks, start_method="spawn")


if __name__ == "__main__":
    main()
