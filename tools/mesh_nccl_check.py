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
their losses and grad norms, the relative differences, and the median
of MEASURED further sharded steps (host clock between synchronisations).
Then ``FleetTrainer(mesh=2x2, grad_compression=True)`` (two data ranks:
the int8 + error-feedback mean) runs 3 steps.  Rank 0 prints one JSON
line per case.  ``--cpu`` runs the same on a gloo group with reduced
configurations (a check of the script itself).
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
         ("rwkv6-7b", 4, "float32"))
MESHES = ((2, 2), (1, 4))
BATCH, SEQ = 8, 256
MEASURED = 3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank(rank: int, world: int, port: int, cpu: bool) -> None:
    import copy

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
                _, m0 = plain({"params": copy.deepcopy(params),
                               "opt": adamw.init(params)}, batch)
                pp = shd.distribute_tree(params, S.param_shardings(cfg, mesh),
                                         mesh)
                specs = shd.input_shardings(batch, mesh, b)
                bd = {k: shd.distribute(v, shd.placements(specs[k], mesh),
                                        mesh) for k, v in batch.items()}
                step = S.build_train_step(cfg, opt,
                                          S.make_context(mesh=mesh, **kw))
                state = {"params": pp, "opt": adamw.init(pp)}
                state, m1 = step(state, bd)
                times = []
                for _ in range(MEASURED):
                    sync()
                    t0 = time.perf_counter()
                    state, _ = step(state, bd)
                    sync()
                    times.append(time.perf_counter() - t0)
                vals = {k: (float(m1[k]), float(m0[k]))
                        for k in ("loss", "grad_norm")}
                report({"mesh": "x".join(map(str, shape)), "arch": cfg.name,
                        "layers": cfg.n_layers, "dtype": dtype,
                        **{f"{k}_mesh": v[0] for k, v in vals.items()},
                        **{f"{k}_plain": v[1] for k, v in vals.items()},
                        **{f"{k}_rel": abs(v[0] - v[1]) / abs(v[1])
                           for k, v in vals.items()},
                        "step_ms_median": 1e3 * float(np.median(times)),
                        "peak_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                                    if not cpu else None)})
                del state, pp, params
                if not cpu:
                    torch.cuda.empty_cache()
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
