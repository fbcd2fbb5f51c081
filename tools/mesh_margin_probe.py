#!/usr/bin/env python3
"""Where a sharded float32 train step's gradient gap comes from, leaf by
leaf, on the CPU test battery's own weights and batch.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/mesh_margin_probe.py \
        [--arch rwkv6-7b] [--meshes 2x2 1x4]

Four gloo ranks (one torch thread each) take the reduced configuration
and the numpy weights and batch of ``tests/test_torch_distributed.py``
and compute the train-mode gradients three ways: float32 on the mesh,
float32 on one device, and float64 on one device (the same float32
draws, widened; every float32 cast of the model widens with them).  For
every leaf, rank 0 prints the mesh-vs-one-device gap the test bounds
(2e-5 of the leaf's largest entry) beside each float32 step's distance
from the float64 one: a gap that is mostly the one-device step's own
rounding is no fault of the mesh.
"""
import argparse
import dataclasses
import logging
import os
import socket
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tests"))


def _grads(cfg, ctx, params, batch):
    import torch
    from repro_torch.models import model
    live = model.tree_map(lambda p: p.detach().requires_grad_(), params)
    total, _ = model.forward(cfg, live, batch, ctx, "train")
    gs = torch.autograd.grad(total, model._tree_leaves(live),
                             materialize_grads=True)
    return [g.full_tensor() if hasattr(g, "full_tensor") else g for g in gs]


def _rank(rank: int, port: int, arch: str, shape) -> None:
    import torch
    import torch.distributed as dist
    import test_torch_distributed as T
    from repro_torch import configs
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model
    from repro_torch.models.spec import spec_leaves
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4)
    cfg = T._cfg(arch, None, configs)
    leaves = spec_leaves(model.param_specs(cfg))
    arrs = T._np_leaves({p: s.shape for p, s in leaves},
                        {p: (s.init, s.fan_in if s.fan_in is not None
                             else (s.shape[0] if s.shape else 1))
                         for p, s in leaves})

    def params(dtype):
        out = model.tree_map(lambda _: None, model.param_specs(cfg))
        for p, _ in leaves:
            node = out
            *head, last = p.split("/")
            for k in head:
                node = node[k]
            node[last] = torch.from_numpy(arrs[p]).to(dtype)
        return out

    batch = {k: torch.from_numpy(v) for k, v in T._np_batch(cfg).items()}
    cpu = torch.device("cpu")
    g64 = _grads(dataclasses.replace(cfg, dtype="float64"),
                 S.make_context(cpu), params(torch.float64), batch)
    g0 = _grads(cfg, S.make_context(cpu), params(torch.float32), batch)
    mesh = make_mesh(shape, device_type="cpu")
    pp = shd.distribute_tree(params(torch.float32),
                             S.param_shardings(cfg, mesh), mesh)
    specs = shd.input_shardings(batch, mesh, T.B)
    bd = {k: shd.distribute(v, shd.placements(specs[k], mesh), mesh)
          for k, v in batch.items()}
    g1 = _grads(cfg, S.make_context(mesh=mesh), pp, bd)
    if rank == 0:
        def rel(a, b):
            return (float((a.double() - b.double()).abs().max())
                    / max(float(b.double().abs().max()), 1e-300))
        print(f"{arch} {shape[0]}x{shape[1]}: leaf, float32 mesh vs "
              "one-device (the test's gap), mesh vs float64, one-device vs "
              "float64", flush=True)
        for (p, _), a, b, c in zip(leaves, g1, g0, g64):
            print(f"  {p:34s} {rel(a, b):.3e}  {rel(a, c):.3e}  "
                  f"{rel(b, c):.3e}", flush=True)
    dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-7b")
    ap.add_argument("--meshes", nargs="+", default=["2x2", "1x4"])
    args = ap.parse_args()
    import torch.multiprocessing as mp
    for m in args.meshes:
        shape = tuple(int(x) for x in m.split("x"))
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        mp.start_processes(_rank, args=(port, args.arch, shape), nprocs=4,
                           start_method="spawn")


if __name__ == "__main__":
    main()
