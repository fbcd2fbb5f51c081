#!/usr/bin/env python3
"""Time the RWKV-6 WKV kernel at its serving and long shapes, one GPU.

    python3 tools/rwkv6_scan_probe.py [--src DIR] [--reps 50] [--variants]

Times this checkout's ``ops.rwkv6_scan`` and, with ``--src``, another
tree's (the ``src`` directory of, e.g., the parent commit unpacked under
the git-ignored ``.chip_tree/``) in one process, in the order other, this,
this, other, on the same inputs: bf16 r, k, v and float32 decays in
(0.29, 0.99) from seed 0, a zero initial state, as the cohort prefill of
rwkv6-7b calls it (H 64, N 64), at the serving shape (B 8, S 64) and the
long shape (B 8, S 2048).  Each tree's package is imported under its own
name set and swapped into ``sys.modules`` while it runs, so each builds
and loads its own kernels.  Per (tree, shape) one JSON line: the max abs
error against the plain version (bf16 tolerance), CUDA-event,
host-enqueue and graph-replayed ms per call, the bound (the larger of
bytes over the HBM rate and float32 operations over the CUDA-core peak),
the launch plan where the tree has one and, for this tree, the CTAs the
card holds per SM at that plan.  With ``--variants``, this tree is timed
again at each shape with 8-step chunks and with 4 ring stages: each
variant's plan is ``ops.rwkv6_scan_plan``'s own, given that keyword.

Needs a CUDA device and nvcc (the kernels build on first use).
"""
import argparse
import contextlib
import functools
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SHAPES = {"serving": (8, 64, 64, 64), "long": (8, 2048, 64, 64)}


def _port_modules():
    return {m: mod for m, mod in sys.modules.items()
            if m == "repro_torch" or m.startswith("repro_torch.")}


@contextlib.contextmanager
def active(mods):
    """Runs the body with ``mods`` as the imported ``repro_torch``."""
    saved = _port_modules()
    for m in saved:
        del sys.modules[m]
    sys.modules.update(mods)
    try:
        yield
    finally:
        for m in _port_modules():
            del sys.modules[m]
        sys.modules.update(saved)


def load_tree(src):
    """Imports ``repro_torch`` (ops, ref, build) from ``src`` and builds
    its kernels; returns its module set, leaving none of it imported."""
    with active({}):
        sys.path.insert(0, str(src))
        try:
            from repro_torch.kernels import build, ops, ref  # noqa: F401
            build.build_all()
        finally:
            sys.path.remove(str(src))
        return _port_modules()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=None)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    import chip_smoke as cs              # helpers only; imports no kernel
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    trees = {"this": load_tree(ROOT / "src")}
    if args.src:
        trees["other"] = load_tree(pathlib.Path(args.src).resolve())
    order = [("other", {}), ("this", {}), ("this", {}), ("other", {})]
    if not args.src:
        order = order[1:3]
    if args.variants:
        order += [("this", {"chunk": 8}), ("this", {"stages": 4})]
    print(f"# {smi} | this: {ROOT / 'src'} | other: {args.src}", flush=True)
    rng = np.random.default_rng(0)
    for shape, (b, s, h, n) in SHAPES.items():
        r, k, v, w, u, _ = cs.wkv_inputs(torch, rng, b, s, h, n,
                                         torch.bfloat16, dev)
        zeros = torch.zeros((b, h, n, n), dtype=torch.float32, device=dev)
        with active(trees["this"]):
            from repro_torch.kernels import ref
            want_y, _ = ref.rwkv6_scan_ref(
                *(x.transpose(1, 2) for x in (r, k, v, w)), u, zeros)
        want_y = want_y.transpose(1, 2).float()
        byts, flops = cs.wkv_cost(r, w, u, zeros)
        t_bytes = byts / cs.H100_HBM_BW * 1e3
        t_ops = flops / cs.H100_PEAK["float32"] * 1e3
        for tree, override in order:
            with active(trees[tree]):
                from repro_torch.kernels import ops
                plan_of = getattr(ops, "rwkv6_scan_plan", None)
                if override:
                    ops.rwkv6_scan_plan = functools.partial(plan_of,
                                                            **override)
                call = lambda: ops.rwkv6_scan(r, k, v, w, u)  # noqa: E731
                got = call()[0].float()
                atol, rtol = cs.TOL["bfloat16"]
                diff = (got - want_y).abs()
                host = {}
                row = {
                    "tree": tree, "variant": override, "shape": shape,
                    "b": b, "s": s, "h": h,
                    "n": n, "max_abs_err": float(diff.max()),
                    "ok": bool((diff <= atol + rtol * want_y.abs()).all()),
                    "ms": cs.time_ms(torch, call, reps=args.reps, host=host),
                    "enqueue_ms": host["ms"],
                    "graph_ms": cs.graph_ms(torch, call, reps=args.reps),
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "bytes": byts, "flops": flops}
                plan = getattr(ops, "last_plan", {}).get("rwkv6_scan")
                row["plan"] = None if plan is None else plan._asdict()
                if tree == "this":
                    row["resident"] = ops.rwkv6_scan_resident(
                        plan, torch.bfloat16)
                if plan_of is not None:
                    ops.rwkv6_scan_plan = plan_of
                print(json.dumps(row), flush=True)
        del r, k, v, w, want_y
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
