#!/usr/bin/env python3
"""Time the chunked-prefill paged-attention kernel at three shapes, one GPU.

    python3 tools/paged_prefill_probe.py [--src DIR] [--reps 50] [--variants]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's), so that an older tree unpacked beside this one
can be timed in the same process order on the same card (old, new, new,
old).  bf16 inputs from seed 0 at the shapes of ``chip_smoke.py``:
smollm-360m's serving chunk (2 slots, C 8, pos0 36/32, Hq 15 / Hkv 5, D 64,
bs 8) and the two long-prefill layouts (8 slots of 8065-8192 tokens, C 8:
qwen2.5-3b's heads Hq 16 / Hkv 2, D 128, bs 16; smollm-360m's Hq 15 /
Hkv 5, D 64, bs 8).  Per shape, one JSON line: the kernel's result against
the plain version (max abs error, bf16 tolerance), CUDA-event, host-enqueue
and graph-replayed ms per call, the byte bound, and the plan; or the
``ValueError`` a kernel that cannot take the shape raises.  With
``--variants``, the long shapes are timed again at ring depths 2 and 3 x
cluster sizes 1-8, the serving chunk and short contexts (8 slots of 256
and 2048 tokens) at both ring depths, and chunks of more than 64
flattened rows (C 16 and 64 at qwen2.5-3b's heads, C 32 at smollm-360m's,
long and serving contexts) in 64- and 128-row tiles, at the plan's
cluster and at 8: each variant's plan is ``ops.paged_prefill_plan``'s
own, given that ring depth, cluster or row count (a tree whose plan takes
none of them reports the variant refused).

Needs a CUDA device and nvcc (the kernels build on first use).
"""
import argparse
import functools
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    import chip_smoke as cs              # helpers only; imports no kernel
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    import repro_torch
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    where = pathlib.Path(repro_torch.__file__).parent
    print(f"# {smi} | repro_torch from {where}", flush=True)
    long = np.array(cs.LONG_CTX, np.int32)
    serving = np.array([36, 32], np.int32)
    # (pos0, chunk, Hq, Hkv, D, bs, table width)
    shapes = {
        "serving": (serving, cs.CHUNK, 15, 5, 64, 8, 32),
        "long_qwen": (long - cs.CHUNK, cs.CHUNK, 16, 2, 128, 16, 512),
        "long_smollm": (long - cs.CHUNK, cs.CHUNK, 15, 5, 64, 8, 1024),
    }
    runs = [(name, shape, {}) for name, shape in shapes.items()]
    if args.variants:
        for stages in (2, 3):
            runs.append((f"serving stages {stages}", shapes["serving"],
                         {"stages": stages}))
        for name in ("long_qwen", "long_smollm"):
            p0, c, hq, hkv, d, bs, m = shapes[name]
            for stages in (2, 3):
                for cluster in (1, 2, 4, 8):
                    runs.append((f"{name} stages {stages} cluster {cluster}",
                                 shapes[name],
                                 {"stages": stages, "cluster": cluster}))
                for ctx in (256, 2048):
                    runs.append((f"{name} ctx {ctx} stages {stages}",
                                 (p0 - 8192 + ctx, c, hq, hkv, d, bs, m),
                                 {"stages": stages}))
        for name, c in (("long_qwen", 16), ("long_qwen", 64),
                        ("long_smollm", 32), ("serving", 32)):
            p0, _, hq, hkv, d, bs, m = shapes[name]
            p0 = p0 + cs.CHUNK - c if name != "serving" else p0
            m = max(m, -(-int(p0.max() + c) // bs))
            for rows in (64, 128):
                for cluster in (None, 8):
                    over = {"rows": rows}
                    if cluster:
                        over["cluster"] = cluster
                    runs.append((f"{name} C {c} rows {rows}"
                                 + (f" cluster {cluster}" if cluster else ""),
                                 (p0, c, hq, hkv, d, bs, m), over))
    plan_of = getattr(ops, "paged_prefill_plan", None)   # None: no plan yet
    rng = np.random.default_rng(0)
    for name, (p0, c, hq, hkv, d, bs, m), override in runs:
        if plan_of is not None:
            ops.paged_prefill_plan = functools.partial(plan_of, **override)
        nl = np.full(len(p0), c, np.int32)
        kp, vp, tables, mk = cs.paged_inputs(
            torch, rng, len(p0), hkv, d, p0 + c, torch.bfloat16, dev,
            bs=bs, m=m)
        q = mk(len(p0), c, hq, d)
        tp0, tnl = (torch.from_numpy(x).to(dev) for x in (p0, nl))
        byts, flops = cs.paged_prefill_cost(q, p0, nl, hkv, bs, 2)
        row = {"shape": name, "bound_ms": byts / cs.H100_HBM_BW * 1e3,
               "bytes": byts, "flops": flops}
        call = lambda: ops.paged_prefill(q, kp, vp, tables,  # noqa: E731
                                         tp0, tnl)
        try:
            got = call()
        except (TypeError, ValueError) as e:     # TypeError: an older plan
            row["refused"] = str(e)
            print(json.dumps(row), flush=True)
            continue
        want = ref.paged_prefill_ref(q.transpose(1, 2), kp, vp, tables, tp0,
                                     tnl).transpose(1, 2)
        atol, rtol = cs.TOL["bfloat16"]
        diff = (got.float() - want.float()).abs()
        row["max_abs_err"] = float(diff.max())
        row["err_over_rms"] = row["max_abs_err"] / float(
            want.float().pow(2).mean().sqrt())
        row["ok"] = bool((diff <= atol + rtol * want.float().abs()).all())
        host = {}
        row["ms"] = cs.time_ms(torch, call, reps=args.reps, host=host)
        row["enqueue_ms"] = host["ms"]
        row["graph_ms"] = cs.graph_ms(torch, call, reps=args.reps)
        plan = ops.last_plan.get("paged_prefill")
        row["plan"] = None if plan is None else plan._asdict()
        print(json.dumps(row), flush=True)
        del kp, vp, q, got, want
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
