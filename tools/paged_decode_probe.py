#!/usr/bin/env python3
"""Where the paged-decode kernel's time goes, on one NVIDIA GPU.

    python3 tools/paged_decode_probe.py

Times ``ops.paged_attention`` (bf16, CUDA-graph replays of 50 calls, each
variant checked against the plain version first where its output is
meant to be right) at chip_smoke.py's two decode shapes: smollm-360m's
serving batch and the long context (qwen2.5-3b's heads, 8 slots near 8192
tokens, block 16, table width 512).  Four parts:

1. plan  -- warps per CTA (4, 8) x the cap on rows per CTA (8, 4) at the
            long shape, and the cap on the cluster size (8, 4, 2, 1) at
            both shapes, with eager (CUDA-event) and host enqueue times
            beside the graph times;
2. length -- the long shape's heads at contexts 256 ... 8192 (all slots
            equal): the fixed cost per call and the cost per key;
3. ablation -- patched copies of ``csrc/paged_decode.cu``, one nvcc each
            (timing only, outputs wrong on purpose): no K/V loads, no math
            after the loads, and the walk without the score shuffles, the
            softmax, the P.V update or the q.k products;
4. stream -- a torch copy and sum over buffers of the same size, the
            card's plain streaming rate for comparison.

Prints the card's name and power limit first.  Needs the CUDA toolkit's
nvcc; writes its builds under the git-ignored kernel build directory.
"""
import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402

SHAPES = {  # hq, hkv, d, bs, m, contexts
    "smollm": (15, 5, 64, 8, 32, [97, 100, 104, 108, 101, 103, 106, 110]),
    "long": (16, 2, 128, 16, 512, list(cs.LONG_CTX)),
}
# name -> [(anchor in csrc/paged_decode.cu, replacement)]
COPY = "    uint4* stage = ring + (i & (NS - 1)) * STAGE + lane;\n"
STEP = "    const uint4* stage = ring + (i & (NS - 1)) * STAGE + lane;\n"
DOT = "        for (int e = 0; e < E; ++e) d = fmaf(qr[r][e], kf[e], d);\n"
PV = ("        acc[r][e] = fmaf(p1, vf1[e], fmaf(p0, vf0[e], acc[r][e]));\n")
ABLATIONS = {
    "no loads": [(COPY, COPY + "    return;\n")],
    "no math": [(STEP, STEP + "    { acc[0][0] += __uint_as_float(stage[0].x)"
                 " + __uint_as_float(stage[32].y); lr[0] = 1.f; mr[0] = 0.f;"
                 " continue; }\n")],
    "no shuffles": [("for (int o = h >> 1; o > 0; o >>= 1)",
                     "for (int o = 0; o > 0; o >>= 1)"),
                    ("+ __shfl_xor_sync(FULL, send, h)", "+ send")],
    "no softmax": [("const float mine = own ? ex2(y[r] - mr[r]) : 0.f;",
                    "const float mine = y[r];"),
                   ("if (__any_sync(FULL, grow)) {", "if (false) {")],
    "no P.V": [(PV, "        if (e == 0) acc[r][0] = fmaf(p1, vf1[r % E],"
                " fmaf(p0, vf0[r % E], acc[r][0]));\n")],
    "no q.k": [(DOT, "        d = kf[r % E];\n")],
}


def inputs(rng, shape, lens=None):
    hq, hkv, d, bs, m, ctx = SHAPES[shape]
    lens = ctx if lens is None else lens
    kp, vp, tables, mk = cs.paged_inputs(torch, rng, len(lens), hkv, d, lens,
                                         torch.bfloat16, torch.device("cuda"),
                                         bs=bs, m=m)
    cls = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return mk(len(lens), 1, hq, d), kp, vp, tables, cls


def set_plan(warps=4, rows=8, cluster=8):
    ops._PD_WARPS, ops.PAGED_DECODE_MAX_ROWS = warps, rows
    ops._PD_MAX_CLUSTER = cluster
    ops.paged_decode_plan.cache_clear()


def checked(args):
    q, kp, vp, tables, cls = args
    fn = lambda: ops.paged_attention(q, kp, vp, tables, cls)  # noqa: E731
    want = ref.paged_attention_ref(q[:, 0], kp, vp, tables, cls)[:, None]
    cs.compare(torch, "paged_decode", fn(), want, "bfloat16", quiet=True)
    return fn


def plan_part(rng):
    print("1. plan (graph ms; eager ms / host enqueue ms)", flush=True)
    long = inputs(rng, "long")
    for warps in (4, 8):
        for rows in (8, 4):
            set_plan(warps, rows)
            fn = checked(long)
            p = ops.last_plan["paged_decode"]
            print(f"  long   warps {warps} rows {p.rows} cluster {p.cluster}: "
                  f"{cs.graph_ms(torch, fn):.5f}", flush=True)
    for shape in SHAPES:
        args = long if shape == "long" else inputs(rng, shape)
        for cap in (8, 4, 2, 1):
            set_plan(cluster=cap)
            fn = checked(args)
            host = {}
            ev = cs.time_ms(torch, fn, reps=200, host=host)
            p = ops.last_plan["paged_decode"]
            print(f"  {shape:6s} cluster {p.cluster} grid {p.grid}: "
                  f"{cs.graph_ms(torch, fn):.5f}; eager {ev:.5f} / "
                  f"{host['ms']:.5f}", flush=True)
    set_plan()


def length_part(rng):
    print("2. length (graph ms, long shape's heads, all slots equal)",
          flush=True)
    for n in (256, 1024, 2048, 4096, 8192):
        fn = checked(inputs(rng, "long", [n] * 8))
        print(f"  ctx {n:5d}: {cs.graph_ms(torch, fn):.5f}", flush=True)


def ablation_part(rng):
    print("3. ablation (graph ms at the long shape; outputs wrong on "
          "purpose)", flush=True)
    src = (build.CSRC / "paged_decode.cu").read_text()
    out = build.build_dir() / "probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, patches in ABLATIONS.items():
        text = src
        for old, new in patches:
            if old not in text:
                raise SystemExit(f"probe: anchor for {name!r} not found in "
                                 "paged_decode.cu")
            text = text.replace(old, new)
        stem = name.replace(" ", "_").replace(".", "")
        cu = out / f"{stem}.cu"
        cu.write_text(text)
        lib = out / f"lib{stem}.so"
        procs[name] = (subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT), lib)
    q, kp, vp, tables, cls = inputs(rng, "long")
    fn = checked((q, kp, vp, tables, cls))
    plan = ops.last_plan["paged_decode"]
    print(f"  kernel as built: {cs.graph_ms(torch, fn):.5f}", flush=True)
    hq, hkv, d, bs, m, _ = SHAPES["long"]
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode != 0:
            raise SystemExit(f"probe: {name} did not build:\n{log[-2000:]}")
        entry = ctypes.CDLL(str(lib)).paged_decode
        entry.argtypes = build.SIGNATURES["paged_decode"]
        o = torch.empty_like(q)

        def call():
            err = entry(1, q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                        tables.data_ptr(), cls.data_ptr(), o.data_ptr(), 8,
                        hq, hkv, d, bs, m, kp.shape[0], *plan.grid[:2],
                        plan.cluster, plan.rows, 32 * plan.warps, plan.lanes,
                        plan.chunks, plan.smem, d ** -0.5, 0.0,
                        torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"probe: {name} launch error {err}")
        print(f"  {name:12s}: {cs.graph_ms(torch, call):.5f}", flush=True)


def stream_part():
    print("4. stream (graph ms)", flush=True)
    q, kp, vp, tables, cls = inputs(np.random.default_rng(1), "long")
    live = sum(cs.LONG_CTX) * 2 * 128 * 2 * 2      # K and V bytes read
    x = torch.empty(live // 2, dtype=torch.bfloat16, device="cuda").normal_()
    y = torch.empty_like(x)
    g = cs.graph_ms(torch, lambda: torch.sum(x, dtype=torch.float32))
    print(f"  sum of {live / 1e6:.1f} MB: {g:.5f} ({live / g / 1e6:.0f} GB/s)")
    g = cs.graph_ms(torch, lambda: y.copy_(x))
    print(f"  copy of {live / 1e6:.1f} MB: {g:.5f} "
          f"({2 * live / g / 1e6:.0f} GB/s read + write)", flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probe: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, "| torch", torch.__version__, flush=True)
    build.build_all()
    rng = np.random.default_rng(0)
    plan_part(rng)
    length_part(rng)
    ablation_part(rng)
    stream_part()


if __name__ == "__main__":
    main()
