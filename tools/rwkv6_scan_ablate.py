#!/usr/bin/env python3
"""Where the WKV kernel's time goes: time it with parts of it taken out, one GPU.

    python3 tools/rwkv6_scan_ablate.py [--reps 20]

Builds, beside the real ``csrc/rwkv6_scan.cu``, copies of it with one part
taken out, each by a fixed text edit of the source (the script stops if an
edit no longer applies), and times every copy with CUDA events on the same
bf16 inputs as ``tools/rwkv6_scan_probe.py`` at the serving shape (B 8,
S 64, H 64, N 64) and the long shape (B 8, S 2048), under the launch plan
of ``ops.rwkv6_scan_plan``:

- ``base``: the kernel as it is;
- ``consumers``: the producer warp stages nothing and computes no bonus
  (it only hands each stage on), so the consumer lanes alone set the pace;
- ``no_shuffle``: no reduce-scatter (each lane's y is its own partial);
- ``fma_only``: ``consumers`` with neither reduce-scatter nor y stores:
  the consumers' loads, conversions and FMAs alone;
- ``unroll2``: the consumers' step loop unrolled by two.

Every copy but ``base`` computes wrong outputs; only times are printed,
one JSON line per (copy, shape), with the card's name and power limit
first.  The copies build into the git-ignored ``_build/ablate/`` beside
the kernels.  Needs a CUDA device and nvcc.
"""
import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

SHAPES = {"serving": (8, 64, 64, 64), "long": (8, 2048, 64, 64)}

PRODUCER_LOOP = """      const int s = c % stages, n = steps_of(c);
      if (vec)"""
REDUCE = "for (int kk2 = C / 2, o = 1; kk2 >= 1; kk2 >>= 1, o <<= 1)"
Y_STORE = "if (writes) *yt"
STEP_LOOP = "      for (int t = 1; t < n; ++t) {"


def edit(src, old, new):
    if old not in src:
        sys.exit(f"rwkv6_scan_ablate: the kernel no longer has {old!r}")
    return src.replace(old, new)


def variants(src):
    # S > 0 / S < 0 keep each edit a run-time condition the compiler
    # cannot fold away
    consumers = edit(
        edit(src, PRODUCER_LOOP, PRODUCER_LOOP.replace(
            "      if (vec)",
            "      if (S > 0) {\n"
            "        if (c >= stages) mbar_wait(empty + s, "
            "(c / stages - 1) & 1);\n"
            "        mbar_arrive(full + s);\n"
            "        continue;\n"
            "      }\n"
            "      if (vec)")),
        "    for (int c = 0; c < stages - 1; ++c) load(c);",
        "    for (int c = 0; c < stages - 1 && S < 0; ++c) load(c);")
    no_reduce = REDUCE.replace("kk2 >= 1;", "kk2 >= 1 && S < 0;")
    return {
        "base": src,
        "consumers": consumers,
        "no_shuffle": edit(src, REDUCE, no_reduce),
        "fma_only": edit(edit(consumers, REDUCE, no_reduce), Y_STORE,
                         "if (writes && S < 0) *yt"),
        "unroll2": edit(src, STEP_LOOP, "#pragma unroll 2\n" + STEP_LOOP),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    import chip_smoke as cs              # helpers only; imports no kernel
    from repro_torch.kernels import build, ops
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"# {smi}", flush=True)
    out = build.BUILD_ROOT / "ablate"
    out.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / "rwkv6_scan.cu").read_text()
    procs = {}
    for name, text in variants(src).items():
        (out / f"{name}.cu").write_text(text)
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
               str(out / f"lib{name}.so"), str(out / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"rwkv6_scan_ablate: {name} failed to build:\n{log}")
        fn = getattr(ctypes.CDLL(str(out / f"lib{name}.so")), "rwkv6_scan")
        fn.argtypes = build.SIGNATURES["rwkv6_scan"]
        fn.restype = ctypes.c_int
        libs[name] = fn
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for shape, (b, s, h, n) in SHAPES.items():
        r, k, v, w, u, _ = cs.wkv_inputs(torch, rng, b, s, h, n,
                                         torch.bfloat16, dev)
        y = torch.empty_like(r)
        sf = torch.empty((b, h, n, n), dtype=torch.float32, device=dev)
        plan = ops.rwkv6_scan_plan(b, s, h, n, torch.bfloat16)
        for name, fn in libs.items():
            def call(fn=fn):
                err = fn(1, r.data_ptr(), k.data_ptr(), v.data_ptr(),
                         w.data_ptr(), u.data_ptr(), None, y.data_ptr(),
                         sf.data_ptr(), b, s, h, n, plan.threads,
                         plan.chunk, plan.stages, plan.smem, int(plan.vec),
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    sys.exit(f"rwkv6_scan_ablate: {name}: CUDA error {err}")
            print(json.dumps({"variant": name, "shape": shape,
                              "ms": cs.time_ms(torch, call,
                                               reps=args.reps)}),
                  flush=True)


if __name__ == "__main__":
    main()
