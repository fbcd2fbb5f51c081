#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
with nvcc (sm_90a), holds each against its plain PyTorch version, serves
smollm-360m at full width (32 layers, d_model 960, 15/5 heads, vocab 49152;
random weights from seed 0) through ``ClientHandler`` on ``LMBackend``, and
checks the float32 token streams of the kernel path against the plain path.
Phases:

1. device   — a CUDA device must be present; prints name and power limit;
2. build    — one nvcc per kernel source, all started together;
3. kernels  — each kernel vs its plain version at the serving shapes, in
              float32 (atol 2e-5, rtol 1e-5; TF32 off) and bfloat16 (atol
              2e-2, rtol 2e-2), with edge cases (zero-context row,
              n_live == 0 row, scattered tables, softcap, sliding window,
              per-head decode grid); CUDA-event times of kernel, plain
              version and, where one exists, one PyTorch library call;
4. serving  — 8 requests (prompts 16–96 tokens, two pairs sharing a
              32-token prefix, 16 new tokens each) through the default
              paged handler path in bfloat16, decode_window 4; every
              request must finish its budget and every kernel must have
              launched;
5. parity   — the same trace in float32 with impl="cuda" and impl="torch"
              on the same weights: token streams must be identical (a first
              mismatch is accepted only as a near-tie, top-two logit gap of
              the plain path < 1e-4).

Prints, before the last line, one ``{"kernels": [...]}`` line; the last line
is ``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero.
"""
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

H100_HBM_BW = 3.35e12            # B/s
H100_PEAK = {"float32": 67e12, "bfloat16": 989e12}   # FLOP/s, dense
TOL = {"float32": (2e-5, 1e-5), "bfloat16": (2e-2, 2e-2)}
CAPACITY = 256
PROMPT_PAD = 96
MAX_BATCH = 8
NEW_TOKENS = 16
BLOCK = 8
CHUNK = 8
REPLACES = {
    "paged_decode": "src/repro/kernels/flash_attention.py:337",
    "paged_prefill": "src/repro/kernels/flash_attention.py:264",
    "flash_attention": "src/repro/kernels/flash_attention.py:362",
}


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


# --------------------------------------------------------------------------- #
# phase 3: kernels vs plain versions
# --------------------------------------------------------------------------- #
def paged_inputs(torch, rng, b, hkv, d, lens, dtype, dev, extra=4):
    """Pool + scattered, shuffled tables covering ``lens`` tokens per row."""
    import numpy as np
    m = CAPACITY // BLOCK
    spans = [max(-(-ln // BLOCK), 1) for ln in lens]
    n = sum(spans) + 1 + extra
    ids = rng.permutation(np.arange(1, n))
    tables = np.zeros((b, m), np.int32)
    nxt = 0
    for i, sp in enumerate(spans):
        tables[i, :sp] = ids[nxt:nxt + sp]
        nxt += sp
    mk = lambda *s: torch.from_numpy(                      # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(dev, dtype)
    return (mk(n, BLOCK, hkv, d), mk(n, BLOCK, hkv, d),
            torch.from_numpy(tables).to(dev), mk)


def compare(torch, name, got, want, dtype_name):
    atol, rtol = TOL[dtype_name]
    g, w = got.float(), want.float()
    err = float((g - w).abs().max()) if g.numel() else 0.0
    ok = bool(((g - w).abs() <= atol + rtol * w.abs()).all())
    if not bool(torch.isfinite(g).all()):
        ok = False
    log(f"  {name:16s} {dtype_name:8s} max_abs_err={err:.3e} "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name} ({dtype_name}) disagrees with its plain version "
             f"(max abs err {err}, atol {atol}, rtol {rtol})")
    return err


def time_ms(torch, fn, reps=50, host=None):
    """CUDA-event time per call over ``reps`` back-to-back calls; when
    ``host`` is a dict, also the host's enqueue time per call (no sync
    inside the loop) under ``host["ms"]`` — equal times mean the launch
    path, not the device, sets the pace."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    if host is not None:
        host["ms"] = (time.perf_counter() - t0) * 1e3 / reps
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_phase(torch, dev, cfg):
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rng = np.random.default_rng(0)
    main_err = {}
    results = {}
    host = {}
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        # -------- paged decode: zero-context row, scattered tables,
        # softcap, both grids; the serving batch is MAX_BATCH slots
        lens = [0, 1, 17, 64, 97, 104, 112, 200]
        kp, vp, tables, mk = paged_inputs(torch, rng, MAX_BATCH, hkv, d,
                                          lens, dtype, dev)
        cls = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = mk(MAX_BATCH, 1, hq, d)
        for fused in (True, False):
            for softcap in (None, 30.0):
                got = ops.paged_attention(q, kp, vp, tables, cls,
                                          softcap=softcap, fused=fused)
                want = ref.paged_attention_ref(q[:, 0], kp, vp, tables, cls,
                                               softcap=softcap)[:, None]
                e = compare(torch, "paged_decode", got, want, dtype_name)
                if float(got[0].abs().max()) != 0.0:
                    fail("paged_decode: zero-context row is not exact zeros")
                if fused and softcap is None:
                    main_err[("paged_decode", dtype_name)] = e
        # -------- paged prefill: n_live == 0 row, partial rows, softcap
        p0 = np.array([0, 36, 32, 120, 5, 64, 88, 40], np.int32)
        nl = np.array([8, 8, 0, 3, 8, 1, 8, 8], np.int32)
        kp, vp, tables, mk = paged_inputs(torch, rng, 8, hkv, d, p0 + CHUNK,
                                          dtype, dev)
        q = mk(8, CHUNK, hq, d)
        tp0 = torch.from_numpy(p0).to(dev)
        tnl = torch.from_numpy(nl).to(dev)
        for softcap in (None, 30.0):
            got = ops.paged_prefill(q, kp, vp, tables, tp0, tnl,
                                    softcap=softcap)
            want = ref.paged_prefill_ref(q.transpose(1, 2), kp, vp, tables,
                                         tp0, tnl,
                                         softcap=softcap).transpose(1, 2)
            e = compare(torch, "paged_prefill", got, want, dtype_name)
            if float(got[2].abs().max()) != 0.0 or \
                    float(got[3, 3:].abs().max()) != 0.0:
                fail("paged_prefill: dead rows are not exact zeros")
            if softcap is None:
                main_err[("paged_prefill", dtype_name)] = e
        # -------- flash attention: S 96 (serving), 128, 256, ragged 100;
        # sliding window and softcap
        for s, window, softcap in ((PROMPT_PAD, None, None),
                                   (128, None, None), (256, None, None),
                                   (100, 32, None), (128, None, 30.0)):
            b = MAX_BATCH if s == PROMPT_PAD else 2
            q, k, v = mk(b, s, hq, d), mk(b, s, hkv, d), mk(b, s, hkv, d)
            got = ops.flash_attention(q, k, v, window=window, softcap=softcap)
            want = ref.flash_attention_ref(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                window=window, softcap=softcap).transpose(1, 2)
            e = compare(torch, "flash_attention", got, want, dtype_name)
            if s == PROMPT_PAD:
                main_err[("flash_attention", dtype_name)] = e

    # -------- timings at the serving shapes, in the serving dtype (bf16)
    dtype = torch.bfloat16
    item = 2
    peak = H100_PEAK["bfloat16"]
    lens = [97, 100, 104, 108, 101, 103, 106, 110]
    kp, vp, tables, mk = paged_inputs(torch, rng, MAX_BATCH, hkv, d, lens,
                                      dtype, dev)
    cls = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = mk(MAX_BATCH, 1, hq, d)
    ctx_tok = sum(lens)
    # each CTA reads only the table entries j < ceil(ctx / bs) of its row
    entries = sum(-(-ln // BLOCK) for ln in lens)
    byts = (2 * q.numel() * item + 2 * ctx_tok * hkv * d * item
            + entries * 4 + cls.numel() * 4)
    flops = 4 * hq * d * ctx_tok
    results["paged_decode"] = dict(
        ms=time_ms(torch, lambda: ops.paged_attention(q, kp, vp, tables,
                                                      cls),
                   host=host.setdefault("paged_decode", {})),
        plain_ms=time_ms(torch, lambda: ref.paged_attention_ref(
            q[:, 0], kp, vp, tables, cls)),
        bytes=byts, flops=flops, library_ms=None)
    p0 = np.array([36, 32], np.int32)
    nl = np.array([8, 8], np.int32)
    kp, vp, tables, mk = paged_inputs(torch, rng, 2, hkv, d, p0 + CHUNK,
                                      dtype, dev)
    q = mk(2, CHUNK, hq, d)
    tp0 = torch.from_numpy(p0).to(dev)
    tnl = torch.from_numpy(nl).to(dev)
    keys = int((p0 + nl).sum())
    # blocks at j * bs >= pos0 + n_live are skipped, table entries with them
    entries = int(sum(-(-int(e) // BLOCK) for e in p0 + nl))
    byts = (2 * q.numel() * item + 2 * keys * hkv * d * item
            + entries * 4 + 4 * (p0.size + nl.size))
    flops = sum(4 * hq * d * (int(p) + c + 1)
                for p, n in zip(p0, nl) for c in range(int(n)))
    results["paged_prefill"] = dict(
        ms=time_ms(torch, lambda: ops.paged_prefill(q, kp, vp, tables, tp0,
                                                    tnl),
                   host=host.setdefault("paged_prefill", {})),
        plain_ms=time_ms(torch, lambda: ref.paged_prefill_ref(
            q.transpose(1, 2), kp, vp, tables, tp0, tnl)),
        bytes=byts, flops=flops, library_ms=None)
    s = PROMPT_PAD
    q, k, v = (mk(MAX_BATCH, s, h, d) for h in (hq, hkv, hkv))
    byts = (2 * q.numel() + k.numel() + v.numel()) * item
    flops = 4 * MAX_BATCH * hq * d * s * (s + 1) // 2
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    results["flash_attention"] = dict(
        ms=time_ms(torch, lambda: ops.flash_attention(q, k, v),
                   host=host.setdefault("flash_attention", {})),
        plain_ms=time_ms(torch, lambda: ref.flash_attention_ref(qt, kt, vt)),
        bytes=byts, flops=flops,
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)))
    for name, r in results.items():
        t_bytes = r["bytes"] / H100_HBM_BW * 1e3
        t_ops = r["flops"] / peak * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        r["max_abs_err"] = main_err[(name, "bfloat16")]
        r["max_abs_err_float32"] = main_err[(name, "float32")]
        log(f"  time {name:16s} kernel {r['ms']:.5f} ms (host enqueue "
            f"{host[name]['ms']:.5f} ms)  plain "
            f"{r['plain_ms']:.5f} ms  library "
            f"{r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 5)}"
            f" ms  bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
    return results


# --------------------------------------------------------------------------- #
# phases 4-5: serving
# --------------------------------------------------------------------------- #
def trace(vocab):
    """8 requests, prompts 16-96 tokens; (A1, A2) share 36 tokens — a
    32-token prefix plus 4 tokens of the next block, so A2 maps 4 blocks
    shared and copies the fifth on write — and (B1, B2) share exactly a
    32-token prefix.  A2 and B2 arrive while the first step is in flight,
    so they join mid-flight through the chunked suffix prefill fused with
    the resident cohort's decode window."""
    import numpy as np
    from repro_torch.core.scheduler import ServeRequest
    rng = np.random.default_rng(11)
    tok = lambda n: rng.integers(0, vocab, n, dtype=np.int32)  # noqa: E731
    pa, pb = tok(32), tok(32)
    a1 = np.concatenate([pa, tok(60)])
    a2 = np.concatenate([a1[:36], tok(40)])
    b1 = np.concatenate([pb, tok(48)])
    b2 = np.concatenate([pb, tok(30)])
    cold = [a1, b1, tok(16), tok(24), tok(70), tok(96)]
    reqs = [ServeRequest(i, p, NEW_TOKENS, arrival_t=0.0)
            for i, p in enumerate(cold)]
    reqs += [ServeRequest(6, a2, NEW_TOKENS, arrival_t=0.01),
             ServeRequest(7, b2, NEW_TOKENS, arrival_t=0.02)]
    return reqs


def serve(torch, backend, executor=None):
    from repro_torch.launch.serve import ClientHandler
    h = ClientHandler(backend, max_batch=MAX_BATCH, max_secondaries=0,
                      prompt_pad=PROMPT_PAD, decode_window=4,
                      executor=executor)
    reqs = trace(backend.cfg.vocab_size)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = h.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    toks = {c.rid: [int(t) for t in c.tokens] for c in rep.completions}
    if sorted(toks) != list(range(len(reqs))):
        fail(f"served {sorted(toks)} of {len(reqs)} requests")
    for rid, t in toks.items():
        if len(t) != NEW_TOKENS or not all(0 <= x < backend.cfg.vocab_size
                                           for x in t):
            fail(f"request {rid}: {len(t)} tokens {t[:4]}...")
    return toks, rep, h, wall, reqs


def near_tie(torch, backend, req, generated, prompt_pad):
    """Top-two logit gap of the plain path at the step that produced
    ``generated[-1]`` (context: padded prompt + the earlier tokens)."""
    import numpy as np
    from repro_torch.models import model
    ctx = np.zeros((prompt_pad,), np.int32)
    ctx[:min(len(req.prompt), prompt_pad)] = req.prompt[:prompt_pad]
    seq = np.concatenate([ctx, np.asarray(generated[:-1], np.int32)])
    logits, _ = model.forward(backend.cfg, backend.params,
                              {"tokens": backend.tensor(seq[None])},
                              backend.ctx, "prefill")
    top = torch.topk(logits[0].float(), 2).values
    return float(top[0] - top[1])


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops
    from repro_torch.launch.serve import LMBackend
    from repro_torch.models import model

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    log(f"[1/5 device] {kind} x{torch.cuda.device_count()} | {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"[2/5 build] {len(libs)} kernels in "
        f"{time.perf_counter() - t0:.1f} s -> {build.build_dir()}")
    for name in libs:
        for line in (build.build_dir() / f"{name}.log").read_text() \
                .splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    cfg = get_config("smollm-360m")
    log("[3/5 kernels] each kernel vs its plain version")
    results = kernel_phase(torch, dev, cfg)

    log("[4/5 serving] smollm-360m full width, bfloat16, ClientHandler")
    backend = LMBackend(cfg, capacity=CAPACITY, device="cuda")
    ops.reset_launches()
    toks, rep, h, wall, _ = serve(torch, backend)
    launches = dict(ops.launches)
    n_tok = sum(len(t) for t in toks.values())
    log(f"  {rep.summary()}")
    log(f"  wall {wall:.4f} s for {n_tok} tokens ({n_tok / wall:.3f} tok/s, "
        f"Venue executor re-runs each step closure); prefix hit tokens "
        f"{h.prefix_hit_tokens}, launches {launches}")
    if h.prefix_hit_tokens <= 0:
        fail("no prefix hit: the trace did not exercise the prefix cache")
    for name, n in launches.items():
        if n <= 0:
            fail(f"{name} never launched on the serving path")
    del backend

    log("[5/5 parity] float32, impl=cuda vs impl=torch, same weights")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(cfg32, gen, dev)
    fixed = lambda c, f, a: (f(*a), 0.05)          # noqa: E731
    runs = {}
    for impl in ("cuda", "torch"):
        b = LMBackend(cfg32, capacity=CAPACITY, params=params, device="cuda",
                      impl=impl)
        runs[impl] = serve(torch, b, executor=fixed)
        n = sum(len(t) for t in runs[impl][0].values())
        log(f"  impl={impl}: wall {runs[impl][3]:.4f} s for {n} tokens "
            f"(fixed-time executor, each step run once)")
    got, want = runs["cuda"][0], runs["torch"][0]
    mismatched = [rid for rid in want if got[rid] != want[rid]]
    plain = LMBackend(cfg32, capacity=CAPACITY, params=params,
                      device="cuda", impl="torch")
    reqs = {r.rid: r for r in runs["torch"][4]}
    for rid in mismatched:
        j = next(i for i, (x, y) in enumerate(zip(got[rid], want[rid]))
                 if x != y)
        gap = near_tie(torch, plain, reqs[rid], want[rid][:j + 1],
                       PROMPT_PAD)
        log(f"  request {rid}: first mismatch at token {j}, plain-path "
            f"top-two gap {gap:.3e}")
        if gap >= 1e-4:
            fail(f"request {rid}: token streams differ at {j} "
                 f"(gap {gap} is no near-tie)")
    log(f"  {len(want) - len(mismatched)}/{len(want)} streams identical"
        + (f", {len(mismatched)} near-tie(s) accepted" if mismatched
           else ""))

    kernels = []
    for name in ("paged_decode", "paged_prefill", "flash_attention"):
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
