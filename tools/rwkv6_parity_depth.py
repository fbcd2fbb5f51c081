#!/usr/bin/env python3
"""Where float32 token parity of rwkv6-7b breaks with depth, on one GPU.

    python3 tools/rwkv6_parity_depth.py [--depths 1 2 4 8 16 32]

Full-width rwkv6-7b in float32 (random weights from seed 0, TF32 off) on
the 8-request trace of ``chip_smoke.py`` phase 6.  Prints:

1. layer 0 on the prefill batch: the relative difference (max abs
   difference over max abs value) between the CUDA WKV kernel and the
   plain chunked path, in the WKV output, the final state, and after the
   per-head group norm;
2. after a full-depth prefill, kernel path vs plain path: the relative
   difference of every fourth layer's WKV state, and of the logits;
3. per depth (the first n layers of the same weights): the first
   mismatches (request, token) of the token streams served through
   ``ClientHandler(kv="contiguous")`` — kernel path vs plain path, and
   plain path with WKV chunk 16 vs chunk 64, the same arithmetic in
   another rounding order.

Needs a CUDA device and nvcc (the kernels build on first use).
"""
import argparse
import dataclasses
import functools
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def layer0(torch, cfg, params, toks):
    """WKV output, state and group norm of layer 0: kernel vs plain."""
    from repro_torch.kernels import ops
    from repro_torch.models import model, rwkv6
    from repro_torch.models.layers import apply_norm
    lp = model.tree_map(lambda t: t[0], params["layers"]["stack"]["b0"])
    x = model.embed_tokens(cfg, params, toks)
    h = apply_norm(x, lp["norm1"], cfg.norm_type)
    tm = lp["tm"]
    b, s, d = h.shape
    hh, n = cfg.n_heads, cfg.head_dim
    xp = rwkv6._token_shift(h, None)
    xr, xk, xv, _, xw = (h + (xp - h) * tm["mu"][i] for i in range(5))
    r, k, v = (torch.matmul(a, tm[w].reshape(d, -1)).reshape(b, s, hh, n)
               for a, w in ((xr, "wr"), (xk, "wk"), (xv, "wv")))
    lora = torch.matmul(torch.tanh(torch.matmul(xw, tm["wA"])), tm["wB"])
    w = torch.exp(-torch.exp(tm["w0"] + lora)).reshape(b, s, hh, n)
    yk, sk = ops.rwkv6_scan(r, k, v, w, tm["u"])
    yp, sp = rwkv6.wkv6_chunked_ref(r, k, v, w, tm["u"], None)
    gk, gp = (rwkv6._group_norm(y, tm["gn_scale"], tm["gn_bias"])
              for y in (yk, yp))
    print(f"layer 0 (relative): WKV output {rel(yk, yp):.3e}, final state "
          f"{rel(sk, sp):.3e}, after group norm {rel(gk, gp):.3e}",
          flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--depths", type=int, nargs="+",
                    default=[1, 2, 4, 8, 16, 32])
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import LMBackend
    from repro_torch.models import model, rwkv6
    from repro_torch.models.context import RunContext

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("rwkv6-7b"), dtype="float32")
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    reqs = cs.rwkv_trace(cfg.vocab_size)
    toks = np.zeros((len(reqs), cs.RWKV_PROMPT_PAD), np.int32)
    for i, r in enumerate(reqs):
        toks[i, :len(r.prompt)] = r.prompt[:cs.RWKV_PROMPT_PAD]
    toks = torch.tensor(toks, device=dev)
    with torch.no_grad():
        layer0(torch, cfg, params, toks)
        out = {impl: model.forward(cfg, params, {"tokens": toks},
                                   RunContext(dev, impl), "prefill",
                                   cs.RWKV_CAPACITY)
               for impl in ("cuda", "torch")}
    (lk, ck), (lp, cp) = out["cuda"], out["torch"]
    sk, sp = (c["stack"]["b0"]["tm"]["s"] for c in (ck, cp))
    per = ", ".join(f"{i}: {rel(sk[i], sp[i]):.3e}"
                    for i in range(0, cfg.n_layers, 4))
    print(f"full-depth prefill, kernel vs plain (relative): state by layer "
          f"{{{per}}}; logits {rel(lk, lp):.3e}", flush=True)
    del out, lk, ck, lp, cp, sk, sp

    fixed = lambda c, f, a: (f(*a), 0.05)          # noqa: E731
    orig = rwkv6.wkv6_chunked_ref

    def streams(dcfg, dparams, impl, chunk=64):
        rwkv6.wkv6_chunked_ref = functools.partial(orig, chunk=chunk)
        try:
            b = LMBackend(dcfg, capacity=cs.RWKV_CAPACITY, params=dparams,
                          device="cuda", impl=impl)
            return cs.serve(torch, b, cs.rwkv_trace(dcfg.vocab_size),
                            executor=fixed, kv="contiguous", decode_window=1,
                            prompt_pad=cs.RWKV_PROMPT_PAD)[0]
        finally:
            rwkv6.wkv6_chunked_ref = orig

    for depth in args.depths:
        dcfg = dataclasses.replace(cfg, n_layers=depth)
        dparams = dict(params)
        dparams["layers"] = dict(params["layers"], stack=model.tree_map(
            lambda t: t[:depth], params["layers"]["stack"]))
        plain = streams(dcfg, dparams, "torch")
        kernel = cs.first_mismatches(streams(dcfg, dparams, "cuda"), plain)
        other = cs.first_mismatches(streams(dcfg, dparams, "torch", 16),
                                    plain)
        print(f"depth {depth}: first mismatches kernel vs plain {kernel}; "
              f"plain chunk 16 vs chunk 64 {other}", flush=True)


if __name__ == "__main__":
    main()
