#!/usr/bin/env python3
"""Where float32 token parity of recurrentgemma-2b holds with depth, on one
GPU.

    python3 tools/rglru_parity_depth.py [--depths 3 6 12 24 26]

Full-width recurrentgemma-2b in float32 (random weights from seed 0, TF32
off) on the 8-request trace of ``chip_smoke.py`` phase 8 (prompts padded
to the 2048-token window).  Prints:

1. on the prefill batch: layer 0's RG-LRU scan, CUDA kernel vs the plain
   sequential scan (the same rounding, so 0) and the plain sequential
   scan vs a log-depth doubling scan (the reference's associative order);
   and layer 2 (the first attention layer, its input from the plain
   layers 0-1), the block output with the flash kernel vs the plain
   attention — all as relative differences (max abs difference over max
   abs value);
2. after a full-depth prefill, kernel path vs plain path: the relative
   difference of each RG-LRU group's state and of the logits;
3. per depth (the first n layers of the same weights): the first
   mismatches (request, token) of the token streams served through
   ``ClientHandler(kv="contiguous")`` — kernel path vs plain path, and
   plain path with the doubling scan vs the sequential one, the same
   arithmetic in another rounding order.

Needs a CUDA device and nvcc (the kernels build on first use).
"""
import argparse
import dataclasses
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def doubling_scan(a, b, h0):
    """``h_t = a_t h_{t-1} + b_t`` as a Hillis-Steele scan: log2(S) rounds
    of the reference's associative combine, h0 folded into the first
    step."""
    import torch
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    d = 1
    while d < a.shape[1]:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b, b[:, -1]


def first_layers(torch, cfg, params, toks):
    """Layer 0's scans and layer 2's attention block: kernel vs plain."""
    from repro_torch.kernels import ops
    from repro_torch.models import blocks, model, rglru
    from repro_torch.models.context import RunContext
    from repro_torch.models.layers import apply_norm, rope_tables
    stack = params["layers"]["stack"]
    lp = [model.tree_map(lambda t: t[0], stack[f"b{j}"]) for j in range(3)]
    x = model.embed_tokens(cfg, params, toks)
    rec = lp[0]["rec"]
    h = apply_norm(x, lp[0]["norm1"], cfg.norm_type)
    xc, _ = rglru._causal_conv(torch.matmul(h, rec["wx"]), rec["conv_w"],
                               rec["conv_b"], None)
    a, b = rglru._gates(xc, rec)
    hk, _ = ops.rglru_scan(a, b)
    hp, _ = rglru.linear_scan(a, b, None)
    hd, _ = doubling_scan(a, b, None)
    print(f"layer 0 RG-LRU scan (relative): kernel vs plain {rel(hk, hp):.3e}"
          f", doubling vs sequential {rel(hd, hp):.3e}", flush=True)
    plain = RunContext(toks.device, "torch")
    s = toks.shape[1]
    rope = rope_tables(torch.arange(s, device=toks.device).expand(
        toks.shape[0], s), cfg.head_dim, cfg.rope_theta)
    for j in range(2):
        x, _, _ = blocks.block_apply("rglru", lp[j], x, cfg, plain, rope,
                                     None, "train", 0, None)
    yk, _, _ = blocks.block_apply("attn", lp[2], x, cfg,
                                  RunContext(toks.device, "cuda"), rope,
                                  None, "train", 0, None)
    yp, _, _ = blocks.block_apply("attn", lp[2], x, cfg, plain, rope, None,
                                  "train", 0, None)
    print(f"layer 2 attention block output (relative): flash kernel vs "
          f"plain {rel(yk, yp):.3e}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--depths", type=int, nargs="+",
                    default=[3, 6, 12, 24, 26])
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
    from repro_torch.models import model, rglru
    from repro_torch.models.context import RunContext

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("recurrentgemma-2b"),
                              dtype="float32")
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    reqs = cs.rg_trace(cfg.vocab_size)
    toks = np.zeros((len(reqs), cs.RG_PROMPT_PAD), np.int32)
    for i, r in enumerate(reqs):
        toks[i, :len(r.prompt)] = r.prompt[:cs.RG_PROMPT_PAD]
    toks = torch.tensor(toks, device=dev)
    with torch.no_grad():
        first_layers(torch, cfg, params, toks)
        out = {impl: model.forward(cfg, params, {"tokens": toks},
                                   RunContext(dev, impl), "prefill",
                                   cs.RG_CAPACITY)
               for impl in ("cuda", "torch")}
    (lk, ck), (lp, cp) = out["cuda"], out["torch"]
    hk, hp = (c["stack"]["b0"]["h"] for c in (ck, cp))
    per = ", ".join(f"{3 * g}: {rel(hk[g], hp[g]):.3e}"
                    for g in range(hk.shape[0]))
    print(f"full-depth prefill, kernel vs plain (relative): RG-LRU state by "
          f"layer {{{per}}}; logits {rel(lk, lp):.3e}", flush=True)
    del out, lk, ck, lp, cp, hk, hp

    fixed = lambda c, f, a: (f(*a), 0.05)          # noqa: E731
    sequential = rglru.linear_scan

    def streams(dcfg, dparams, impl, scan=sequential):
        rglru.linear_scan = scan
        try:
            b = LMBackend(dcfg, capacity=cs.RG_CAPACITY, params=dparams,
                          device="cuda", impl=impl)
            return cs.serve(torch, b, cs.rg_trace(dcfg.vocab_size),
                            executor=fixed, kv="contiguous", decode_window=1,
                            prompt_pad=cs.RG_PROMPT_PAD)[0]
        finally:
            rglru.linear_scan = sequential

    for depth in args.depths:
        dcfg, dparams = cs.cut_depth(model, cfg, params, depth)
        plain = streams(dcfg, dparams, "torch")
        kernel = cs.first_mismatches(streams(dcfg, dparams, "cuda"), plain)
        other = cs.first_mismatches(
            streams(dcfg, dparams, "torch", doubling_scan), plain)
        print(f"depth {depth}: first mismatches kernel vs plain {kernel}; "
              f"plain doubling scan vs sequential {other}", flush=True)


if __name__ == "__main__":
    main()
