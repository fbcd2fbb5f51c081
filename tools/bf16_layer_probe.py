#!/usr/bin/env python3
"""Where the whole-model bfloat16 gap between the port and the eager
reference starts (CPU).

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/bf16_layer_probe.py

Reduced smollm-360m at 3 layers in bfloat16, weights from the reference's
``model.init(cfg, PRNGKey(0))`` carried by ``weights.from_jax``, 16
prompts of 16 tokens from ``default_rng(1)``; the reference runs under
``jax.disable_jit()`` (every op rounded by itself, as the port rounds).
Prints, per layer, the largest difference of the block outputs (every
position, not only the last one ``forward`` unembeds) and, inside the
first layer, of each step of the attention: RoPE tables, the q
projection, RoPE'd q, the float32 scores, ``exp``, the softmax row sums,
the probabilities and the core's bf16 output, each on identical inputs.
Each line gives the max |difference| and how many elements differ.
"""
import dataclasses
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config, reduced_config  # noqa: E402
from repro.models import blocks as jb  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models.context import RunContext as JContext  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced_config as t_reduced_config  # noqa
from repro_torch.models import blocks as tb  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import weights  # noqa: E402
from repro_torch.models.context import RunContext  # noqa: E402

ARCH, LAYERS, ROWS, TOKENS = "smollm-360m", 3, 16, 16


def diff(name, want, got):
    w = np.asarray(jnp.asarray(want, jnp.float32))
    g = got.float().numpy()
    d = np.abs(w - g)
    print(f"  {name:24s} max |diff| {float(d.max()):.3g}, "
          f"{int((d > 0).sum())}/{d.size} differ", flush=True)


def to_torch(x):
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32))
                            ).to(torch.bfloat16)


def main():
    cfg = dataclasses.replace(reduced_config(get_config(ARCH)),
                              n_layers=LAYERS, dtype="bfloat16")
    tcfg = dataclasses.replace(t_reduced_config(t_get_config(ARCH)),
                               n_layers=LAYERS, dtype="bfloat16")
    jp = jm.init(cfg, jax.random.PRNGKey(0))
    tp = weights.from_jax(
        jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jp), tcfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             (ROWS, TOKENS), dtype=np.int32)
    ctx = RunContext(torch.device("cpu"), "torch")
    with jax.disable_jit():
        jx, jpos, _ = jm.embed_inputs(cfg, jp, {"tokens": jnp.asarray(toks)})
        tx, tpos, _ = tm.embed_inputs(tcfg, tp,
                                      {"tokens": torch.from_numpy(toks)})
        jrope = jl.rope_tables(jpos, cfg.head_dim, cfg.rope_theta)
        trope = tl.rope_tables(tpos, tcfg.head_dim, tcfg.rope_theta)
        print("block outputs, every position:")
        first = None
        for i, (_, tlp, _) in enumerate(tm.layers(tcfg, tp, None)):
            lp = jax.tree.map(lambda a: a[i], jp["layers"]["stack"]["b0"])
            if first is None:
                first = (lp, tlp, jx, tx)
            jx, _, _ = jb.block_apply("attn", lp, jx, cfg, JContext(), jrope,
                                      None, "prefill", 0, None, TOKENS)
            tx, _, _ = tb.block_apply("attn", tlp, tx, tcfg, ctx, trope,
                                      None, "prefill", 0, None, TOKENS)
            diff(f"layer {i}", jx, tx)
        lp, tlp, jx, tx = first
        print("layer 0 attention, step by step on identical inputs:")
        diff("rope cos", jrope[0], trope[0])
        diff("rope sin", jrope[1], trope[1])
        h = jl.apply_norm(jx, lp["norm1"], cfg.norm_type)
        q = jnp.einsum("bsd,dhn->bshn", h, lp["attn"]["wq"],
                       preferred_element_type=jnp.float32).astype(h.dtype)
        tq = tb._proj(to_torch(h), tlp["attn"]["wq"])
        diff("q projection", q, tq)
        q = jl.apply_rope(q, *jrope)
        diff("RoPE'd q (own tables)", q, tl.apply_rope(tq, *trope))
        k = jl.apply_rope(jnp.einsum(
            "bsd,dhn->bshn", h, lp["attn"]["wk"],
            preferred_element_type=jnp.float32).astype(h.dtype), *jrope)
        v = jnp.einsum("bsd,dhn->bshn", h, lp["attn"]["wv"],
                       preferred_element_type=jnp.float32).astype(h.dtype)
        b, s, hq, d = q.shape
        hkv = k.shape[2]
        qg = q.reshape(b, s, hkv, hq // hkv, d)
        sc = jnp.einsum("bqhgd,bkhd->bhgqk", qg, k,
                        preferred_element_type=jnp.float32) * d ** -0.5
        tsc = torch.einsum("bqhgd,bkhd->bhgqk", to_torch(qg).float(),
                           to_torch(k).float()) * d ** -0.5
        diff("scores (float32)", sc, tsc)
        mask = np.tril(np.ones((s, s), bool))
        sc = jnp.where(mask, sc, -1e30)
        e = jnp.exp(sc - sc.max(-1, keepdims=True))
        tsc = torch.from_numpy(np.array(sc))
        te = torch.exp(tsc - tsc.amax(-1, keepdim=True))
        diff("exp (same scores)", e, te)
        diff("row sums (same exp)", e.sum(-1),
             torch.from_numpy(np.array(e)).sum(-1))
        diff("softmax (same scores)", jax.nn.softmax(sc, axis=-1),
             torch.softmax(tsc, dim=-1))
        diff("attention core (bf16)", jl.attention_xla(q, k, v, causal=True),
             tl.attention_xla(to_torch(q), to_torch(k), to_torch(v),
                              causal=True))


if __name__ == "__main__":
    main()
