"""The cell's weights, made by the benchmark on the device from ``--seed``.

One ``torch.Generator`` on the device draws every leaf in a fixed order,
each in one call in the type it is served in: matrices normal with
standard deviation 1/sqrt(fan-in), norm scales and biases normal with
standard deviation 0.1 (so the norms' ``1 + scale`` and the biases are
exercised), the router in float32.  The tree is laid out as the port
takes its parameters (``params`` of ``LMBackend``): layers stacked on a
leading axis.  The same tensors go to the port and to the reference.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from bench.counts import Shape


def layout(shape: Shape, tied: bool, qkv_bias: bool) -> Dict:
    """{path: (shape, dtype, std, fan_in)} of every leaf."""
    L, d, f = shape.layers, shape.d_model, shape.d_ff
    hq, hkv, n, v = shape.q_heads, shape.kv_heads, shape.head_dim, shape.vocab
    bf, f32 = torch.bfloat16, torch.float32
    st = "layers/stack/b0/"
    out = {"embed": ((v, d), bf, d),
           "final_norm/scale": ((d,), bf, None),
           st + "norm1/scale": ((L, d), bf, None),
           st + "norm2/scale": ((L, d), bf, None),
           st + "attn/wq": ((L, d, hq, n), bf, d),
           st + "attn/wk": ((L, d, hkv, n), bf, d),
           st + "attn/wv": ((L, d, hkv, n), bf, d),
           st + "attn/wo": ((L, hq, n, d), bf, hq * n)}
    if qkv_bias:
        out[st + "attn/bq"] = ((L, hq, n), bf, None)
        out[st + "attn/bk"] = ((L, hkv, n), bf, None)
        out[st + "attn/bv"] = ((L, hkv, n), bf, None)
    if shape.experts:
        e = shape.experts
        out[st + "ffn/router"] = ((L, d, e), f32, d)
        out[st + "ffn/wi"] = ((L, e, d, f), bf, d)
        out[st + "ffn/wg"] = ((L, e, d, f), bf, d)
        out[st + "ffn/wo"] = ((L, e, f, d), bf, f)
    else:
        out[st + "ffn/wi"] = ((L, d, f), bf, d)
        out[st + "ffn/wg"] = ((L, d, f), bf, d)
        out[st + "ffn/wo"] = ((L, f, d), bf, f)
    if not tied:
        out["head"] = ((d, v), bf, d)
    return out


def make(shape: Shape, tied: bool, qkv_bias: bool, seed: int,
         device) -> Dict:
    """The parameter tree for ``seed``, drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    tree: Dict = {}
    for path, (shp, dtype, fan) in sorted(layout(shape, tied,
                                                 qkv_bias).items()):
        t = torch.randn(shp, generator=gen, dtype=dtype, device=device)
        t.mul_(0.1 if fan is None else 1.0 / math.sqrt(fan))
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    tree["layers"].setdefault("rest", {})
    return tree


def leaves(tree: Dict, prefix: str = ""):
    """(path, tensor) of every leaf, in sorted order."""
    for k in sorted(tree):
        v = tree[k]
        p = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from leaves(v, p + "/")
        else:
            yield p, v


def check_layout(tree: Dict, abstract: Dict) -> None:
    """Raise unless ``tree`` has the leaves, shapes and dtypes of the
    port's own parameter tree (``abstract``: meta tensors)."""
    have = {p: (tuple(t.shape), t.dtype) for p, t in leaves(tree)}
    want = {p: (tuple(t.shape), t.dtype) for p, t in leaves(abstract)}
    if have != want:
        diff = sorted(set(have.items()) ^ set(want.items()))
        raise ValueError(f"weights do not match the port's layout: {diff}")
