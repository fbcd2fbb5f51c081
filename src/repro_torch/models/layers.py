"""Shared neural layers: norms, RoPE, MLP, and the plain reference attention.

:func:`attention_xla` keeps the reference's name: it is the plain gathered
attention the model runs under ``impl="torch"`` and the end-to-end oracle
the hand-written kernels are held to.  Numerics follow the reference:
RMSNorm scales by ``1 + scale`` (scale is zero-initialised), RoPE is
rotate-half in float32, masks use ``-1e30`` and scores/softmax are float32.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


# --------------------------------------------------------------------------- #
# Norms
# --------------------------------------------------------------------------- #
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def apply_norm(x: torch.Tensor, params: dict, norm_type: str) -> torch.Tensor:
    if norm_type == "rmsnorm":
        return rms_norm(x, params["scale"])
    return layer_norm(x, params["scale"], params["bias"])


# --------------------------------------------------------------------------- #
# Rotary position embedding (llama-style rotate-half)
# --------------------------------------------------------------------------- #
def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: (..., S) int -> cos/sin tables (..., S, head_dim//2)."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), exps)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (B, S, D//2) broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    cos, sin = cos[..., None, :].float(), sin[..., None, :].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------- #
# MLP
# --------------------------------------------------------------------------- #
_ACTS = {
    "silu": F.silu,
    "gelu": lambda t: F.gelu(t, approximate="tanh"),
    "relu": F.relu,
}


def mlp(params: dict, x: torch.Tensor, act: str, gated: bool) -> torch.Tensor:
    """Dense (optionally gated) MLP.  Products run in the weights' dtype
    (a bf16 GEMM accumulates in float32 and rounds its output); the
    activation and gate run in float32."""
    fn = _ACTS[act]
    h = torch.matmul(x, params["wi"]).float()
    if gated:
        h = fn(torch.matmul(x, params["wg"]).float()) * h
    else:
        h = fn(h)
    return torch.matmul(h.to(x.dtype), params["wo"])


# --------------------------------------------------------------------------- #
# Attention masks + reference attention (GQA, causal / sliding window)
# --------------------------------------------------------------------------- #
def attn_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
              window: Optional[int]) -> torch.Tensor:
    """Boolean allow-mask (…, Sq, Sk) from absolute positions."""
    q = q_pos[..., :, None]
    k = k_pos[..., None, :]
    ok = torch.ones(torch.broadcast_shapes(q.shape, k.shape),
                    dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (k <= q)
    if window is not None:
        ok = ok & (k > q - window)
    return ok


def attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None, q_offset=0
                  ) -> torch.Tensor:
    """Grouped-query attention, scores materialized in float32.

    q: (B, Sq, Hq, D);  k, v: (B, Sk, Hkv, D);  returns (B, Sq, Hq, D).
    ``q_offset`` is the absolute position of q[0] (an int, or a (B,) tensor
    of per-row cursors); keys sit at positions 0..Sk-1.  Probabilities are rounded to the value dtype before the PV product,
    as the reference does.
    """
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    dev = q.device
    qg = q.reshape(b, sq, hkv, g, d).float()
    k_pos = torch.arange(sk, device=dev).expand(b, sk)
    if isinstance(q_offset, torch.Tensor) and q_offset.ndim == 1:
        q_pos = q_offset.long()[:, None] + torch.arange(sq, device=dev)
    else:
        q_pos = (int(q_offset) + torch.arange(sq, device=dev)).expand(b, sq)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * d ** -0.5
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    mask = attn_mask(q_pos, k_pos, causal=causal, window=window)
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(v.dtype).reshape(b, sq, hq, d)
