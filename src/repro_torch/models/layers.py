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
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30
# Query-chunk size above which attention takes its rows a chunk at a time
# (keeps 32k-prefill activation memory O(S * chunk)).
_Q_CHUNK = 1024


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


def _out_dtype_ok(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ``aten::mm.dtype`` / ``bmm.dtype`` can take two operands:
    bf16 on the card, and no gradient recorded (the overloads have no
    derivative; the upcast products they stand for are the same)."""
    return (a.is_cuda and a.dtype == b.dtype == torch.bfloat16
            and not (torch.is_grad_enabled()
                     and (a.requires_grad or b.requires_grad)))


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a 2-D ``w``, accumulated and returned in float32 and
    not rounded to the operands' dtype: the reference's ``einsum(...,
    preferred_element_type=jnp.float32)``.  Two bf16 operands on the card
    take one ``aten::mm.dtype`` (reads bf16, writes float32, copies no
    weight) unless autograd records the product; elsewhere (the CPU has
    no kernel for it, an operand is float32, or training) both are
    upcast, which leaves a float32 product as it was."""
    if _out_dtype_ok(x, w):
        out = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.float(), w.float())


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched :func:`matmul_f32`: (E, C, D) x (E, D, F) -> (E, C, F) in
    float32, not rounded to the operands' dtype (the reference's expert
    ``einsum(..., preferred_element_type=jnp.float32)``).  Two bf16
    operands on the card take one ``aten::bmm.dtype`` (no float32 copy of
    an expert weight) unless autograd records the product; elsewhere
    both are upcast."""
    if _out_dtype_ok(a, b):
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def mlp(params: dict, x: torch.Tensor, act: str, gated: bool) -> torch.Tensor:
    """Dense (optionally gated) MLP.  The up and gate products stay float32
    into the activation (:func:`matmul_f32`); the hidden state is rounded
    to the activation dtype once, before the down product."""
    fn = _ACTS[act]
    h = matmul_f32(x, params["wi"])
    if gated:
        h = fn(matmul_f32(x, params["wg"])) * h
    else:
        h = fn(h)
    return torch.matmul(h.to(x.dtype), params["wo"])


# --------------------------------------------------------------------------- #
# Attention masks + reference attention (GQA, causal / sliding window)
# --------------------------------------------------------------------------- #
def attn_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
              window: Optional[int], prefix_len: int = 0) -> torch.Tensor:
    """Boolean allow-mask (…, Sq, Sk) from absolute positions.  A causal
    mask with ``prefix_len`` lets the first ``prefix_len`` positions (an
    image prefix) see each other both ways; later positions stay causal."""
    q = q_pos[..., :, None]
    k = k_pos[..., None, :]
    if causal:
        ok = k <= q
        if prefix_len:
            ok = ok | ((q < prefix_len) & (k < prefix_len))
    else:
        ok = torch.ones(torch.broadcast_shapes(q.shape, k.shape),
                        dtype=torch.bool, device=q.device)
    if window is not None:
        ok = ok & (k > q - window)
    # unwritten ring-buffer slots carry negative positions -> invalid
    return ok & (k >= 0)


def _attn_core(q, k, v, q_pos, k_pos, *, causal, window, prefix_len,
               softcap):
    """q: (B, Sq, Hkv, G, D); k, v: (B, Sk, Hkv, D); q_pos (B, Sq), k_pos
    (B, Sk) -> (B, Sq, Hkv, G, D) in v's dtype."""
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q.float(),
                          k.float()) * q.shape[-1] ** -0.5
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    mask = attn_mask(q_pos, k_pos, causal=causal, window=window,
                     prefix_len=prefix_len)
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(v.dtype)


def _chunked(core, qg, q_pos, chunk: int, n: int):
    """``core`` over ``n`` query chunks of ``chunk`` rows of ``qg`` and
    ``q_pos``, each chunk recomputed in the backward pass rather than kept
    (the reference's ``jax.checkpoint`` around each chunk of its
    ``lax.map``)."""
    outs = []
    for i in range(n):
        qi = qg.narrow(1, i * chunk, chunk)
        pi = q_pos.narrow(1, i * chunk, chunk)
        if torch.is_grad_enabled() and qg.requires_grad:
            outs.append(checkpoint(core, qi, pi, use_reentrant=False))
        else:
            outs.append(core(qi, pi))
    return torch.cat(outs, dim=1)


def attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  prefix_len: int = 0, softcap: Optional[float] = None,
                  q_offset=0, k_pos: Optional[torch.Tensor] = None,
                  q_chunk: int = _Q_CHUNK) -> torch.Tensor:
    """Grouped-query attention, scores materialized in float32, memory
    bounded by query chunking.

    q: (B, Sq, Hq, D);  k, v: (B, Sk, Hkv, D);  returns (B, Sq, Hq, D).
    ``q_offset`` is the absolute position of q[0] (an int, or a (B,) tensor
    of per-row cursors); keys sit at positions 0..Sk-1 unless ``k_pos``
    ((Sk,) or (B, Sk)) names each key's position (ring buffers);
    ``prefix_len`` as in :func:`attn_mask`.
    Probabilities are rounded to the value dtype before the PV product, as
    the reference does.

    Past ``q_chunk`` query rows (when it divides Sq) the rows are taken a
    chunk at a time, each chunk recomputed in the backward pass: memory
    O(Sq x chunk), the same arithmetic per row.  On a mesh the rows are
    already each rank's own (``blocks._block_sharded`` runs this under
    ``local_map``), so the reference's sequence-parallel row blocks
    (``seq_shards``, ``constrain_cb``, ``_attn_core_m``) have no
    counterpart here.
    """
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    dev = q.device
    qg = q.reshape(b, sq, hkv, g, d)
    if k_pos is None:
        k_pos = torch.arange(sk, device=dev)
    k_pos = k_pos.expand(b, sk)
    if isinstance(q_offset, torch.Tensor) and q_offset.ndim == 1:
        q_pos = q_offset.long()[:, None] + torch.arange(sq, device=dev)
    else:
        q_pos = (int(q_offset) + torch.arange(sq, device=dev)).expand(b, sq)
    kw = dict(causal=causal, window=window, prefix_len=prefix_len,
              softcap=softcap)

    def core(qi, pi):
        return _attn_core(qi, k, v, pi, k_pos, **kw)

    if sq > q_chunk and sq % q_chunk == 0:
        out = _chunked(core, qg, q_pos, q_chunk, sq // q_chunk)
    else:
        out = core(qg, q_pos)
    return out.reshape(b, sq, hq, d)
