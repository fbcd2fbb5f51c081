"""Plain PyTorch versions of the hand-written kernels, plus ``copy_blocks``.

Deliberately naive, straight-line implementations (scores materialized,
KV gathered through the block table) with the reference oracles' exact
contracts and layouts, so a kernel bug cannot hide behind code shared with
the model path.  The CUDA kernels are held to these on the card; on CPU
tensors the ``ops`` wrappers run them in the kernels' place.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _softcap(scores: torch.Tensor, softcap: Optional[float]) -> torch.Tensor:
    if softcap is None:
        return scores
    return softcap * torch.tanh(scores / softcap)


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None):
    """q: (B,Hq,S,D); k,v: (B,Hkv,T,D) -> (B,Hq,S,D). Materializes scores."""
    b, hq, s, d = q.shape
    t = k.shape[2]
    g = hq // k.shape[1]
    kk = k.repeat_interleave(g, dim=1).float()
    vv = v.repeat_interleave(g, dim=1).float()
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * d ** -0.5
    scores = _softcap(scores, softcap)
    qp = torch.arange(s, device=q.device)[:, None]
    kp = torch.arange(t, device=q.device)[None, :]
    ok = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= kp > qp - window
    scores = scores.masked_fill(~ok, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vv).to(q.dtype)


def _gather(pool, block_tables):
    """(N, bs, Hkv, D) pool through (B, M) tables -> (B, Hkv, M*bs, D)."""
    b = block_tables.shape[0]
    x = pool[block_tables.long()].reshape(b, -1, pool.shape[2], pool.shape[3])
    return x.transpose(1, 2).float()


def paged_attention_ref(q, k_pool, v_pool, block_tables, context_lens, *,
                        softcap: Optional[float] = None):
    """Decode-time paged attention (block-table gather, materialized).

    q: (B, Hq, D) one query per slot; k_pool, v_pool: (N, bs, Hkv, D);
    block_tables: (B, M) int32; context_lens: (B,) int32.  Returns
    (B, Hq, D).  Positions >= context_lens[i] are masked, and probabilities
    are re-masked after the softmax so a zero-context row is exact zeros.
    """
    b, hq, d = q.shape
    g = hq // k_pool.shape[2]
    kk = _gather(k_pool, block_tables).repeat_interleave(g, dim=1)
    vv = _gather(v_pool, block_tables).repeat_interleave(g, dim=1)
    scores = torch.einsum("bhd,bhkd->bhk", q.float(), kk) * d ** -0.5
    scores = _softcap(scores, softcap)
    ok = (torch.arange(kk.shape[2], device=q.device)[None, :]
          < context_lens[:, None])                             # (B, M*bs)
    scores = scores.masked_fill(~ok[:, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1) * ok[:, None, :]
    return torch.einsum("bhk,bhkd->bhd", probs, vv).to(q.dtype)


def paged_prefill_ref(q, k_pool, v_pool, block_tables, pos0, n_live, *,
                      softcap: Optional[float] = None):
    """Chunked-prefill paged attention (block-table gather).

    q: (B, Hq, C, D) one C-token chunk per slot (its KV already in the
    pool); pos0, n_live: (B,) int32.  Chunk position t attends to keys at
    positions <= pos0 + t; rows t >= n_live are exact zeros.  Returns
    (B, Hq, C, D).
    """
    b, hq, c, d = q.shape
    g = hq // k_pool.shape[2]
    kk = _gather(k_pool, block_tables).repeat_interleave(g, dim=1)
    vv = _gather(v_pool, block_tables).repeat_interleave(g, dim=1)
    scores = torch.einsum("bhcd,bhkd->bhck", q.float(), kk) * d ** -0.5
    scores = _softcap(scores, softcap)
    cidx = torch.arange(c, device=q.device)
    q_pos = pos0[:, None] + cidx[None, :]                        # (B, C)
    k_pos = torch.arange(kk.shape[2], device=q.device)
    ok = ((cidx[None, :] < n_live[:, None])[:, :, None]
          & (k_pos[None, None, :] <= q_pos[:, :, None]))         # (B, C, K)
    scores = scores.masked_fill(~ok[:, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1) * ok[:, None]
    return torch.einsum("bhck,bhkd->bhcd", probs, vv).to(q.dtype)


def rwkv6_scan_ref(r, k, v, w, u, s0):
    """Sequential WKV. r,k,v,w: (B,H,S,N); u: (H,N); s0: (B,H,N,N) fp32.

    Per step: ``y_t = r_t^T (S + diag(u) k_t v_t^T)``, then
    ``S <- diag(w_t) S + k_t v_t^T``, all in float32.  Returns (y
    (B,H,S,N) in r.dtype, s_final (B,H,N,N) fp32)."""
    s = s0.float()
    uf = u.float()
    ys = []
    for t in range(r.shape[2]):
        r_t, k_t, v_t, w_t = (x[:, :, t].float() for x in (r, k, v, w))
        bonus = torch.einsum("bhk,hk,bhk->bh", r_t, uf, k_t)
        ys.append(torch.einsum("bhk,bhkn->bhn", r_t, s)
                  + bonus[..., None] * v_t)
        s = w_t[..., None] * s + k_t[..., None] * v_t[..., None, :]
    if not ys:
        return torch.empty_like(r), s.clone()
    return torch.stack(ys, dim=2).to(r.dtype), s


def rglru_scan_ref(a, b, h0):
    """Sequential linear recurrence ``h_t = a_t * h_{t-1} + b_t``.

    a, b: (B, S, R); h0: (B, R).  Every step is one float32 multiply and
    one float32 add, each rounded.  Returns (h (B, S, R) in a.dtype,
    h_last (B, R) float32)."""
    h = h0.float()
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t].float() * h + b[:, t].float()
        hs.append(h)
    if not hs:
        return torch.empty_like(a), h.clone()
    return torch.stack(hs, dim=1).to(a.dtype), h


def copy_blocks(leaf, src, dst, *, axis: int = 0):
    """``leaf[dst] = leaf[src]`` along ``axis``, in place; returns ``leaf``.

    The copy-on-write primitive of the prefix cache: every dst is a freshly
    allocated block, so no pair's dst is another pair's src, and (0, 0)
    bucket pads copy the trash block onto itself."""
    moved = leaf.movedim(axis, 0)
    moved[dst.long()] = moved[src.long()]
    return leaf
