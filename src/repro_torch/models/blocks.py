"""Residual blocks: attention (+ paged, contiguous or ring KV), RG-LRU or
RWKV-6, each with norm + feed-forward.

This covers the dense attention family (full or sliding-window, causal,
bidirectional or prefix-LM) with a dense or mixture-of-experts
feed-forward (``models/moe.py``), RWKV-6 and the RG-LRU hybrid.  Mode
``"train"`` runs the prefill math and writes no cache.

KV caches are updated **in place**: every write is a function of the
step's inputs only (positions, block tables, the tokens' K/V), and
attention always writes before it reads, so re-running a step on the same
inputs leaves the same cache — the serving executors rely on that.
Recurrent state is replaced, never written in place, for the same reason.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import moe, rglru, rwkv6
from repro_torch.models.context import RunContext
from repro_torch.models.layers import apply_norm, apply_rope, attention_xla, mlp
from repro_torch.models.spec import ParamSpec


# --------------------------------------------------------------------------- #
# Specs
# --------------------------------------------------------------------------- #
def norm_specs(cfg: ModelConfig):
    d = cfg.d_model
    if cfg.norm_type == "rmsnorm":
        return {"scale": ParamSpec((d,), ("embed",), init="zeros")}
    return {"scale": ParamSpec((d,), ("embed",), init="ones"),
            "bias": ParamSpec((d,), ("embed",), init="zeros")}


def mlp_specs(cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    sp = {"wi": ParamSpec((d, f), ("embed", "mlp")),
          "wo": ParamSpec((f, d), ("mlp", "embed"), fan_in=f)}
    if cfg.mlp_gated:
        sp["wg"] = ParamSpec((d, f), ("embed", "mlp"))
    return sp


def attn_specs(cfg: ModelConfig):
    d, hq, hkv, n = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sp = {
        "wq": ParamSpec((d, hq, n), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, hkv, n), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, hkv, n), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((hq, n, d), ("heads", "head_dim", "embed"),
                        fan_in=hq * n),
    }
    if cfg.qkv_bias:
        sp["bq"] = ParamSpec((hq, n), ("heads", "head_dim"), init="zeros")
        sp["bk"] = ParamSpec((hkv, n), ("kv_heads", "head_dim"), init="zeros")
        sp["bv"] = ParamSpec((hkv, n), ("kv_heads", "head_dim"), init="zeros")
    return sp


def block_specs(cfg: ModelConfig, kind: str):
    sp = {"norm1": norm_specs(cfg), "norm2": norm_specs(cfg)}
    if kind == "attn":
        sp["attn"] = attn_specs(cfg)
        sp["ffn"] = moe.moe_specs(cfg) if cfg.is_moe else mlp_specs(cfg)
    elif kind == "rglru":
        sp["rec"] = rglru.rglru_specs(cfg)
        sp["ffn"] = mlp_specs(cfg)
    elif kind == "rwkv":
        sp["tm"] = rwkv6.rwkv_time_specs(cfg)
        sp["cm"] = rwkv6.rwkv_channel_specs(cfg)
    else:
        raise ValueError(kind)
    return sp


# --------------------------------------------------------------------------- #
# Attention apply
# --------------------------------------------------------------------------- #
def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, d) x (d, H, n) -> (B, S, H, n)."""
    b, s, d = x.shape
    return torch.matmul(x, w.reshape(d, -1)).reshape(b, s, *w.shape[1:])


def _ring_positions(pos: int, window: int,
                    device=None) -> torch.Tensor:
    """Absolute position stored in each ring-buffer slot, given cursor pos."""
    idx = torch.arange(window, device=device)
    return pos - torch.remainder(pos - idx, window)


def _gather(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """(N, bs, Hkv, D) pool through (B, M) tables -> (B, M*bs, Hkv, D)."""
    return pool[tables.long()].reshape(tables.shape[0], -1, *pool.shape[2:])


def attn_apply(params: dict, x: torch.Tensor, cfg: ModelConfig,
               ctx: RunContext, rope, cache: Optional[dict], mode: str,
               prefix_len: int, pos, cache_capacity: int = 0,
               block_tables: Optional[torch.Tensor] = None,
               block_size: int = 0) -> Tuple[torch.Tensor, Optional[dict]]:
    cos, sin = rope
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    softcap = cfg.logit_softcap
    use_kernels = ctx.impl == "cuda"

    new_cache = None
    if mode == "decode" and block_tables is None:
        # Contiguous cohort decode: leaves are (B, capacity, Hkv, D), every
        # row at the one cursor ``pos`` (an int).  A cache exactly one
        # window long is a ring: the token lands in slot pos % window and
        # each slot's key carries the position it holds.  Otherwise the
        # write pins at capacity - 1 and keys sit at their slot index.
        ck, cv = cache["k"], cache["v"]
        cap = ck.shape[1]
        pos = int(pos)
        k_pos = None
        if cfg.window is not None and cap == cfg.window:
            slot = pos % cap
            k_pos = _ring_positions(pos, cap, x.device)
        else:
            slot = min(pos, cap - 1)
        ck[:, slot] = k[:, 0]
        cv[:, slot] = v[:, 0]
        out = attention_xla(q, ck, cv, causal=True, window=cfg.window,
                            softcap=softcap, q_offset=pos, k_pos=k_pos)
        new_cache = cache
    elif mode == "decode":
        # Paged decode: the cache leaves are (N, bs, Hkv, D) block pools
        # shared by every slot; row i writes its token at its own cursor
        # pos[i] through its table row.  Inactive slots carry an all-zero
        # table row, so their writes land in block 0 (the trash block);
        # several rows may write there — harmless, never read unmasked.
        ck, cv = cache["k"], cache["v"]
        bsz = x.shape[0]
        rows = torch.arange(bsz, device=x.device)
        # the reference's gather clamps an out-of-range column; torch would
        # raise (CPU) or device-assert (CUDA), so clamp explicitly
        col = torch.clamp(pos // block_size, max=block_tables.shape[1] - 1)
        blk = block_tables[rows, col.long()].long()
        off = (pos % block_size).long()
        ck[blk, off] = k[:, 0]
        cv[blk, off] = v[:, 0]
        if use_kernels:
            out = ops.paged_attention(q, ck, cv, block_tables,
                                      (pos + 1).to(torch.int32),
                                      softcap=softcap, fused=ctx.paged_fused)
        else:
            out = attention_xla(q, _gather(ck, block_tables),
                                _gather(cv, block_tables), causal=True,
                                softcap=softcap, q_offset=pos)
        new_cache = cache
    elif mode == "chunk":
        # Chunked paged prefill: row i carries a C-token chunk of its
        # uncached suffix; pos = (pos0, n_live).  Writes mirror the
        # stepwise scan: dead tokens write the trash block, and tokens
        # clamped at capacity - 1 collapse to ONE writer holding the last
        # live token's K/V (last-live-wins), so no live cell ever sees two
        # writes whose order the device would not define.
        pos0, n_live = pos
        ck, cv = cache["k"], cache["v"]
        csz = x.shape[1]
        cap = cache_capacity
        cidx = torch.arange(csz, device=x.device)
        cpos = pos0[:, None] + cidx[None, :]                  # (B, C)
        live = cidx[None, :] < n_live[:, None]
        wpos = torch.clamp(cpos, max=cap - 1)
        writer = live & ((cpos < cap - 1)
                         | (cidx[None, :] == n_live[:, None] - 1))
        blk_col = torch.clamp(wpos // block_size,
                              max=block_tables.shape[1] - 1)
        blk = torch.where(writer,
                          torch.take_along_dim(block_tables, blk_col.long(),
                                               dim=1), 0).long()
        off = torch.where(writer, wpos % block_size, 0).long()
        ck[blk, off] = k
        cv[blk, off] = v
        if use_kernels:
            out = ops.paged_prefill(q, ck, cv, block_tables, pos0, n_live,
                                    softcap=softcap)
        else:
            out = attention_xla(q, _gather(ck, block_tables),
                                _gather(cv, block_tables), causal=True,
                                softcap=softcap, q_offset=pos0)
        new_cache = cache
    else:
        # prefill and train: the whole sequence at once; the kernel takes
        # causal attention without an image prefix, as in the reference
        if use_kernels and cfg.causal and prefix_len == 0:
            out = ops.flash_attention(q, k, v, causal=True,
                                      window=cfg.window, softcap=softcap)
        else:
            out = attention_xla(q, k, v, causal=cfg.causal, window=cfg.window,
                                prefix_len=prefix_len, softcap=softcap)
        if mode == "prefill":
            new_cache = _prefill_cache(k, v, cfg, cache_capacity)
    b, s = out.shape[:2]
    wo = params["wo"]
    out = torch.matmul(out.reshape(b, s, -1).to(x.dtype),
                       wo.reshape(-1, wo.shape[-1]))
    return out, new_cache


def _prefill_cache(k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig,
                   cache_capacity: int) -> dict:
    """The contiguous cache a prefill leaves: K/V zero-padded to the
    capacity, or, when the prompt fills a sliding window, the ring of its
    last ``window`` keys.

    Decode takes ring slot ``i`` to hold a position congruent to ``i``
    modulo the window, which the last ``window`` keys are only when the
    prompt length is a multiple of it.  The reference keeps them all the
    same and its next decode step overwrites a key still in the window;
    the port raises instead."""
    w, s = cfg.window, k.shape[1]
    if w is not None and s >= w:
        if s % w:
            raise ValueError(
                f"{cfg.name}: a {s}-token prefill fills the {w}-token window "
                "ring out of phase (ring slot i must hold a position = i mod "
                "window); pad prompts to the window or a multiple of it")
        return {"k": k[:, -w:], "v": v[:, -w:]}
    pad = (cache_capacity or s) - s
    return {"k": F.pad(k, (0, 0, 0, 0, 0, pad)),
            "v": F.pad(v, (0, 0, 0, 0, 0, pad))}


# --------------------------------------------------------------------------- #
# Residual block
# --------------------------------------------------------------------------- #
def block_apply(kind: str, params: dict, x: torch.Tensor, cfg: ModelConfig,
                ctx: RunContext, rope, cache: Optional[dict], mode: str,
                prefix_len: int, pos, cache_capacity: int = 0,
                block_tables=None, block_size: int = 0):
    """Returns (x, new_cache, aux_loss): the aux loss is the MoE router's
    load-balance term (a float32 zero for every other block)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = apply_norm(x, params["norm1"], cfg.norm_type)
    if kind == "attn":
        mix, new_cache = attn_apply(params["attn"], h, cfg, ctx, rope, cache,
                                    mode, prefix_len, pos, cache_capacity,
                                    block_tables, block_size)
    elif kind == "rglru":
        mix, new_cache = rglru.rglru_block_apply(params["rec"], h, cfg, ctx,
                                                 cache, mode)
    elif kind == "rwkv":
        mix, tm_cache = rwkv6.rwkv_time_apply(
            params["tm"], h, cfg, ctx,
            cache["tm"] if cache is not None else None, mode)
    else:
        raise ValueError(kind)
    x = x + mix
    h2 = apply_norm(x, params["norm2"], cfg.norm_type)
    if kind == "rwkv":
        ffn, cm_cache = rwkv6.rwkv_channel_apply(
            params["cm"], h2, cfg,
            cache["cm"] if cache is not None else None, mode)
        new_cache = ({"tm": tm_cache, "cm": cm_cache}
                     if tm_cache is not None else None)
    elif kind == "attn" and cfg.is_moe:
        ffn, aux = moe.moe_apply(params["ffn"], h2, cfg, ctx)
    else:
        ffn = mlp(params["ffn"], h2, cfg.mlp_act, cfg.mlp_gated)
    return x + ffn, new_cache, aux


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, capacity: int,
                     dtype: torch.dtype, device=None) -> dict:
    """Zero contiguous cache for one block: (batch, capacity, Hkv, D) K/V
    for attention (capacity capped at a sliding window: a ring), the state
    rows for RG-LRU and RWKV."""
    if kind == "attn":
        cap = min(capacity, cfg.window) if cfg.window else capacity
        shape = (batch, cap, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    if kind == "rglru":
        return rglru.init_rglru_cache(cfg, batch, dtype, device)
    if kind == "rwkv":
        return rwkv6.init_rwkv_cache(cfg, batch, dtype, device)
    raise ValueError(kind)
