"""Residual attention blocks: norm + GQA attention (+ paged KV) + norm + MLP.

This slice covers the dense, full-attention family.  Recurrent kinds
(RG-LRU, RWKV), MoE feed-forwards and sliding windows raise
``NotImplementedError`` naming their ROADMAP item.

The paged KV pool is updated **in place**: every write is a function of the
step's inputs only (positions, block tables, the tokens' K/V), and
attention always writes before it reads, so re-running a step on the same
inputs leaves the same pool — the serving executors rely on that.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.context import RunContext
from repro_torch.models.layers import apply_norm, apply_rope, attention_xla, mlp
from repro_torch.models.spec import ParamSpec


def check_supported(cfg: ModelConfig) -> None:
    """Raise for configurations later slices of the port cover."""
    if any(k != "attn" for k in cfg.layer_kinds()):
        raise NotImplementedError(
            f"{cfg.name}: recurrent blocks are ported later "
            "(ROADMAP Queue 1 item 9, recurrent and windowed families)")
    if cfg.window is not None:
        raise NotImplementedError(
            f"{cfg.name}: sliding-window attention is ported later "
            "(ROADMAP Queue 1 item 9, recurrent and windowed families)")
    if cfg.is_moe:
        raise NotImplementedError(f"{cfg.name}: MoE is ported later "
                                  "(ROADMAP Queue 1 item 10, MoE)")
    if cfg.frontend is not None:
        raise NotImplementedError(f"{cfg.name}: modality frontends are "
                                  "ported later (ROADMAP Queue 1 item 11)")


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
    check_supported(cfg)
    return {"norm1": norm_specs(cfg), "norm2": norm_specs(cfg),
            "attn": attn_specs(cfg), "ffn": mlp_specs(cfg)}


# --------------------------------------------------------------------------- #
# Attention apply
# --------------------------------------------------------------------------- #
def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, d) x (d, H, n) -> (B, S, H, n)."""
    b, s, d = x.shape
    return torch.matmul(x, w.reshape(d, -1)).reshape(b, s, *w.shape[1:])


def _gather(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """(N, bs, Hkv, D) pool through (B, M) tables -> (B, M*bs, Hkv, D)."""
    return pool[tables.long()].reshape(tables.shape[0], -1, *pool.shape[2:])


def attn_apply(params: dict, x: torch.Tensor, cfg: ModelConfig,
               ctx: RunContext, rope, cache: Optional[dict], mode: str,
               pos, cache_capacity: int = 0,
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
    if mode == "decode":
        # Paged decode: the cache leaves are (N, bs, Hkv, D) block pools
        # shared by every slot; row i writes its token at its own cursor
        # pos[i] through its table row.  Inactive slots carry an all-zero
        # table row, so their writes land in block 0 (the trash block);
        # several rows may write there — harmless, never read unmasked.
        if block_tables is None:
            raise NotImplementedError("contiguous KV decode is ported later "
                                      "(ROADMAP Queue 1, contiguous mode)")
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
        if use_kernels:
            out = ops.flash_attention(q, k, v, causal=cfg.causal,
                                      window=cfg.window, softcap=softcap)
        else:
            out = attention_xla(q, k, v, causal=cfg.causal, window=cfg.window,
                                softcap=softcap)
        if mode == "prefill":
            pad = (cache_capacity or x.shape[1]) - x.shape[1]
            new_cache = {"k": F.pad(k, (0, 0, 0, 0, 0, pad)),
                         "v": F.pad(v, (0, 0, 0, 0, 0, pad))}
    b, s = out.shape[:2]
    wo = params["wo"]
    out = torch.matmul(out.reshape(b, s, -1).to(x.dtype),
                       wo.reshape(-1, wo.shape[-1]))
    return out, new_cache


# --------------------------------------------------------------------------- #
# Residual block
# --------------------------------------------------------------------------- #
def block_apply(kind: str, params: dict, x: torch.Tensor, cfg: ModelConfig,
                ctx: RunContext, rope, cache: Optional[dict], mode: str,
                pos, cache_capacity: int = 0,
                block_tables=None, block_size: int = 0):
    """Returns (x, new_cache).  Entry points reject non-attention kinds
    (``check_supported``) before any block runs."""
    h = apply_norm(x, params["norm1"], cfg.norm_type)
    mix, new_cache = attn_apply(params["attn"], h, cfg, ctx, rope, cache,
                                mode, pos, cache_capacity, block_tables,
                                block_size)
    x = x + mix
    h2 = apply_norm(x, params["norm2"], cfg.norm_type)
    x = x + mlp(params["ffn"], h2, cfg.mlp_act, cfg.mlp_gated)
    return x, new_cache
