"""Unified model: specs, init, prefill forward, paged decode and prefill loops.

Parameters are a nested dict of tensors with exactly the reference's key
paths and shapes (``embed``, ``final_norm``, ``layers/stack/b{i}`` stacked
on a leading group axis, ``layers/rest/r{i}``, ``head``); a layer reads its
slice ``w[i]`` of a stacked leaf.  Each reference ``lax.scan`` becomes a
Python loop.  The paged KV cache is a tree of block pools updated in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks
from repro_torch.models.context import RunContext
from repro_torch.models.layers import apply_norm, rope_tables
from repro_torch.models.spec import (ParamSpec, init_params, map_specs,
                                     param_count, stack_specs)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# --------------------------------------------------------------------------- #
# Grouping / specs / init
# --------------------------------------------------------------------------- #
def grouping(cfg: ModelConfig):
    """(pattern, n_groups, rest_kinds)."""
    pat = cfg.block_pattern
    n_groups = cfg.n_layers // len(pat)
    rest = cfg.layer_kinds()[n_groups * len(pat):]
    return pat, n_groups, rest


def param_specs(cfg: ModelConfig) -> Dict:
    blocks.check_supported(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    pat, n_groups, rest = grouping(cfg)
    sp: Dict = {
        "embed": ParamSpec((v, d), ("vocab", "embed"), fan_in=d),
        "final_norm": blocks.norm_specs(cfg),
        "layers": {
            "stack": {f"b{i}": stack_specs(blocks.block_specs(cfg, kind),
                                           n_groups)
                      for i, kind in enumerate(pat)},
            "rest": {f"r{i}": blocks.block_specs(cfg, kind)
                     for i, kind in enumerate(rest)},
        },
    }
    if not cfg.tie_embeddings:
        sp["head"] = ParamSpec((d, v), ("embed", "vocab"))
    if cfg.dtype != "bfloat16":
        target = dtype_of(cfg)
        sp = map_specs(lambda s: dataclasses.replace(s, dtype=target)
                       if s.dtype == torch.bfloat16 else s, sp)
    return sp


def init(cfg: ModelConfig, generator: torch.Generator,
         device: torch.device) -> Dict:
    """Random parameters from ``generator`` (standalone use; parity tests
    load the reference's weights through ``weights.from_jax``)."""
    return init_params(param_specs(cfg), generator, device)


def n_params(cfg: ModelConfig) -> int:
    return param_count(param_specs(cfg))


def layers(cfg: ModelConfig, params: Dict, cache: Optional[Dict]
           ) -> Iterator[Tuple[str, Dict, Optional[Dict]]]:
    """(kind, layer params, layer cache) in depth order; stacked leaves
    are sliced per group (views: in-place cache writes reach the pool)."""
    pat, n_groups, rest = grouping(cfg)

    def pick(tree, i):
        if isinstance(tree, dict):
            return {k: pick(v, i) for k, v in tree.items()}
        return tree[i]

    for g in range(n_groups):
        for j, kind in enumerate(pat):
            key = f"b{j}"
            yield (kind, pick(params["layers"]["stack"][key], g),
                   None if cache is None
                   else pick(cache["stack"][key], g))
    for j, kind in enumerate(rest):
        key = f"r{j}"
        yield (kind, params["layers"]["rest"][key],
               None if cache is None else cache["rest"][key])


# --------------------------------------------------------------------------- #
# Cache
# --------------------------------------------------------------------------- #
def cache_axes(cfg: ModelConfig):
    """(batch_axis, capacity_axis) trees matching the cache layout: stacked
    leaves are (layers, batch/blocks, capacity/block_size, Hkv, D), rest
    leaves drop the layer axis.  Every leaf of this slice is attention KV."""
    pat, _, rest = grouping(cfg)
    b = {"stack": {f"b{i}": {"k": 1, "v": 1} for i in range(len(pat))},
         "rest": {f"r{i}": {"k": 0, "v": 0} for i in range(len(rest))}}
    c = {"stack": {f"b{i}": {"k": 2, "v": 2} for i in range(len(pat))},
         "rest": {f"r{i}": {"k": 1, "v": 1} for i in range(len(rest))}}
    return b, c


def cache_leaves(cfg: ModelConfig, cache: Dict):
    """``[(leaf, batch_axis)]`` over every KV tensor of a cache tree."""
    b_ax, _ = cache_axes(cfg)
    return [(cache[grp][key][kv], b_ax[grp][key][kv])
            for grp in ("stack", "rest") for key in cache[grp]
            for kv in ("k", "v")]


def init_paged_cache(cfg: ModelConfig, max_slots: int, num_blocks: int,
                     block_size: int, dtype: Optional[torch.dtype] = None,
                     device: Optional[torch.device] = None) -> Dict:
    """Zero paged KV pool: every attention leaf is a (num_blocks,
    block_size, Hkv, D) block pool (stacked per group).  Block 0 is the
    trash block inactive slots write into; allocators never hand it out.
    ``max_slots`` sizes per-slot state rows, which attention-only
    configurations do not have."""
    blocks.check_supported(cfg)
    dtype = dtype or dtype_of(cfg)
    pat, n_groups, rest = grouping(cfg)
    shape = (num_blocks, block_size, cfg.n_kv_heads, cfg.head_dim)

    def kv(lead):
        return {"k": torch.zeros(lead + shape, dtype=dtype, device=device),
                "v": torch.zeros(lead + shape, dtype=dtype, device=device)}

    return {"stack": {f"b{i}": kv((n_groups,)) for i in range(len(pat))},
            "rest": {f"r{i}": kv(()) for i in range(len(rest))}}


def _stack_caches(cfg: ModelConfig, per_layer):
    """Per-layer {"k","v"} caches in depth order -> the stacked cache tree."""
    pat, n_groups, rest = grouping(cfg)
    out = {"stack": {}, "rest": {}}
    for j in range(len(pat)):
        mine = per_layer[j:n_groups * len(pat):len(pat)]
        out["stack"][f"b{j}"] = {kk: torch.stack([c[kk] for c in mine])
                                 for kk in ("k", "v")}
    for j in range(len(rest)):
        out["rest"][f"r{j}"] = per_layer[n_groups * len(pat) + j]
    return out


# --------------------------------------------------------------------------- #
# Embedding / unembedding
# --------------------------------------------------------------------------- #
def embed_tokens(cfg: ModelConfig, params: Dict,
                 tokens: torch.Tensor) -> torch.Tensor:
    dtype = dtype_of(cfg)
    x = params["embed"][tokens.long()].to(dtype)
    if cfg.scale_embeddings:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dtype)
    return x


def embed_inputs(cfg: ModelConfig, params: Dict, batch: Dict):
    """Returns (x, positions, prefix_len) for text inputs."""
    blocks.check_supported(cfg)
    x = embed_tokens(cfg, params, batch["tokens"])
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device).expand(b, s)
    return x, positions, 0


def unembed(cfg: ModelConfig, params: Dict, x: torch.Tensor) -> torch.Tensor:
    """Final norm + vocab projection; logits in float32 (the product runs
    in float32 so bf16 models keep full-precision logits)."""
    x = apply_norm(x, params["final_norm"], cfg.norm_type).float()
    if cfg.tie_embeddings:
        logits = torch.matmul(x, params["embed"].float().t())
    else:
        logits = torch.matmul(x, params["head"].float())
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def _run_layers(cfg, params, x, ctx, rope, cache, mode, pos,
                cache_capacity=0, block_tables=None, block_size=0):
    per_layer = []
    for kind, lp, lc in layers(cfg, params, cache):
        x, nc = blocks.block_apply(kind, lp, x, cfg, ctx, rope, lc, mode,
                                   pos, cache_capacity, block_tables,
                                   block_size)
        per_layer.append(nc)
    return x, per_layer


# --------------------------------------------------------------------------- #
# Public entry points
# --------------------------------------------------------------------------- #
def forward(cfg: ModelConfig, params: Dict, batch: Dict, ctx: RunContext,
            mode: str = "prefill", cache_capacity: int = 0):
    """mode="prefill" -> (last_logits (B, V), cache) with a contiguous
    (layers, B, capacity, Hkv, D) cache tree.  Training is ported later."""
    if mode != "prefill":
        raise NotImplementedError("training forward is ported later "
                                  "(ROADMAP Queue 1 item 12, training)")
    x, positions, _ = embed_inputs(cfg, params, batch)
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    x, per_layer = _run_layers(cfg, params, x, ctx, rope, None, "prefill",
                               None, cache_capacity)
    logits = unembed(cfg, params, x[:, -1:])
    return logits[:, 0], _stack_caches(cfg, per_layer)


def decode_step(cfg: ModelConfig, params: Dict, cache: Dict,
                tokens: torch.Tensor, pos: torch.Tensor, ctx: RunContext,
                block_tables: torch.Tensor, block_size: int):
    """One paged decode step. tokens: (B, 1) int; pos: (B,) int32 per-slot
    cursors; block_tables: (B, M) int32.  Writes each row's K/V into the
    pool in place; returns (logits (B, V), cache)."""
    x = embed_tokens(cfg, params, tokens)
    rope = rope_tables(pos[:, None], cfg.head_dim, cfg.rope_theta)
    x, _ = _run_layers(cfg, params, x, ctx, rope, cache, "decode", pos,
                       block_tables=block_tables, block_size=block_size)
    return unembed(cfg, params, x)[:, 0], cache


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


def decode_loop(cfg: ModelConfig, params: Dict, cache: Dict,
                tokens: torch.Tensor, pos: torch.Tensor,
                steps_left: torch.Tensor, ctx: RunContext, *,
                block_tables: torch.Tensor, block_size: int, num_steps: int,
                capacity: int):
    """``num_steps`` greedy decode steps (one window).

    tokens (B, 1); pos (B,) cursors (may equal ``capacity``); steps_left
    (B,) tokens still to emit per row.  A row past its ``steps_left`` is
    dead: table row and cursor masked to 0 (writes park in the trash
    block), its token frozen.  Write positions pin at ``capacity - 1``.
    Returns (tokens_out (B, num_steps) int32, cache).
    """
    tok = _i32(tokens[:, 0])
    tables = _i32(block_tables)
    steps_left = _i32(steps_left)
    cur = _i32(pos)
    outs = []
    for t in range(num_steps):
        live = t < steps_left
        eff_tables = torch.where(live[:, None], tables, 0)
        eff_pos = torch.where(live, torch.clamp(cur, max=capacity - 1), 0)
        logits, cache = decode_step(cfg, params, cache, tok[:, None],
                                    _i32(eff_pos), ctx,
                                    block_tables=_i32(eff_tables),
                                    block_size=block_size)
        nxt = _i32(torch.argmax(logits, -1))
        tok = torch.where(live, nxt, tok)
        cur = torch.where(live, torch.clamp(cur + 1, max=capacity), cur)
        outs.append(tok)
    return torch.stack(outs, dim=1), cache


def prefill_loop(cfg: ModelConfig, params: Dict, cache: Dict,
                 tokens: torch.Tensor, pos0: torch.Tensor,
                 n_tokens: torch.Tensor, ctx: RunContext, *,
                 block_tables: torch.Tensor, block_size: int, num_steps: int,
                 capacity: int):
    """Teacher-forced stepwise suffix prefill over the paged pool.

    tokens (B, T) suffix rows; pos0 (B,) first uncached position; n_tokens
    (B,) live suffix length (0 = pad row, parked in the trash block).
    Returns (first_tokens (B,), cache): the greedy token after each row's
    last suffix position."""
    tables = _i32(block_tables)
    n_tokens = _i32(n_tokens)
    pos0 = _i32(pos0)
    toks = _i32(tokens)
    first = torch.zeros_like(n_tokens)
    for t in range(num_steps):
        live = t < n_tokens
        eff_tables = torch.where(live[:, None], tables, 0)
        eff_pos = torch.where(live, torch.clamp(pos0 + t, max=capacity - 1),
                              0)
        logits, cache = decode_step(cfg, params, cache, toks[:, t:t + 1],
                                    _i32(eff_pos), ctx,
                                    block_tables=_i32(eff_tables),
                                    block_size=block_size)
        nxt = _i32(torch.argmax(logits, -1))
        first = torch.where(t == n_tokens - 1, nxt, first)
    return first, cache


def supports_chunked_prefill(cfg: ModelConfig) -> bool:
    """Chunked prefill needs every layer to be windowless attention."""
    return cfg.window is None and all(k == "attn"
                                      for k in cfg.layer_kinds())


def chunk_step(cfg: ModelConfig, params: Dict, cache: Dict,
               tokens: torch.Tensor, pos0: torch.Tensor,
               n_live: torch.Tensor, ctx: RunContext, *,
               block_tables: torch.Tensor, block_size: int, capacity: int):
    """One C-token chunk of suffix prefill per row in one model pass.
    Returns (logits after each row's last live token (B, V), cache);
    rows with n_live == 0 yield garbage the caller masks out."""
    x = embed_tokens(cfg, params, tokens)
    c = x.shape[1]
    pos0 = _i32(pos0)
    n_live = _i32(n_live)
    positions = torch.clamp(pos0[:, None] + torch.arange(c, device=x.device),
                            max=capacity - 1)
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    x, _ = _run_layers(cfg, params, x, ctx, rope, cache, "chunk",
                       (pos0, n_live), capacity, _i32(block_tables),
                       block_size)
    idx = torch.clamp(n_live - 1, 0, c - 1).long()
    x_last = x[torch.arange(x.shape[0], device=x.device), idx][:, None]
    return unembed(cfg, params, x_last)[:, 0], cache


def _pad_cols(toks: torch.Tensor, width: int) -> torch.Tensor:
    if toks.shape[1] >= width:
        return toks
    pad = torch.zeros((toks.shape[0], width - toks.shape[1]),
                      dtype=toks.dtype, device=toks.device)
    return torch.cat([toks, pad], dim=1)


def prefill_chunks(cfg: ModelConfig, params: Dict, cache: Dict,
                   tokens: torch.Tensor, pos0: torch.Tensor,
                   n_tokens: torch.Tensor, ctx: RunContext, *,
                   block_tables: torch.Tensor, block_size: int, chunk: int,
                   num_steps: int, capacity: int):
    """:func:`prefill_loop` at ``chunk`` tokens per step via
    :func:`chunk_step`; ``num_steps`` is the number of chunk steps."""
    tables = _i32(block_tables)
    n_tokens = _i32(n_tokens)
    pos0 = _i32(pos0)
    toks = _pad_cols(_i32(tokens), num_steps * chunk)
    first = torch.zeros_like(n_tokens)
    for t in range(num_steps):
        base = t * chunk
        n_live = torch.clamp(n_tokens - base, 0, chunk)
        eff_tables = torch.where((n_live > 0)[:, None], tables, 0)
        logits, cache = chunk_step(cfg, params, cache,
                                   toks[:, base:base + chunk], pos0 + base,
                                   n_live, ctx, block_tables=eff_tables,
                                   block_size=block_size, capacity=capacity)
        nxt = _i32(torch.argmax(logits, -1))
        done_here = (n_tokens > base) & (n_tokens <= base + chunk)
        first = torch.where(done_here, nxt, first)
    return first, cache


def mixed_loop(cfg: ModelConfig, params: Dict, cache: Dict,
               tokens: torch.Tensor, pos: torch.Tensor,
               steps_left: torch.Tensor, sfx_tokens: torch.Tensor,
               sfx_pos0: torch.Tensor, sfx_n: torch.Tensor, ctx: RunContext,
               *, block_tables: torch.Tensor, sfx_tables: torch.Tensor,
               block_size: int, chunk: int, num_steps: int, capacity: int):
    """Mixed prefill/decode engine step: each loop step runs the pending
    prefill chunk of the joining rows, then one decode step of the
    resident cohort (the serial order of the split path, over disjoint
    blocks).  Returns (tokens_out (S, num_steps), firsts (J,), cache)."""
    tok = _i32(tokens[:, 0])
    tables = _i32(block_tables)
    steps_left = _i32(steps_left)
    stables = _i32(sfx_tables)
    sfx_n = _i32(sfx_n)
    sfx_pos0 = _i32(sfx_pos0)
    stoks = _pad_cols(_i32(sfx_tokens), num_steps * chunk)
    first = torch.zeros_like(sfx_n)
    cur = _i32(pos)
    outs = []
    for t in range(num_steps):
        base = t * chunk
        n_live = torch.clamp(sfx_n - base, 0, chunk)
        eff_stables = torch.where((n_live > 0)[:, None], stables, 0)
        logits_c, cache = chunk_step(cfg, params, cache,
                                     stoks[:, base:base + chunk],
                                     sfx_pos0 + base, n_live, ctx,
                                     block_tables=eff_stables,
                                     block_size=block_size,
                                     capacity=capacity)
        nxt_c = _i32(torch.argmax(logits_c, -1))
        done_here = (sfx_n > base) & (sfx_n <= base + chunk)
        first = torch.where(done_here, nxt_c, first)
        live = t < steps_left
        eff_tables = torch.where(live[:, None], tables, 0)
        eff_pos = torch.where(live, torch.clamp(cur, max=capacity - 1), 0)
        logits, cache = decode_step(cfg, params, cache, tok[:, None],
                                    _i32(eff_pos), ctx,
                                    block_tables=_i32(eff_tables),
                                    block_size=block_size)
        nxt = _i32(torch.argmax(logits, -1))
        tok = torch.where(live, nxt, tok)
        cur = torch.where(live, torch.clamp(cur + 1, max=capacity), cur)
        outs.append(tok)
    return torch.stack(outs, dim=1), first, cache
