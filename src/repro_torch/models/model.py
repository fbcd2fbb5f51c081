"""Unified model: specs, init, train and prefill forward, loss, decode
step, paged loops, speculative verify and draft.

Parameters are a nested dict of tensors with exactly the reference's key
paths and shapes (``embed``, ``final_norm``, ``layers/stack/b{i}`` stacked
on a leading group axis, ``layers/rest/r{i}``, ``head``); a layer reads its
slice ``w[i]`` of a stacked leaf.  Each reference ``lax.scan`` becomes a
Python loop.  Caches are trees of the same grouping: attention K/V leaves
(contiguous ``(B, capacity, Hkv, D)`` rows or paged block pools) are
updated in place; recurrent state leaves (no capacity axis) are replaced
by each step.  Training (``forward(mode="train")``) writes no cache and
recomputes each layer group in the backward pass (``ctx.remat``, through
``torch.utils.checkpoint``), as the reference's ``jax.checkpoint`` does.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks
from repro_torch.models.context import RunContext
from repro_torch.models.layers import apply_norm, matmul_f32, rope_tables
from repro_torch.models.spec import (ParamSpec, init_params, map_specs,
                                     param_count, spec_leaves, stack_specs)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}
_AUX_COEF = 0.01


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
    if cfg.frontend is not None:
        sp["frontend"] = {"proj": ParamSpec((d, d), ("embed", "embed_out"))}
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


def n_active_params(cfg: ModelConfig) -> int:
    """Active params per token (MoE: top_k of n_experts expert params)."""
    if not cfg.is_moe:
        return n_params(cfg)
    total = n_params(cfg)
    expert_leaves = [
        s for _, s in spec_leaves(param_specs(cfg))
        if len(s.shape) >= 3 and cfg.n_experts in s.shape[:2]
        and s.shape[-1] != cfg.n_experts]
    expert_total = sum(math.prod(s.shape) for s in expert_leaves)
    return total - expert_total + expert_total * cfg.top_k // cfg.n_experts


def layers(cfg: ModelConfig, params: Dict, cache: Optional[Dict]
           ) -> Iterator[Tuple[str, Dict, Optional[Dict]]]:
    """(kind, layer params, layer cache) in depth order; stacked leaves
    are sliced per group (views: in-place cache writes reach the pool)."""
    pat, n_groups, rest = grouping(cfg)
    for g in range(n_groups):
        for j, kind in enumerate(pat):
            key = f"b{j}"
            yield (kind, _pick(params["layers"]["stack"][key], g),
                   None if cache is None
                   else _pick(cache["stack"][key], g))
    for j, kind in enumerate(rest):
        key = f"r{j}"
        yield (kind, params["layers"]["rest"][key],
               None if cache is None else cache["rest"][key])


def _pick(tree, i):
    """Group ``i`` of a stacked tree (views of the stacked leaves)."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]


# --------------------------------------------------------------------------- #
# Cache
# --------------------------------------------------------------------------- #
def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _tree_leaves(tree):
    """Leaves of a nested dict in sorted key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(tree, leaves):
    """``leaves`` (in :func:`_tree_leaves` order) back into the structure
    of ``tree``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)
    return build(tree)


def init_cache(cfg: ModelConfig, batch: int, capacity: int,
               dtype: Optional[torch.dtype] = None,
               device: Optional[torch.device] = None) -> Dict:
    """Zero contiguous decode cache, stacked to match the layer grouping:
    attention leaves (layers, batch, capacity, Hkv, D) (capacity capped at
    a sliding window), RG-LRU and RWKV state leaves (layers, batch, ...)."""
    dtype = dtype or dtype_of(cfg)
    pat, n_groups, rest = grouping(cfg)

    def stacked(kind):
        one = blocks.init_block_cache(cfg, kind, batch, capacity, dtype,
                                      device)
        return tree_map(lambda a: torch.zeros((n_groups,) + a.shape,
                                              dtype=a.dtype, device=device),
                        one)

    return {
        "stack": {f"b{i}": stacked(kind) for i, kind in enumerate(pat)},
        "rest": {f"r{i}": blocks.init_block_cache(cfg, kind, batch, capacity,
                                                  dtype, device)
                 for i, kind in enumerate(rest)},
    }


@functools.lru_cache(maxsize=None)
def cache_axes(cfg: ModelConfig):
    """Locate each cache leaf's (batch_axis, capacity_axis) by shape diffing.

    Returns two trees matching :func:`init_cache`'s structure: the axis that
    scales with batch, and the axis that scales with capacity (``None`` for
    per-row state leaves such as recurrent states, which have no sequence
    storage).  Shapes come from meta tensors: nothing is allocated.

    A sliding window caps an attention leaf's capacity, so where the window
    is at most 8 (reduced configs) both probe capacities give the same
    shape and its KV leaves report no capacity axis, as in the reference.
    Nothing may rely on that axis for a windowed configuration: the paged
    pool, its only user, raises for them (:func:`init_paged_cache`).
    """
    def diff_axis(x, y):
        d = [i for i, (p, q) in enumerate(zip(x.shape, y.shape)) if p != q]
        return d[0] if d else None

    meta = torch.device("meta")
    b1, b2 = (init_cache(cfg, n, 16, device=meta) for n in (1, 2))
    c1, c2 = (init_cache(cfg, 1, n, device=meta) for n in (8, 16))
    return tree_map(diff_axis, b1, b2), tree_map(diff_axis, c1, c2)


def cache_leaves(cfg: ModelConfig, cache: Dict):
    """``[(leaf, batch_axis)]`` over every tensor (KV or state) of a cache
    tree, in sorted key order."""
    return list(zip(_tree_leaves(cache), _tree_leaves(cache_axes(cfg)[0])))


def has_state_rows(cfg: ModelConfig) -> bool:
    """Whether any cache leaf is a per-row state (no capacity axis)."""
    return any(ax is None for ax in _tree_leaves(cache_axes(cfg)[1]))


def init_paged_cache(cfg: ModelConfig, max_slots: int, num_blocks: int,
                     block_size: int, dtype: Optional[torch.dtype] = None,
                     device: Optional[torch.device] = None) -> Dict:
    """Zero paged KV pool: every attention leaf is a (num_blocks,
    block_size, Hkv, D) block pool (stacked per group).  Block 0 is the
    trash block inactive slots write into; allocators never hand it out.
    ``max_slots`` would size per-slot state rows: configurations with
    recurrent state are not served paged (the reference's paged path
    corrupts their state; ROADMAP Queue 3), nor are sliding windows (the
    reference has no paged ring)."""
    if cfg.window is not None:
        raise NotImplementedError("paged KV cache requires full attention "
                                  "(cfg.window=None)")
    if has_state_rows(cfg):
        raise NotImplementedError(
            f"{cfg.name}: recurrent state rows are not served from the "
            "paged pool (the reference's paged path corrupts them, ROADMAP "
            "Queue 3); use kv='contiguous'")
    return init_cache(cfg, num_blocks, block_size, dtype, device)


def _stack_caches(cfg: ModelConfig, per_layer, kv_from=None):
    """Per-layer cache trees in depth order -> the stacked cache tree.
    With ``kv_from`` (the stacked cache a decode step wrote its K/V into
    in place) the attention groups are taken from it as they are, and
    only the state groups are restacked."""
    pat, n_groups, rest = grouping(cfg)
    out = {"stack": {}, "rest": {}}
    for j, kind in enumerate(pat):
        if kv_from is not None and kind == "attn":
            out["stack"][f"b{j}"] = kv_from["stack"][f"b{j}"]
            continue
        mine = per_layer[j:n_groups * len(pat):len(pat)]
        out["stack"][f"b{j}"] = tree_map(lambda *xs: torch.stack(xs),
                                         *mine)
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
    """Returns (x, positions, prefix_len).  Text embeds ``tokens``; the
    audio stub projects ``frames`` (B, S, d_model); the vision stub
    projects ``patches`` (B, P, d_model) into a prefix of P positions
    ahead of the embedded ``tokens`` (``prefix_len`` = P)."""
    dtype = dtype_of(cfg)
    if cfg.frontend == "audio":
        x = torch.matmul(batch["frames"].to(dtype),
                         params["frontend"]["proj"]).to(dtype)
        prefix_len = 0
    elif cfg.frontend == "vision":
        patches = torch.matmul(batch["patches"].to(dtype),
                               params["frontend"]["proj"]).to(dtype)
        x = torch.cat([patches, embed_tokens(cfg, params, batch["tokens"])],
                      dim=1)
        prefix_len = patches.shape[1]
    else:
        x = embed_tokens(cfg, params, batch["tokens"])
        prefix_len = 0
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device).expand(b, s)
    return x, positions, prefix_len


def unembed(cfg: ModelConfig, params: Dict, x: torch.Tensor) -> torch.Tensor:
    """Final norm + vocab projection; logits in float32 from a float32
    product of the activation-dtype operands (:func:`layers.matmul_f32`,
    the reference's ``preferred_element_type=jnp.float32``).  A tied
    embedding is read through its transpose view: no float32 copy of the
    vocabulary matrix is made on the card."""
    x = apply_norm(x, params["final_norm"], cfg.norm_type)
    if cfg.tie_embeddings:
        logits = matmul_f32(x, params["embed"].t())
    else:
        logits = matmul_f32(x, params["head"])
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


# --------------------------------------------------------------------------- #
# Stack application
# --------------------------------------------------------------------------- #
def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"`` (the reference's
    ``dots_saveable``): keep every matmul output, recompute the rest."""
    aten = torch.ops.aten
    if op.overloadpacket in (aten.mm, aten.bmm, aten.addmm, aten.baddbmm):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(fn, ctx: RunContext, mode: str):
    """``fn`` (one layer group) under activation checkpointing when a
    training forward records gradients: ``"full"`` recomputes the whole
    group in the backward pass, ``"dots"`` keeps its matmul outputs.  The
    recomputation runs the same ops on the same inputs, so the gradients
    do not depend on ``remat``."""
    if mode != "train" or ctx.remat == "none" \
            or not torch.is_grad_enabled():
        return fn
    kw = {}
    if ctx.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return lambda *a: checkpoint(fn, *a, use_reentrant=False, **kw)


def apply_stack(cfg: ModelConfig, params: Dict, x: torch.Tensor,
                ctx: RunContext, rope, cache: Optional[Dict], mode: str,
                prefix_len: int, pos, cache_capacity: int = 0,
                block_tables=None, block_size: int = 0):
    """Runs all layers in depth order.  Returns (x, the per-layer caches
    in depth order, aux): aux sums the MoE load-balance losses in
    float32.  Each repetition of the block pattern is one group
    (:func:`_remat_wrap` in training); layers left over after the last
    group run on their own, unwrapped, as in the reference."""
    pat, n_groups, rest = grouping(cfg)
    per_layer = []

    def run(kind, lp, lc, x):
        x, nc, a = blocks.block_apply(kind, lp, x, cfg, ctx, rope, lc, mode,
                                      prefix_len, pos, cache_capacity,
                                      block_tables, block_size)
        per_layer.append(nc)
        return x, a

    def group(g):
        def body(x):
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
            for j, kind in enumerate(pat):
                key = f"b{j}"
                x, a = run(kind, _pick(params["layers"]["stack"][key], g),
                           None if cache is None
                           else _pick(cache["stack"][key], g), x)
                aux = aux + a
            return x, aux
        return _remat_wrap(body, ctx, mode)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(n_groups):
        x, a = group(g)(x)
        aux = aux + a
    for j, kind in enumerate(rest):
        key = f"r{j}"
        x, a = run(kind, params["layers"]["rest"][key],
                   None if cache is None else cache["rest"][key], x)
        aux = aux + a
    return x, per_layer, aux


# --------------------------------------------------------------------------- #
# Losses
# --------------------------------------------------------------------------- #
def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: Optional[torch.Tensor], chunk: int = 0
                  ) -> torch.Tensor:
    """Stable cross-entropy of (B, S, V) logits against (B, S) targets in
    float32: the mean over positions, or over ``mask``-weighted positions
    (divided by at least 1).  ``chunk`` evaluates ``chunk`` positions at a
    time when it divides S (the same per-position values).  The
    vocab-sharded form waits for the port's mesh (ROADMAP Queue 1 item
    10)."""
    def ce(lg, tg):
        lg = lg.float()
        ll = torch.take_along_dim(lg, tg.long()[..., None], dim=-1)[..., 0]
        return torch.logsumexp(lg, dim=-1) - ll

    s = logits.shape[1]
    if chunk and s % chunk == 0 and s > chunk:
        losses = torch.cat([ce(logits[:, i:i + chunk],
                               targets[:, i:i + chunk])
                            for i in range(0, s, chunk)], dim=1)
    else:
        losses = ce(logits, targets)
    if mask is None:
        return losses.mean()
    mask = mask.float()
    return (losses * mask).sum() / torch.clamp(mask.sum(), min=1.0)


# --------------------------------------------------------------------------- #
# Public entry points
# --------------------------------------------------------------------------- #
def forward(cfg: ModelConfig, params: Dict, batch: Dict, ctx: RunContext,
            mode: str = "train", cache_capacity: int = 0):
    """mode="train" -> (total, {"loss", "aux"}): the cross-entropy against
    ``batch["targets"]`` (over the text suffix for the vision stub,
    weighted by ``batch["loss_mask"]`` where there is one) plus
    ``_AUX_COEF`` times the MoE load-balance loss; no cache is written.
    mode="prefill" -> (last_logits (B, V), cache) with a contiguous cache
    tree (the layout of :func:`init_cache`; K/V padded to
    ``cache_capacity``)."""
    if mode not in ("train", "prefill"):
        raise ValueError(f"forward: mode must be 'train' or 'prefill', "
                         f"got {mode!r}")
    x, positions, prefix_len = embed_inputs(cfg, params, batch)
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    x, per_layer, aux = apply_stack(cfg, params, x, ctx, rope, None, mode,
                                    prefix_len, None, cache_capacity)
    if mode == "prefill":
        logits = unembed(cfg, params, x[:, -1:])
        return logits[:, 0], _stack_caches(cfg, per_layer)
    logits = unembed(cfg, params, x)
    if cfg.frontend == "vision":
        logits = logits[:, prefix_len:]      # loss over the text suffix only
    loss = cross_entropy(logits, batch["targets"], batch.get("loss_mask"),
                         ctx.loss_chunk)
    return loss + _AUX_COEF * aux, {"loss": loss, "aux": aux}


def decode_step(cfg: ModelConfig, params: Dict, cache: Dict,
                tokens: torch.Tensor, pos, ctx: RunContext,
                block_tables: Optional[torch.Tensor] = None,
                block_size: int = 0):
    """One decode step. tokens: (B, 1) int.

    ``pos`` is the decode cursor: an int when the whole batch shares one
    position (contiguous cohort cache, ``block_tables`` None), or a (B,)
    int32 tensor of per-slot cursors when ``block_tables`` (B, M) maps each
    row onto a paged KV block pool.  K/V are written into the cache in
    place; recurrent state leaves are replaced.  Returns (logits (B, V),
    cache)."""
    x = embed_tokens(cfg, params, tokens)
    if block_tables is None:
        pos = int(pos)
        positions = torch.full((x.shape[0], 1), pos, device=x.device)
    else:
        positions = pos[:, None]
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    x, per_layer, _ = apply_stack(cfg, params, x, ctx, rope, cache,
                                  "decode", 0, pos,
                                  block_tables=block_tables,
                                  block_size=block_size)
    if has_state_rows(cfg):
        cache = _stack_caches(cfg, per_layer, kv_from=cache)
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
    x, _, _ = apply_stack(cfg, params, x, ctx, rope, cache, "chunk", 0,
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


def verify_window(cfg: ModelConfig, params: Dict, cache: Dict,
                  tokens: torch.Tensor, pos0: torch.Tensor,
                  n_live: torch.Tensor, ctx: RunContext, *,
                  block_tables: torch.Tensor, block_size: int, capacity: int):
    """Speculative verification: score a K+1 token window in one pass.

    Row i of ``tokens`` (B, C) is the slot's current token followed by its
    ``k_i`` draft proposals, of which the first ``n_live[i] = k_i + 1`` are
    fed teacher-forced at positions ``pos0[i] ..`` through chunk mode (the
    paged-prefill kernel on the card); every position is unembedded, so
    ``greedy[i, j]`` is the target's next token after ``tokens[i, j]``.
    Dead rows (``n_live == 0``) have their table row masked to 0 (trash
    block); positions clamp at ``capacity - 1``, and callers keep
    ``k_i <= capacity - 1 - pos0[i]``.  Returns (greedy (B, C) int32,
    cache)."""
    x = embed_tokens(cfg, params, tokens)
    c = x.shape[1]
    pos0 = _i32(pos0)
    n_live = _i32(n_live)
    eff_tables = torch.where((n_live > 0)[:, None], _i32(block_tables), 0)
    positions = torch.clamp(pos0[:, None] + torch.arange(c, device=x.device),
                            max=capacity - 1)
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    x, _, _ = apply_stack(cfg, params, x, ctx, rope, cache, "chunk", 0,
                          (pos0, n_live), capacity, _i32(eff_tables),
                          block_size)
    return _i32(torch.argmax(unembed(cfg, params, x), -1)), cache


def draft_loop(cfg: ModelConfig, params: Dict, cache: Dict,
               ctoks: torch.Tensor, cpos0: torch.Tensor,
               n_ctok: torch.Tensor, tokens: torch.Tensor, pos: torch.Tensor,
               k_live: torch.Tensor, ctx: RunContext, *,
               block_tables: torch.Tensor, block_size: int,
               catchup_steps: int, num_steps: int, capacity: int):
    """Draft side of speculative decoding, on the draft model's own pool
    indexed by the target's block tables: the catch-up teacher-forces the
    ``n_ctok`` committed tokens the draft has not ingested from ``cpos0``
    (:func:`prefill_loop`, skipped when ``catchup_steps`` is 0), then
    ``k_live[i]`` greedy steps from the current token (:func:`decode_loop`).
    Returns (drafts (B, num_steps) int32, cache)."""
    if catchup_steps > 0:
        _, cache = prefill_loop(cfg, params, cache, ctoks, cpos0, n_ctok,
                                ctx, block_tables=block_tables,
                                block_size=block_size,
                                num_steps=catchup_steps, capacity=capacity)
    return decode_loop(cfg, params, cache, tokens, pos, k_live, ctx,
                       block_tables=block_tables, block_size=block_size,
                       num_steps=num_steps, capacity=capacity)


def spec_accept(greedy: np.ndarray, drafts: np.ndarray,
                n_spec: np.ndarray) -> np.ndarray:
    """Longest-matching-prefix acceptance (host side): row i accepts the
    longest ``a <= n_spec[i]`` with ``drafts[i, j] == greedy[i, j]`` for
    every ``j < a``; the emitted tokens ``greedy[i, :a + 1]`` are what
    ``a + 1`` stepwise greedy steps give.  Returns accepts (B,) int64."""
    k = drafts.shape[1]
    m = np.asarray(greedy)[:, :k] == np.asarray(drafts)
    m &= np.arange(k)[None, :] < np.asarray(n_spec)[:, None]
    return np.cumprod(m, axis=1).sum(axis=1).astype(np.int64)
