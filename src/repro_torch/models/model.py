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

On a mesh (``ctx.mesh``) the parameters, caches and inputs are DTensors
(``launch/steps.py`` places them): the embedding, every block
(``blocks.block_apply``), the unembedding and the vocab-sharded loss each
run under one ``local_map``; :func:`constrain` pins activations between
them, the reference's ``with_sharding_constraint``.
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
from repro_torch.core.trace import span
from repro_torch.distributed import sharding as shd
from repro_torch.models import blocks
from repro_torch.models.context import RunContext
from repro_torch.models.layers import apply_norm, f32, matmul_f32, rope_tables
from repro_torch.models.spec import (ParamSpec, abstract_params,
                                     init_params, logical_axes, map_specs,
                                     param_count, spec_leaves, stack_specs)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16, "float64": torch.float64}
_AUX_COEF = 0.01


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def constrain(x: torch.Tensor, ctx: RunContext, *trailing) -> torch.Tensor:
    """Pin a DTensor activation: batch dim over the data-parallel axes and
    each trailing dim over the mesh axis named for it (or replicated),
    where the size divides; a plain tensor comes back unchanged.  The
    reference's ``with_sharding_constraint``: here a ``redistribute``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if ctx.mesh is None or not isinstance(x, DTensor):
        return x
    sizes = shd.mesh_shape(ctx.mesh)
    plc = []
    for name in ctx.mesh.mesh_dim_names:
        p = Replicate()
        if name in ctx.dp_axes and x.shape[0] % ctx.dp_size == 0:
            p = Shard(0)
        for d, (size, want) in enumerate(zip(x.shape[1:], trailing), 1):
            if want == name and size % sizes[name] == 0:
                p = Shard(d)
        plc.append(p)
    return x.redistribute(ctx.mesh, tuple(plc))


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
        # bf16 leaves take the model dtype; float32 leaves widen to float64
        target = dtype_of(cfg)
        sp = map_specs(lambda s: dataclasses.replace(s, dtype=target)
                       if s.dtype == torch.bfloat16
                       or target.itemsize > s.dtype.itemsize else s, sp)
    return sp


def init(cfg: ModelConfig, generator: torch.Generator,
         device: torch.device) -> Dict:
    """Random parameters from ``generator`` (standalone use; parity tests
    load the reference's weights through ``weights.from_jax``)."""
    return init_params(param_specs(cfg), generator, device)


def init_abstract(cfg: ModelConfig) -> Dict:
    """Meta tensors of every parameter: shapes and dtypes, no storage."""
    return abstract_params(param_specs(cfg))


def param_logical_axes(cfg: ModelConfig) -> Dict:
    return logical_axes(param_specs(cfg))


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


def _unbind(tree):
    """Each stacked leaf split into its groups once (views): one
    ``unbind`` whose backward is one ``stack``, where a ``select`` per
    group would give each group's gradient as a zero-filled copy of the
    whole stack, summed group by group."""
    if isinstance(tree, dict):
        return {k: _unbind(v) for k, v in tree.items()}
    return tree.unbind(0)


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


def abstract_cache(cfg: ModelConfig, batch: int, capacity: int) -> Dict:
    """Meta tensors of :func:`init_cache`'s tree."""
    return init_cache(cfg, batch, capacity, device=torch.device("meta"))


def cache_logical_axes(cfg: ModelConfig) -> Dict:
    """Logical axes tree matching :func:`init_cache` (leading layer-stack
    dim on the stacked groups)."""
    pat, _, rest = grouping(cfg)

    def stacked(kind):
        return tree_map(lambda a: ("layers",) + a,
                        blocks.block_cache_axes(cfg, kind))

    return {
        "stack": {f"b{i}": stacked(kind) for i, kind in enumerate(pat)},
        "rest": {f"r{i}": blocks.block_cache_axes(cfg, kind)
                 for i, kind in enumerate(rest)},
    }


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
def embed_tokens(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                 ctx: Optional[RunContext] = None) -> torch.Tensor:
    if ctx is not None and ctx.mesh is not None:
        return _embed_sharded(cfg, params, {"tokens": tokens}, ctx)
    dtype = dtype_of(cfg)
    x = params["embed"][tokens.long()].to(dtype)
    if cfg.scale_embeddings:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dtype)
    return x


def _frontend(cfg: ModelConfig, params: Dict, batch: Dict, tok_embed):
    """(x, prefix_len) of a batch: text embeds ``tokens``; the audio stub
    projects ``frames``; the vision stub projects ``patches`` into a
    prefix ahead of the embedded ``tokens``."""
    dtype = dtype_of(cfg)
    if cfg.frontend == "audio":
        x = torch.matmul(batch["frames"].to(dtype),
                         params["frontend"]["proj"]).to(dtype)
        return x, 0
    if cfg.frontend == "vision":
        patches = torch.matmul(batch["patches"].to(dtype),
                               params["frontend"]["proj"]).to(dtype)
        return torch.cat([patches, tok_embed(batch["tokens"])], dim=1), \
            patches.shape[1]
    return tok_embed(batch["tokens"]), 0


def embed_inputs(cfg: ModelConfig, params: Dict, batch: Dict,
                 ctx: Optional[RunContext] = None):
    """Returns (x, positions, prefix_len).  Text embeds ``tokens``; the
    audio stub projects ``frames`` (B, S, d_model); the vision stub
    projects ``patches`` (B, P, d_model) into a prefix of P positions
    ahead of the embedded ``tokens`` (``prefix_len`` = P).  On a mesh x is
    a DTensor and positions has one row (every row's are the same)."""
    if ctx is not None and ctx.mesh is not None:
        x = _embed_sharded(cfg, params, batch, ctx)
        prefix_len = (batch["patches"].shape[1]
                      if cfg.frontend == "vision" else 0)
        s = x.shape[1]
        dev = batch[next(iter(batch))].device
        return x, torch.arange(s, device=dev)[None], prefix_len
    x, prefix_len = _frontend(cfg, params, batch,
                              lambda t: embed_tokens(cfg, params, t))
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device).expand(b, s)
    return x, positions, prefix_len


def _vocab_split(t: torch.Tensor, ctx: RunContext, dim: int) -> bool:
    """Whether a DTensor parameter's vocab dim ``dim`` is split over the
    model axis."""
    p = t.placements[ctx.mesh.mesh_dim_names.index(ctx.model_axis)]
    return p.is_shard() and p.dim == dim


def _embed_sharded(cfg: ModelConfig, params: Dict, batch: Dict,
                   ctx: RunContext):
    """Embedding (and frontend projection) under one ``local_map``: the
    table gathered over the data axes; when its vocab is split over the
    model axis each rank looks up the tokens in its stretch and one sum
    over the axis completes every row (vocab-parallel).  Zero-sp gathers
    the table whole and splits the rows over the model axis."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh, m = ctx.mesh, ctx.model_axis
    dtype = dtype_of(cfg)
    names = sorted(n for n in batch if n in ("tokens", "frames", "patches"))
    b = batch[names[0]].shape[0]
    s_full = sum(batch[n].shape[1] for n in names)
    dp = Shard(0) if b % ctx.dp_size == 0 else Replicate()
    pdp = Partial() if b % ctx.dp_size == 0 else Replicate()
    seq = ctx.zero_sp and s_full % ctx.model_size == 0
    split = _vocab_split(params["embed"], ctx, 0) and not seq
    rep_grad = Partial() if seq else Replicate()
    leaves = {"embed": params["embed"]}
    if cfg.frontend is not None:
        leaves["proj"] = params["frontend"]["proj"]
    lnames = sorted(leaves)
    p_in = {"embed": blocks._plc(ctx, Replicate(),
                                 Shard(0) if split else Replicate()),
            "proj": blocks._plc(ctx, Replicate(), Replicate())}
    p_grad = {"embed": blocks._plc(ctx, pdp, Shard(0) if split else rep_grad),
              "proj": blocks._plc(ctx, pdp, rep_grad)}

    def body(*args):
        w = dict(zip(lnames, args[:len(lnames)]))
        inp = dict(zip(names, args[len(lnames):]))

        def tok_embed(tok):
            tok = tok.long()
            if split:
                v_loc = w["embed"].shape[0]
                idx = tok - shd.axis_index(mesh, m) * v_loc
                ok = (idx >= 0) & (idx < v_loc)
                x = w["embed"][idx.clamp(0, v_loc - 1)] * ok[..., None]
                x = shd.reduce_from(x.to(dtype), mesh, m)
            else:
                x = w["embed"][tok].to(dtype)
            if cfg.scale_embeddings:
                x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dtype)
            return x

        if names == ["tokens"]:             # a decode step's tokens
            x = tok_embed(inp["tokens"])
        else:
            x, _ = _frontend(cfg, {"frontend": {"proj": w.get("proj")}},
                             inp, tok_embed)
        return shd.split_to(x, mesh, m, 1) if seq else x

    fn = shd.local_map(
        body, mesh=mesh,
        in_placements=tuple(p_in[n] for n in lnames)
        + tuple(blocks._plc(ctx, dp, Replicate()) for _ in names),
        out_placements=blocks._plc(ctx, dp, Shard(1) if seq
                                   else Replicate()),
        in_grad_placements=tuple(p_grad[n] for n in lnames)
        + tuple(None for _ in names))
    return fn(*(leaves[n] for n in lnames), *(batch[n] for n in names))


def unembed(cfg: ModelConfig, params: Dict, x: torch.Tensor,
            ctx: Optional[RunContext] = None) -> torch.Tensor:
    """Final norm + vocab projection; logits in float32 from a float32
    product of the activation-dtype operands (:func:`layers.matmul_f32`,
    the reference's ``preferred_element_type=jnp.float32``).  A tied
    embedding is read through its transpose view: no float32 copy of the
    vocabulary matrix is made on the card.  On a mesh the logits come out
    split over the model axis along the vocab where the weight is."""
    if ctx is not None and ctx.mesh is not None:
        return constrain(_unembed_sharded(cfg, params, x, ctx), ctx, None,
                         ctx.model_axis)
    x = apply_norm(x, params["final_norm"], cfg.norm_type)
    if cfg.tie_embeddings:
        logits = matmul_f32(x, params["embed"].t())
    else:
        logits = matmul_f32(x, params["head"])
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def _unembed_sharded(cfg: ModelConfig, params: Dict, x, ctx: RunContext):
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh, m = ctx.mesh, ctx.model_axis
    b = x.shape[0]
    m_idx = mesh.mesh_dim_names.index(m)
    seq = x.placements[m_idx].is_shard()
    dp = Shard(0) if b % ctx.dp_size == 0 else Replicate()
    pdp = Partial() if b % ctx.dp_size == 0 else Replicate()
    w = params["embed"] if cfg.tie_embeddings else params["head"]
    vdim = 0 if cfg.tie_embeddings else 1
    split = _vocab_split(w, ctx, vdim) and not seq
    rep_grad = Partial() if seq else Replicate()
    norm = params["final_norm"]
    nnames = sorted(norm)
    x_plc = blocks._plc(ctx, dp, Shard(1) if seq else Replicate())

    def body(xl, wl, *nl):
        h = apply_norm(xl, dict(zip(nnames, nl)), cfg.norm_type)
        if split:
            h = shd.copy_to(h, mesh, m)
        logits = matmul_f32(h, wl.t() if cfg.tie_embeddings else wl)
        if cfg.final_softcap is not None:
            logits = cfg.final_softcap * torch.tanh(logits
                                                    / cfg.final_softcap)
        return logits

    rep = blocks._plc(ctx, Replicate(), Replicate())
    fn = shd.local_map(
        body, mesh=mesh,
        in_placements=(x_plc, blocks._plc(ctx, Replicate(), Shard(vdim)
                                          if split else Replicate()))
        + tuple(rep for _ in nnames),
        out_placements=blocks._plc(ctx, dp, Shard(2) if split
                                   else (Shard(1) if seq else Replicate())),
        in_grad_placements=(x_plc, blocks._plc(ctx, pdp, Shard(vdim)
                                               if split else rep_grad))
        + tuple(blocks._plc(ctx, pdp, rep_grad) for _ in nnames))
    return fn(x, w, *(norm[n] for n in nnames))


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


def _zero(x: torch.Tensor, ctx: RunContext) -> torch.Tensor:
    """A float32 zero scalar beside ``x`` (a replicated DTensor on a
    mesh)."""
    z = torch.zeros((), dtype=torch.float32, device=x.device)
    if ctx.mesh is None:
        return z
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(z, ctx.mesh,
                              [Replicate()] * ctx.mesh.ndim, run_check=False)


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
    seq_ax = ctx.model_axis if (ctx.mesh is not None and ctx.zero_sp) \
        else None

    def run(kind, lp, lc, x):
        x, nc, a = blocks.block_apply(kind, lp, x, cfg, ctx, rope, lc, mode,
                                      prefix_len, pos, cache_capacity,
                                      block_tables, block_size)
        per_layer.append(nc)
        return x, a

    def group(g):
        def body(x):
            x = constrain(x, ctx, seq_ax, None)
            aux = _zero(x, ctx)
            for j, kind in enumerate(pat):
                key = f"b{j}"
                x, a = run(kind, _pick(stack[key], g),
                           None if cache is None
                           else _pick(cache["stack"][key], g), x)
                aux = aux + a
            return x, aux
        return _remat_wrap(body, ctx, mode)

    aux = _zero(x, ctx)
    stack = _unbind(params["layers"]["stack"]) if n_groups else {}
    for g in range(n_groups):
        with span("model.layer"):
            x, a = group(g)(x)
            aux = aux + a
    for j, kind in enumerate(rest):
        key = f"r{j}"
        with span("model.layer"):
            x, a = run(kind, params["layers"]["rest"][key],
                       None if cache is None else cache["rest"][key], x)
            aux = aux + a
    return x, per_layer, aux


# --------------------------------------------------------------------------- #
# Losses
# --------------------------------------------------------------------------- #
def _ce(lg: torch.Tensor, tg: torch.Tensor) -> torch.Tensor:
    lg = f32(lg)
    ll = torch.take_along_dim(lg, tg.long()[..., None], dim=-1)[..., 0]
    return torch.logsumexp(lg, dim=-1) - ll


def _ce_vocab_sharded(logits: torch.Tensor, targets: torch.Tensor,
                      ctx: RunContext) -> torch.Tensor:
    """Per-token CE with the vocab dim split over the model axis, under one
    ``local_map``: each rank reduces its vocab slice; a max over the axis
    of the detached row max (the log-sum-exp is shift-invariant, so
    treating the max as a constant gives exact gradients), then sums of
    the exponentials and of the target logit.  No rank gathers the full
    logits."""
    from torch.distributed.tensor import Replicate, Shard
    mesh, m = ctx.mesh, ctx.model_axis
    dp = Shard(0) if logits.shape[0] % ctx.dp_size == 0 else Replicate()

    def body(lg, tg):
        lg = f32(lg)
        v_loc = lg.shape[-1]
        off = shd.axis_index(mesh, m) * v_loc
        lmax = shd.reduce_from(lg.amax(-1), mesh, m, "max")
        z = torch.exp(lg - lmax[..., None])
        denom = shd.reduce_from(z.sum(-1), mesh, m)
        idx = tg.long() - off
        ok = (idx >= 0) & (idx < v_loc)
        ll_loc = torch.take_along_dim(
            lg, idx.clamp(0, v_loc - 1)[..., None], dim=-1)[..., 0]
        ll = shd.reduce_from(torch.where(ok, ll_loc, 0.0), mesh, m)
        return torch.log(denom) + lmax - ll

    lg_plc = blocks._plc(ctx, dp, Shard(2))
    return shd.local_map(
        body, mesh=mesh,
        in_placements=(lg_plc, blocks._plc(ctx, dp, Replicate())),
        out_placements=blocks._plc(ctx, dp, Replicate()),
        in_grad_placements=(lg_plc, None))(logits, targets)


def _ce_sharded_rows(logits, targets, ctx: RunContext):
    """Per-token CE of logits whose vocab is whole on every rank."""
    from torch.distributed.tensor import Replicate, Shard
    dp = Shard(0) if logits.shape[0] % ctx.dp_size == 0 else Replicate()
    plc = blocks._plc(ctx, dp, Replicate())
    return shd.local_map(_ce, mesh=ctx.mesh, in_placements=(plc, plc),
                         out_placements=plc,
                         in_grad_placements=(plc, None))(logits, targets)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: Optional[torch.Tensor], chunk: int = 0,
                  ctx: Optional[RunContext] = None) -> torch.Tensor:
    """Stable cross-entropy of (B, S, V) logits against (B, S) targets in
    float32: the mean over positions, or over ``mask``-weighted positions
    (divided by at least 1).  ``chunk`` evaluates ``chunk`` positions at a
    time when it divides S (the same per-position values).  On a mesh
    (DTensor logits) a vocab that divides the model axis takes
    :func:`_ce_vocab_sharded`; the means are DTensor reductions."""
    if ctx is not None and ctx.mesh is not None:
        if logits.shape[-1] % ctx.model_size == 0:
            losses = _ce_vocab_sharded(logits, targets, ctx)
        else:
            losses = _ce_sharded_rows(logits, targets, ctx)
    else:
        s = logits.shape[1]
        if chunk and s % chunk == 0 and s > chunk:
            losses = torch.cat([_ce(logits[:, i:i + chunk],
                                    targets[:, i:i + chunk])
                                for i in range(0, s, chunk)], dim=1)
        else:
            losses = _ce(logits, targets)
    if mask is None:
        loss = losses.mean()
    else:
        mask = mask.float()
        loss = (losses * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    if ctx is not None and ctx.mesh is not None:
        from torch.distributed.tensor import Replicate
        loss = loss.redistribute(ctx.mesh, [Replicate()] * ctx.mesh.ndim)
    return loss


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
    ``cache_capacity``).  On a mesh everything in and out is a DTensor."""
    if mode not in ("train", "prefill"):
        raise ValueError(f"forward: mode must be 'train' or 'prefill', "
                         f"got {mode!r}")
    with span("model.embed"):
        x, positions, prefix_len = embed_inputs(cfg, params, batch, ctx)
        seq_ax = ctx.model_axis if (ctx.mesh is not None and ctx.zero_sp) \
            else None
        x = constrain(x, ctx, seq_ax, None)
        rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    x, per_layer, aux = apply_stack(cfg, params, x, ctx, rope, None, mode,
                                    prefix_len, None, cache_capacity)
    if mode == "prefill":
        with span("model.unembed"):
            x = constrain(x, ctx, None, None)
            logits = unembed(cfg, params, x[:, -1:], ctx)
        return logits[:, 0], _stack_caches(cfg, per_layer)
    logits = unembed(cfg, params, x, ctx)
    if cfg.frontend == "vision":
        logits = logits[:, prefix_len:]      # loss over the text suffix only
    loss = cross_entropy(logits, batch["targets"], batch.get("loss_mask"),
                         ctx.loss_chunk, ctx)
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
    with span("model.embed"):
        x = embed_tokens(cfg, params, tokens, ctx)
        if block_tables is None:
            pos = int(pos)
            rows = 1 if ctx.mesh is not None else x.shape[0]
            positions = torch.full((rows, 1), pos, device=x.device)
        else:
            positions = pos[:, None]
        rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    x, per_layer, _ = apply_stack(cfg, params, x, ctx, rope, cache,
                                  "decode", 0, pos,
                                  block_tables=block_tables,
                                  block_size=block_size)
    if has_state_rows(cfg):
        cache = _stack_caches(cfg, per_layer, kv_from=cache)
    with span("model.unembed"):
        return unembed(cfg, params, x, ctx)[:, 0], cache


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
        with span("model.embed"):
            live = t < steps_left
            eff_tables = torch.where(live[:, None], tables, 0)
            eff_pos = torch.where(live, torch.clamp(cur, max=capacity - 1),
                                  0)
        logits, cache = decode_step(cfg, params, cache, tok[:, None],
                                    _i32(eff_pos), ctx,
                                    block_tables=_i32(eff_tables),
                                    block_size=block_size)
        with span("model.unembed"):
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
        with span("model.embed"):
            live = t < n_tokens
            eff_tables = torch.where(live[:, None], tables, 0)
            eff_pos = torch.where(
                live, torch.clamp(pos0 + t, max=capacity - 1), 0)
        logits, cache = decode_step(cfg, params, cache, toks[:, t:t + 1],
                                    _i32(eff_pos), ctx,
                                    block_tables=_i32(eff_tables),
                                    block_size=block_size)
        with span("model.unembed"):
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
    with span("model.embed"):
        x = embed_tokens(cfg, params, tokens)
        c = x.shape[1]
        pos0 = _i32(pos0)
        n_live = _i32(n_live)
        positions = torch.clamp(
            pos0[:, None] + torch.arange(c, device=x.device),
            max=capacity - 1)
        rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    x, _, _ = apply_stack(cfg, params, x, ctx, rope, cache, "chunk", 0,
                          (pos0, n_live), capacity, _i32(block_tables),
                          block_size)
    with span("model.unembed"):
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
        with span("model.embed"):
            n_live = torch.clamp(n_tokens - base, 0, chunk)
            eff_tables = torch.where((n_live > 0)[:, None], tables, 0)
        logits, cache = chunk_step(cfg, params, cache,
                                   toks[:, base:base + chunk], pos0 + base,
                                   n_live, ctx, block_tables=eff_tables,
                                   block_size=block_size, capacity=capacity)
        with span("model.unembed"):
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
        with span("model.embed"):
            n_live = torch.clamp(sfx_n - base, 0, chunk)
            eff_stables = torch.where((n_live > 0)[:, None], stables, 0)
        logits_c, cache = chunk_step(cfg, params, cache,
                                     stoks[:, base:base + chunk],
                                     sfx_pos0 + base, n_live, ctx,
                                     block_tables=eff_stables,
                                     block_size=block_size,
                                     capacity=capacity)
        with span("model.unembed"):
            nxt_c = _i32(torch.argmax(logits_c, -1))
            done_here = (sfx_n > base) & (sfx_n <= base + chunk)
            first = torch.where(done_here, nxt_c, first)
        with span("model.embed"):
            live = t < steps_left
            eff_tables = torch.where(live[:, None], tables, 0)
            eff_pos = torch.where(live, torch.clamp(cur, max=capacity - 1),
                                  0)
        logits, cache = decode_step(cfg, params, cache, tok[:, None],
                                    _i32(eff_pos), ctx,
                                    block_tables=_i32(eff_tables),
                                    block_size=block_size)
        with span("model.unembed"):
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
