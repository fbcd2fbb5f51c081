"""Mixture-of-Experts layer: top-k routing + sort-based capacity dispatch.

On a mesh (``plan`` set by ``blocks._block_sharded``: local tensors) the
routing runs on each rank's tokens, its load-balance statistics summed
over the data axes, and dispatch / compute / combine run in
:func:`_sharded_body`: expert-parallel when the experts split over the
model axis (each rank dispatches its own experts' assignments), else
tensor-parallel over d_ff; one sum over the model axis combines.  Training
gathers the expert weights over ``data`` at the block boundary (FSDP);
serving (:func:`_dispatch_contract_sharded`) keeps them resident with a
d_model slice per data rank and sums the up-projection's partial products
over ``data`` before the nonlinearity.

Numerics follow the reference step by step: router logits and softmax in
IEEE float32 (never TF32); top-k by a stable descending sort, so ties go
to the lower expert id as ``lax.top_k`` does; the up and gate products
stay float32 into the activation (:func:`layers.bmm_f32`), ``act(g) * h``
is rounded to the activation dtype once, and the down product is
accumulated in float32, then rounded.  The combine adds each token's k
weighted expert outputs in ascending expert id, one add at a time in the
activation dtype, the order of the reference's scatter-add; no atomics,
so two calls on the same inputs give the same bits.

Training runs the same layer at ``ctx.moe_capacity_factor`` (1.25, the
reference's training factor) and returns the load-balance loss; autograd
reaches the routing weights (through the sort's values) and the expert
products, and a dropped assignment reads the zero row, so its expert
gradients are exact zeros.
"""
from __future__ import annotations

import contextlib
from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models.context import RunContext
from repro_torch.models.layers import _ACTS, bmm_f32
from repro_torch.models.spec import ParamSpec


def moe_specs(cfg: ModelConfig):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    sp = {
        "router": ParamSpec((d, e), ("embed", "experts_r"), torch.float32),
        "wi": ParamSpec((e, d, f), ("experts", "embed", "mlp"), fan_in=d),
        "wo": ParamSpec((e, f, d), ("experts", "mlp", "embed"), fan_in=f),
    }
    if cfg.mlp_gated:
        sp["wg"] = ParamSpec((e, d, f), ("experts", "embed", "mlp"),
                             fan_in=d)
    return sp


@contextlib.contextmanager
def _ieee_float32():
    """float32 matmuls on the card without TF32, whatever the global
    setting; restored on exit."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``: values in descending order, ties to the lower index
    (``torch.topk`` promises no tie order; a stable sort does)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(x2d: torch.Tensor, router: torch.Tensor, cfg: ModelConfig,
           plan=None):
    """x2d: (T, D) -> weights (T, k) float32, ids (T, k), aux-loss scalar.
    On a mesh with the batch split over the data axes the load-balance
    statistics are summed over them: aux is the global batch's."""
    with _ieee_float32():
        logits = torch.matmul(x2d.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    weights, ids = _top_k(probs, cfg.top_k)
    # Mixtral renormalizes over the top-k; OLMoE does not.
    if cfg.name.startswith("mixtral"):
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-9)
    # load-balance auxiliary loss (Switch-style): E * sum_e f_e * p_e
    t = x2d.shape[0]
    flat = ids.reshape(-1)
    counts = torch.zeros(cfg.n_experts, dtype=torch.float32,
                         device=ids.device).index_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32,
                            device=ids.device))
    if plan is not None and plan.batch_sharded:
        counts = shd.reduce_from(counts, plan.mesh, plan.dp_axes)
        p_sum = shd.reduce_from(probs.sum(0), plan.mesh, plan.dp_axes)
        t = t * shd.axis_size(plan.mesh, plan.dp_axes)
        p_e = p_sum / t
    else:
        p_e = probs.mean(0)
    f_e = counts / (t * cfg.top_k)
    aux = cfg.n_experts * (f_e * p_e).sum()
    return weights, ids, aux


def _capacity(t: int, cfg: ModelConfig, factor: float) -> int:
    cap = int(t * cfg.top_k / cfg.n_experts * factor)
    return max(8, -(-cap // 8) * 8)


def _assign(ids: torch.Tensor, e_offset: int, e_local: int,
            capacity: int):
    """Sort-based slot assignment: (buffer row of each sorted assignment,
    its token, the sort order).  Assignments are stably sorted by expert;
    each expert takes its first ``capacity`` in token order and drops the
    rest, which point at the spare row past the ``e_local * capacity``
    live rows (it reads as zeros)."""
    t, k = ids.shape
    flat_ids = ids.reshape(-1)
    sort_idx = torch.argsort(flat_ids, stable=True)
    s_ids = flat_ids[sort_idx]
    seg_start = torch.searchsorted(s_ids, s_ids, side="left")
    pos_in_e = torch.arange(t * k, device=ids.device) - seg_start
    local = (s_ids >= e_offset) & (s_ids < e_offset + e_local) \
        & (pos_in_e < capacity)
    row = torch.where(local, (s_ids - e_offset) * capacity + pos_in_e,
                      e_local * capacity)
    return row, sort_idx // k, sort_idx


def _buffer(x2d: torch.Tensor, row, tok, e_local: int, capacity: int):
    n_rows = e_local * capacity
    buf = torch.zeros((n_rows + 1, x2d.shape[1]), dtype=x2d.dtype,
                      device=x2d.device)
    buf[row] = x2d[tok]
    return buf[:n_rows].view(e_local, capacity, x2d.shape[1])


def _combine(y_buf: torch.Tensor, weights, row, sort_idx, t: int, k: int,
             dtype) -> torch.Tensor:
    """Each token's k weighted expert outputs added in ascending expert id,
    one add at a time in ``dtype`` (the reference's scatter-add order)."""
    d = y_buf.shape[-1]
    dev = y_buf.device
    y_rows = torch.cat([y_buf.reshape(-1, d),
                        torch.zeros((1, d), dtype=dtype, device=dev)])
    wflat = weights.reshape(-1)[sort_idx].to(dtype)
    contrib = y_rows[row] * wflat[:, None]              # sorted order
    inv = torch.empty_like(sort_idx)
    inv[sort_idx] = torch.arange(t * k, device=dev)
    terms = contrib[torch.sort(inv.view(t, k), dim=-1).values]   # (T, k, D)
    y = torch.zeros((t, d), dtype=dtype, device=dev)
    for j in range(k):
        y = y + terms[:, j]
    return y


def _dispatch_compute_combine(x2d, weights, ids, wi, wg, wo, *,
                              cfg: ModelConfig, e_offset: int, e_local: int,
                              capacity: int):
    """Sort-based capacity dispatch.

    x2d: (T, D); ids: (T, k) expert ids; wi: (e_local, D, F) etc.
    Returns the output (T, D) in x2d's dtype: the contributions of experts
    ``e_offset .. e_offset + e_local - 1``."""
    t, k = ids.shape
    row, tok, sort_idx = _assign(ids, e_offset, e_local, capacity)
    buf = _buffer(x2d, row, tok, e_local, capacity)
    act = _ACTS[cfg.mlp_act]
    h = bmm_f32(buf, wi)
    if wg is not None:
        h = act(bmm_f32(buf, wg)) * h
    else:
        h = act(h)
    y_buf = bmm_f32(h.to(x2d.dtype), wo).to(x2d.dtype)
    return _combine(y_buf, weights, row, sort_idx, t, k, x2d.dtype)


def _dispatch_contract_sharded(x2d, weights, ids, wi, wg, wo, *,
                               cfg: ModelConfig, e_offset: int, e_local: int,
                               capacity: int, plan):
    """Serving MoE: wi/wg hold a d_model slice (split over ``data``); the
    up-projection's partial products are summed over ``data`` before the
    nonlinearity; wo is resident with the full d_model output.  Every
    data rank must hold the same tokens (the caller gathers them)."""
    t, k = ids.shape
    d_loc = wi.shape[1]
    didx = shd.axis_index(plan.mesh, "data")
    x_slice = x2d.narrow(1, didx * d_loc, d_loc)
    row, tok, sort_idx = _assign(ids, e_offset, e_local, capacity)
    buf = _buffer(x_slice, row, tok, e_local, capacity)
    act = _ACTS[cfg.mlp_act]
    h = shd.reduce_from(bmm_f32(buf, wi), plan.mesh, "data")
    if wg is not None:
        h = act(shd.reduce_from(bmm_f32(buf, wg), plan.mesh, "data")) * h
    else:
        h = act(h)
    y_buf = bmm_f32(h.to(x2d.dtype), wo).to(x2d.dtype)
    return _combine(y_buf, weights, row, sort_idx, t, k, x2d.dtype)


def _sharded_body(x2d, weights, ids, wi, wg, wo, *, cfg: ModelConfig,
                  capacity: int, plan):
    """One rank's share of the layer on local tensors: expert-parallel
    (``wi`` holds this rank's experts) when the experts split over the
    model axis, else tensor-parallel (every expert, a d_ff slice); the
    partial outputs are summed over the model axis.  ``x2d`` and the
    routing weights enter through ``copy_to``: their gradients are summed
    over the ranks that each used them for their own experts."""
    mesh, m = plan.mesh, plan.model_axis
    if cfg.n_experts % plan.model_size == 0:
        e_local = wi.shape[0]
        e_offset = plan.model_rank * e_local
    else:
        e_local, e_offset = cfg.n_experts, 0
    if plan.fsdp:
        y = _dispatch_compute_combine(
            shd.copy_to(x2d, mesh, m), shd.copy_to(weights, mesh, m), ids,
            wi, wg, wo, cfg=cfg, e_offset=e_offset, e_local=e_local,
            capacity=capacity)
    else:
        y = _dispatch_contract_sharded(
            x2d, weights, ids, wi, wg, wo, cfg=cfg, e_offset=e_offset,
            e_local=e_local, capacity=capacity, plan=plan)
    return shd.reduce_from(y, mesh, m)


def moe_apply(params: dict, x: torch.Tensor, cfg: ModelConfig,
              ctx: RunContext, plan=None) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """x: (B, S, D) -> (y, aux_loss).  Every row of the call is routed
    (pad columns and dead rows included), and the capacity counts them
    all, as in the reference.  With ``plan`` (on a mesh) ``x`` and the
    parameters are local shards: the capacity is per shard (this rank's
    tokens into the global expert pool) in training; serving gathers the
    data ranks' tokens first and sizes it on all of them."""
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    if plan is not None:
        weights, ids, aux = _route(x2d, params["router"], cfg, plan)
        return _moe_sharded(params, x2d, weights, ids, cfg, ctx,
                            plan).reshape(b, s, d), aux
    weights, ids, aux = _route(x2d, params["router"], cfg)
    cap = _capacity(b * s, cfg, ctx.moe_capacity_factor)
    y = _dispatch_compute_combine(
        x2d, weights, ids, params["wi"], params.get("wg"), params["wo"],
        cfg=cfg, e_offset=0, e_local=cfg.n_experts, capacity=cap)
    return y.reshape(b, s, d), aux


def _moe_sharded(params: dict, x2d, weights, ids, cfg: ModelConfig,
                 ctx: RunContext, plan):
    """The mesh branch of :func:`moe_apply` on local (T, D) tokens."""
    wg = params.get("wg")
    if plan.fsdp:
        cap = _capacity(x2d.shape[0], cfg, ctx.moe_capacity_factor)
        return _sharded_body(x2d, weights, ids, params["wi"], wg,
                             params["wo"], cfg=cfg, capacity=cap, plan=plan)
    # serving: the sum over ``data`` adds d_model slices of one token, so
    # every data rank takes all the data ranks' tokens
    gather = plan.batch_sharded and "data" in plan.dp_axes
    if gather:
        x2d, weights, ids = (shd.gather_from(t, plan.mesh, "data", 0)
                             for t in (x2d, weights, ids))
    cap = _capacity(x2d.shape[0], cfg, ctx.moe_capacity_factor)
    y = _sharded_body(x2d, weights, ids, params["wi"], wg, params["wo"],
                      cfg=cfg, capacity=cap, plan=plan)
    return shd.split_to(y, plan.mesh, "data", 0) if gather else y
