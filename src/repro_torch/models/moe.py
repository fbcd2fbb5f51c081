"""Mixture-of-Experts layer: top-k routing + sort-based capacity dispatch.

Single-device only: the reference's sharded bodies (expert-parallel and
tensor-parallel ``shard_map``, ``_sharded_body`` /
``_dispatch_contract_sharded``) wait for the port's sharding slice
(ROADMAP Queue 1 item 10); :class:`~repro_torch.models.context.RunContext`
has no mesh.

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


def _route(x2d: torch.Tensor, router: torch.Tensor, cfg: ModelConfig):
    """x2d: (T, D) -> weights (T, k) float32, ids (T, k), aux-loss scalar."""
    with _ieee_float32():
        logits = torch.matmul(x2d.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    weights, ids = _top_k(probs, cfg.top_k)
    # Mixtral renormalizes over the top-k; OLMoE does not.
    if cfg.name.startswith("mixtral"):
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-9)
    # load-balance auxiliary loss (Switch-style): E * sum_e f_e * p_e
    t = x2d.shape[0]
    counts = torch.bincount(ids.reshape(-1),
                            minlength=cfg.n_experts).float()
    f_e = counts / (t * cfg.top_k)
    p_e = probs.mean(0)
    aux = cfg.n_experts * (f_e * p_e).sum()
    return weights, ids, aux


def _capacity(t: int, cfg: ModelConfig, factor: float) -> int:
    cap = int(t * cfg.top_k / cfg.n_experts * factor)
    return max(8, -(-cap // 8) * 8)


def _dispatch_compute_combine(x2d, weights, ids, wi, wg, wo, *,
                              cfg: ModelConfig, e_offset: int, e_local: int,
                              capacity: int):
    """Sort-based capacity dispatch.

    x2d: (T, D); ids: (T, k) expert ids; wi: (e_local, D, F) etc.
    Assignments are stably sorted by expert; each expert takes its first
    ``capacity`` in token order and drops the rest (their row reads as
    zeros).  Returns the output (T, D) in x2d's dtype."""
    t, d = x2d.shape
    k = ids.shape[-1]
    dev = x2d.device
    flat_ids = ids.reshape(-1)
    sort_idx = torch.argsort(flat_ids, stable=True)
    s_ids = flat_ids[sort_idx]
    seg_start = torch.searchsorted(s_ids, s_ids, side="left")
    pos_in_e = torch.arange(t * k, device=dev) - seg_start
    local = (s_ids >= e_offset) & (s_ids < e_offset + e_local) \
        & (pos_in_e < capacity)
    # buffer row of each assignment; every dropped one points at the
    # spare row past the (e_local * capacity) live rows
    n_rows = e_local * capacity
    row = torch.where(local, (s_ids - e_offset) * capacity + pos_in_e,
                      n_rows)
    tok = sort_idx // k

    buf = torch.zeros((n_rows + 1, d), dtype=x2d.dtype, device=dev)
    buf[row] = x2d[tok]
    buf = buf[:n_rows].view(e_local, capacity, d)

    act = _ACTS[cfg.mlp_act]
    h = bmm_f32(buf, wi)
    if wg is not None:
        h = act(bmm_f32(buf, wg)) * h
    else:
        h = act(h)
    y_buf = bmm_f32(h.to(x2d.dtype), wo).to(x2d.dtype)

    y_rows = torch.cat([y_buf.view(n_rows, d),
                        torch.zeros((1, d), dtype=x2d.dtype, device=dev)])
    wflat = weights.reshape(-1)[sort_idx].to(x2d.dtype)
    contrib = y_rows[row] * wflat[:, None]              # sorted order
    # each token's k assignments at their sorted positions, ascending:
    # ascending expert id, the order the reference adds them in
    inv = torch.empty_like(sort_idx)
    inv[sort_idx] = torch.arange(t * k, device=dev)
    terms = contrib[torch.sort(inv.view(t, k), dim=-1).values]   # (T, k, D)
    y = torch.zeros((t, d), dtype=x2d.dtype, device=dev)
    for j in range(k):
        y = y + terms[:, j]
    return y


def moe_apply(params: dict, x: torch.Tensor, cfg: ModelConfig,
              ctx: RunContext) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux_loss).  Every row of the call is routed
    (pad columns and dead rows included), and the capacity counts them
    all, as in the reference."""
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    weights, ids, aux = _route(x2d, params["router"], cfg)
    cap = _capacity(b * s, cfg, ctx.moe_capacity_factor)
    y = _dispatch_compute_combine(
        x2d, weights, ids, params["wi"], params.get("wg"), params["wo"],
        cfg=cfg, e_offset=0, e_local=cfg.n_experts, capacity=cap)
    return y.reshape(b, s, d), aux
