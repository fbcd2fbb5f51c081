"""int8 quantization: the compressed KV handoff and gradient compression
with error feedback.

The disaggregated prefill -> decode handoff ships each gathered block as
an int8 payload plus one float32 scale per (block, head) instead of the
full-width block (docs/architecture.md ADR-009).  Gradients quantize per
tensor (:func:`quantize_int8`), carrying the rounding error into the next
step (:func:`init_error_feedback` starts the residuals).  Rounding is half
to even (``torch.round``), scales are ``amax / 127 + 1e-12`` in float32
and the payload is clipped to +-127, so an all-zero block maps to exact
zeros.  :func:`compressed_psum` is the error-feedback all-reduce over a
mesh axis that the data-parallel trainer runs on local tensors (inside
``local_map``): an int8 all-gather plus a gather of the float32 scales,
summed dequantized and divided by the number of ranks.
"""
from __future__ import annotations

from typing import Tuple

import torch


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor int8: ``(q int8, scale float32 scalar)``."""
    scale = g.float().abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(g.float() / scale), -127, 127)
    return q.to(torch.int8), scale.float()


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_feedback(params):
    """Zero float32 residuals beside every parameter of a nested dict."""
    if isinstance(params, dict):
        return {k: init_error_feedback(v) for k, v in params.items()}
    return torch.zeros_like(params, dtype=torch.float32)


def kv_quant_axes(ndim: int) -> Tuple[int, ...]:
    """Reduction axes of per-(block, head) scales over gathered blocks laid
    out ``(n_blocks, block_size, n_kv_heads, head_dim)``: every axis but 0
    and the head axis at -2; leaves with ndim < 3 get per-block scales."""
    if ndim >= 3:
        return tuple(i for i in range(1, ndim) if i != ndim - 2)
    return tuple(range(1, ndim))


def quantize_kv_blocks(blocks: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(block, head) int8 quantization of gathered KV blocks ``(n,
    ...)``.  Returns ``(q int8, scales float32)``, the scales keepdims-
    shaped so they broadcast against ``blocks``."""
    v = blocks.float()
    axes = kv_quant_axes(blocks.dim())
    amax = v.abs().amax(dim=axes, keepdim=True) if axes else v.abs()
    scale = amax / 127.0 + 1e-12
    q = torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def dequantize_kv_blocks(q: torch.Tensor, scale: torch.Tensor,
                         dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`quantize_kv_blocks`, cast to the pool dtype."""
    return (q.float() * scale).to(dtype)


def compressed_psum(g: torch.Tensor, residual: torch.Tensor, axis_name: str,
                    *, mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 mean over ``axis_name`` of ``mesh``.

    Wire bytes: 1 per element (the int8 all-gather) + 4 per rank (the
    scales), against 4 per element for the float32 all-reduce it
    replaces.  Returns (the mean of the ranks' dequantized values, this
    rank's new residual)."""
    from repro_torch.distributed.sharding import _all_gather
    v = g.float() + residual
    q, scale = quantize_int8(v)
    new_residual = v - dequantize_int8(q, scale)
    qs = _all_gather(q[None], mesh, axis_name, 0)              # (k, ...)
    scales = _all_gather(scale.reshape(1), mesh, axis_name, 0)  # (k,)
    summed = torch.tensordot(scales, qs.float(), dims=([0], [0]))
    return summed / qs.shape[0], new_residual


def tree_compressed_pmean(grads, residuals, axis_name: str, *, mesh):
    """:func:`compressed_psum` over every leaf of a nested dict: (means,
    residuals), each of the input's structure."""
    if isinstance(grads, dict):
        out = {k: tree_compressed_pmean(grads[k], residuals[k], axis_name,
                                        mesh=mesh) for k in grads}
        return ({k: v[0] for k, v in out.items()},
                {k: v[1] for k, v in out.items()})
    return compressed_psum(grads, residuals, axis_name, mesh=mesh)
