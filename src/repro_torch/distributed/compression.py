"""int8 quantization: the compressed KV handoff and gradient compression
with error feedback.

The disaggregated prefill -> decode handoff ships each gathered block as
an int8 payload plus one float32 scale per (block, head) instead of the
full-width block (docs/architecture.md ADR-009).  Gradients quantize per
tensor (:func:`quantize_int8`), carrying the rounding error into the next
step (:func:`init_error_feedback` starts the residuals).  Rounding is half
to even (``torch.round``), scales are ``amax / 127 + 1e-12`` in float32
and the payload is clipped to +-127, so an all-zero block maps to exact
zeros.  The reference's error-feedback all-reduce over a data axis
(``compressed_psum``, ``tree_compressed_pmean``) waits for the port's
mesh (ROADMAP Queue 1 item 10).
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
    return torch.zeros(params.shape, dtype=torch.float32,
                       device=params.device)


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
