"""RG-LRU recurrent block (Griffin / recurrentgemma).

Plain path (``impl="torch"``): the gates in float32, then the recurrence
as a sequential scan over S (:func:`linear_scan`; torch has no
``associative_scan``, and the reference's log-depth scan would round in
another order than the kernel).  Kernel path (``impl="cuda"``): the
hand-written scan ``ops.rglru_scan`` (``kernels/csrc/rglru_scan.cu``),
which rounds every step as :func:`linear_scan` does, so the two paths agree
bit for bit in these layers.  Decode runs :func:`rglru_step` in plain
tensor ops on both paths.  Mode ``"train"`` is the prefill math without a
cache; its gradients pass only through the plain path (the kernel refuses
them).

Block structure (Griffin, arXiv:2402.19427):
    y = W_out[ RG-LRU(conv1d(x W_x)) * gelu(x W_y) ]
    r_t = sigmoid(x_t W_a);  i_t = sigmoid(x_t W_i)
    a_t = exp(-c * softplus(Lambda) * r_t),  c = 8
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Caches are replaced, never written in place: a step closure that an
executor re-runs reads the same state both times.

On a mesh (``tp`` = (mesh, model axis), from ``blocks._block_sharded``)
the block holds this rank's R/M lru channels: every ``lru`` weight, the
state and the conv carry.  The two gate products contract the whole
width, so the conv output is all-gathered over the axis for them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops
from repro_torch.models.context import RunContext
from repro_torch.models.layers import matmul_f32
from repro_torch.models.spec import ParamSpec

_C = 8.0


def rglru_specs(cfg: ModelConfig):
    d = cfg.d_model
    r = cfg.d_model                     # lru_width = d_model
    w = cfg.conv1d_width
    return {
        "wx": ParamSpec((d, r), ("embed", "lru")),
        "wy": ParamSpec((d, r), ("embed", "lru")),
        "conv_w": ParamSpec((w, r), (None, "lru"), fan_in=w),
        "conv_b": ParamSpec((r,), ("lru",), init="zeros"),
        "wa": ParamSpec((r, r), ("lru_in", "lru")),
        "ba": ParamSpec((r,), ("lru",), init="zeros"),
        "wi": ParamSpec((r, r), ("lru_in", "lru")),
        "bi": ParamSpec((r,), ("lru",), init="zeros"),
        "lam": ParamSpec((r,), ("lru",), init="ones"),
        "wout": ParamSpec((r, d), ("lru", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 carry: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x: (B,S,R); w: (W,R); carry: (B,W-1,R).

    The reference's order in the activation dtype: the W products summed
    left to right, then the bias."""
    width = w.shape[0]
    if carry is None:
        carry = torch.zeros((x.shape[0], width - 1, x.shape[-1]),
                            dtype=x.dtype, device=x.device)
    xp = torch.cat([carry, x], dim=1)
    s = x.shape[1]
    y = sum(xp[:, i:i + s] * w[i] for i in range(width)) + b
    return y.to(x.dtype), xp[:, -(width - 1):]


def _gates(xc: torch.Tensor, p: dict, xg: Optional[torch.Tensor] = None):
    """Returns (a, mult*i*xc) in fp32 — the linear-recurrence coefficients.
    ``xg`` is the gate products' input (default ``xc``): on a mesh the
    whole width gathered, where ``xc`` holds this rank's channels."""
    xf = xc.float()
    xgf = xf if xg is None else xg.float()
    rg = torch.sigmoid(torch.matmul(xgf, p["wa"].float()) + p["ba"].float())
    ig = torch.sigmoid(torch.matmul(xgf, p["wi"].float()) + p["bi"].float())
    log_a = -_C * F.softplus(p["lam"].float()) * rg
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6))
    return a, mult * ig * xf


def linear_scan(a: torch.Tensor, b: torch.Tensor,
                h0: Optional[torch.Tensor]):
    """``h_t = a_t h_{t-1} + b_t`` over S, one rounded multiply and add per
    step. a, b: (B,S,R) fp32; h0: (B,R) fp32 or None (zeros).  Returns
    (h (B,S,R) fp32, h_last (B,R) fp32)."""
    h = (torch.zeros_like(a[:, 0]) if h0 is None else h0.float())
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h


def rglru_scan_ref(xc: torch.Tensor, p: dict, h0: Optional[torch.Tensor],
                   xg: Optional[torch.Tensor] = None):
    """Full-sequence recurrence on the plain path. xc: (B,S,R)."""
    a, b = _gates(xc, p, xg)
    h, h_last = linear_scan(a, b, h0)
    return h.to(xc.dtype), h_last


def rglru_step(xc: torch.Tensor, p: dict, h0: torch.Tensor,
               xg: Optional[torch.Tensor] = None):
    """Single decode step. xc: (B,1,R); h0: (B,R) fp32."""
    a, b = _gates(xc, p, xg)
    h = a[:, 0] * h0 + b[:, 0]
    return h[:, None].to(xc.dtype), h


def rglru_block_apply(params: dict, x: torch.Tensor, cfg: ModelConfig,
                      ctx: RunContext, cache: Optional[dict], mode: str,
                      tp=None):
    """x: (B,S,D) -> (y, new_cache). cache = {"h": (B,R) f32, "conv":
    (B,W-1,R)}.  The gelu gate takes the float32 product
    (``layers.matmul_f32``), as the reference does; ``xb`` is rounded to
    the activation dtype.  With ``tp`` every width is this rank's R/M
    channels: ``x`` enters with f, the conv output is gathered whole for
    the gate products (its gradient reduce-scattered back), and the
    ``wout`` product leaves summed over the axis (g)."""
    if tp is not None:
        x = shd.copy_to(x, *tp)
    gate = F.gelu(matmul_f32(x, params["wy"]), approximate="tanh").to(x.dtype)
    xb = torch.matmul(x, params["wx"])
    conv_carry = cache["conv"] if cache is not None else None
    xc, new_conv = _causal_conv(xb, params["conv_w"], params["conv_b"],
                                conv_carry)
    xg = None if tp is None else shd.gather_from(xc, *tp, 2, partial=True)
    h0 = cache["h"] if cache is not None else None
    if mode == "decode":
        h_seq, h_last = rglru_step(xc, params, h0, xg)
    elif ctx.impl == "cuda":
        a, b = _gates(xc, params, xg)
        h_seq, h_last = ops.rglru_scan(a, b, h0=h0, out_dtype=xc.dtype)
    else:
        h_seq, h_last = rglru_scan_ref(xc, params, h0, xg)
    y = torch.matmul(h_seq * gate, params["wout"])
    if tp is not None:
        y = shd.reduce_from(y, *tp)
    new_cache = None
    if cache is not None or mode == "prefill":
        new_cache = {"h": h_last, "conv": new_conv}
    return y, new_cache


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device=None) -> dict:
    """Zero state: ``h`` (batch, R) float32 and the conv carry (batch,
    W-1, R) in the activation dtype."""
    r, w = cfg.d_model, cfg.conv1d_width
    return {"h": torch.zeros((batch, r), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, w - 1, r), dtype=dtype,
                                device=device)}
