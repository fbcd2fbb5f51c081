"""RWKV-6 "Finch" block: data-dependent-decay WKV recurrence + channel mix.

Plain path (``impl="torch"``): the chunked-parallel WKV evaluation below
(numerically stable: all decay products are <= 1).  Kernel path
(``impl="cuda"``): the hand-written WKV scan ``ops.rwkv6_scan``
(``kernels/csrc/rwkv6_scan.cu``), held to :func:`wkv6_chunked_ref`.
Decode runs :func:`wkv6_step` in plain tensor ops on both paths.  Mode
``"train"`` is the prefill math without a cache; its gradients pass only
through the plain path (the kernel refuses them).

Recurrence (per head, state S in R^{N_k x N_v}):
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
with w_t = exp(-exp(w0 + tanh(x_w A) B)) data-dependent per channel.

Caches are replaced, never written in place: a step closure that an
executor re-runs reads the same state both times.

On a mesh (``tp`` = (mesh, model axis), from ``blocks._block_sharded``)
the time mix holds this rank's heads (``wr/wk/wv/wg`` columns, ``u``,
the group norm and ``wo`` rows, the state's heads) and the channel mix
its slice of d_ff; Megatron's f / g (``distributed.sharding``) mark where
the replicated activation enters the split work and where its partial
sums leave.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops
from repro_torch.models.context import RunContext
from repro_torch.models.layers import f32, matmul_f32
from repro_torch.models.spec import ParamSpec

_LORA_RANK = 64
_CHUNK = 64


def rwkv_time_specs(cfg: ModelConfig):
    d, h, n = cfg.d_model, cfg.n_heads, cfg.head_dim
    return {
        "mu": ParamSpec((5, d), (None, "embed"), torch.float32, init="zeros"),
        "w0": ParamSpec((d,), ("embed",), torch.float32, init="zeros"),
        "wA": ParamSpec((d, _LORA_RANK), ("embed", "rank")),
        "wB": ParamSpec((_LORA_RANK, d), ("rank", "embed"), fan_in=_LORA_RANK),
        "u": ParamSpec((h, n), ("heads", "head_dim"), torch.float32,
                       init="zeros"),
        "wr": ParamSpec((d, h, n), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, h, n), ("embed", "heads", "head_dim")),
        "wv": ParamSpec((d, h, n), ("embed", "heads", "head_dim")),
        "wg": ParamSpec((d, h, n), ("embed", "heads", "head_dim")),
        "gn_scale": ParamSpec((h, n), ("heads", "head_dim"), init="ones"),
        "gn_bias": ParamSpec((h, n), ("heads", "head_dim"), init="zeros"),
        "wo": ParamSpec((h, n, d), ("heads", "head_dim", "embed"),
                        fan_in=h * n),
    }


def rwkv_channel_specs(cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": ParamSpec((d,), ("embed",), torch.float32, init="zeros"),
        "mu_r": ParamSpec((d,), ("embed",), torch.float32, init="zeros"),
        "wk": ParamSpec((d, f), ("embed", "mlp")),
        "wv": ParamSpec((f, d), ("mlp", "embed"), fan_in=f),
        "wr": ParamSpec((d, d), ("embed", "embed_out")),
    }


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """x_{t-1} with the carried last token (or zeros) at t=0."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    else:
        prev = prev[:, None].to(x.dtype)
    return torch.cat([prev, x[:, :-1]], dim=1)


def wkv6_chunked_ref(r, k, v, w, u, s0, chunk: int = _CHUNK):
    """Chunked-parallel WKV. r,k,v,w: (B,S,H,N) — w is the decay in (0,1].

    Returns y: (B,S,H,N), s_final: (B,H,N,N) fp32.  S must be a multiple
    of min(chunk, S) (serving pads prompts to 64 or a multiple of it).
    All decay factors appearing in products are <=1 => numerically stable.
    """
    b, s, h, n = r.shape
    c = min(chunk, s)
    if c == 0 or s % c:
        raise ValueError(f"wkv6_chunked_ref: sequence {s} is not a multiple "
                         f"of the chunk {c}")
    m = s // c
    rs, ks, vs, ws = (f32(a).reshape(b, m, c, h, n) for a in (r, k, v, w))
    lw = torch.log(torch.clamp(ws, min=1e-30))
    cum_incl = torch.cumsum(lw, dim=2)                # log prod_{1..t}
    cum_excl = cum_incl - lw                          # log prod_{1..t-1}
    total = torch.exp(cum_incl[:, :, -1])             # (B,M,H,N)
    uf = f32(u)

    # ---- intra-chunk: scan over the C positions, vectorized over chunks ----
    delta = torch.zeros((b, m, h, n, n), dtype=rs.dtype, device=r.device)
    ys = []
    for t in range(c):
        r_t, k_t, v_t, w_t = rs[:, :, t], ks[:, :, t], vs[:, :, t], ws[:, :, t]
        bonus = torch.einsum("bmhk,hk,bmhk->bmh", r_t, uf, k_t)
        ys.append(torch.einsum("bmhk,bmhkv->bmhv", r_t, delta)
                  + bonus[..., None] * v_t)
        delta = w_t[..., None] * delta + k_t[..., None] * v_t[..., None, :]
    y_intra = torch.stack(ys, dim=2)                  # (B,M,C,H,N)

    # ---- inter-chunk: propagate state across chunks (M sequential steps) ----
    state = (torch.zeros((b, h, n, n), dtype=rs.dtype, device=r.device)
             if s0 is None else f32(s0))
    prefix = []
    for i in range(m):
        prefix.append(state)
        state = total[:, i][..., None] * state + delta[:, i]
    s_prefix = torch.stack(prefix, dim=1)             # (B,M,H,N,N)

    # ---- prefix-state contribution ----
    rq = rs * torch.exp(cum_excl)                     # decays <= 1
    y = y_intra + torch.einsum("bmchk,bmhkv->bmchv", rq, s_prefix)
    return y.reshape(b, s, h, n).to(r.dtype), state


def wkv6_step(r, k, v, w, u, s0):
    """Single decode step. r,k,v,w: (B,1,H,N); s0: (B,H,N,N) fp32."""
    r_, k_, v_, w_ = (f32(a)[:, 0] for a in (r, k, v, w))
    bonus = torch.einsum("bhk,hk,bhk->bh", r_, f32(u), k_)
    y = torch.einsum("bhk,bhkv->bhv", r_, s0) + bonus[..., None] * v_
    s1 = w_[..., None] * s0 + k_[..., None] * v_[..., None, :]
    return y[:, None].to(r.dtype), s1


def _group_norm(y: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """Per-head layer norm. y: (B,S,H,N)."""
    f = f32(y)
    mu = f.mean(-1, keepdim=True)
    var = (f - mu).square().mean(-1, keepdim=True)
    out = (f - mu) * torch.rsqrt(var + 1e-5)
    return (out * f32(scale) + f32(bias)).to(y.dtype)


def _shifted(x: torch.Tensor, prev: Optional[torch.Tensor], mode: str
             ) -> torch.Tensor:
    """The previous token of every position: the token shift over the
    sequence, or the carried token alone at decode."""
    if mode != "decode":
        return _token_shift(x, prev)
    if prev is None:
        return torch.zeros_like(x)
    return prev[:, None].to(x.dtype)


def rwkv_time_apply(params: dict, x: torch.Tensor, cfg: ModelConfig,
                    ctx: RunContext, cache: Optional[dict], mode: str,
                    tp=None):
    """Time-mix. cache = {"prev": (B,D), "s": (B,H,N,N) f32}.

    With ``tp`` the head weights and the state hold this rank's H/M
    heads: ``x`` enters with f, the decay takes the local heads' columns
    of ``w0`` and ``wB`` (``mu`` and ``wA`` whole), and the ``wo``
    product leaves summed over the axis (g)."""
    b, s, d = x.shape
    h, n = params["wr"].shape[1], cfg.head_dim
    cols = slice(None)
    if tp is not None:
        x = shd.copy_to(x, *tp)
        h0 = shd.axis_index(*tp) * h
        cols = slice(h0 * n, (h0 + h) * n)
    prev = cache["prev"] if cache is not None else None
    xp = _shifted(x, prev, mode)
    mu = params["mu"].to(x.dtype)
    xr, xk, xv, xg, xw = (x + (xp - x) * mu[i] for i in range(5))

    def proj(inp, wname):
        return torch.matmul(inp, params[wname].reshape(d, -1)
                            ).reshape(b, s, h, n)

    r, k, v = proj(xr, "wr"), proj(xk, "wk"), proj(xv, "wv")
    g = F.silu(f32(proj(xg, "wg"))).to(x.dtype)
    lora = torch.matmul(torch.tanh(torch.matmul(f32(xw), f32(params["wA"]))),
                        f32(params["wB"][:, cols]))
    w = torch.exp(-torch.exp(f32(params["w0"][cols]) + lora))
    w = w.reshape(b, s, h, n)

    s0 = cache["s"] if cache is not None else None
    if mode == "decode":
        y, s_new = wkv6_step(r, k, v, w, params["u"], s0)
    elif ctx.impl == "cuda":
        y, s_new = ops.rwkv6_scan(r, k, v, w, params["u"], s0=s0)
    else:
        y, s_new = wkv6_chunked_ref(r, k, v, w, params["u"], s0)

    y = _group_norm(y, params["gn_scale"], params["gn_bias"]) * g
    wo = params["wo"]
    out = torch.matmul(y.reshape(b, s, h * n), wo.reshape(h * n, d))
    if tp is not None:
        out = shd.reduce_from(out, *tp)
    new_cache = None
    if cache is not None or mode == "prefill":
        new_cache = {"prev": x[:, -1].float(), "s": s_new}
    return out, new_cache


def rwkv_channel_apply(params: dict, x: torch.Tensor, cfg: ModelConfig,
                       cache: Optional[dict], mode: str, tp=None):
    """Channel-mix. cache = {"prev": (B,D)}.  With ``tp`` ``wk`` / ``wv``
    hold this rank's slice of d_ff: ``xk`` enters it with f and ``vv``
    is summed over the axis (g) before the receptance gate, which runs
    whole (``wr`` replicated)."""
    prev = cache["prev"] if cache is not None else None
    xp = _shifted(x, prev, mode)
    xk = x + (xp - x) * params["mu_k"].to(x.dtype)
    xr = x + (xp - x) * params["mu_r"].to(x.dtype)
    if tp is not None:
        xk = shd.copy_to(xk, *tp)
    kk = torch.square(torch.relu(matmul_f32(xk, params["wk"]))).to(x.dtype)
    vv = torch.matmul(kk, params["wv"])
    if tp is not None:
        vv = shd.reduce_from(vv, *tp)
    rr = torch.sigmoid(matmul_f32(xr, params["wr"]))
    out = (rr * f32(vv)).to(x.dtype)
    new_cache = None
    if cache is not None or mode == "prefill":
        new_cache = {"prev": x[:, -1].float()}
    return out, new_cache


def init_rwkv_cache(cfg: ModelConfig, batch: int, dtype=None,
                    device=None) -> dict:
    """Zero state: the carried token of each mix and the WKV state, all
    float32 whatever the model dtype (``dtype`` is accepted for the
    common cache signature)."""
    h, n, d = cfg.n_heads, cfg.head_dim, cfg.d_model

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {"tm": {"prev": z(batch, d), "s": z(batch, h, n, n)},
            "cm": {"prev": z(batch, d)}}
