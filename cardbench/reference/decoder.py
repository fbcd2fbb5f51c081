"""Plain PyTorch reference of a decoder-only transformer with grouped-query
attention and a dense gated or a mixture-of-experts feed-forward, as the
port serves them: the qwen2.5-3b configuration, and a mixture of experts
such as OLMoE-1B-7B (without its QK-norm, which the port lacks).

It imports nothing of the program: it takes the configuration file's
numbers, the benchmark's weights (the tree of ``bench.weights``) and token
ids, and works out the logits at every position of one sequence from
scratch, with no cache, no batching and no kernel, one layer at a time
(each layer's weights widened to float32 in turn, so it fits beside the
served model), attention over query chunks.  float32 throughout, TF32
off.

What it computes, per layer (pre-norm residual blocks):

- RMSNorm with the scale read as ``1 + scale``, eps ``rms_norm_eps``;
- q, k, v projections (plus biases where the tree has them), rotary
  embedding (rotate-half, base ``rope_theta``, float32), causal softmax
  attention with 1/sqrt(head_dim) scaling, each KV head shared by
  ``num_attention_heads / num_key_value_heads`` query heads, the output
  projection;
- feed-forward ``wo(silu(x wg) * (x wi))``; for a mixture of experts the
  router's float32 softmax over all experts, the ``num_experts_per_tok``
  largest probabilities (ties to the lower expert id), their weights used
  as they are (renormalised only where ``norm_topk_prob`` is true), each
  token through only its chosen experts;
- final RMSNorm and the unembedding (the embedding's transpose when tied).

``precision="fp8"`` is the control: every projection and expert product
of the blocks takes its operands rounded to float8 e4m3 (weights per
output channel, activations per token, each scaled by its largest
magnitude over 448) and accumulates in float32; the router, attention,
norms and the unembedding stay float32.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

FP8_MAX = 448.0


@contextlib.contextmanager
def _no_tf32():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (its largest magnitude maps to 448), back in float32."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def _lin(x: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    """x (..., in) @ w (in, out) in float32."""
    if fp8:
        return _fp8(x, -1) @ _fp8(w, 0)
    return x @ w


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale.float())


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x (T, H, D); cos/sin (T, D/2)."""
    half = x.shape[-1] // 2
    a, b = x[..., :half], x[..., half:]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat([a * c - b * s, b * c + a * s], dim=-1)


def _attention(q, k, v, q_chunk: int) -> torch.Tensor:
    """Causal attention, q (T, Hq, D), k/v (T, Hkv, D) -> (T, Hq*D)."""
    t, hq, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    out = torch.empty((t, hq, d), dtype=torch.float32, device=q.device)
    kt = k.permute(1, 2, 0)                            # (Hkv, D, T)
    vt = v.permute(1, 0, 2)                            # (Hkv, T, D)
    for s in range(0, t, q_chunk):
        e = min(t, s + q_chunk)
        qc = q[s:e].reshape(e - s, hkv, g, d).permute(1, 2, 0, 3)
        qc = qc.reshape(hkv, g * (e - s), d)            # (Hkv, g*c, D)
        sc = (qc @ kt[:, :, :e]) * d ** -0.5            # (Hkv, g*c, e)
        qpos = torch.arange(s, e, device=q.device).repeat(g)
        mask = torch.arange(e, device=q.device)[None, :] > qpos[:, None]
        sc.masked_fill_(mask[None], float("-inf"))
        o = torch.softmax(sc, dim=-1) @ vt[:, :e]       # (Hkv, g*c, D)
        o = o.reshape(hkv, g, e - s, d).permute(2, 0, 1, 3)
        out[s:e] = o.reshape(e - s, hq, d)
    return out.reshape(t, hq * d)


def _moe(h: torch.Tensor, lw: Dict, conf: dict, fp8: bool) -> torch.Tensor:
    router = lw["ffn"]["router"].float()
    probs = torch.softmax(h @ router, dim=-1)          # router: float32
    k = conf["num_experts_per_tok"]
    top, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    top, ids = top[:, :k], ids[:, :k]
    if conf.get("norm_topk_prob", False):
        top = top / top.sum(-1, keepdim=True)
    y = torch.zeros_like(h)
    for e in torch.unique(ids).tolist():
        rows, slot = torch.nonzero(ids == e, as_tuple=True)
        x = h[rows]
        wi = lw["ffn"]["wi"][e].float()
        wg = lw["ffn"]["wg"][e].float()
        wo = lw["ffn"]["wo"][e].float()
        ye = _lin(torch.nn.functional.silu(_lin(x, wg, fp8))
                  * _lin(x, wi, fp8), wo, fp8)
        y.index_add_(0, rows, ye * top[rows, slot][:, None])
    return y


def _layer(params: Dict, i: int) -> Dict:
    """Layer i's leaves of the stacked tree, widened to float32."""
    def take(node):
        return {k: take(v) if isinstance(v, dict) else v[i].float()
                for k, v in node.items()}
    return take(params["layers"]["stack"]["b0"])


@torch.no_grad()
def logits(conf: dict, params: Dict, tokens: torch.Tensor, first: int,
           precision: str = "float32", q_chunk: int = 1024) -> torch.Tensor:
    """float32 logits (T - first, vocab) at positions first .. T-1 of the
    token sequence ``tokens`` (T,), computed on ``tokens.device``."""
    if precision not in ("float32", "fp8"):
        raise ValueError(f"precision {precision!r}")
    fp8 = precision == "fp8"
    eps = float(conf["rms_norm_eps"])
    hq, hkv = conf["num_attention_heads"], conf["num_key_value_heads"]
    n = conf["head_dim"]
    t = tokens.shape[0]
    dev = tokens.device
    with _no_tf32():
        x = params["embed"][tokens.long()].float()
        half = n // 2
        inv = float(conf["rope_theta"]) ** (
            -torch.arange(half, dtype=torch.float32, device=dev) / half)
        ang = torch.arange(t, dtype=torch.float32, device=dev)[:, None] * inv
        cos, sin = torch.cos(ang), torch.sin(ang)
        for i in range(conf["num_hidden_layers"]):
            lw = _layer(params, i)
            a = lw["attn"]
            h = _rms(x, lw["norm1"]["scale"], eps)
            q = _lin(h, a["wq"].reshape(h.shape[1], -1), fp8)
            k = _lin(h, a["wk"].reshape(h.shape[1], -1), fp8)
            v = _lin(h, a["wv"].reshape(h.shape[1], -1), fp8)
            if "bq" in a:
                q = q + a["bq"].reshape(-1)
                k = k + a["bk"].reshape(-1)
                v = v + a["bv"].reshape(-1)
            q = _rope(q.view(t, hq, n), cos, sin)
            k = _rope(k.view(t, hkv, n), cos, sin)
            o = _attention(q, k, v.view(t, hkv, n), q_chunk)
            x = x + _lin(o, a["wo"].reshape(hq * n, -1), fp8)
            h = _rms(x, lw["norm2"]["scale"], eps)
            if "router" in lw["ffn"]:
                x = x + _moe(h, lw, conf, fp8)
            else:
                f = lw["ffn"]
                x = x + _lin(torch.nn.functional.silu(_lin(h, f["wg"], fp8))
                             * _lin(h, f["wi"], fp8), f["wo"], fp8)
            del lw
        h = _rms(x[first:], params["final_norm"]["scale"], eps)
        head: Optional[torch.Tensor] = params.get("head")
        if head is None:
            return h @ params["embed"].float().t()
        return h @ head.float()
