"""Residual blocks: attention (+ paged, contiguous or ring KV), RG-LRU or
RWKV-6, each with norm + feed-forward.

This covers the dense attention family (full or sliding-window, causal,
bidirectional or prefix-LM) with a dense or mixture-of-experts
feed-forward (``models/moe.py``), RWKV-6 and the RG-LRU hybrid.  Mode
``"train"`` runs the prefill math and writes no cache.

KV caches are updated **in place**: every write is a function of the
step's inputs only (positions, block tables, the tokens' K/V), and
attention always writes before it reads, so re-running a step on the same
inputs leaves the same cache — the serving executors rely on that.
Recurrent state is replaced, never written in place, for the same reason.

With ``ctx.mesh`` set, :func:`block_apply` takes DTensors and runs the
block under one ``local_map`` (:func:`_block_sharded`): every parameter
enters at the placements its use needs (FSDP shards gathered over the data
axes, tensor-parallel shards kept or resharded on the model axis) and the
body runs on local tensors with explicit collectives, Megatron style:
``copy_to`` where a tensor replicated over the model axis enters sharded
work, ``reduce_from`` where partial sums leave it.  A :class:`MeshPlan`
tells the body's functions (:func:`attn_apply`, :func:`_mlp_sharded`,
``moe.moe_apply``, and through ``tp`` the recurrent mixers of
``rwkv6`` / ``rglru``) how their inputs are laid out.  Train, prefill and
contiguous decode run on a mesh; the paged and chunk modes do not.

The recurrent blocks split over the model axis where the reference's
rules place them (``heads``, ``mlp``, ``lru`` -> model) and M divides
the dimension; otherwise that part runs whole on every rank, as the
rules fall back to replication.  Their reductions over the model axis,
each with the gradient leaves it sums:

- RWKV-6 time mix, H/M heads a rank: f on the normed input (its
  backward all-reduce gives ``norm1`` and everything before the block
  their gradient); the ``Partial`` gradients of ``tm/mu``, ``tm/wA``
  (used whole) and ``tm/w0``, ``tm/wB`` (the local heads' columns
  sliced inside the body), reduced by DTensor; g on the ``wo`` product
  (forward only).  ``wr/wk/wv/wg``, ``u``, ``gn_*`` and ``wo`` take no
  model-axis sum: each rank owns its heads' gradients.
- RWKV-6 channel mix, d_ff/M a rank: f on ``xk`` (``cm/mu_k``, and
  ``norm2`` through the key branch); g on the ``wv`` product before
  ``rr * vv`` (forward only).  ``wr`` and ``mu_r`` run whole.
- RG-LRU, R/M channels a rank: f on the normed input (``norm1``); the
  all-gather of the conv output for the gate products, whose backward
  reduce-scatter sums the ``wa`` / ``wi`` branches' share of the
  ``conv_w``, ``conv_b`` and ``wx`` gradients; g on the ``wout``
  product (forward only).  Its dense ``ffn`` is an attention block's
  (:func:`_mlp_sharded`: f on the normed input, ``norm2``; g after
  ``wo``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops
from repro_torch.models import moe, rglru, rwkv6
from repro_torch.models.context import RunContext
from repro_torch.models.layers import (_Q_CHUNK, NEG_INF, apply_norm,
                                       apply_rope, attention_xla, attn_mask,
                                       mlp)
from repro_torch.models.spec import ParamSpec


# --------------------------------------------------------------------------- #
# Specs
# --------------------------------------------------------------------------- #
def norm_specs(cfg: ModelConfig):
    d = cfg.d_model
    if cfg.norm_type == "rmsnorm":
        return {"scale": ParamSpec((d,), ("embed",), init="zeros")}
    return {"scale": ParamSpec((d,), ("embed",), init="ones"),
            "bias": ParamSpec((d,), ("embed",), init="zeros")}


def mlp_specs(cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    sp = {"wi": ParamSpec((d, f), ("embed", "mlp")),
          "wo": ParamSpec((f, d), ("mlp", "embed"), fan_in=f)}
    if cfg.mlp_gated:
        sp["wg"] = ParamSpec((d, f), ("embed", "mlp"))
    return sp


def attn_specs(cfg: ModelConfig):
    d, hq, hkv, n = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sp = {
        "wq": ParamSpec((d, hq, n), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, hkv, n), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, hkv, n), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((hq, n, d), ("heads", "head_dim", "embed"),
                        fan_in=hq * n),
    }
    if cfg.qkv_bias:
        sp["bq"] = ParamSpec((hq, n), ("heads", "head_dim"), init="zeros")
        sp["bk"] = ParamSpec((hkv, n), ("kv_heads", "head_dim"), init="zeros")
        sp["bv"] = ParamSpec((hkv, n), ("kv_heads", "head_dim"), init="zeros")
    return sp


def block_specs(cfg: ModelConfig, kind: str):
    sp = {"norm1": norm_specs(cfg), "norm2": norm_specs(cfg)}
    if kind == "attn":
        sp["attn"] = attn_specs(cfg)
        sp["ffn"] = moe.moe_specs(cfg) if cfg.is_moe else mlp_specs(cfg)
    elif kind == "rglru":
        sp["rec"] = rglru.rglru_specs(cfg)
        sp["ffn"] = mlp_specs(cfg)
    elif kind == "rwkv":
        sp["tm"] = rwkv6.rwkv_time_specs(cfg)
        sp["cm"] = rwkv6.rwkv_channel_specs(cfg)
    else:
        raise ValueError(kind)
    return sp


# --------------------------------------------------------------------------- #
# Attention apply
# --------------------------------------------------------------------------- #
def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, d) x (d, H, n) -> (B, S, H, n)."""
    b, s, d = x.shape
    return torch.matmul(x, w.reshape(d, -1)).reshape(b, s, *w.shape[1:])


def _ring_positions(pos: int, window: int,
                    device=None) -> torch.Tensor:
    """Absolute position stored in each ring-buffer slot, given cursor pos."""
    idx = torch.arange(window, device=device)
    return pos - torch.remainder(pos - idx, window)


def _gather(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """(N, bs, Hkv, D) pool through (B, M) tables -> (B, M*bs, Hkv, D)."""
    return pool[tables.long()].reshape(tables.shape[0], -1, *pool.shape[2:])


def attn_apply(params: dict, x: torch.Tensor, cfg: ModelConfig,
               ctx: RunContext, rope, cache: Optional[dict], mode: str,
               prefix_len: int, pos, cache_capacity: int = 0,
               block_tables: Optional[torch.Tensor] = None,
               block_size: int = 0, plan: Optional["MeshPlan"] = None
               ) -> Tuple[torch.Tensor, Optional[dict]]:
    if plan is not None:
        return _attn_sharded(params, x, cfg, rope, cache, mode, prefix_len,
                             pos, cache_capacity, plan)
    cos, sin = rope
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    softcap = cfg.logit_softcap
    use_kernels = ctx.impl == "cuda"

    new_cache = None
    if mode == "decode" and block_tables is None:
        # Contiguous cohort decode: leaves are (B, capacity, Hkv, D), every
        # row at the one cursor ``pos`` (an int).  A cache exactly one
        # window long is a ring: the token lands in slot pos % window and
        # each slot's key carries the position it holds.  Otherwise the
        # write pins at capacity - 1 and keys sit at their slot index.
        ck, cv = cache["k"], cache["v"]
        cap = ck.shape[1]
        pos = int(pos)
        k_pos = None
        if cfg.window is not None and cap == cfg.window:
            slot = pos % cap
            k_pos = _ring_positions(pos, cap, x.device)
        else:
            slot = min(pos, cap - 1)
        ck[:, slot] = k[:, 0]
        cv[:, slot] = v[:, 0]
        out = attention_xla(q, ck, cv, causal=True, window=cfg.window,
                            softcap=softcap, q_offset=pos, k_pos=k_pos)
        new_cache = cache
    elif mode == "decode":
        # Paged decode: the cache leaves are (N, bs, Hkv, D) block pools
        # shared by every slot; row i writes its token at its own cursor
        # pos[i] through its table row.  Inactive slots carry an all-zero
        # table row, so their writes land in block 0 (the trash block);
        # several rows may write there — harmless, never read unmasked.
        ck, cv = cache["k"], cache["v"]
        bsz = x.shape[0]
        rows = torch.arange(bsz, device=x.device)
        # the reference's gather clamps an out-of-range column; torch would
        # raise (CPU) or device-assert (CUDA), so clamp explicitly
        col = torch.clamp(pos // block_size, max=block_tables.shape[1] - 1)
        blk = block_tables[rows, col.long()].long()
        off = (pos % block_size).long()
        ck[blk, off] = k[:, 0]
        cv[blk, off] = v[:, 0]
        if use_kernels:
            out = ops.paged_attention(q, ck, cv, block_tables,
                                      (pos + 1).to(torch.int32),
                                      softcap=softcap, fused=ctx.paged_fused)
        else:
            out = attention_xla(q, _gather(ck, block_tables),
                                _gather(cv, block_tables), causal=True,
                                softcap=softcap, q_offset=pos)
        new_cache = cache
    elif mode == "chunk":
        # Chunked paged prefill: row i carries a C-token chunk of its
        # uncached suffix; pos = (pos0, n_live).  Writes mirror the
        # stepwise scan: dead tokens write the trash block, and tokens
        # clamped at capacity - 1 collapse to ONE writer holding the last
        # live token's K/V (last-live-wins), so no live cell ever sees two
        # writes whose order the device would not define.
        pos0, n_live = pos
        ck, cv = cache["k"], cache["v"]
        csz = x.shape[1]
        cap = cache_capacity
        cidx = torch.arange(csz, device=x.device)
        cpos = pos0[:, None] + cidx[None, :]                  # (B, C)
        live = cidx[None, :] < n_live[:, None]
        wpos = torch.clamp(cpos, max=cap - 1)
        writer = live & ((cpos < cap - 1)
                         | (cidx[None, :] == n_live[:, None] - 1))
        blk_col = torch.clamp(wpos // block_size,
                              max=block_tables.shape[1] - 1)
        blk = torch.where(writer,
                          torch.take_along_dim(block_tables, blk_col.long(),
                                               dim=1), 0).long()
        off = torch.where(writer, wpos % block_size, 0).long()
        ck[blk, off] = k
        cv[blk, off] = v
        if use_kernels:
            out = ops.paged_prefill(q, ck, cv, block_tables, pos0, n_live,
                                    softcap=softcap)
        else:
            out = attention_xla(q, _gather(ck, block_tables),
                                _gather(cv, block_tables), causal=True,
                                softcap=softcap, q_offset=pos0)
        new_cache = cache
    else:
        # prefill and train: the whole sequence at once; the kernel takes
        # causal attention without an image prefix, as in the reference
        if use_kernels and cfg.causal and prefix_len == 0:
            out = ops.flash_attention(q, k, v, causal=True,
                                      window=cfg.window, softcap=softcap)
        else:
            out = attention_xla(q, k, v, causal=cfg.causal, window=cfg.window,
                                prefix_len=prefix_len, softcap=softcap)
        if mode == "prefill":
            new_cache = _prefill_cache(k, v, cfg, cache_capacity)
    b, s = out.shape[:2]
    wo = params["wo"]
    out = torch.matmul(out.reshape(b, s, -1).to(x.dtype),
                       wo.reshape(-1, wo.shape[-1]))
    return out, new_cache


def _prefill_cache(k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig,
                   cache_capacity: int) -> dict:
    """The contiguous cache a prefill leaves: K/V zero-padded to the
    capacity, or, when the prompt fills a sliding window, the ring of its
    last ``window`` keys.

    Decode takes ring slot ``i`` to hold a position congruent to ``i``
    modulo the window, which the last ``window`` keys are only when the
    prompt length is a multiple of it.  The reference keeps them all the
    same and its next decode step overwrites a key still in the window;
    the port raises instead."""
    w, s = cfg.window, k.shape[1]
    if w is not None and s >= w:
        if s % w:
            raise ValueError(
                f"{cfg.name}: a {s}-token prefill fills the {w}-token window "
                "ring out of phase (ring slot i must hold a position = i mod "
                "window); pad prompts to the window or a multiple of it")
        return {"k": k[:, -w:], "v": v[:, -w:]}
    pad = (cache_capacity or s) - s
    return {"k": F.pad(k, (0, 0, 0, 0, 0, pad)),
            "v": F.pad(v, (0, 0, 0, 0, 0, pad))}


# --------------------------------------------------------------------------- #
# Residual block
# --------------------------------------------------------------------------- #
def block_apply(kind: str, params: dict, x: torch.Tensor, cfg: ModelConfig,
                ctx: RunContext, rope, cache: Optional[dict], mode: str,
                prefix_len: int, pos, cache_capacity: int = 0,
                block_tables=None, block_size: int = 0):
    """Returns (x, new_cache, aux_loss): the aux loss is the MoE router's
    load-balance term (a float32 zero for every other block).  On a mesh
    the arguments are DTensors (:func:`_block_sharded`)."""
    if ctx.mesh is not None:
        if block_tables is not None or mode == "chunk":
            raise NotImplementedError("a mesh runs train, prefill and "
                                      "contiguous decode, not the paged pool")
        return _block_sharded(kind, params, x, cfg, ctx, rope, cache, mode,
                              prefix_len, pos, cache_capacity)
    return _block_body(kind, params, x, cfg, ctx, rope, cache, mode,
                       prefix_len, pos, cache_capacity, block_tables,
                       block_size)


def _block_body(kind: str, params: dict, x: torch.Tensor, cfg: ModelConfig,
                ctx: RunContext, rope, cache: Optional[dict], mode: str,
                prefix_len: int, pos, cache_capacity: int = 0,
                block_tables=None, block_size: int = 0,
                plan: Optional["MeshPlan"] = None):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = apply_norm(x, params["norm1"], cfg.norm_type)
    tp = plan.tp if plan is not None and plan.rec else None
    if kind == "attn":
        mix, new_cache = attn_apply(params["attn"], h, cfg, ctx, rope, cache,
                                    mode, prefix_len, pos, cache_capacity,
                                    block_tables, block_size, plan=plan)
    elif kind == "rglru":
        mix, new_cache = rglru.rglru_block_apply(params["rec"], h, cfg, ctx,
                                                 cache, mode, tp)
    elif kind == "rwkv":
        mix, tm_cache = rwkv6.rwkv_time_apply(
            params["tm"], h, cfg, ctx,
            cache["tm"] if cache is not None else None, mode, tp)
    else:
        raise ValueError(kind)
    x = x + mix
    h2 = apply_norm(x, params["norm2"], cfg.norm_type)
    if kind == "rwkv":
        ffn, cm_cache = rwkv6.rwkv_channel_apply(
            params["cm"], h2, cfg,
            cache["cm"] if cache is not None else None, mode,
            plan.tp if plan is not None and _ffn_split(cfg, plan) else None)
        new_cache = ({"tm": tm_cache, "cm": cm_cache}
                     if tm_cache is not None else None)
    elif kind == "attn" and cfg.is_moe:
        ffn, aux = moe.moe_apply(params["ffn"], h2, cfg, ctx, plan=plan)
    elif plan is not None:
        ffn = _mlp_sharded(params["ffn"], h2, cfg, plan)
    else:
        ffn = mlp(params["ffn"], h2, cfg.mlp_act, cfg.mlp_gated)
    return x + ffn, new_cache, aux


def block_cache_axes(cfg: ModelConfig, kind: str):
    """Logical sharding axes mirroring ``init_block_cache`` structure.

    kv_heads takes the model axis when divisible; otherwise the cache
    sequence dim does ("kv_seq" is lower priority than "kv_heads" in
    ``distributed.sharding._PRIORITY``, so exactly one of them claims it).
    """
    if kind == "attn":
        kv = ("batch", "kv_seq", "kv_heads", "head_dim")
        return {"k": kv, "v": kv}
    if kind == "rglru":
        return {"h": ("batch", "lru"), "conv": ("batch", None, "lru")}
    if kind == "rwkv":
        return {"tm": {"prev": ("batch", None),
                       "s": ("batch", "heads", None, None)},
                "cm": {"prev": ("batch", None)}}
    raise ValueError(kind)


# --------------------------------------------------------------------------- #
# Sharded blocks
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Layout of one block's local tensors on ``mesh``.

    ``batch_sharded``: the batch dim is split over ``dp_axes``;
    ``seq_sharded``: the rows are split over the model axis (zero-sp);
    ``attn``: ``"heads"`` (local q heads, their K/V heads sliced or local),
    ``"seq"`` (local q rows against all K/V rows), ``"kvseq"`` (decode
    against a cache whose sequence is split over the model axis: partial
    softmax per rank, combined) or ``"rep"`` (everything replicated);
    ``cache_dim``: the cache dim split over the model axis (1: sequence,
    2: KV heads) or None; ``rec``: the recurrent mixer (RWKV-6's time mix
    over heads, RG-LRU over its channels) split over the model axis."""

    mesh: Any
    model_axis: str
    dp_axes: Tuple[str, ...]
    batch_sharded: bool
    seq_sharded: bool
    attn: str
    cache_dim: Optional[int]
    fsdp: bool
    rec: bool = False

    @property
    def model_size(self) -> int:
        return shd.axis_size(self.mesh, self.model_axis)

    @property
    def model_rank(self) -> int:
        return shd.axis_index(self.mesh, self.model_axis)

    @property
    def tp(self):
        """(mesh, model axis): the recurrent bodies' ``tp`` argument."""
        return self.mesh, self.model_axis


def _rec_split(kind: str, cfg: ModelConfig, msz: int) -> bool:
    """Whether a recurrent mixer splits over a model axis of ``msz``:
    RWKV-6 over its heads, RG-LRU over its lru width (= d_model)."""
    if kind == "rwkv":
        return cfg.n_heads % msz == 0
    return kind == "rglru" and cfg.d_model % msz == 0


def _ffn_split(cfg: ModelConfig, plan: MeshPlan) -> bool:
    """Whether a dense feed-forward (or RWKV-6's channel mix) splits d_ff
    over the model axis."""
    return cfg.d_ff % plan.model_size == 0 and not plan.seq_sharded


# the recurrent cache leaves split over the model axis, and on which dim
_REC_CACHE_DIM = {"tm/s": 1, "h": 1, "conv": 2}
# RWKV-6 time-mix leaves used whole by the heads-split body (gradients
# partial over the model axis); the others hold this rank's heads
_TM_WHOLE = ("mu", "w0", "wA", "wB")


def _plc(ctx: RunContext, dp, model):
    """Placements over ``ctx.mesh``: ``dp`` on every data-parallel axis,
    ``model`` on the model axis, ``Replicate()`` on any other."""
    from torch.distributed.tensor import Replicate
    return tuple(model if n == ctx.model_axis
                 else (dp if n in ctx.dp_axes else Replicate())
                 for n in ctx.mesh.mesh_dim_names)


def _placement(kind_):
    from torch.distributed.tensor import Partial, Replicate, Shard
    if kind_ == "R":
        return Replicate()
    if kind_ == "P":
        return Partial()
    return Shard(kind_[1])


def _leaf_roles(kind: str, path: str, cfg: ModelConfig, plan: MeshPlan):
    """(model-axis use, model-axis gradient, data-axis use) of one block
    parameter: ``("S", d)`` keeps dim ``d`` split over the axis, ``"R"``
    gathers it whole for computation replicated over the axis (gradient
    whole on every rank), ``"P"`` gathers it whole for computation split
    over the axis (gradient a partial sum).  On the data axes a parameter
    is gathered (``"R"``) unless serving's MoE contracts a d_model slice
    (``("S", 1)``)."""
    rep = "P" if plan.seq_sharded else "R"
    top, _, name = path.partition("/")
    if top.startswith("norm"):
        return rep, rep, "R"
    msz = plan.model_size
    if top in ("tm", "rec"):
        if not plan.rec:
            return "R", "R", "R"
        if name in _TM_WHOLE:
            return "R", "P", "R"
        d = 1 if name in ("wr", "wk", "wv", "wg", "wx", "wy", "conv_w",
                          "wa", "wi") else 0
        return ("S", d), ("S", d), "R"
    if top == "cm":
        if name in ("wk", "wv") and _ffn_split(cfg, plan):
            d = 1 if name == "wk" else 0
            return ("S", d), ("S", d), "R"
        return "R", "R", "R"
    if top == "attn":
        if plan.attn == "heads":
            kv_split = cfg.n_kv_heads % msz == 0
            d = 1 if name.startswith("w") and name != "wo" else 0
            if name in ("wq", "bq", "wo") or kv_split:
                return ("S", d), ("S", d), "R"
            return "R", "P", "R"
        if plan.attn == "seq":
            return "R", ("R" if name == "wo" and not plan.seq_sharded
                         else "P"), "R"
        return "R", "R", "R"
    if cfg.is_moe:
        if name == "router":
            return rep, rep, "R"
        ep = cfg.n_experts % msz == 0
        d = 0 if ep else (2 if name in ("wi", "wg") else 1)
        data = "R" if plan.fsdp or name == "wo" else ("S", 1)
        return ("S", d), ("S", d), data
    if _ffn_split(cfg, plan):
        d = 1 if name in ("wi", "wg") else 0
        return ("S", d), ("S", d), "R"
    return rep, rep, "R"


def _leaf_placements(use_m, data, ctx: RunContext):
    from torch.distributed.tensor import Replicate, Shard
    names = ctx.mesh.mesh_dim_names
    out = []
    for n in names:
        if n == ctx.model_axis:
            out.append(_placement(use_m) if use_m != "P" else Replicate())
        elif n == "data" and data != "R":
            out.append(Shard(data[1]))
        else:
            out.append(Replicate())
    return tuple(out)


def _leaf_grad_placements(grad_m, data, ctx: RunContext, plan: MeshPlan):
    from torch.distributed.tensor import Partial, Replicate, Shard
    out = []
    for n in ctx.mesh.mesh_dim_names:
        if n == ctx.model_axis:
            out.append(_placement(grad_m))
        elif n in ctx.dp_axes:
            if n == "data" and data != "R":
                out.append(Shard(data[1]))
            else:
                out.append(Partial() if plan.batch_sharded else Replicate())
        else:
            out.append(Replicate())
    return tuple(out)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flat(tree[k], f"{prefix}/{k}" if prefix else k)
        return out
    return [(prefix, tree)]


def _unflat(paths, leaves):
    out = {}
    for path, leaf in zip(paths, leaves):
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def _cache_placements(cfg: ModelConfig, kind: str, shapes: dict,
                      ctx: RunContext):
    """Stored placements of one block's cache leaves (``shapes``: path ->
    global shape), the layout of ``steps.cache_shardings``."""
    axes = dict(_flat(block_cache_axes(cfg, kind)))
    rules = shd.rules_for(ctx.sharding_profile)
    return {p: shd.placements(shd.spec_for(shp, axes[p], ctx.mesh, rules),
                              ctx.mesh)
            for p, shp in shapes.items()}


def _attn_mode(cfg: ModelConfig, ctx: RunContext, mode: str, seq: int,
               cache_dim: Optional[int]) -> str:
    msz = ctx.model_size
    if mode == "decode":
        return {2: "heads", 1: "kvseq"}.get(cache_dim, "rep")
    if (ctx.zero_sp or cfg.n_heads % msz != 0) and seq % msz == 0:
        return "seq"
    return "heads" if cfg.n_heads % msz == 0 else "rep"


def _block_cache_shapes(cfg: ModelConfig, kind: str, b: int, cap: int):
    meta = torch.device("meta")
    one = init_block_cache(cfg, kind, b, cap, torch.float32, meta)
    return {p: tuple(t.shape) for p, t in _flat(one)}


def _block_sharded(kind: str, params: dict, x, cfg: ModelConfig,
                   ctx: RunContext, rope, cache: Optional[dict], mode: str,
                   prefix_len: int, pos, cache_capacity: int):
    """One block on ``ctx.mesh``: ``x`` (B, S, D) and the parameters are
    DTensors, ``rope`` plain (1, S, D/2) tables; ``cache`` the block's
    DTensor cache in decode.  Returns DTensors: x at its placements, the
    cache at its stored placements (``steps.cache_shardings``), aux
    replicated."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = ctx.mesh
    msz = ctx.model_size
    b, s = x.shape[:2]
    batch_sharded = b % ctx.dp_size == 0
    seq_sharded = (ctx.zero_sp and mode in ("train", "prefill")
                   and s % msz == 0)
    if seq_sharded and (kind != "attn" or cfg.is_moe):
        raise NotImplementedError("zero-sp shards the sequence of dense "
                                  "attention blocks only")
    # cache layout
    cache_plc, cache_in_plc = {}, {}
    if mode == "prefill":
        cap = cache_capacity or s
        cache_plc = _cache_placements(
            cfg, kind, _block_cache_shapes(cfg, kind, b, cap), ctx)
    elif mode == "decode":
        cache_plc = {p: t.placements for p, t in _flat(cache)}
    cache_dim = None
    m_idx = mesh.mesh_dim_names.index(ctx.model_axis)
    if kind == "attn" and cache_plc:
        pk = cache_plc["k"][m_idx]
        cache_dim = pk.dim if pk.is_shard() else None
    plan = MeshPlan(mesh, ctx.model_axis, tuple(ctx.dp_axes), batch_sharded,
                    seq_sharded, _attn_mode(cfg, ctx, mode, s, cache_dim),
                    cache_dim, ctx.fsdp_weights, _rec_split(kind, cfg, msz))
    dp_p = Shard(0) if batch_sharded else Replicate()
    x_plc = _plc(ctx, dp_p, Shard(1) if seq_sharded else Replicate())

    paths, leaves = zip(*_flat(params))
    roles = [_leaf_roles(kind, p, cfg, plan) for p in paths]
    in_plc = [_leaf_placements(u, d, ctx) for u, _, d in roles]
    grad_plc = [_leaf_grad_placements(g, d, ctx, plan) for _, g, d in roles]
    cpaths = sorted(cache_plc)
    # recurrent state in the body's layout: split with the mixer, else
    # whole over the model axis (the carried tokens always whole)
    body_m = {p: (Shard(_REC_CACHE_DIM[p]) if plan.rec
                  and p in _REC_CACHE_DIM else Replicate()) for p in cpaths}
    if mode == "decode":
        cache_leaves = [dict(_flat(cache))[p] for p in cpaths]
        # attention reads and writes its cache shard in place; recurrent
        # state enters in the body's layout and leaves as stored
        cache_in_plc = {p: (cache_plc[p] if kind == "attn"
                            else _plc(ctx, dp_p, body_m[p]))
                        for p in cpaths}     # sorted, as cache_leaves
    else:
        cache_leaves = []
    n_par = len(leaves)

    def body(xl, cos, sin, *rest):
        p = _unflat(paths, rest[:n_par])
        c = (_unflat(cpaths, rest[n_par:]) if mode == "decode" else None)
        xo, nc, aux = _block_body(kind, p, xl, cfg, ctx, (cos, sin), c,
                                  mode, prefix_len, pos, cache_capacity,
                                  plan=plan)
        if kind != "attn" and nc is not None:    # -> stored model layout
            flat = dict(_flat(nc))
            nc = _unflat(cpaths, [_relayout(flat[q], body_m[q],
                                            cache_plc[q][m_idx], plan)
                                  for q in cpaths])
        outs = [xo, aux]
        if cpaths:
            flat = dict(_flat(nc))
            outs += [flat[q] for q in cpaths]
        return tuple(outs)

    rep = _plc(ctx, Replicate(), Replicate())
    out_plc = (x_plc, rep) + tuple(cache_plc[q] for q in cpaths)
    fn = shd.local_map(
        body, mesh=mesh,
        in_placements=(x_plc, None, None, *in_plc,
                       *(cache_in_plc[q] for q in cache_in_plc)),
        out_placements=out_plc,
        in_grad_placements=(x_plc, None, None, *grad_plc,
                            *(None for _ in cache_in_plc)))
    cos, sin = rope
    outs = fn(x, cos, sin, *leaves, *cache_leaves)
    x_out, aux = outs[0], outs[1]
    new_cache = _unflat(cpaths, outs[2:]) if cpaths else None
    return x_out, new_cache, aux


def _relayout(t: torch.Tensor, have, want, plan: MeshPlan) -> torch.Tensor:
    """A recurrent cache leaf from the body's model-axis placement to its
    stored one (split where the body ran whole, gathered where the
    stored layout is whole but the body split)."""
    if have == want:
        return t
    if want.is_shard():
        return shd.split_to(t, plan.mesh, plan.model_axis, want.dim)
    return shd.gather_from(t, plan.mesh, plan.model_axis, have.dim)


def _mlp_sharded(params: dict, x: torch.Tensor, cfg: ModelConfig,
                 plan: MeshPlan) -> torch.Tensor:
    """Dense MLP on local tensors: tensor-parallel over d_ff when the
    weights hold a d_ff slice (Megatron: f before, g after), else whole."""
    if params["wi"].shape[1] == cfg.d_ff:
        return mlp(params, x, cfg.mlp_act, cfg.mlp_gated)
    mesh, m = plan.mesh, plan.model_axis
    y = mlp(params, shd.copy_to(x, mesh, m), cfg.mlp_act, cfg.mlp_gated)
    return shd.reduce_from(y, mesh, m)


def _rows(t: torch.Tensor, plan: MeshPlan, n: int) -> torch.Tensor:
    """This rank's ``n`` rows (dim 1) of a (1, S, ...) table."""
    return t.narrow(1, plan.model_rank * n, n)


def _attn_sharded(params: dict, x: torch.Tensor, cfg: ModelConfig, rope,
                  cache: Optional[dict], mode: str, prefix_len: int, pos,
                  cache_capacity: int, plan: MeshPlan):
    """Attention on local tensors in the layout ``plan`` names: ``x`` the
    normed (B_local, S or S/M, D) activation, replicated over the model
    axis unless zero-sp splits its rows."""
    mesh, m = plan.mesh, plan.model_axis
    msz, r = plan.model_size, plan.model_rank
    cos, sin = rope
    softcap = cfg.logit_softcap
    b, s = x.shape[:2]
    if plan.attn in ("heads", "seq") and not plan.seq_sharded \
            and mode != "decode":
        x = shd.copy_to(x, mesh, m)

    def proj(name, xi, c=None, sn=None):
        t = _proj(xi, params["w" + name])
        if cfg.qkv_bias:
            t = t + params["b" + name].to(x.dtype)
        return apply_rope(t, c, sn) if c is not None else t

    def qkv(xi, c, sn):
        return proj("q", xi, c, sn), proj("k", xi, c, sn), proj("v", xi)

    new_cache = None
    if mode == "decode":
        q, k, v = qkv(x, cos, sin)
        out = _decode_sharded(q, k, v, cfg, cache, int(pos), plan)
        new_cache = cache
    elif plan.attn == "seq":
        if plan.seq_sharded:
            c, sn = _rows(cos, plan, s), _rows(sin, plan, s)
            q, k, v = qkv(x, c, sn)
            k = shd.gather_from(k, mesh, m, 1, partial=True)
            v = shd.gather_from(v, mesh, m, 1, partial=True)
            rows, off = s, r * s
        else:
            rows, off = s // msz, r * (s // msz)
            k, v = proj("k", x, cos, sin), proj("v", x)
            q = proj("q", shd.split_to(x, mesh, m, 1),
                     _rows(cos, plan, rows), _rows(sin, plan, rows))
        out = attention_xla(q, k, v, causal=cfg.causal, window=cfg.window,
                            prefix_len=prefix_len, softcap=softcap,
                            q_offset=off, q_chunk=max(128, _Q_CHUNK // msz))
        if not plan.seq_sharded:
            out = shd.gather_from(out, mesh, m, 1)      # all rows again
        if mode == "prefill":
            new_cache = _cache_shard(_prefill_cache(k, v, cfg,
                                                    cache_capacity),
                                     plan, full_heads=True)
    else:
        q, k, v = qkv(x, cos, sin)
        kq, vq = k, v
        if plan.attn == "heads" and cfg.n_kv_heads % msz:
            kq, vq = _kv_for_local_heads(k, v, cfg, plan)
        out = attention_xla(q, kq, vq, causal=cfg.causal, window=cfg.window,
                            prefix_len=prefix_len, softcap=softcap)
        if mode == "prefill":
            full = plan.attn != "heads" or cfg.n_kv_heads % msz != 0
            new_cache = _cache_shard(_prefill_cache(k, v, cfg,
                                                    cache_capacity),
                                     plan, full_heads=full)
    bb, ss = out.shape[:2]
    wo = params["wo"]
    y = torch.matmul(out.reshape(bb, ss, -1).to(x.dtype),
                     wo.reshape(-1, wo.shape[-1]))
    if plan.attn == "heads":
        y = shd.reduce_from(y, mesh, m)
    return y, new_cache


def _kv_for_local_heads(k, v, cfg: ModelConfig, plan: MeshPlan):
    """K/V heads of this rank's q heads when the KV heads do not split
    over the model axis: a contiguous run of KV heads when the local q
    heads cover whole groups, else one KV head per q head (GQA group 1)."""
    hq_l = cfg.n_heads // plan.model_size
    g = cfg.q_per_kv
    first = plan.model_rank * hq_l
    if hq_l % g == 0:
        return (k.narrow(2, first // g, hq_l // g),
                v.narrow(2, first // g, hq_l // g))
    idx = torch.div(torch.arange(first, first + hq_l, device=k.device), g,
                    rounding_mode="floor")
    return k.index_select(2, idx), v.index_select(2, idx)


def _cache_shard(c: dict, plan: MeshPlan, full_heads: bool) -> dict:
    """The prefill cache's local shard at its stored layout."""
    dim = plan.cache_dim
    if dim is None or (dim == 2 and not full_heads):
        return c
    return {n: shd.split_to(t, plan.mesh, plan.model_axis, dim)
            for n, t in c.items()}


def _decode_sharded(q, k, v, cfg: ModelConfig, cache: dict, pos: int,
                    plan: MeshPlan):
    """One decode step against the local cache shard (written in place).
    ``"heads"``: local q and KV heads; ``"kvseq"``: all heads against this
    rank's stretch of slots, the partial softmaxes combined over the model
    axis (max, then sums); ``"rep"``: the whole cache."""
    ck, cv = cache["k"], cache["v"]
    cap_l = ck.shape[1]
    msz = plan.model_size
    cap = cap_l * (msz if plan.attn == "kvseq" else 1)
    if cfg.window is not None and cap == cfg.window:
        slot = pos % cap
        k_pos = _ring_positions(pos, cap, q.device)
    else:
        slot = min(pos, cap - 1)
        k_pos = torch.arange(cap, device=q.device)
    if plan.attn != "kvseq":
        ck[:, slot] = k[:, 0]
        cv[:, slot] = v[:, 0]
        return attention_xla(q, ck, cv, causal=True, window=cfg.window,
                             softcap=cfg.logit_softcap, q_offset=pos,
                             k_pos=k_pos if cfg.window is not None
                             and cap == cfg.window else None)
    lo = plan.model_rank * cap_l
    if lo <= slot < lo + cap_l:
        ck[:, slot - lo] = k[:, 0]
        cv[:, slot - lo] = v[:, 0]
    k_pos = k_pos[lo:lo + cap_l]
    b, _, hq, d = q.shape
    hkv = ck.shape[2]
    qg = q.reshape(b, 1, hkv, hq // hkv, d).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, ck.float()) * d ** -0.5
    if cfg.logit_softcap is not None:
        scores = cfg.logit_softcap * torch.tanh(scores / cfg.logit_softcap)
    q_pos = torch.full((b, 1), pos, device=q.device)
    mask = attn_mask(q_pos, k_pos.expand(b, cap_l), causal=True,
                     window=cfg.window)
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    mesh, m = plan.mesh, plan.model_axis
    mx = scores.amax(-1, keepdim=True)
    gmx = shd.reduce_from(mx, mesh, m, "max")
    z = torch.exp(scores - gmx)
    denom = shd.reduce_from(z.sum(-1, keepdim=True), mesh, m)
    # normalised and rounded to the value dtype before the PV product, as
    # ``_attn_core`` and the reference do
    p = (z / denom).to(v.dtype).float()
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, cv.float())
    o = shd.reduce_from(o, mesh, m)
    return o.to(v.dtype).reshape(b, 1, hq, d)


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, capacity: int,
                     dtype: torch.dtype, device=None) -> dict:
    """Zero contiguous cache for one block: (batch, capacity, Hkv, D) K/V
    for attention (capacity capped at a sliding window: a ring), the state
    rows for RG-LRU and RWKV."""
    if kind == "attn":
        cap = min(capacity, cfg.window) if cfg.window else capacity
        shape = (batch, cap, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    if kind == "rglru":
        return rglru.init_rglru_cache(cfg, batch, dtype, device)
    if kind == "rwkv":
        return rwkv6.init_rwkv_cache(cfg, batch, dtype, device)
    raise ValueError(kind)
