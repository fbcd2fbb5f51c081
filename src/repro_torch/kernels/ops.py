"""Model-layout wrappers for the hand-written CUDA kernels.

Every wrapper checks its inputs (device, dtype, shape, contiguity) and then
dispatches on where the tensors live: on a CUDA tensor it launches the
kernel from ``csrc/`` (building it on first use) and raises if the build or
the launch fails; on a CPU tensor it runs the kernel's plain version from
:mod:`repro_torch.kernels.ref`; any other device raises.  The kernels read
and write the model's own layouts ((B, S, H, D) activations, (N, bs, Hkv, D)
pools, (B, H, N, N) and (B, R) recurrent states), so no wrapper transposes
or pads on the card.  The int8 KV pair (:func:`quantize_kv_blocks`,
:func:`dequantize_kv_blocks`) is plain torch on every device: its reference
is plain ``jnp``, not a Pallas kernel.

No kernel has a backward pass, nor has any of the reference's Pallas
kernels: every wrapper raises when autograd would record through it (grad
enabled and an input that requires it), on the card and on the CPU alike,
so no gradient passes through a plain version behind a kernel's back.
Training runs ``impl="torch"``, as the reference trains on ``impl="xla"``.

``launches`` counts, per kernel, the launches made through these wrappers
(one per call that reached the card); :func:`reset_launches` zeroes it.
``last_plan`` holds the plan of flash_attention's (:class:`FlashPlan`),
paged_decode's (:class:`PagedDecodePlan`), paged_prefill's
(:class:`PagedPrefillPlan`) and rwkv6_scan's (:class:`WkvPlan`) last
launch.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.distributed import compression as _comp
from repro_torch.kernels import ref

# per-CTA tile limits of the scalar attention kernels (csrc/attn_tile.cuh:
# float32 paged prefill and flash)
_NT = 128
_ACC = 16
_MAX_SMEM = 232448            # bytes a Hopper block may use
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# rwkv6_scan (csrc/rwkv6_scan.cu): N padded to _WKV_MAX_N; each consumer
# lane holds _WKV_C columns x (_WKV_MAX_N / _WKV_R) rows of the state,
# _WKV_R lanes per group of _WKV_C columns, beside one producer warp;
# chunks of _WKV_CHUNK steps staged in a ring of _WKV_STAGES (16-step
# chunks beat 8 by 2-4% at 2048 tokens and tie at 64; 2 stages tie 3, 4
# and 6, PERF.md §6); the kernel's launch bounds (96 threads, 4 CTAs per
# SM) cap a lane at 168 registers
_WKV_MAX_N = 64
_WKV_R = 8
_WKV_C = 8
_WKV_CHUNK = 16
_WKV_STAGES = 2
_WKV_REGS = 168
_SM_SMEM = 233472             # shared bytes of one SM
_SM_THREADS = 2048
_SM_REGS = 65536
_SM_CTAS = 32
_CTA_SMEM_RESERVED = 1024     # bytes the card keeps per resident CTA

# bf16 flash_attention, the tensor-core kernel (csrc/flash_attention.cu,
# whose BK and two-stage ring these mirror)
FLASH_TC_HEAD_DIMS = (64, 80, 96, 128, 256)     # one template each
_TC_KEYS = 64                # keys per K/V tile
_TC_STAGES = 2               # K/V ring depth
_TC_WARPGROUP = 128          # threads per consumer warpgroup (64 rows)
_SMS = 132                   # H100 SXM streaming multiprocessors

# paged decode (csrc/paged_decode.cu): query rows per CTA and 16-byte
# chunks per lane are template arguments, the cluster at most the portable 8
PAGED_DECODE_MAX_ROWS = 8
PAGED_DECODE_MAX_HEAD_DIM = 256
_PD_WARPS = 4                  # 4 beat 8 at both serving shapes (PERF.md §6)
_PD_MAX_CLUSTER = 8
_PD_RING_BYTES = 8192          # K/V ring per warp
PAGED_DECODE_KEYS_PER_LANE = 2   # keys a lane folds per step

# paged prefill (csrc/paged_prefill.cu): bf16 row tiles on the tensor-core
# kernel's 64-key tiles (_TC_KEYS), 128 rows only past 128 (two warpgroups
# share each K/V tile; at 96-128 rows two 64-row CTAs were faster), split
# over a cluster of at most 8 until two CTAs per SM are in flight (a CTA
# walks its key tiles one after the other); a third ring stage only where
# two CTAs still fit an SM's 228 KB of shared memory (PERF.md §6: it wins
# 3-6% at smollm's heads over 2048-8192 tokens, and costs 48-59% where it
# leaves one CTA per SM); float32 row tiles over attn_tile.cuh, 32 keys
# staged per step
_PP_MAX_CLUSTER = 8
_PP_CTAS_PER_SM = 2
_PP_SMEM_PER_CTA = 233472 // _PP_CTAS_PER_SM - 1024
_PP_TWO_WARPGROUPS = 128       # flattened rows past which a tile has 128
_PP_SCALAR_KEYS = 32

launches = {"paged_decode": 0, "paged_prefill": 0, "flash_attention": 0,
            "rwkv6_scan": 0, "rglru_scan": 0}
last_plan = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _no_grad_through(name: str, *tensors) -> None:
    """Raise when autograd would record through kernel ``name``."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: a gradient was asked for through the hand-written "
            "kernel; neither this package nor the reference has a backward "
            "kernel: train with impl='torch', as the reference trains on "
            "impl='xla'")


def _smem_bytes(rows: int, keys: int, d: int) -> int:
    return 4 * (rows * d + keys * (d + 1) + keys * d + rows * keys + 3 * rows)


def _check(name: str, floats, ints=(), *, d: int):
    """Raise unless every float input is a contiguous float32/bfloat16
    tensor of one dtype, every int input a contiguous int32 tensor, all on
    one device.  Whether a head dim fits a kernel's CTA tile is each
    kernel's plan's call."""
    dev = floats[0].device
    dtype = floats[0].dtype
    if dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {dtype} unsupported "
                        "(float32 or bfloat16)")
    for t in floats:
        if t.dtype != dtype:
            raise TypeError(f"{name}: mixed dtypes {dtype} / {t.dtype}")
    for t in ints:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: index tensors must be int32, "
                            f"got {t.dtype}")
    for t in (*floats, *ints):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if d < 1:
        raise ValueError(f"{name}: head_dim {d} < 1")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: device {dev} unsupported")


def _fits(name: str, rows: int, keys: int, d: int) -> None:
    if rows > _NT or rows * d > _NT * _ACC:
        raise ValueError(f"{name}: a {rows}x{d} query tile exceeds one CTA "
                         f"({_NT} rows, {_NT * _ACC} accumulator elements)")
    if _smem_bytes(rows, keys, d) > _MAX_SMEM:
        raise ValueError(f"{name}: tile needs more shared memory than a "
                         "Hopper block has")


def _launch(name: str, *args, device: torch.device) -> None:
    from repro_torch.kernels import build
    fn = getattr(build.library(name), name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
    launches[name] += 1


def paged_kv_fetches(b: int, hq: int, hkv: int, m: int, *,
                     fused: bool = True) -> int:
    """KV blocks the decode grid can stage per step, per pool tensor: one
    CTA per (slot, kv-head) fused, per (slot, q-head) unfused, each walking
    at most the table width ``m`` (a CTA stops at ceil(ctx / bs))."""
    return b * (hkv if fused else hq) * m


class PagedDecodePlan(NamedTuple):
    """Launch plan of one paged_decode call.

    Grid ``(cluster, hq // rows, b)`` in clusters of ``cluster`` CTAs along
    x: one cluster per (slot, ``rows`` query heads of one kv-head), each
    rank walking its share of the slot's live table entries.  ``warps``
    per CTA split the rank's keys in steps of ``PAGED_DECODE_KEYS_PER_LANE
    * 32 // lanes`` keys; ``lanes`` lanes hold one key, each ``chunks``
    16-byte slices of D; ``smem`` dynamic shared bytes per CTA."""
    grid: Tuple[int, int, int]
    cluster: int
    rows: int
    warps: int
    lanes: int
    chunks: int
    smem: int


@functools.lru_cache(maxsize=None)
def paged_decode_plan(b: int, hq: int, hkv: int, d: int, bs: int, m: int,
                      dtype: torch.dtype, fused: bool = True
                      ) -> PagedDecodePlan:
    """The grid, cluster, CTA shape and shared memory the CUDA paged-decode
    kernel launches with; the kernel computes none of them itself.

    Rows per CTA: the largest divisor of the GQA group g = hq / hkv up to
    8 (fused), else 1.  Cluster size: the smallest power of two that
    brings the CTA count to at least one per SM (132), at most 8 and at
    most the table width ``m``.  D must be a multiple of 8 up to 256, so
    that a lane's 16-byte slices tile it (``ValueError`` otherwise)."""
    name = "paged_decode"
    if dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {dtype} unsupported")
    if d % 8 or not 8 <= d <= PAGED_DECODE_MAX_HEAD_DIM:
        raise ValueError(f"{name}: head_dim {d} is not a multiple of 8 up "
                         f"to {PAGED_DECODE_MAX_HEAD_DIM}")
    g = hq // hkv
    rows = max(r for r in range(1, PAGED_DECODE_MAX_ROWS + 1)
               if g % r == 0) if fused else 1
    heads = hq // rows
    slices = d * dtype.itemsize // 16
    chunks = -(-slices // 32)
    # at least 2 lanes per key: the score reduction splits a lane pair
    lanes = 32 if chunks > 1 else max(2, 1 << (slices - 1).bit_length())
    cluster = 1
    while (cluster < _PD_MAX_CLUSTER and 2 * cluster <= m
           and b * heads * cluster < _SMS):
        cluster *= 2
    # per warp a ring of K and V slices, the warps' and the CTA's softmax
    # states, the rank's table entries
    smem = (_PD_WARPS * _PD_RING_BYTES
            + 4 * ((_PD_WARPS + 1) * rows * (d + 2) + -(-m // cluster)))
    if smem > _MAX_SMEM:
        raise ValueError(f"{name}: a table width of {m} needs {smem} bytes "
                         "of shared memory per CTA, more than a Hopper "
                         "block has")
    return PagedDecodePlan((cluster, heads, b), cluster, rows, _PD_WARPS,
                           lanes, chunks, smem)


def paged_attention(q, k_pool, v_pool, block_tables, context_lens, *,
                    softcap: Optional[float] = None, fused: bool = True):
    """Decode-time paged attention, model layout.

    q: (B, 1, Hq, D); k_pool, v_pool: (N, bs, Hkv, D); block_tables: (B, M)
    int32; context_lens: (B,) int32.  Returns (B, 1, Hq, D).  ``fused``
    picks the GQA-fused grid (a CTA holds the query heads of one kv-head,
    so each K/V byte is read once per group) over the per-query-head grid
    (one head per CTA).  On the card the launch follows
    :func:`paged_decode_plan`, recorded in ``last_plan``.
    """
    name = "paged_decode"
    _no_grad_through(name, q, k_pool, v_pool)
    b, one, hq, d = q.shape
    n, bs, hkv, dk = k_pool.shape
    if (one != 1 or dk != d or v_pool.shape != k_pool.shape or hq % hkv
            or block_tables.ndim != 2 or block_tables.shape[0] != b
            or context_lens.shape != (b,)):
        raise ValueError(f"{name}: bad shapes q{tuple(q.shape)} "
                         f"pool{tuple(k_pool.shape)} "
                         f"tables{tuple(block_tables.shape)} "
                         f"lens{tuple(context_lens.shape)}")
    _check(name, (q, k_pool, v_pool), (block_tables, context_lens), d=d)
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q[:, 0], k_pool, v_pool, block_tables,
                                       context_lens, softcap=softcap)[:, None]
    m = block_tables.shape[1]
    plan = paged_decode_plan(b, hq, hkv, d, bs, max(m, 1), q.dtype, fused)
    if any(x.data_ptr() % 16 for x in (q, k_pool, v_pool)):
        raise ValueError(f"{name}: the kernel loads 16-byte slices and "
                         "needs 16-byte-aligned q and pools")
    out = torch.empty_like(q)
    if b:
        _launch(name, _DTYPES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
                v_pool.data_ptr(), block_tables.data_ptr(),
                context_lens.data_ptr(), out.data_ptr(), b, hq, hkv, d, bs,
                m, n, *plan.grid[:2], plan.cluster, plan.rows,
                32 * plan.warps, plan.lanes, plan.chunks, plan.smem,
                d ** -0.5, float(softcap or 0.0), device=q.device)
        last_plan[name] = plan
    return out


class PagedPrefillPlan(NamedTuple):
    """Launch plan of one paged_prefill call.

    ``kernel`` is "tensor_core" (bfloat16: grid ``(cluster * tiles, Hkv,
    B)`` in clusters of ``cluster`` CTAs along x, one cluster per ``rows``
    (64 or 128) flattened (chunk position, q-head) rows of one (slot,
    kv-head), each rank walking its share of the slot's live table entries
    in ``keys``-key tiles through a ring of ``stages``) or "scalar"
    (float32: grid ``(tiles, Hkv, B)``, at most 2048 / D rows per CTA,
    ``keys`` keys staged per step, cluster 1, stages 1); ``threads`` per
    CTA, ``smem`` dynamic shared bytes per CTA."""
    kernel: str
    grid: Tuple[int, int, int]
    cluster: int
    rows: int
    threads: int
    keys: int
    stages: int
    smem: int


@functools.lru_cache(maxsize=None)
def paged_prefill_plan(b: int, c: int, hq: int, hkv: int, d: int, bs: int,
                       m: int, dtype: torch.dtype, *,
                       cluster: Optional[int] = None,
                       rows: Optional[int] = None,
                       stages: Optional[int] = None) -> PagedPrefillPlan:
    """The kernel body, grid, cluster, CTA shape, key tile, ring depth and
    shared memory the CUDA paged-prefill kernel launches with; the kernel
    computes none of them itself.

    bfloat16 takes the tensor-core kernel (head dims
    :data:`FLASH_TC_HEAD_DIMS`, else ``ValueError``): 128-row tiles where
    C * g > 128, else 64; the cluster is the smallest power of two that
    brings the CTA count to at least two per SM (264), at most 8 and at
    most the table width ``m``; three ring stages where two such CTAs fit
    an SM's shared memory, else two.  ``cluster`` (1-8), ``rows`` (64 or
    128) and ``stages`` (2 or 3) override that choice, to time other plans
    (``tools/paged_prefill_probe.py``); grid and shared memory follow.
    float32 takes the scalar kernel: row tiles of min(C * g, 2048 // d,
    128) rows, 32 keys per step."""
    name = "paged_prefill"
    if dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {dtype} unsupported")
    rows_all = c * (hq // hkv)
    if dtype == torch.bfloat16:
        if d not in FLASH_TC_HEAD_DIMS:
            raise ValueError(f"{name}: the bfloat16 kernel is built for head "
                             f"dims {FLASH_TC_HEAD_DIMS}, not {d}")
        if rows is None:
            rows = 128 if rows_all > _PP_TWO_WARPGROUPS else 64
        if rows not in (64, 128):
            raise ValueError(f"{name}: rows per CTA {rows} is not 64 or 128")
        tiles = -(-rows_all // rows)
        if cluster is None:
            cluster = 1
            while (cluster < _PP_MAX_CLUSTER and 2 * cluster <= m
                   and b * hkv * tiles * cluster < _PP_CTAS_PER_SM * _SMS):
                cluster *= 2
        if not 1 <= cluster <= _PP_MAX_CLUSTER:
            raise ValueError(f"{name}: cluster {cluster} outside "
                             f"1..{_PP_MAX_CLUSTER}")
        dp = -(-d // 64) * 64
        # alignment, Q, the K/V ring, the merge's m and l, the table share
        fixed = 1024 + 2 * dp * rows + 8 * rows + 4 * -(-m // cluster)
        if stages is None:
            stages = 3
            if fixed + 4 * dp * _TC_KEYS * stages > _PP_SMEM_PER_CTA:
                stages = 2
        if stages not in (2, 3):
            raise ValueError(f"{name}: ring stages {stages} is not 2 or 3")
        smem = fixed + 4 * dp * _TC_KEYS * stages
        if smem > _MAX_SMEM:
            raise ValueError(f"{name}: a table width of {m} needs {smem} "
                             "bytes of shared memory per CTA, more than a "
                             "Hopper block has")
        return PagedPrefillPlan("tensor_core", (cluster * tiles, hkv, b),
                                cluster, rows, rows // 64 * _TC_WARPGROUP,
                                _TC_KEYS, stages, smem)
    rows = min(rows_all, _NT * _ACC // d, _NT)
    if rows < 1:
        raise ValueError(f"{name}: head_dim {d} exceeds one CTA's "
                         f"{_NT * _ACC}-element accumulator")
    smem = _smem_bytes(rows, _PP_SCALAR_KEYS, d)
    if smem > _MAX_SMEM:
        raise ValueError(f"{name}: a {rows}x{d} tile needs more shared "
                         "memory than a Hopper block has")
    return PagedPrefillPlan("scalar", (-(-rows_all // rows), hkv, b), 1, rows,
                            _NT, _PP_SCALAR_KEYS, 1, smem)


def paged_prefill(q, k_pool, v_pool, block_tables, pos0, n_live, *,
                  softcap: Optional[float] = None):
    """Chunked-prefill paged attention, model layout.

    q: (B, C, Hq, D) one C-token chunk per slot (its KV already scattered
    into the pool); pools (N, bs, Hkv, D); block_tables (B, M) int32; pos0,
    n_live (B,) int32.  Returns (B, C, Hq, D); rows at chunk positions
    >= n_live are exact zeros.  Any C: on the card the launch follows
    :func:`paged_prefill_plan`, recorded in ``last_plan``.
    """
    name = "paged_prefill"
    _no_grad_through(name, q, k_pool, v_pool)
    b, c, hq, d = q.shape
    n, bs, hkv, dk = k_pool.shape
    if (dk != d or v_pool.shape != k_pool.shape or hq % hkv
            or block_tables.ndim != 2 or block_tables.shape[0] != b
            or pos0.shape != (b,) or n_live.shape != (b,)):
        raise ValueError(f"{name}: bad shapes q{tuple(q.shape)} "
                         f"pool{tuple(k_pool.shape)} "
                         f"tables{tuple(block_tables.shape)}")
    _check(name, (q, k_pool, v_pool), (block_tables, pos0, n_live), d=d)
    if q.device.type == "cpu":
        return ref.paged_prefill_ref(q.transpose(1, 2), k_pool, v_pool,
                                     block_tables, pos0, n_live,
                                     softcap=softcap).transpose(1, 2)
    m = block_tables.shape[1]
    plan = paged_prefill_plan(b, c, hq, hkv, d, bs, max(m, 1), q.dtype)
    if plan.kernel == "tensor_core" and any(
            x.data_ptr() % 16 for x in (q, k_pool, v_pool)):
        raise ValueError(f"{name}: the bfloat16 kernel copies 16-byte "
                         "chunks and needs 16-byte-aligned q and pools")
    out = torch.empty_like(q)
    if b and c:
        _launch(name, _DTYPES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
                v_pool.data_ptr(), block_tables.data_ptr(), pos0.data_ptr(),
                n_live.data_ptr(), out.data_ptr(), b, c, hq, hkv, d, bs, m, n,
                plan.grid[0], plan.cluster, plan.rows, plan.threads,
                plan.keys, plan.stages, plan.smem, d ** -0.5,
                float(softcap or 0.0), device=q.device)
        last_plan[name] = plan
    return out


def paged_verify(q, k_pool, v_pool, block_tables, pos0, n_live, *,
                 softcap: Optional[float] = None):
    """Speculative-verification paged attention, model layout: the
    :func:`paged_prefill` contract, launching the same kernel on the card
    (its launches count under ``paged_prefill``).

    q: (B, C, Hq, D), per slot the queries of its current token and its
    ``k_i`` draft proposals, C = K + 1 (the window's K/V already scattered
    into the pool); pos0 (B,) the slot cursor; n_live (B,) = ``k_i + 1``,
    0 for a dead row.  Rows at window positions >= n_live come back exact
    zeros, and keys past ``pos0 + q_row`` are masked causally, so the
    stale K/V of proposals an earlier round rejected is never read:
    positions below the window were committed, positions inside it were
    overwritten by this window's scatter before the call.  The model's
    chunk branch calls :func:`paged_prefill` itself, as the reference's
    does; this entry point names the verify shape (ragged ``n_live``,
    C 2-5) for the kernel checks."""
    return paged_prefill(q, k_pool, v_pool, block_tables, pos0, n_live,
                         softcap=softcap)


def quantize_kv_blocks(blocks):
    """Per-(block, head) int8 quantization of gathered KV blocks ``(n, bs,
    Hkv, D)``: ``(q int8, scales float32 keepdims)``.  Plain torch on
    every device: the reference computes it in plain ``jnp`` outside any
    Pallas kernel, so there is no TPU kernel to port here."""
    return _comp.quantize_kv_blocks(blocks)


def dequantize_kv_blocks(q, scales, *, dtype=torch.bfloat16):
    """Inverse of :func:`quantize_kv_blocks` to the pool dtype (plain
    torch on every device, as the reference's is plain ``jnp``)."""
    return _comp.dequantize_kv_blocks(q, scales, dtype=dtype)


class FlashPlan(NamedTuple):
    """Launch plan of one flash_attention call.

    ``kernel`` is "tensor_core" (bfloat16: one CTA per ``rows`` flattened
    (position, q-head) rows of one (batch, kv-head), grid (tiles, Hkv, B))
    or "scalar" (float32: one CTA per ``rows`` positions of one q-head, grid
    (tiles, Hq, B)); ``keys`` per K/V tile, ``stages`` in the K/V ring,
    ``threads`` per CTA, ``smem`` dynamic shared bytes per CTA."""
    kernel: str
    grid: Tuple[int, int, int]
    rows: int
    keys: int
    stages: int
    threads: int
    smem: int


def flash_plan(b: int, s: int, hq: int, hkv: int, d: int,
               dtype: torch.dtype) -> FlashPlan:
    """The grid, tile and shared memory the CUDA flash kernel launches
    with: the kernel takes rows, the grid's x extent and ``smem`` from here
    and computes none of them itself.  bfloat16 takes the tensor-core
    kernel (head dims :data:`FLASH_TC_HEAD_DIMS`, else ``ValueError``):
    128-row tiles, or 64-row tiles where 128 would leave SMs idle.
    float32 takes the scalar kernel: 32 rows up to d = 64, fewer above
    (its register accumulator holds 2048 elements per CTA)."""
    name = "flash_attention"
    if dtype == torch.bfloat16:
        if d not in FLASH_TC_HEAD_DIMS:
            raise ValueError(f"{name}: the bfloat16 kernel is built for head "
                             f"dims {FLASH_TC_HEAD_DIMS}, not {d}")
        rows = s * (hq // hkv)
        m = 128 if -(-rows // 128) * hkv * b >= _SMS else 64
        dp = -(-d // 64) * 64
        smem = 2 * dp * (m + 2 * _TC_STAGES * _TC_KEYS) + 1024
        return FlashPlan("tensor_core", (-(-rows // m), hkv, b), m,
                         _TC_KEYS, _TC_STAGES, m // 64 * _TC_WARPGROUP, smem)
    bq = min(32, _NT * _ACC // d)
    _fits(name, bq, bq, d)
    return FlashPlan("scalar", (-(-s // bq), hq, b), bq, bq, 1, _NT,
                     _smem_bytes(bq, bq, d))


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None):
    """Full-sequence GQA attention, model layout.

    q: (B, S, Hq, D); k, v: (B, T, Hkv, D) -> (B, S, Hq, D).  Queries and
    keys share one position grid starting at 0 (causal: key t <= query s;
    window: key t > s - window).
    """
    name = "flash_attention"
    _no_grad_through(name, q, k, v)
    b, s, hq, d = q.shape
    _, t, hkv, dk = k.shape
    if (dk != d or v.shape != k.shape or k.shape[0] != b or hq % hkv):
        raise ValueError(f"{name}: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    _check(name, (q, k, v), d=d)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window, softcap=softcap).transpose(1, 2)
    plan = flash_plan(b, s, hq, hkv, d, q.dtype)
    if plan.kernel == "tensor_core" and any(
            x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError(f"{name}: the bfloat16 kernel copies 16-byte "
                         "chunks and needs 16-byte-aligned inputs")
    out = torch.empty_like(q)
    if b and s and t:
        _launch(name, _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), b, s, t, hq, hkv, d, plan.rows,
                plan.grid[0], plan.smem, int(causal), int(window or 0),
                d ** -0.5, float(softcap or 0.0), device=q.device)
        last_plan[name] = plan
    return out


class WkvPlan(NamedTuple):
    """Launch plan of one rwkv6_scan call.

    Grid ``(H, B)``: one CTA per (batch, head) of ``threads`` lanes, 64
    consumers and one producer warp.  ``r`` consumer lanes share each
    group of ``c`` columns of the state (N padded to 64), lane q of a group
    holding rows ``4 * (r * m + q) + e`` (m < 2, e < 4) of each.
    ``chunk`` steps per ring stage, ``stages`` stages, ``smem`` dynamic
    shared bytes per CTA, ``ctas_per_sm`` resident at once by threads,
    shared memory and the 168-register cap of the kernel's launch bounds
    (the card may fit more where the kernel needs fewer registers);
    ``vec``: tensor copies (N 64)."""
    grid: Tuple[int, int]
    threads: int
    r: int
    c: int
    chunk: int
    stages: int
    smem: int
    ctas_per_sm: int
    vec: bool


@functools.lru_cache(maxsize=None)
def rwkv6_scan_plan(b: int, s: int, h: int, n: int, dtype: torch.dtype, *,
                    chunk: Optional[int] = None,
                    stages: Optional[int] = None) -> WkvPlan:
    """The grid, CTA shape, chunk, ring depth and shared memory the CUDA
    WKV kernel launches with; the kernel computes none of them itself.

    N is padded to 64.  Each consumer lane holds 8 columns of 8 rows of the
    state, 8 lanes per 8 columns, so a CTA of 64 consumers and a producer
    warp holds all of a (batch, head)'s state.  ``chunk`` (steps per ring
    stage) and ``stages`` (ring depth) override the defaults, to time
    other plans (``tools/rwkv6_scan_probe.py``).  The state is float32
    whatever ``dtype`` (float32 or bfloat16) r, k and v have; ``s`` does
    not change the plan.  N outside 1-64 raises ``ValueError``."""
    name = "rwkv6_scan"
    if dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {dtype} unsupported")
    if not 1 <= n <= _WKV_MAX_N:
        raise ValueError(f"{name}: head_dim {n} outside 1..{_WKV_MAX_N}")
    isz = 4 if dtype == torch.float32 else 2
    chunk = chunk or _WKV_CHUNK
    stages = stages or _WKV_STAGES
    if chunk % 4 or not 4 <= chunk <= 256 or stages < 2:
        raise ValueError(f"{name}: chunk {chunk} (a multiple of 4 up to "
                         f"256) or ring of {stages} stages (at least 2)")
    threads = _WKV_MAX_N + 32
    # the ring (w in float32, r, k and v in the model dtype, each over the
    # padded N, the bonus in float32, each on 128 bytes) and its
    # mbarriers; the state tile (N rows of 68 floats) overlays the front
    # before and after the chunks
    stage = (chunk * _WKV_MAX_N * (4 + 3 * isz)
             + -(-chunk * 4 // 128) * 128)
    smem = max(stages * (stage + 3 * 8), n * (_WKV_MAX_N + 4) * 4)
    ctas = min(_SM_THREADS // threads,
               _SM_SMEM // (smem + _CTA_SMEM_RESERVED),
               _SM_REGS // (threads * _WKV_REGS), _SM_CTAS)
    return WkvPlan((h, b), threads, _WKV_R, _WKV_C, chunk, stages, smem,
                   ctas, n == _WKV_MAX_N)


def rwkv6_scan_resident(plan: WkvPlan, dtype: torch.dtype) -> int:
    """CTAs of ``plan``'s kernel the card holds on one SM at once (CUDA's
    occupancy count, with the kernel's real register use); needs the
    card."""
    from repro_torch.kernels import build
    n = build.library("rwkv6_scan").rwkv6_scan_occupancy(
        _DTYPES[dtype], plan.threads, plan.smem)
    if n < 0:
        raise RuntimeError(f"rwkv6_scan: occupancy query failed with CUDA "
                           f"error {-n}")
    return n


def rwkv6_scan(r, k, v, w, u, s0=None):
    """RWKV-6 WKV recurrence, model layout.

    r, k, v: (B, S, H, N) float32 or bfloat16; w: (B, S, H, N) float32
    decays in (0, 1] (the model computes them in float32); u: (H, N)
    float32; s0: (B, H, N, N) float32, or None for a zero state.  Any
    S >= 0 (no padding) and 1 <= N <= 64.  Returns (y (B, S, H, N) in
    r.dtype, s_final (B, H, N, N) float32).  On the card the launch follows
    :func:`rwkv6_scan_plan`, recorded in ``last_plan``.
    """
    name = "rwkv6_scan"
    _no_grad_through(name, r, k, v, w, u, s0)
    b, s, h, n = r.shape
    if (k.shape != r.shape or v.shape != r.shape or w.shape != r.shape
            or tuple(u.shape) != (h, n)
            or (s0 is not None and tuple(s0.shape) != (b, h, n, n))):
        raise ValueError(f"{name}: bad shapes r{tuple(r.shape)} "
                         f"w{tuple(w.shape)} u{tuple(u.shape)} "
                         f"s0{None if s0 is None else tuple(s0.shape)}")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"{name}: r, k, v must share one dtype of "
                        f"float32/bfloat16: {r.dtype} {k.dtype} {v.dtype}")
    for t in (w, u) + (() if s0 is None else (s0,)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: w, u and s0 must be float32, got "
                            f"{t.dtype}")
    dev = r.device
    for t in (k, v, w, u) + (() if s0 is None else (s0,)):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if not r.is_contiguous():
        raise ValueError(f"{name}: inputs must be contiguous")
    if not 1 <= n <= _WKV_MAX_N:
        raise ValueError(f"{name}: head_dim {n} outside 1..{_WKV_MAX_N}")
    if dev.type == "cpu":
        if s0 is None:
            s0 = torch.zeros((b, h, n, n), dtype=torch.float32)
        y, s_final = ref.rwkv6_scan_ref(r.transpose(1, 2), k.transpose(1, 2),
                                        v.transpose(1, 2), w.transpose(1, 2),
                                        u, s0)
        return y.transpose(1, 2), s_final
    if dev.type != "cuda":
        raise ValueError(f"{name}: device {dev} unsupported")
    plan = rwkv6_scan_plan(b, s, h, n, r.dtype)
    y = torch.empty_like(r)
    s_final = torch.empty((b, h, n, n), dtype=torch.float32, device=dev)
    # tensor copies and 16-byte state pieces need 16-byte-aligned rows: N
    # 64 (the plan) and aligned tensors (any fresh allocation)
    vec = plan.vec and not any(
        x.data_ptr() % 16
        for x in (r, k, v, w, y, s_final) + (() if s0 is None else (s0,)))
    if b and h:
        _launch(name, _DTYPES[r.dtype], r.data_ptr(), k.data_ptr(),
                v.data_ptr(), w.data_ptr(), u.data_ptr(),
                None if s0 is None else s0.data_ptr(), y.data_ptr(),
                s_final.data_ptr(), b, s, h, n, plan.threads, plan.chunk,
                plan.stages, plan.smem, int(vec), device=dev)
        last_plan[name] = plan
    return y, s_final


def rglru_scan(a, b, h0=None, out_dtype=None):
    """RG-LRU linear recurrence ``h_t = a_t * h_{t-1} + b_t``, model layout.

    a, b: (B, S, R) float32 coefficients; h0: (B, R) float32, or None for a
    zero state.  Any S >= 0 and any R (no padding).  Returns (h (B, S, R)
    in ``out_dtype`` (default a.dtype; float32 or bfloat16), h_last (B, R)
    float32).
    """
    name = "rglru_scan"
    _no_grad_through(name, a, b, h0)
    if a.ndim != 3 or b.shape != a.shape or (
            h0 is not None and tuple(h0.shape) != (a.shape[0], a.shape[2])):
        raise ValueError(f"{name}: bad shapes a{tuple(a.shape)} "
                         f"b{tuple(b.shape)} "
                         f"h0{None if h0 is None else tuple(h0.shape)}")
    bsz, s, r = a.shape
    out_dtype = out_dtype or a.dtype
    if out_dtype not in _DTYPES:
        raise TypeError(f"{name}: out_dtype {out_dtype} unsupported "
                        "(float32 or bfloat16)")
    dev = a.device
    for t in (a, b) + (() if h0 is None else (h0,)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: a, b and h0 must be float32, got "
                            f"{t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if dev.type == "cpu":
        if h0 is None:
            h0 = torch.zeros((bsz, r), dtype=torch.float32)
        h, h_last = ref.rglru_scan_ref(a, b, h0)
        return h.to(out_dtype), h_last
    if dev.type != "cuda":
        raise ValueError(f"{name}: device {dev} unsupported")
    h = torch.empty((bsz, s, r), dtype=out_dtype, device=dev)
    h_last = torch.empty((bsz, r), dtype=torch.float32, device=dev)
    if bsz and r:
        _launch(name, _DTYPES[out_dtype], a.data_ptr(), b.data_ptr(),
                None if h0 is None else h0.data_ptr(), h.data_ptr(),
                h_last.data_ptr(), bsz, s, r, device=dev)
    return h, h_last
