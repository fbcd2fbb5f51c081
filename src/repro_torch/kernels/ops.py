"""Model-layout wrappers for the hand-written CUDA attention kernels.

Every wrapper checks its inputs (device, dtype, shape, contiguity) and then
dispatches on where the tensors live: on a CUDA tensor it launches the
kernel from ``csrc/`` (building it on first use) and raises if the build or
the launch fails; on a CPU tensor it runs the kernel's plain version from
:mod:`repro_torch.kernels.ref`; any other device raises.  The kernels read
and write the model's own layouts ((B, S, H, D) activations, (N, bs, Hkv, D)
pools), so no wrapper transposes or pads on the card.

``launches`` counts, per kernel, the launches made through these wrappers
(one per call that reached the card); :func:`reset_launches` zeroes it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref

# per-CTA tile limits shared by the three kernels (csrc/attn_tile.cuh)
_NT = 128
_ACC = 16
_MAX_SMEM = 232448            # bytes a Hopper block may use
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = {"paged_decode": 0, "paged_prefill": 0, "flash_attention": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _smem_bytes(rows: int, keys: int, d: int) -> int:
    return 4 * (rows * d + keys * (d + 1) + keys * d + rows * keys + 3 * rows)


def _check(name: str, floats, ints=(), *, d: int):
    """Raise unless every float input is a contiguous float32/bfloat16
    tensor of one dtype, every int input a contiguous int32 tensor, all on
    one device, and the head dim fits a CTA tile."""
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
    if not 1 <= d <= 128:
        raise ValueError(f"{name}: head_dim {d} outside 1..128")
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


def paged_attention(q, k_pool, v_pool, block_tables, context_lens, *,
                    softcap: Optional[float] = None, fused: bool = True):
    """Decode-time paged attention, model layout.

    q: (B, 1, Hq, D); k_pool, v_pool: (N, bs, Hkv, D); block_tables: (B, M)
    int32; context_lens: (B,) int32.  Returns (B, 1, Hq, D).  ``fused``
    picks the GQA-fused grid (one CTA per (slot, kv-head)) over the
    per-query-head grid.
    """
    name = "paged_decode"
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
    gq = hq // hkv if fused else 1
    _fits(name, gq, bs, d)
    out = torch.empty_like(q)
    if b:
        _launch(name, _DTYPES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
                v_pool.data_ptr(), block_tables.data_ptr(),
                context_lens.data_ptr(), out.data_ptr(), b, hq, hkv, d, bs,
                block_tables.shape[1], n, int(fused), d ** -0.5,
                float(softcap or 0.0), device=q.device)
    return out


def paged_prefill(q, k_pool, v_pool, block_tables, pos0, n_live, *,
                  softcap: Optional[float] = None):
    """Chunked-prefill paged attention, model layout.

    q: (B, C, Hq, D) one C-token chunk per slot (its KV already scattered
    into the pool); pools (N, bs, Hkv, D); block_tables (B, M) int32; pos0,
    n_live (B,) int32.  Returns (B, C, Hq, D); rows at chunk positions
    >= n_live are exact zeros.
    """
    name = "paged_prefill"
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
    _fits(name, c * (hq // hkv), bs, d)
    out = torch.empty_like(q)
    if b:
        _launch(name, _DTYPES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
                v_pool.data_ptr(), block_tables.data_ptr(), pos0.data_ptr(),
                n_live.data_ptr(), out.data_ptr(), b, c, hq, hkv, d, bs,
                block_tables.shape[1], n, d ** -0.5, float(softcap or 0.0),
                device=q.device)
    return out


def flash_tile(d: int) -> int:
    """Query rows per CTA for head dim ``d`` (32 up to d = 64)."""
    return min(32, _NT * _ACC // d)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None):
    """Full-sequence GQA attention, model layout.

    q: (B, S, Hq, D); k, v: (B, T, Hkv, D) -> (B, S, Hq, D).  Queries and
    keys share one position grid starting at 0 (causal: key t <= query s;
    window: key t > s - window).
    """
    name = "flash_attention"
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
    bq = bk = flash_tile(d)
    _fits(name, bq, bk, d)
    out = torch.empty_like(q)
    if b and s and t:
        _launch(name, _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), b, s, t, hq, hkv, d, bq, bk,
                int(causal), int(window or 0), d ** -0.5,
                float(softcap or 0.0), device=q.device)
    return out
