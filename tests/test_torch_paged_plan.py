"""The paged-decode kernel's launch plan and its split-and-merge, on the CPU.

The CUDA kernel (``csrc/paged_decode.cu``) launches with the grid, cluster,
rows, warps, lanes per key and shared memory of ``ops.paged_decode_plan``;
``walk`` below mirrors how it cuts a slot's live table entries over the
ranks of a cluster, each rank's keys over its warps in steps of ``2 * 32
// lanes`` keys, and a step over the warp's key slots, two keys each (the
card tests hold
the kernel to the same split through its outputs).  These tests hold the
plan to what the kernel needs: every live key of every (slot, head group)
is walked exactly once and no entry past the context is touched; both
serving shapes fill the card's 132 SMs or take the largest cluster; every
head dim of the configs fits and D 12 is refused; and the split's partial
softmax states, merged by the kernel's rule (empty states take no weight),
equal the JAX package's paged attention (its Pallas kernel in interpret
mode) in float32 to 1e-6.
"""
import collections
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.configs import get_config, list_archs, reduced_config
from repro_torch.kernels import ops

LOG2E = 1.4426950408889634
# (b, hq, hkv, d, bs, m, contexts): smollm-360m's paged serving batch and
# the long-context shape of chip_smoke.py (qwen2.5-3b's heads)
SERVING = {
    "smollm": (8, 15, 5, 64, 8, 32, [97, 100, 104, 108, 101, 103, 106, 110]),
    "long": (8, 16, 2, 128, 16, 512,
             [8192, 8097, 8065, 8146, 8171, 8086, 8128, 8184]),
}


def walk(plan, ctx, bs, m):
    """The states the kernel forms for one (slot, head group) of context
    ``ctx``: ``{(rank, warp, key slot): [key positions]}``."""
    kpw = 32 // plan.lanes
    kps = kpw * ops.PAGED_DECODE_KEYS_PER_LANE
    nblk = min(-(-ctx // bs), m) if ctx > 0 else 0
    per = -(-nblk // plan.cluster)
    states = {}
    for rank in range(plan.cluster):
        c0 = min(rank * per, nblk)
        nkeys = (min(c0 + per, nblk) - c0) * bs
        nsteps = -(-nkeys // kps)
        for warp in range(plan.warps):
            nw = -(-(nsteps - warp) // plan.warps) if nsteps > warp else 0
            for slot in range(kpw):
                keys = [(warp + i * plan.warps) * kps + t * kpw + slot
                        for i in range(nw)
                        for t in range(ops.PAGED_DECODE_KEYS_PER_LANE)]
                states[rank, warp, slot] = [
                    c0 * bs + k for k in keys
                    if k < nkeys and c0 * bs + k < ctx]
    return states


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per-head"])
@pytest.mark.parametrize("shape", sorted(SERVING))
def test_walk_covers_each_live_key_once(shape, fused):
    b, hq, hkv, d, bs, m, lens = SERVING[shape]
    plan = ops.paged_decode_plan(b, hq, hkv, d, bs, m, torch.bfloat16,
                                 fused)
    for ctx in sorted({0, 1, bs, bs + 1, m * bs, *lens}):
        seen = collections.Counter(
            p for keys in walk(plan, ctx, bs, m).values() for p in keys)
        assert sorted(seen) == list(range(min(ctx, m * bs)))
        assert set(seen.values()) <= {1}
        # entries j >= ceil(ctx / bs) are never read
        assert {p // bs for p in seen} == set(range(-(-min(ctx, m * bs)
                                                      // bs)))


@pytest.mark.parametrize("shape,rows,cluster", [("long", 8, 8),
                                                 ("smollm", 3, 4)])
def test_serving_shapes_fill_the_card(shape, rows, cluster):
    """One CTA per group of ``rows`` query heads (the whole GQA group), in
    the smallest cluster that reaches 132 CTAs, or 8."""
    b, hq, hkv, d, bs, m, _ = SERVING[shape]
    plan = ops.paged_decode_plan(b, hq, hkv, d, bs, m, torch.bfloat16)
    assert (plan.rows, plan.cluster) == (rows, cluster)
    assert plan.grid == (cluster, hq // rows, b)
    ctas = math.prod(plan.grid)
    assert ctas >= 132 or cluster == 8
    assert cluster == 1 or ctas // 2 < 132
    assert 4 <= plan.warps <= 8


def _head_dims():
    dims = set()
    for arch in list_archs():
        for cfg in (get_config(arch), reduced_config(get_config(arch))):
            dims.add((cfg.n_heads, cfg.n_kv_heads, cfg.head_dim))
    return sorted(dims)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_every_config_head_dim_fits(dtype):
    for hq, hkv, d in _head_dims():
        for fused in (True, False):
            plan = ops.paged_decode_plan(8, hq, hkv, d, 16, 512, dtype, fused)
            assert plan.smem <= 232448
            assert plan.rows <= ops.PAGED_DECODE_MAX_ROWS
            assert (hq // hkv) % plan.rows == 0
            # the lanes of a key cover D in 16-byte slices
            assert plan.lanes * plan.chunks * 16 >= d * dtype.itemsize
            assert plan.lanes & (plan.lanes - 1) == 0 and plan.lanes <= 32
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.paged_decode_plan(8, 4, 2, 12, 16, 512, dtype)


def _merge(a, b):
    """The kernel's merge of two (m, l, acc) states in base-2 units: an
    empty state (l == 0) takes no weight."""
    (m1, l1, a1), (m2, l2, a2) = a, b
    mn = max(m1, m2)
    w1 = np.float32(2.0) ** np.float32(m1 - mn) if l1 > 0 else np.float32(0)
    w2 = np.float32(2.0) ** np.float32(m2 - mn) if l2 > 0 else np.float32(0)
    return mn, l1 * w1 + l2 * w2, a1 * w1 + a2 * w2


def _state(q, k, v, keys, scale):
    """One key slot's softmax state over ``keys`` (float32, base 2)."""
    if not keys:
        rows = q.shape[0]
        return (np.full(rows, -1e30, np.float32), np.zeros(rows, np.float32),
                np.zeros_like(q))
    x = ((k[keys] @ q.T).T * np.float32(scale)
         * np.float32(LOG2E)).astype(np.float32)          # (R, keys)
    mx = x.max(axis=1, keepdims=True)
    p = np.exp2(x - mx).astype(np.float32)
    return mx[:, 0], p.sum(axis=1), p @ v[keys]


def split_merge(plan, q, kp, vp, tables, lens):
    """Python model of the kernel: per (slot, head group), the states of
    :func:`walk` merged over key slots, then warps, then ranks."""
    b, hq, d = q.shape
    n, bs, hkv, _ = kp.shape
    g, rows = hq // hkv, plan.rows
    out = np.zeros_like(q)
    for i in range(b):
        ctx = int(lens[i])
        ids = np.clip(tables[i], 0, n - 1)
        for y in range(hq // rows):
            h = y * rows // g
            k = kp[ids, :, h].reshape(-1, d)       # key position order
            v = vp[ids, :, h].reshape(-1, d)
            qs = q[i, y * rows:(y + 1) * rows]
            states = walk(plan, ctx, bs, tables.shape[1])
            ranks = []
            for rank in range(plan.cluster):
                warps = []
                for warp in range(plan.warps):
                    st = [_state(qs, k, v, states[rank, warp, s], d ** -0.5)
                          for s in range(32 // plan.lanes)]
                    warps.append(_fold(st, rows))
                ranks.append(_fold(warps, rows))
            m_, l_, acc = _fold(ranks, rows)
            out[i, y * rows:(y + 1) * rows] = (
                acc / np.maximum(l_, np.float32(1e-30))[:, None])
    return out


def _fold(states, rows):
    """Merge per-row states in order, row by row."""
    m = np.full(rows, -1e30, np.float32)
    l_ = np.zeros(rows, np.float32)
    acc = np.zeros((rows, states[0][2].shape[1]), np.float32)
    for sm, sl, sa in states:
        for r in range(rows):
            m[r], l_[r], acc[r] = _merge((m[r], l_[r], acc[r]),
                                         (sm[r], sl[r], sa[r]))
    return m, l_, acc


def test_split_merge_model_matches_reference():
    """float32, atol 1e-6: slots of ctx 0 (exact zeros), 1 and bs + 3
    (ranks with no live entry), a partial last block, and the full table;
    GQA group 3 (fused) and the per-head grid; out-of-pool ids past each
    context are clamped and never weighted."""
    rng = np.random.default_rng(0)
    b, hq, hkv, d, bs, m = 5, 6, 2, 16, 4, 6
    lens = np.array([0, 1, bs + 3, 3 * bs + 2, m * bs], np.int32)
    n = 1 + b * m
    tables = (1 + np.arange(b * m, dtype=np.int32)).reshape(b, m)
    kp, vp = (rng.standard_normal((n, bs, hkv, d)).astype(np.float32)
              for _ in range(2))
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    want = np.asarray(jops.paged_attention(
        jnp.asarray(q[:, None]), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lens), interpret=True))[:, 0]
    wild = tables.copy()
    for i, ln in enumerate(lens):
        wild[i, -(-ln // bs):] = n + 5
    for fused in (True, False):
        plan = ops.paged_decode_plan(b, hq, hkv, d, bs, m, torch.float32,
                                     fused)
        assert plan.cluster > 1
        got = split_merge(plan, q, kp, vp, wild, lens)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        assert not got[0].any()
