"""The paged-prefill kernel's launch plan and its split-and-merge, on the CPU.

The CUDA kernel (``csrc/paged_prefill.cu``) launches with the kernel body,
grid, cluster, rows, threads, key tile, ring stages and shared memory of
``ops.paged_prefill_plan``.  ``tile_rows`` and ``rank_rows`` below
mirror how the bfloat16 kernel maps a CTA to the flattened (chunk
position, q-head) rows of one (slot, kv-head) and how the ranks of a
cluster share the tile's outputs; ``split_merge`` mirrors its walk (each
rank's even share of the slot's live table entries, in 64-key tiles, an
online softmax in base 2 with a safe running max) and its merge (a state
with l = 0 takes no weight).  These tests hold the plan to what the kernel
needs: every row is written exactly once; shared memory fits a Hopper block
at every config head dim and chunks 1-64; both long shapes fill the card's
132 SMs or take the largest cluster; the cluster stays within 8 and the
table width; a head dim the bfloat16 kernel was not built for is refused;
and the split's merged states equal the JAX package's paged prefill (its
Pallas kernel in interpret mode) in float32 to 1e-6.
"""
import collections
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.configs import get_config, list_archs
from repro_torch.kernels import ops

LOG2E = np.float32(1.4426950408889634)
NEG = np.float32(-1e30)
# (b, c, hq, hkv, d, bs, m): the long-prefill shapes of chip_smoke.py (8
# slots near 8192 tokens) at qwen2.5-3b's and smollm-360m's heads, and
# smollm-360m's serving chunk
SHAPES = {
    "qwen-long": (8, 8, 16, 2, 128, 16, 512),
    "smollm-long": (8, 8, 15, 5, 64, 8, 1024),
    "smollm-serving": (2, 8, 15, 5, 64, 8, 32),
}


def tile_rows(plan, c, hq, hkv, x):
    """The flattened rows CTA x of ``plan`` owns, as (chunk position,
    q-head offset in the group) pairs: tensor core, tile x // cluster;
    scalar, tile x."""
    g = hq // hkv
    tile = x // plan.cluster
    return [(r // g, r % g) for r in range(tile * plan.rows,
                                           min((tile + 1) * plan.rows,
                                               c * g))]


def rank_rows(nrow, cluster, rank):
    """The tile's rows rank ``rank`` merges and writes when the cluster has
    more than one CTA."""
    share = -(-nrow // cluster)
    return range(rank * share, min(nrow, (rank + 1) * share))


def fragment_rows(rows):
    """The rows the threads of a CTA hold (two per quad of lanes), as the
    kernel writes them from registers when the cluster is one CTA."""
    return [wg * 64 + warp * 16 + lane // 4 + 8 * h
            for wg in range(rows // 64) for warp in range(4)
            for lane in range(0, 32, 4) for h in range(2)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("c,hq,hkv,d", [(8, 16, 2, 128), (8, 15, 5, 64),
                                        (1, 16, 2, 128), (64, 16, 2, 128),
                                        (16, 15, 5, 64), (20, 16, 2, 256),
                                        (3, 32, 32, 96)])
def test_every_row_written_once(c, hq, hkv, d, dtype):
    b, bs, m = 2, 16, 64
    plan = ops.paged_prefill_plan(b, c, hq, hkv, d, bs, m, dtype)
    assert plan.grid[1:] == (hkv, b)
    seen = collections.Counter(
        row for x in range(plan.grid[0])
        for row in tile_rows(plan, c, hq, hkv, x)
        if x % plan.cluster == 0)
    assert sorted(seen) == [(p, j) for p in range(c)
                            for j in range(hq // hkv)]
    assert set(seen.values()) == {1}
    if plan.kernel == "tensor_core":
        assert sorted(fragment_rows(plan.rows)) == list(range(plan.rows))
        assert plan.threads == plan.rows // 64 * 128
        for x in range(0, plan.grid[0], plan.cluster):
            nrow = len(tile_rows(plan, c, hq, hkv, x))
            got = [r for rank in range(plan.cluster)
                   for r in rank_rows(nrow, plan.cluster, rank)]
            assert got == list(range(nrow))
    else:
        assert plan.cluster == 1 and plan.rows * d <= 2048


def _head_dims():
    return sorted({(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
                   for cfg in map(get_config, list_archs())})


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_every_config_head_dim_fits(dtype):
    for hq, hkv, d in _head_dims():
        for c in range(1, 65):
            for bs, m in ((8, 1024), (16, 512), (16, 1)):
                plan = ops.paged_prefill_plan(8, c, hq, hkv, d, bs, m, dtype)
                assert plan.smem <= 232448
                assert 1 <= plan.cluster <= min(8, m)
                if plan.kernel == "tensor_core":
                    assert plan.rows in (64, 128) and plan.keys == 64
                    assert plan.stages in (2, 3)


@pytest.mark.parametrize("shape,cluster,stages", [("qwen-long", 8, 2),
                                                  ("smollm-long", 8, 3)])
def test_long_shapes_fill_the_card(shape, cluster, stages):
    """One cluster per 64-row tile of a (slot, kv-head), in the smallest
    power of two that reaches two CTAs per SM (264), or 8; a third ring
    stage only where two CTAs fit an SM's 228 KB of shared memory."""
    plan = ops.paged_prefill_plan(*SHAPES[shape], torch.bfloat16)
    assert plan.kernel == "tensor_core"
    assert (plan.rows, plan.cluster, plan.stages) == (64, cluster, stages)
    ctas = math.prod(plan.grid)
    assert ctas >= 264 or plan.cluster == 8
    assert plan.cluster == 1 or ctas // 2 < 264
    assert 2 * (plan.smem + 1024) <= 233472


def test_rows_per_tile_follow_the_chunk():
    """64-row tiles up to 128 flattened rows (at 96 and 128 rows two 64-row
    CTAs beat one 128-row CTA on the card), 128-row tiles past it."""
    for c, rows, tiles in ((8, 64, 1), (16, 64, 2), (17, 128, 2),
                           (64, 128, 4)):
        plan = ops.paged_prefill_plan(8, c, 16, 2, 128, 16, 512,
                                      torch.bfloat16)
        assert (plan.rows, plan.grid[0] // plan.cluster) == (rows, tiles)


def test_overrides_keep_the_plan_whole():
    """A cluster, row count or ring depth given to the plan (to time other
    plans) moves the grid and shared memory with it; values the kernel
    cannot take raise."""
    args = (*SHAPES["qwen-long"], torch.bfloat16)
    base = ops.paged_prefill_plan(*args)
    assert base.stages == 2
    for cluster in (1, 2, 4, 8):
        plan = ops.paged_prefill_plan(*args, cluster=cluster)
        assert plan.grid == (cluster, *base.grid[1:])
        assert plan.smem == base.smem + 4 * (-(-512 // cluster)
                                             - -(-512 // base.cluster))
    plan = ops.paged_prefill_plan(*args, rows=128)
    assert (plan.rows, plan.threads) == (128, 256)
    assert plan.smem == base.smem + 64 * (2 * 128 + 8)
    plan = ops.paged_prefill_plan(*args, stages=3)
    assert plan.stages == 3 and plan.smem == base.smem + 4 * 128 * 64
    for bad in ({"cluster": 0}, {"cluster": 16}, {"rows": 96},
                {"stages": 4}):
        with pytest.raises(ValueError):
            ops.paged_prefill_plan(*args, **bad)


def test_refused_head_dims():
    with pytest.raises(ValueError, match="head dims"):
        ops.paged_prefill_plan(2, 8, 4, 2, 48, 8, 16, torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        ops.paged_prefill_plan(2, 8, 4, 2, 16, 8, 16, torch.bfloat16)
    with pytest.raises(ValueError, match="accumulator"):
        ops.paged_prefill_plan(2, 8, 4, 2, 4096, 8, 16, torch.float32)
    # the float32 body takes any head dim up to its accumulator: at D 16
    # 128 rows per tile
    plan = ops.paged_prefill_plan(2, 64, 4, 2, 16, 8, 16, torch.float32)
    assert (plan.rows, plan.grid) == (128, (1, 2, 2))


def _merge(a, b):
    """The kernel's merge of two (m, l, acc) states in base-2 units: an
    empty state (l == 0) takes no weight."""
    (m1, l1, a1), (m2, l2, a2) = a, b
    mn = max(m1, m2)
    w1 = np.float32(2.0) ** np.float32(m1 - mn) if l1 > 0 else np.float32(0)
    w2 = np.float32(2.0) ** np.float32(m2 - mn) if l2 > 0 else np.float32(0)
    return mn, l1 * w1 + l2 * w2, a1 * w1 + a2 * w2


def rank_walk(plan, q, k, v, p0, nl, rows, bs, ntbl, rank, scale):
    """One rank's (m, l, acc) per row of a tile: its share of the live
    table entries in ``plan.keys``-key tiles, each fold masked at key
    > min(pos0 + chunk position, the rank's last key), a safe running max.
    ``rows`` are the tile's (chunk position) per row; ``k``, ``v`` the
    slot's keys in position order."""
    nrow = len(rows)
    c_hi = min(max(rows), nl - 1)
    nblk = min(-(-(p0 + nl) // bs), ntbl)
    per = -(-nblk // plan.cluster)
    e0 = min(rank * per, nblk)
    e1 = min(e0 + per, nblk)
    kb, ke = e0 * bs, min(e1 * bs, p0 + c_hi + 1)
    lim = np.array([min(p0 + c, ke - 1) if c < nl else -1 for c in rows])
    m = np.full(nrow, NEG, np.float32)
    l_ = np.zeros(nrow, np.float32)
    acc = np.zeros((nrow, q.shape[1]), np.float32)
    for k0 in range(kb, ke, plan.keys):
        pos = np.arange(k0, min(k0 + plan.keys, ke))
        x = (q @ k[pos].T * np.float32(scale) * LOG2E).astype(np.float32)
        x = np.where(pos[None, :] > lim[:, None], NEG, x)
        mx = np.maximum(m, x.max(axis=1))
        mb = np.where(mx > NEG, mx, np.float32(0))
        alpha = np.exp2(m - mb).astype(np.float32)
        p = np.exp2(x - mb[:, None]).astype(np.float32)
        l_ = l_ * alpha + p.sum(axis=1)
        acc = acc * alpha[:, None] + p @ v[pos]
        m = mx
    return m, l_, acc


def split_merge(plan, q, kp, vp, tables, pos0, n_live):
    """Python model of the tensor-core kernel: per (slot, kv-head, row
    tile), the ranks' states of :func:`rank_walk` merged in rank order;
    rows at chunk positions >= n_live are zeros.  q (B, C, Hq, D)."""
    b, c, hq, d = q.shape
    n, bs, hkv, _ = kp.shape
    g = hq // hkv
    out = np.zeros_like(q)
    for i in range(b):
        p0, nl = int(pos0[i]), int(n_live[i])
        ids = np.clip(tables[i], 0, n - 1)
        for h in range(hkv):
            k = kp[ids, :, h].reshape(-1, d)
            v = vp[ids, :, h].reshape(-1, d)
            for x in range(0, plan.grid[0], plan.cluster):
                pairs = tile_rows(plan, c, hq, hkv, x)
                rows = [p for p, _ in pairs]
                if rows[0] >= nl:
                    continue                     # a dead tile: zeros
                qs = np.stack([q[i, p, h * g + j] for p, j in pairs])
                states = [rank_walk(plan, qs, k, v, p0, nl, rows, bs,
                                    tables.shape[1], rank, d ** -0.5)
                          for rank in range(plan.cluster)]
                for r, (p, j) in enumerate(pairs):
                    st = (NEG, np.float32(0), np.zeros(d, np.float32))
                    for sm, sl, sa in states:
                        st = _merge(st, (sm[r], sl[r], sa[r]))
                    if p < nl:
                        out[i, p, h * g + j] = st[2] / max(
                            st[1], np.float32(1e-30))
    return out


@pytest.mark.parametrize("cluster", [None, 1, 2], ids=["plan", "one",
                                                       "two"])
def test_split_merge_model_matches_reference(cluster):
    """float32, atol 1e-6: slots with pos0 0 and n_live 0 (exact zeros),
    1, a partial chunk and the full chunk; 160 rows (two 128-row tiles, the
    second with 32 rows past n_live's reach in one slot); the plan's
    cluster (8 ranks, most with no live key for the early rows) and, to
    walk several key tiles per rank, clusters of 1 and 2; out-of-pool ids
    past each slot's reach are never read."""
    rng = np.random.default_rng(0)
    b, c, hq, hkv, d, bs, m = 4, 20, 16, 2, 16, 8, 24
    pos0 = np.array([0, 37, 150, 5], np.int32)
    n_live = np.array([0, 1, 13, 20], np.int32)
    n = 1 + b * m
    tables = (1 + np.arange(b * m, dtype=np.int32)).reshape(b, m)
    kp, vp = (rng.standard_normal((n, bs, hkv, d)).astype(np.float32)
              for _ in range(2))
    q = rng.standard_normal((b, c, hq, d)).astype(np.float32)
    want = np.asarray(jops.paged_prefill(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(pos0), jnp.asarray(n_live),
        interpret=True))
    wild = tables.copy()
    for i in range(b):
        wild[i, -(-int(pos0[i] + n_live[i]) // bs):] = n + 5
    # the geometry's plan (the head dim sets only shared memory)
    plan = ops.paged_prefill_plan(b, c, hq, hkv, 64, bs, m, torch.bfloat16,
                                  cluster=cluster)
    assert (plan.rows, plan.grid[0]) == (128, 2 * plan.cluster)
    assert plan.cluster == (cluster or 8)
    got = split_merge(plan, q, kp, vp, wild, pos0, n_live)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert not got[0].any() and not got[1, 1:].any()
