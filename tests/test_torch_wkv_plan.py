"""The WKV kernel's launch plan and its float32 order, on the CPU.

The CUDA kernel (``csrc/rwkv6_scan.cu``) launches with the grid, lanes,
chunk, ring depth and shared memory of ``ops.rwkv6_scan_plan``.
``lane_cells`` below mirrors which state cells a lane keeps in registers
(``plan.c`` columns, permuted by the bit reversal of its place in its
group, times ``ROWS`` rows, N padded to ``PADDED``); ``kernel_order_scan``
mirrors the kernel's float32 arithmetic: chunks of ``plan.chunk`` steps
whose bonus the producer warp computes (per step, four lanes, each a
chain of fmaf over a quarter of the channels, then shuffles at distance 1
and 2), ``plan.r`` row partials per column, each a chain of fmaf over its
lane's rows, combined as the reduce-scatter combines them (pairs of
neighbours, then pairs of pairs: ((p0 + p1) + (p2 + p3)) + ((p4 + p5) +
(p6 + p7))), y = fmaf(bonus, v, sum) and S <- fmaf(w, S, k v).  These
tests hold the plan to what the kernel needs: every state cell is kept by
exactly one lane, and every column's reduce-scatter ends in exactly one
lane; shared memory fits a Hopper block at every N from 1 to 64; the
serving shape (B 8, H 64, N 64, bf16) fits its 512 CTAs in one wave, at
least 4 per SM; N outside 1-64 is refused.  And they hold the mirror to the
JAX package's Pallas kernel (interpret mode) in float32 to 1e-5: the
state elementwise (atol and rtol), y to 1e-5 plus 1e-5 of the sum of its
terms' magnitudes (its N + 1 terms cancel, so two summation orders differ
by a share of that sum, not of y).
"""
import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_scan import rwkv6_scan_bhsn
from repro_torch.kernels import ops

SMS = 132
MAX_SMEM = 232448             # bytes a Hopper block may use
# the cohort prefill of rwkv6-7b: 8 prompts of 64 tokens, 64 heads of 64
SERVING = (8, 64, 64, 64)
TOL = dict(atol=1e-5, rtol=1e-5)
PADDED = 64                   # N as the kernel pads it
CONSUMERS = 64                # consumer lanes per CTA


def rows_per_lane(plan):
    return PADDED // plan.r


def bitrev3(q):
    return ((q & 1) << 2) | (q & 2) | ((q >> 2) & 1)


def lane_slots(plan, tid):
    """The columns of consumer lane ``tid``, by register slot: slot s holds
    column (tid // r) * c + (s ^ bitrev3(tid % r))."""
    base = (tid // plan.r) * plan.c
    return [base + (s ^ bitrev3(tid % plan.r)) for s in range(plan.c)]


def lane_cells(plan, n, tid):
    """The (row, column) cells of the state consumer lane ``tid`` keeps:
    its slots' columns, rows 4 (r m + q) + e, those < n."""
    q = tid % plan.r
    rows = [4 * (plan.r * m + q) + e
            for m in range(rows_per_lane(plan) // 4) for e in range(4)]
    return [(i, j) for i in rows for j in lane_slots(plan, tid)
            if i < n and j < n]


def reduce_scatter(plan, slots):
    """Which lane's slot 0 ends holding which column, and from which
    lanes: ``slots`` maps lane -> {slot: (column, lanes summed)}; at
    distance 1, 2, 4 a lane keeps slots [0, K) and adds its partner's
    [K, 2K), which must be the same columns."""
    k, dist = plan.c // 2, 1
    while dist < plan.r:
        nxt = {}
        for lane, held in slots.items():
            other = slots[lane ^ dist]
            nxt[lane] = {}
            for s in range(k):
                col, lanes = held[s]
                ocol, olanes = other[s + k]
                assert ocol == col, (lane, s, col, ocol)
                nxt[lane][s] = (col, lanes | olanes)
        slots, k, dist = nxt, k // 2, dist * 2
    return {lane: held[0] for lane, held in slots.items()}


def tree(parts):
    """Pairs of neighbours, then pairs of pairs, in float32."""
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] for i in range(0, len(parts), 2)]
    return parts[0]


def fma(a, b, c):
    """fmaf in numpy: the float32 product is exact in float64 and the sum
    is rounded there and again to float32 (a double rounding that can
    differ from one fmaf by one float32 ulp, far inside the tolerance)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def bonus_prepass(r_t, k_t, u):
    """sum_i r_i u_i k_i as the producer warp sums it: four lanes per step,
    lane p a chain of fmaf(r_i u_i, k_i, .) over its quarter of the padded
    channels, then shuffles at distance 1 and 2.  r_t, k_t: (B, H, N); u:
    (H, N)."""
    n = r_t.shape[-1]
    pad = lambda x: np.concatenate(                       # noqa: E731
        [x, np.zeros(x.shape[:-1] + (PADDED - n,), np.float32)], -1)
    r_t, k_t, u = pad(r_t), pad(k_t), pad(u)
    qn = PADDED // 4
    parts = []
    for p in range(4):
        acc = np.zeros(r_t.shape[:-1], np.float32)
        for i in range(p * qn, (p + 1) * qn):
            acc = fma(r_t[..., i] * u[..., i], k_t[..., i], acc)
        parts.append(acc)
    return tree(parts)


def kernel_order_scan(r, k, v, w, u, s0, plan):
    """The kernel's float32 order.  r, k, v, w: (B, S, H, N) float32; u:
    (H, N); s0: (B, H, N, N) or None.  Returns (y, s_final) in float32
    and, per element of y, the sum of its terms' magnitudes
    sum_i |r_i S_ij| + |bonus v_j| in float64."""
    b, s, h, n = r.shape
    state = (np.zeros((b, h, n, n), np.float32) if s0 is None
             else s0.astype(np.float32).copy())
    y = np.zeros((b, s, h, n), np.float32)
    mag = np.zeros((b, s, h, n))
    for c0 in range(0, s, plan.chunk):
        steps = min(plan.chunk, s - c0)
        bonus = [bonus_prepass(r[:, c0 + t], k[:, c0 + t], u)
                 for t in range(steps)]
        for t in range(steps):
            r_t, k_t, v_t, w_t = (x[:, c0 + t] for x in (r, k, v, w))
            part = []
            for q in range(plan.r):
                acc = np.zeros((b, h, n), np.float32)
                for m in range(rows_per_lane(plan) // 4):
                    for e in range(4):
                        i = 4 * (plan.r * m + q) + e
                        if i < n:       # padded rows add fmaf(0, 0, acc)
                            acc = fma(r_t[..., i, None], state[:, :, i],
                                      acc)
                part.append(acc)
            total = tree(part)
            y[:, c0 + t] = fma(bonus[t][..., None], v_t, total)
            mag[:, c0 + t] = (np.einsum("bhi,bhij->bhj", np.abs(r_t),
                                        np.abs(state), dtype=np.float64)
                              + np.abs(bonus[t][..., None] * v_t))
            state = fma(w_t[..., None], state,
                        k_t[..., None] * v_t[..., None, :])
    return y, state, mag


def _inputs(rng, b, s, h, n):
    """r, k, v ~ N(0, 1), decays in (0.29, 0.99), u, s0 ~ N(0, 1) (the
    distribution of tests/test_kernels.py), float32 numpy."""
    r, k, v = (rng.standard_normal((b, s, h, n)).astype(np.float32)
               for _ in range(3))
    w = (1 / (1 + np.exp(-rng.standard_normal((b, s, h, n))))
         * 0.7 + 0.29).astype(np.float32)
    u = rng.standard_normal((h, n)).astype(np.float32)
    s0 = rng.standard_normal((b, h, n, n)).astype(np.float32)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("with_s0", [True, False], ids=["s0", "zero"])
@pytest.mark.parametrize("s", [1, 37, 64, 2 * ops._WKV_CHUNK + 3])
@pytest.mark.parametrize("n", [64, 16])
def test_kernel_order_matches_pallas(n, s, with_s0):
    b, h = 2, 2
    r, k, v, w, u, s0 = _inputs(np.random.default_rng(n * 131 + s), b, s,
                                h, n)
    plan = ops.rwkv6_scan_plan(b, s, h, n, torch.float32)
    got_y, got_s, mag = kernel_order_scan(r, k, v, w, u,
                                          s0 if with_s0 else None, plan)
    tr = lambda x: jnp.asarray(np.swapaxes(x, 1, 2))     # noqa: E731
    init = s0 if with_s0 else np.zeros_like(s0)
    want_y, want_s = rwkv6_scan_bhsn(tr(r), tr(k), tr(v), tr(w),
                                     jnp.asarray(u), jnp.asarray(init),
                                     chunk=16 if s % 16 == 0 else s,
                                     interpret=True)
    # y is a sum of N + 1 terms that cancel: two float32 orders differ by
    # a share of the terms' magnitude, not of the result
    err = np.abs(got_y - np.swapaxes(np.asarray(want_y), 1, 2))
    assert (err <= TOL["atol"] + TOL["rtol"] * mag).all(), err.max()
    np.testing.assert_allclose(got_s, np.asarray(want_s), **TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("b,h", [(8, 64), (1, 64), (2, 4), (1, 1)])
def test_every_state_cell_kept_once(b, h, dtype):
    for n in range(1, 65):
        plan = ops.rwkv6_scan_plan(b, 64, h, n, dtype)
        assert plan.grid == (h, b)
        assert plan.threads == CONSUMERS + 32
        assert CONSUMERS == PADDED // plan.c * plan.r
        seen = collections.Counter(
            cell for tid in range(CONSUMERS)
            for cell in lane_cells(plan, n, tid))
        assert set(seen) == {(i, j) for i in range(n) for j in range(n)}, n
        assert set(seen.values()) == {1}, n
        # tensor copies and 16-byte state pieces only over whole rows of
        # the padded width
        assert plan.vec == (n == PADDED)


@pytest.mark.parametrize("n", [64, 37, 32, 16, 1])
def test_every_column_reduced_to_one_lane(n):
    """Each group's reduce-scatter adds only partials of one column and
    ends with every column of the group in exactly one lane, summed over
    all the group's lanes."""
    plan = ops.rwkv6_scan_plan(2, 64, 4, n, torch.float32)
    for group in range(CONSUMERS // plan.r):
        lanes = range(group * plan.r, (group + 1) * plan.r)
        start = {lane - group * plan.r: {
            s: (col, {lane}) for s, col in
            enumerate(lane_slots(plan, lane))} for lane in lanes}
        ends = reduce_scatter(plan, start)
        # every lane writes y: each of the group's columns once
        cols = sorted(col for col, _ in ends.values())
        assert cols == sorted(lane_slots(plan, group * plan.r))
        assert all(summed == set(lanes) for _, summed in ends.values())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_shared_memory_fits_every_width(dtype):
    for b in (1, 8, 64):
        for n in range(1, 65):
            plan = ops.rwkv6_scan_plan(b, 2048, 64, n, dtype)
            assert plan.smem <= MAX_SMEM, (b, n, plan)
            assert plan.ctas_per_sm >= 1, (b, n, plan)
            assert plan.stages >= 2 and plan.chunk % 4 == 0


def test_serving_shape_fills_one_wave():
    b, s, h, n = SERVING
    plan = ops.rwkv6_scan_plan(b, s, h, n, torch.bfloat16)
    ctas = plan.grid[0] * plan.grid[1]
    assert ctas == 512 and plan.ctas_per_sm >= -(-ctas // SMS) == 4
    assert plan.threads == 96 and plan.r == 8 and rows_per_lane(plan) == 8
    assert plan.vec
    # the long shape (S 2048) takes the same plan
    assert ops.rwkv6_scan_plan(b, 2048, h, n, torch.bfloat16) == plan


def test_batch_and_length_change_only_the_grid():
    """One CTA per (batch, head) whatever the cohort: a single request, a
    full cohort and a long prompt differ only in the grid."""
    want = ops.rwkv6_scan_plan(8, 64, 64, 64, torch.bfloat16)
    for b, s in ((1, 64), (1, 1), (4, 2048), (64, 7)):
        plan = ops.rwkv6_scan_plan(b, s, 64, 64, torch.bfloat16)
        assert plan.grid == (64, b)
        assert plan._replace(grid=want.grid) == want


@pytest.mark.parametrize("n", [0, 65, 128])
def test_refuses_widths_outside_one_to_sixty_four(n):
    with pytest.raises(ValueError):
        ops.rwkv6_scan_plan(2, 8, 4, n, torch.float32)
