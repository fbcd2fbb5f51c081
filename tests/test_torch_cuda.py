"""CUDA kernels vs their plain versions, on a card only.

Run where a GPU and nvcc are present (this file imports no JAX, so the
repository's conftest can be skipped):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Elsewhere the tests skip: a CUDA kernel has no CPU mode (only
test_flash_softcap_case_bites, a check of the inputs, runs on the CPU).  Shapes are the
serving paths' (smollm-360m heads: Hq 15, Hkv 5, D 64; block 8; chunk 8;
rwkv6-7b cohort prefill: B 8, S 64, H 64, N 64; recurrentgemma-2b: RG-LRU
width 2560, attention Hq 10, Hkv 1, D 256, window 2048), for the bf16
tensor-core flash kernel every head dim it is built for, and for paged
decode and paged prefill head dims 16-256 with their edge cases.
Tolerances: float32 atol 2e-5 / rtol 1e-5 (another summation order, TF32
off), bfloat16 2e-2.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _paged_case(rng, b, hkv, d, bs, lens, extra_blocks=2):
    """Random pool and tables pointing at scattered, shuffled blocks."""
    spans = [max(-(-ln // bs), 1) for ln in lens]
    m = max(spans)
    n = sum(spans) + 1 + extra_blocks
    ids = rng.permutation(np.arange(1, n))
    tables = np.zeros((b, m), np.int32)
    nxt = 0
    for i, sp in enumerate(spans):
        tables[i, :sp] = ids[nxt:nxt + sp]
        nxt += sp
    kp = rng.standard_normal((n, bs, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((n, bs, hkv, d)).astype(np.float32)
    return kp, vp, tables, np.asarray(lens, np.int32)


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """On a card: each CUDA kernel against its plain version at the
    serving shapes (float32 atol 2e-5 / rtol 1e-5, bfloat16 2e-2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (CUDA kernels have no CPU "
                    "mode); chip_smoke.py runs the same comparison")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(6)
    for dtype, atol, rtol in ((torch.float32, 2e-5, 1e-5),
                              (torch.bfloat16, 2e-2, 2e-2)):
        tol = dict(atol=atol, rtol=rtol)
        c = lambda x: _t(x).to(dev, dtype)         # noqa: E731
        i = lambda x: _t(x).to(dev)                # noqa: E731
        kp, vp, tables, cls = _paged_case(rng, 4, 5, 64, 8,
                                          (0, 17, 64, 130))
        q = _randn(rng, (4, 1, 15, 64))
        for fused in (True, False):
            got = ops.paged_attention(c(q), c(kp), c(vp), i(tables), i(cls),
                                      fused=fused)
            want = ref.paged_attention_ref(c(q)[:, 0], c(kp), c(vp),
                                           i(tables), i(cls))[:, None]
            torch.testing.assert_close(got.float(), want.float(), **tol)
        p0 = np.array([0, 9, 40, 100], np.int32)
        nl = np.array([8, 0, 5, 8], np.int32)
        kp, vp, tables, _ = _paged_case(rng, 4, 5, 64, 8, p0 + 8)
        q = _randn(rng, (4, 8, 15, 64))
        got = ops.paged_prefill(c(q), c(kp), c(vp), i(tables), i(p0), i(nl))
        want = ref.paged_prefill_ref(c(q).transpose(1, 2), c(kp), c(vp),
                                     i(tables), i(p0), i(nl)).transpose(1, 2)
        torch.testing.assert_close(got.float(), want.float(), **tol)
        q, k, v = (_randn(rng, (2, 100, h, 64)) for h in (15, 5, 5))
        for window in (None, 32):
            got = ops.flash_attention(c(q), c(k), c(v), window=window)
            want = ref.flash_attention_ref(
                c(q).transpose(1, 2), c(k).transpose(1, 2),
                c(v).transpose(1, 2), window=window).transpose(1, 2)
            torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
def test_rwkv6_scan_matches_plain_version():
    """On a card: the WKV scan against ``ref.rwkv6_scan_ref`` at the
    serving shape and the edge cases (s0 None, one step, a ragged S, N 16,
    N 8 with its rows padded to 64, N 37 without 16-byte copies), r/k/v in
    float32 and bfloat16 with float32 decays; each launch follows
    ``ops.rwkv6_scan_plan``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (CUDA kernels have no CPU "
                    "mode); chip_smoke.py runs the same comparison")
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    for dtype, atol, rtol in ((torch.float32, 2e-5, 1e-5),
                              (torch.bfloat16, 2e-2, 2e-2)):
        for b, s, h, n, with_s0 in ((8, 64, 64, 64, True),
                                    (8, 64, 64, 64, False),
                                    (2, 1, 4, 64, True),
                                    (2, 37, 4, 64, True),
                                    (3, 40, 4, 16, True),
                                    (2, 19, 3, 8, True),
                                    (2, 35, 3, 37, False)):
            r, k, v = (_t(_randn(rng, (b, s, h, n))).to(dev, dtype)
                       for _ in range(3))
            w = torch.sigmoid(_t(_randn(rng, (b, s, h, n)))).to(dev) * 0.7 \
                + 0.29
            u = _t(_randn(rng, (h, n))).to(dev)
            s0 = _t(_randn(rng, (b, h, n, n))).to(dev)
            y, s_final = ops.rwkv6_scan(r, k, v, w, u,
                                        s0 if with_s0 else None)
            torch.cuda.synchronize()
            plan = ops.rwkv6_scan_plan(b, s, h, n, dtype)
            assert ops.last_plan["rwkv6_scan"] == plan
            assert ops.rwkv6_scan_resident(plan, dtype) >= plan.ctas_per_sm
            init = s0 if with_s0 else torch.zeros_like(s0)
            want_y, want_s = ref.rwkv6_scan_ref(
                *(x.transpose(1, 2) for x in (r, k, v, w)), u, init)
            torch.testing.assert_close(y.float(),
                                       want_y.transpose(1, 2).float(),
                                       atol=atol, rtol=rtol)
            torch.testing.assert_close(s_final, want_s, atol=2e-5, rtol=1e-5)


@pytest.mark.cuda
def test_rglru_scan_matches_plain_version():
    """On a card: the RG-LRU scan against ``ref.rglru_scan_ref`` (float32
    coefficients, float32 and bfloat16 outputs) with and without h0, one
    step, a ragged S and a narrow R; and the flash kernel at head_dim 256
    with MQA 10:1 and a window."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (CUDA kernels have no CPU "
                    "mode); chip_smoke.py runs the same comparison")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(8)
    for b, s, r, with_h0 in ((8, 512, 2560, True), (8, 512, 2560, False),
                             (2, 1, 2560, True), (2, 37, 2560, True),
                             (3, 40, 96, True)):
        a = torch.sigmoid(_t(_randn(rng, (b, s, r)))).to(dev)
        bb = _t(_randn(rng, (b, s, r))).to(dev)
        h0 = _t(_randn(rng, (b, r))).to(dev)
        init = h0 if with_h0 else torch.zeros_like(h0)
        want_h, want_last = ref.rglru_scan_ref(a, bb, init)
        for out_dtype in (torch.float32, torch.bfloat16):
            h, last = ops.rglru_scan(a, bb, h0 if with_h0 else None,
                                     out_dtype=out_dtype)
            torch.cuda.synchronize()
            torch.testing.assert_close(h, want_h.to(out_dtype), atol=2e-5,
                                       rtol=1e-5)
            torch.testing.assert_close(last, want_last, atol=1e-5, rtol=0)
    for dtype, atol, rtol in ((torch.float32, 2e-5, 1e-5),
                              (torch.bfloat16, 2e-2, 2e-2)):
        q, k, v = (_t(_randn(rng, (2, 100, h, 256))).to(dev, dtype)
                   for h in (10, 1, 1))
        got = ops.flash_attention(q, k, v, window=48)
        want = ref.flash_attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            window=48).transpose(1, 2)
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)


# the softcap case scales q so that scores (std 8) pass the cap of 30 and
# the cap moves the output by more than the tolerance
SOFTCAP_Q_SCALE = 8.0


def _flash_bf16_case(dev, rng, b, s, hq, hkv, d, q_scale=1.0, **kw):
    q, k, v = (_t(_randn(rng, (b, s, h, d))).to(dev, torch.bfloat16)
               for h in (hq, hkv, hkv))
    q = q * q_scale                      # a power of 2: exact in bf16
    got = ops.flash_attention(q, k, v, **kw)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    want = ref.flash_attention_ref(qt, kt, vt, **kw).transpose(1, 2)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    if kw.get("softcap"):
        # a kernel that ignored the cap would be outside the tolerance
        uncapped = dict(kw, softcap=None)
        plain = ref.flash_attention_ref(qt, kt, vt, **uncapped)
        assert not torch.allclose(plain.transpose(1, 2).float(),
                                  want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("d", [64, 256])
def test_flash_softcap_case_bites(d):
    """On the CPU (the wrapper's plain version): the softcap case's inputs
    make the cap change the output beyond the bf16 tolerance, so the card
    test's softcap case fails a kernel that drops or misplaces the cap."""
    rng = np.random.default_rng(9)
    for g, hkv in ((1, 2), (3, 5), (10, 1)):
        _flash_bf16_case(torch.device("cpu"), rng, 2, 100, g * hkv, hkv, d,
                         q_scale=SOFTCAP_Q_SCALE, softcap=30.0)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 80, 96, 128, 256])
def test_flash_attention_tensor_core_matches_plain_version(d):
    """On a card: the bf16 tensor-core flash kernel against
    ``ref.flash_attention_ref`` (atol / rtol 2e-2: one bf16 rounding of P
    and of the output) at every head dim it is built for: GQA groups of 1,
    3 and 10, ragged S (100, 129: no multiple of the 64-key tile), windows
    32 and 48, softcap 30 (on scores of std 8, where the cap bites),
    non-causal, B 1 and S 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (CUDA kernels have no CPU "
                    "mode); chip_smoke.py runs the same comparison")
    dev = torch.device("cuda")
    rng = np.random.default_rng(9)
    for g, hkv in ((1, 2), (3, 5), (10, 1)):
        for s in (100, 129):
            _flash_bf16_case(dev, rng, 2, s, g * hkv, hkv, d)
        _flash_bf16_case(dev, rng, 2, 129, g * hkv, hkv, d, window=32)
        _flash_bf16_case(dev, rng, 2, 100, g * hkv, hkv, d, window=48)
        _flash_bf16_case(dev, rng, 2, 100, g * hkv, hkv, d,
                         q_scale=SOFTCAP_Q_SCALE, softcap=30.0)
        _flash_bf16_case(dev, rng, 2, 129, g * hkv, hkv, d, causal=False)
        _flash_bf16_case(dev, rng, 1, 100, g * hkv, hkv, d)
        _flash_bf16_case(dev, rng, 2, 1, g * hkv, hkv, d)


@pytest.mark.cuda
def test_flash_attention_refuses_unbuilt_head_dim():
    """On a card: a bf16 call at a head dim the tensor-core kernel was not
    built for raises ValueError (no other kernel takes it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (CUDA kernels have no CPU "
                    "mode); chip_smoke.py runs the same comparison")
    q, k, v = (torch.zeros((1, 8, h, 48), dtype=torch.bfloat16,
                           device="cuda") for h in (4, 2, 2))
    before = ops.launches["flash_attention"]
    with pytest.raises(ValueError, match="head dims"):
        ops.flash_attention(q, k, v)
    assert ops.launches["flash_attention"] == before


def _paged_wild_tables(tables, lens, bs, n):
    """``tables`` with every entry at j >= ceil(ctx / bs) replaced by an id
    outside the pool (n + 7 or -3): the kernel must never read them."""
    wild = tables.copy()
    for i, ln in enumerate(lens):
        for j in range(-(-int(ln) // bs), tables.shape[1]):
            wild[i, j] = n + 7 if j % 2 == 0 else -3
    return wild


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 64, 128, 256])
def test_paged_decode_matches_plain_version(d):
    """On a card: paged_decode against ``ref.paged_attention_ref`` (float32
    atol 2e-5 / rtol 1e-5, bfloat16 2e-2) for GQA groups 1, 3 and 8 over 2
    kv-heads, block 8 and 16, one slot each of ctx 0 (exact zeros), 1, bs,
    bs + 1 and the full table (M 4: clusters with ranks that own no live
    entry), fused and per-head grids, softcap 30 on scores of std 8 (the
    cap moves the output beyond the tolerance), and out-of-pool table ids
    past each context (never read; the plain version gets the clean
    table)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (CUDA kernels have no CPU "
                    "mode); chip_smoke.py runs the same comparison")
    dev = torch.device("cuda")
    rng = np.random.default_rng(10)
    m, hkv = 4, 2
    for dtype, atol, rtol in ((torch.float32, 2e-5, 1e-5),
                              (torch.bfloat16, 2e-2, 2e-2)):
        c = lambda x: _t(x).to(dev, dtype)         # noqa: E731
        i = lambda x: _t(x).to(dev)                # noqa: E731
        for g in (1, 3, 8):
            for bs in (8, 16):
                lens = (0, 1, bs, bs + 1, m * bs)
                kp, vp, tables, cls = _paged_case(rng, 5, hkv, d, bs, lens)
                wild = _paged_wild_tables(tables, lens, bs, kp.shape[0])
                q = _randn(rng, (5, 1, g * hkv, d))
                for softcap, qs in ((None, 1.0), (30.0, 8.0)):
                    want = ref.paged_attention_ref(
                        c(q * qs)[:, 0], c(kp), c(vp), i(tables), i(cls),
                        softcap=softcap)[:, None]
                    for fused in (True, False):
                        before = ops.launches["paged_decode"]
                        got = ops.paged_attention(
                            c(q * qs), c(kp), c(vp), i(wild), i(cls),
                            softcap=softcap, fused=fused)
                        torch.cuda.synchronize()
                        assert ops.launches["paged_decode"] == before + 1
                        assert ops.last_plan["paged_decode"] == \
                            ops.paged_decode_plan(5, g * hkv, hkv, d, bs, m,
                                                  dtype, fused)
                        torch.testing.assert_close(got.float(), want.float(),
                                                   atol=atol, rtol=rtol)
                        assert not got[0].any()
                    if softcap:
                        plain = ref.paged_attention_ref(
                            c(q * qs)[:, 0], c(kp), c(vp), i(tables),
                            i(cls))[:, None]
                        assert not torch.allclose(plain.float(), want.float(),
                                                  atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_paged_decode_refuses_what_it_cannot_load():
    """On a card: a head dim that is no multiple of 8 and a q that is not
    16-byte aligned raise ValueError without a launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (CUDA kernels have no CPU "
                    "mode); chip_smoke.py runs the same comparison")
    dev = torch.device("cuda")
    tables = torch.ones((2, 2), dtype=torch.int32, device=dev)
    cls = torch.full((2,), 5, dtype=torch.int32, device=dev)
    before = ops.launches["paged_decode"]
    pool = torch.zeros((3, 4, 2, 12), device=dev)
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.paged_attention(torch.zeros((2, 1, 4, 12), device=dev), pool,
                            pool, tables, cls)
    pool = torch.zeros((3, 4, 2, 16), device=dev)
    q = torch.zeros(2 * 4 * 16 + 1, device=dev)[1:].view(2, 1, 4, 16)
    with pytest.raises(ValueError, match="aligned"):
        ops.paged_attention(q, pool, pool, tables, cls)
    assert ops.launches["paged_decode"] == before


def _prefill_case(rng, b, c, hq, hkv, d, bs, pos0, n_live):
    """Pool, clean tables (the plain version's), tables whose entries past
    each slot's reach ceil((pos0 + n_live) / bs) hold ids outside the pool
    (the kernel must never read them), and q (B, C, Hq, D)."""
    kp, vp, tables, _ = _paged_case(rng, b, hkv, d, bs,
                                    [p + c for p in pos0])
    reach = [-(-(p + n) // bs) for p, n in zip(pos0, n_live)]
    wild = _paged_wild_tables(tables, [r * bs for r in reach], bs,
                              kp.shape[0])
    return kp, vp, tables, wild, _randn(rng, (b, c, hq, d))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 64, 80, 96, 128, 256])
def test_paged_prefill_matches_plain_version(d):
    """On a card: paged_prefill against ``ref.paged_prefill_ref`` (float32
    atol 2e-5 / rtol 1e-5, bfloat16 2e-2; D 16 float32 only: the bf16
    kernel is built for the configs' head dims) for GQA groups 1, 3 and 8
    (the 64-row tile of qwen2.5-3b's heads at C 8), block 8 and 16, chunks
    1, 8 and 64 (512 rows per kv-head at g 8: four 128-row tiles), slots at
    pos0 0, bs - 1, 300 and 3000 with n_live 0, 1, partial and C, the
    speculative verify chunks C 2-5 with ragged n_live and windows ending
    at a 3008-token capacity (pos0 = 3008 - n_live), and
    out-of-pool table ids past each slot's reach; rows at chunk positions
    >= n_live must be exact zeros.  At pos0 3000 each of the cluster's 8
    ranks walks several 64-key tiles (the ring wraps, the softmax rescales
    across tiles) and the output's RMS is near atol, so those slots' live
    rows are also held to a max abs error of 0.05 of their RMS (one misread
    tile moves an element by about sqrt(2 * 64 / 3000) of it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (CUDA kernels have no CPU "
                    "mode); chip_smoke.py runs the same comparison")
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    # the verify chunks draw from their own generator: the other cases
    # keep the draws they always had
    rng_verify = np.random.default_rng(12)
    hkv = 2
    dtypes = [(torch.float32, 2e-5, 1e-5)]
    if d in ops.FLASH_TC_HEAD_DIMS:
        dtypes.append((torch.bfloat16, 2e-2, 2e-2))
    for dtype, atol, rtol in dtypes:
        c_ = lambda x: _t(x).to(dev, dtype)        # noqa: E731
        i_ = lambda x: _t(x).to(dev)               # noqa: E731
        for g in (1, 3, 8):
            for bs in (8, 16):
                for c in (1, 2, 3, 4, 5, 8, 64):
                    if 2 <= c <= 5:
                        # the speculative verify window (C = K + 1): ragged
                        # n_live, a dead row, two windows ending at 3008
                        # (pos0 = capacity - n_live at a 3008 capacity)
                        pos0 = np.array([0, bs - 1, 300, 300, 3008 - c, 3007,
                                         3000], np.int32)
                        n_live = np.array([c, 1, c // 2 + 1, 0, c, 1, c - 1],
                                          np.int32)
                    else:
                        pos0 = np.array([0, bs - 1, 300, 300, bs - 1, 3000,
                                         3000], np.int32)
                        n_live = np.array([c, 1, max(1, c // 2 + 1), 0, c, c,
                                           max(1, c // 2 + 1)], np.int32)
                    b = len(pos0)
                    kp, vp, tables, wild, q = _prefill_case(
                        rng_verify if 2 <= c <= 5 else rng, b, c, g * hkv,
                        hkv, d, bs, pos0, n_live)
                    before = ops.launches["paged_prefill"]
                    got = ops.paged_prefill(c_(q), c_(kp), c_(vp), i_(wild),
                                            i_(pos0), i_(n_live))
                    torch.cuda.synchronize()
                    assert ops.launches["paged_prefill"] == before + 1
                    assert ops.last_plan["paged_prefill"] == \
                        ops.paged_prefill_plan(b, c, g * hkv, hkv, d, bs,
                                               tables.shape[1], dtype)
                    want = ref.paged_prefill_ref(
                        c_(q).transpose(1, 2), c_(kp), c_(vp), i_(tables),
                        i_(pos0), i_(n_live)).transpose(1, 2)
                    torch.testing.assert_close(got.float(), want.float(),
                                               atol=atol, rtol=rtol)
                    for s, n in enumerate(n_live):
                        assert not got[s, n:].any()
                        if pos0[s] >= 3000 and n:
                            w = want[s, :n].float()
                            err = (got[s, :n].float() - w).abs().max()
                            assert err <= 0.05 * w.pow(2).mean().sqrt()


@pytest.mark.cuda
def test_paged_prefill_refuses_unbuilt_head_dim():
    """On a card: a bf16 call at a head dim the tensor-core kernel was not
    built for raises ValueError without a launch (the float32 body takes
    it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (CUDA kernels have no CPU "
                    "mode); chip_smoke.py runs the same comparison")
    dev = torch.device("cuda")
    tables = torch.ones((2, 2), dtype=torch.int32, device=dev)
    pos0 = torch.zeros((2,), dtype=torch.int32, device=dev)
    n_live = torch.full((2,), 4, dtype=torch.int32, device=dev)
    q = torch.zeros((2, 4, 4, 48), dtype=torch.bfloat16, device=dev)
    pool = torch.zeros((3, 4, 2, 48), dtype=torch.bfloat16, device=dev)
    before = ops.launches["paged_prefill"]
    with pytest.raises(ValueError, match="head dims"):
        ops.paged_prefill(q, pool, pool, tables, pos0, n_live)
    assert ops.launches["paged_prefill"] == before
    out = ops.paged_prefill(q.float(), pool.float(), pool.float(), tables,
                            pos0, n_live)
    torch.cuda.synchronize()
    assert ops.launches["paged_prefill"] == before + 1
    assert not out.any()


def _randn(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.cuda
def test_cuda_train_steps_match_host():
    """On a card: reduced smollm-360m in float32 (TF32 off), three train
    steps on the card and on the host from the same weights and batches:
    losses and grad norms within 1e-4 relative.  Then the train loss with
    impl="cuda" under no_grad equals impl="torch"'s within 1e-5, and with
    grad enabled the flash kernel refuses the gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (CUDA kernels have no CPU "
                    "mode); chip_smoke.py phase 24 runs the same comparison")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.launch import steps as S
    from repro_torch.models import model
    from repro_torch.optim import adamw
    cfg = reduced_config(get_config("smollm-360m"))
    params = model.init(cfg, torch.Generator().manual_seed(0),
                        torch.device("cpu"))
    pipe = Pipeline(cfg, DataConfig(4, 32))
    runs = {}
    for dev in ("cuda", "cpu"):
        p = model.tree_map(lambda t: t.to(dev, copy=True), params)
        step = S.build_train_step(cfg, adamw.OptConfig(), S.make_context(dev))
        state = {"params": p, "opt": adamw.init(p)}
        runs[dev] = []
        for i in range(3):
            batch = {k: v.to(dev) for k, v in pipe.batch(i).items()}
            state, m = step(state, batch)
            runs[dev].append((float(m["loss"]), float(m["grad_norm"])))
    for got, want in zip(runs["cuda"], runs["cpu"]):
        np.testing.assert_allclose(got, want, rtol=1e-4)
    dev_params = model.tree_map(lambda t: t.cuda(), params)
    batch = {k: v.cuda() for k, v in pipe.batch(0).items()}
    ops.reset_launches()
    with torch.no_grad():
        got, _ = model.forward(cfg, dev_params, batch,
                               S.make_context("cuda", impl="cuda"), "train")
        want, _ = model.forward(cfg, dev_params, batch,
                                S.make_context("cuda"), "train")
    assert ops.launches["flash_attention"] == cfg.n_layers
    assert abs(float(got) - float(want)) <= 1e-5
    live = model.tree_map(lambda t: t.detach().requires_grad_(), dev_params)
    with pytest.raises(RuntimeError, match="backward kernel"):
        model.forward(cfg, live, batch, S.make_context("cuda", impl="cuda"),
                      "train")
