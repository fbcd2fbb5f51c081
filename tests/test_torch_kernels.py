"""Port kernels: plain versions vs the reference's Pallas kernels.

Each plain PyTorch version (``repro_torch.kernels.ref``) and each port
wrapper on CPU tensors (``repro_torch.kernels.ops``, which runs the plain
version there) is held to the reference Pallas kernel in interpret mode —
run as ``tests/test_kernels.py`` runs it — and to the reference oracle.
Inputs are drawn with numpy and handed to both packages.  Tolerance: atol
1e-5 in float32 (the same math in another summation order), 2e-2 in
bfloat16.  The CUDA kernels themselves are compared with their plain
versions in ``test_torch_cuda.py``, which runs on a card only.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

TOL = 1e-5


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


# --------------------------------------------------------------------------- #
# flash attention
# --------------------------------------------------------------------------- #
FLASH_CASES = [
    # b, s, hq, hkv, d, causal, window, softcap
    (1, 64, 6, 2, 16, True, None, None),        # GQA g=3
    (2, 72, 6, 2, 32, True, None, None),        # unaligned seq (padding)
    (2, 64, 6, 2, 16, True, 16, None),          # sliding window
    (1, 48, 3, 3, 16, True, None, 30.0),        # softcap, MHA
    (1, 32, 2, 2, 16, False, None, None),       # non-causal
]


@pytest.mark.parametrize("b,s,hq,hkv,d,causal,window,softcap", FLASH_CASES)
def test_flash_attention_plain_matches_pallas(b, s, hq, hkv, d, causal,
                                              window, softcap):
    rng = np.random.default_rng(0)
    q, k, v = (_rand(rng, (b, s, h, d)) for h in (hq, hkv, hkv))
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, window=window,
                                softcap=softcap, bq=32, bk=32, interpret=True)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                              window=window, softcap=softcap)
    _close(got, want)
    tr = lambda x: np.swapaxes(x, 1, 2)            # noqa: E731
    oracle = jref.flash_attention_ref(jnp.asarray(tr(q)), jnp.asarray(tr(k)),
                                      jnp.asarray(tr(v)), causal=causal,
                                      window=window, softcap=softcap)
    plain = ref.flash_attention_ref(_t(tr(q)), _t(tr(k)), _t(tr(v)),
                                    causal=causal, window=window,
                                    softcap=softcap)
    _close(plain, oracle)


# --------------------------------------------------------------------------- #
# paged decode
# --------------------------------------------------------------------------- #
def _paged_case(rng, b, hq, hkv, d, bs, lens, extra_blocks=2):
    """Random pool (stale data everywhere) and tables pointing at
    scattered, shuffled blocks; block 0 is the trash block."""
    spans = [max(-(-ln // bs), 1) for ln in lens]
    m = max(spans)
    n = sum(spans) + 1 + extra_blocks
    ids = rng.permutation(np.arange(1, n))
    tables = np.zeros((b, m), np.int32)
    nxt = 0
    for i, sp in enumerate(spans):
        tables[i, :sp] = ids[nxt:nxt + sp]
        nxt += sp
    kp = _rand(rng, (n, bs, hkv, d))
    vp = _rand(rng, (n, bs, hkv, d))
    return kp, vp, tables, np.asarray(lens, np.int32)


DECODE_CASES = [
    # b, hq, hkv, d, bs, lens, softcap
    (3, 6, 2, 16, 4, (0, 5, 16), None),         # zero-context row, g=3
    (2, 3, 3, 16, 4, (11, 1), 20.0),            # softcap, MHA
    (2, 15, 5, 64, 8, (40, 24), None),          # smollm heads, bs 8
]


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("b,hq,hkv,d,bs,lens,softcap", DECODE_CASES)
def test_paged_decode_plain_matches_pallas(b, hq, hkv, d, bs, lens, softcap,
                                           fused):
    rng = np.random.default_rng(1)
    kp, vp, tables, cls = _paged_case(rng, b, hq, hkv, d, bs, lens)
    q = _rand(rng, (b, 1, hq, d))
    want = jops.paged_attention(jnp.asarray(q), jnp.asarray(kp),
                                jnp.asarray(vp), jnp.asarray(tables),
                                jnp.asarray(cls), softcap=softcap,
                                fused=fused, interpret=True)
    got = ops.paged_attention(_t(q), _t(kp), _t(vp), _t(tables), _t(cls),
                              softcap=softcap, fused=fused)
    _close(got, want)
    zero = [i for i, ln in enumerate(lens) if ln == 0]
    assert all(float(got[i].abs().max()) == 0.0 for i in zero)
    oracle = jref.paged_attention_ref(jnp.asarray(q[:, 0]), jnp.asarray(kp),
                                      jnp.asarray(vp), jnp.asarray(tables),
                                      jnp.asarray(cls), softcap=softcap)
    plain = ref.paged_attention_ref(_t(q[:, 0]), _t(kp), _t(vp), _t(tables),
                                    _t(cls), softcap=softcap)
    _close(plain, oracle)


def test_paged_decode_plain_bf16_matches_oracle():
    rng = np.random.default_rng(2)
    kp, vp, tables, cls = _paged_case(rng, 2, 6, 2, 16, 8, (13, 30))
    q = _rand(rng, (2, 6, 16))
    bf = lambda x: _t(x).to(torch.bfloat16)        # noqa: E731
    plain = ref.paged_attention_ref(bf(q), bf(kp), bf(vp), _t(tables),
                                    _t(cls))
    oracle = jref.paged_attention_ref(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(kp, jnp.bfloat16),
        jnp.asarray(vp, jnp.bfloat16), jnp.asarray(tables), jnp.asarray(cls))
    _close(plain.float(), oracle, tol=2e-2)


def test_paged_kv_fetches_in_lockstep_with_reference():
    for args in ((3, 6, 2, 4), (4, 15, 5, 32)):
        for fused in (True, False):
            assert ops.paged_kv_fetches(*args, fused=fused) == \
                jfa.paged_kv_fetches(*args, fused=fused)


# --------------------------------------------------------------------------- #
# paged prefill
# --------------------------------------------------------------------------- #
PREFILL_CASES = [
    # b, hq, hkv, d, bs, c, pos0, n_live, softcap
    (3, 6, 2, 16, 4, 8, (0, 5, 9), (8, 3, 0), None),   # dead row, g=3
    (2, 3, 3, 16, 4, 4, (2, 0), (4, 1), 25.0),         # softcap
    (2, 15, 5, 64, 8, 8, (32, 3), (8, 5), None),       # smollm geometry
]


@pytest.mark.parametrize("b,hq,hkv,d,bs,c,pos0,n_live,softcap",
                         PREFILL_CASES)
def test_paged_prefill_plain_matches_pallas(b, hq, hkv, d, bs, c, pos0,
                                            n_live, softcap):
    rng = np.random.default_rng(3)
    kp, vp, tables, _ = _paged_case(rng, b, hq, hkv, d, bs,
                                    [p + c for p in pos0])
    q = _rand(rng, (b, c, hq, d))
    p0 = np.asarray(pos0, np.int32)
    nl = np.asarray(n_live, np.int32)
    want = jops.paged_prefill(jnp.asarray(q), jnp.asarray(kp),
                              jnp.asarray(vp), jnp.asarray(tables),
                              jnp.asarray(p0), jnp.asarray(nl),
                              softcap=softcap, interpret=True)
    got = ops.paged_prefill(_t(q), _t(kp), _t(vp), _t(tables), _t(p0),
                            _t(nl), softcap=softcap)
    _close(got, want)
    for i, n in enumerate(n_live):
        assert float(got[i, n:].abs().sum()) == 0.0
    tr = lambda x: np.swapaxes(x, 1, 2)            # noqa: E731
    oracle = jref.paged_prefill_ref(jnp.asarray(tr(q)), jnp.asarray(kp),
                                    jnp.asarray(vp), jnp.asarray(tables),
                                    jnp.asarray(p0), jnp.asarray(nl),
                                    softcap=softcap)
    plain = ref.paged_prefill_ref(_t(tr(q)), _t(kp), _t(vp), _t(tables),
                                  _t(p0), _t(nl), softcap=softcap)
    _close(plain, oracle)


# --------------------------------------------------------------------------- #
# copy_blocks + wrapper validation
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("axis", [0, 1])
def test_copy_blocks_matches_reference(axis):
    rng = np.random.default_rng(4)
    leaf = _rand(rng, (3, 9, 4, 2, 8)) if axis else _rand(rng, (9, 4, 2, 8))
    src = np.array([2, 5, 0, 0], np.int32)
    dst = np.array([7, 3, 0, 0], np.int32)
    want = jops.copy_blocks(jnp.asarray(leaf), jnp.asarray(src),
                            jnp.asarray(dst), axis=axis)
    t = _t(leaf)
    out = ref.copy_blocks(t, _t(src), _t(dst), axis=axis)
    assert out is t                                # in place
    np.testing.assert_array_equal(t.numpy(), np.asarray(want))


def test_wrappers_reject_bad_inputs():
    rng = np.random.default_rng(5)
    kp, vp, tables, cls = _paged_case(rng, 2, 6, 2, 16, 4, (5, 9))
    q = _t(_rand(rng, (2, 1, 6, 16)))
    with pytest.raises(TypeError, match="int32"):
        ops.paged_attention(q, _t(kp), _t(vp), _t(tables).long(), _t(cls))
    with pytest.raises(TypeError, match="dtype"):
        ops.paged_attention(q.double(), _t(kp).double(), _t(vp).double(),
                            _t(tables), _t(cls))
    with pytest.raises(TypeError, match="mixed"):
        ops.paged_attention(q, _t(kp).bfloat16(), _t(vp), _t(tables),
                            _t(cls))
    with pytest.raises(ValueError, match="contiguous"):
        ops.paged_attention(q, _t(kp).transpose(0, 1).contiguous()
                            .transpose(0, 1), _t(vp), _t(tables), _t(cls))
    with pytest.raises(ValueError, match="shapes"):
        ops.paged_attention(q, _t(kp), _t(vp), _t(tables)[:1], _t(cls))
    with pytest.raises(ValueError, match="shapes"):
        ops.paged_prefill(_t(_rand(rng, (2, 4, 6, 16))), _t(kp), _t(vp),
                          _t(tables), _t(cls), _t(cls)[:1])
    with pytest.raises(ValueError, match="shapes"):
        ops.flash_attention(_t(_rand(rng, (1, 8, 6, 16))),
                            _t(_rand(rng, (1, 8, 4, 16))),
                            _t(_rand(rng, (1, 8, 4, 16))))
