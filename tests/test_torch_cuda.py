"""CUDA kernels vs their plain versions, on a card only.

Run where a GPU and nvcc are present (this file imports no JAX, so the
repository's conftest can be skipped):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Elsewhere the test skips: a CUDA kernel has no CPU mode.  Shapes are the
serving path's (smollm-360m heads: Hq 15, Hkv 5, D 64; block 8; chunk 8).
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


def _randn(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)
