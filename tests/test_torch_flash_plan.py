"""The flash kernel's launch plan (``ops.flash_plan``), checked on the CPU.

The CUDA kernel launches with the grid, rows per CTA and shared memory
that ``ops.flash_plan`` gives; ``cta_rows`` below mirrors its row mapping
(the card tests hold the kernel to it).  These tests hold the plan
to what the kernel needs: every (position, q-head) of a call is written by
exactly one CTA, every head dim of the configs fits a Hopper block's
232,448 bytes of shared memory, and both serving shapes (smollm-360m's
96-token join prefill, recurrentgemma-2b's 2048-token cohort prefill) give
at least one CTA per SM of an H100 (132).
"""
import collections

import pytest
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.kernels import ops

# (B, S, Hq, Hkv, D): the two serving shapes, ragged S, MHA, B 1 and S 1
SERVING = {"smollm-join": (8, 96, 15, 5, 64),
           "recurrentgemma-prefill": (8, 2048, 10, 1, 256)}
SHAPES = dict(SERVING, **{
    "ragged-100": (2, 100, 15, 5, 64),
    "ragged-129-mqa": (2, 129, 10, 1, 256),
    "mha-129": (2, 129, 6, 6, 128),
    "b1-s1": (1, 1, 10, 1, 256),
    "d80-g3": (1, 300, 12, 4, 80),
})


def cta_rows(plan, s, hq, hkv, x, y):
    """The (position, q-head) pairs CTA (x, y, any batch) of ``plan``
    writes, as csrc/flash_attention.cu maps them: the scalar kernel takes
    positions x * rows ... of q-head y; the tensor-core kernel takes the
    flattened rows of tile grid.x - 1 - x of kv-head y, row r being
    position r // g and q-head y * g + r % g."""
    if plan.kernel == "scalar":
        return [(p, y) for p in range(x * plan.rows,
                                      min((x + 1) * plan.rows, s))]
    g = hq // hkv
    tile = plan.grid[0] - 1 - x
    return [(r // g, y * g + r % g)
            for r in range(tile * plan.rows,
                           min((tile + 1) * plan.rows, s * g))]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_flash_plan_covers_every_row_once(shape, dtype):
    b, s, hq, hkv, d = SHAPES[shape]
    plan = ops.flash_plan(b, s, hq, hkv, d, dtype)
    assert plan.kernel == ("tensor_core" if dtype == torch.bfloat16
                           else "scalar")
    assert plan.grid[2] == b
    assert plan.grid[1] == (hkv if plan.kernel == "tensor_core" else hq)
    seen = collections.Counter(
        pair for x in range(plan.grid[0]) for y in range(plan.grid[1])
        for pair in cta_rows(plan, s, hq, hkv, x, y))
    assert set(seen) == {(p, h) for p in range(s) for h in range(hq)}
    assert set(seen.values()) == {1}
    # no CTA is empty
    for x in range(plan.grid[0]):
        assert cta_rows(plan, s, hq, hkv, x, 0)


ATTENTION_ARCHS = [a for a in list_archs()
                   if "attn" in get_config(a).layer_kinds()]


@pytest.mark.parametrize("arch", ATTENTION_ARCHS)
def test_flash_plan_fits_every_config_head_dim(arch):
    cfg = get_config(arch)
    d = cfg.head_dim
    assert d in ops.FLASH_TC_HEAD_DIMS
    for s in (1, 129, 2048):
        for dtype in (torch.bfloat16, torch.float32):
            plan = ops.flash_plan(8, s, cfg.n_heads, cfg.n_kv_heads, d,
                                  dtype)
            assert plan.smem <= ops._MAX_SMEM
            assert plan.threads <= 256
        tc = ops.flash_plan(8, s, cfg.n_heads, cfg.n_kv_heads, d,
                            torch.bfloat16)
        # one consumer warpgroup per 64 rows; the kernel is built for 2
        assert tc.rows in (64, 128)


@pytest.mark.parametrize("shape", sorted(SERVING))
def test_flash_plan_fills_the_card(shape):
    b, s, hq, hkv, d = SERVING[shape]
    plan = ops.flash_plan(b, s, hq, hkv, d, torch.bfloat16)
    ctas = plan.grid[0] * plan.grid[1] * plan.grid[2]
    assert ctas >= 132
    want = {"smollm-join": (64, 200), "recurrentgemma-prefill": (128, 1280)}
    assert (plan.rows, ctas) == want[shape]


@pytest.mark.parametrize("d", [16, 32, 48, 72, 112, 192, 512])
def test_flash_plan_refuses_head_dims_without_a_kernel(d):
    with pytest.raises(ValueError, match="head dims"):
        ops.flash_plan(2, 64, 4, 2, d, torch.bfloat16)
