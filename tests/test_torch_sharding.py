"""The port's sharding rules against the reference's, with no process
group: every parameter, state and cache leaf of all ten full-size configs,
under each profile, on the meshes 16x16, 2x16x16 and 2x4."""
from __future__ import annotations

import jax
import numpy as np
import pytest

from repro import configs as jc
from repro.distributed import sharding as jshd
from repro.launch import inputs as jinputs
from repro.launch import steps as jsteps
from repro.models import model as jm
from repro_torch import configs as tc
from repro_torch.distributed import sharding as tshd
from repro_torch.launch import inputs as tinputs
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as tm

MESHES = (((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 4), ("data", "model")))
PROFILES = ("tp", "zero-sp", "serve", "legacy")
ARCHS = tc.list_archs()


def _leaves(tree, prefix=""):
    """path -> leaf of a nested dict (tuples of axis names are leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _pairs(abstract, axes):
    shapes, names = _leaves(abstract), _leaves(axes)
    assert set(shapes) == set(names)
    return {p: (tuple(shapes[p].shape), tuple(names[p])) for p in shapes}


def _cells(arch):
    """(what, port {path: (shape, axes)}, reference {path: (shape, axes)})
    for params, state and the caches of the decode shapes."""
    tcfg, jcfg = tc.get_config(arch), jc.get_config(arch)
    out = [("params",
            _pairs(tm.init_abstract(tcfg), tm.param_logical_axes(tcfg)),
            _pairs(jm.init_abstract(jcfg), jm.param_logical_axes(jcfg))),
           ("state",
            _pairs(tsteps.abstract_state(tcfg),
                   tsteps.state_logical_axes(tcfg)),
            _pairs(jsteps.abstract_state(jcfg),
                   jsteps.state_logical_axes(jcfg)))]
    for b, cap in ((128, 32768), (1, 4096)):
        out.append((f"cache{b}x{cap}",
                    _pairs(tm.abstract_cache(tcfg, b, cap),
                           tm.cache_logical_axes(tcfg)),
                    _pairs(jm.abstract_cache(jcfg, b, cap),
                           jm.cache_logical_axes(jcfg))))
    return out


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_for_matches_reference(arch, profile):
    """``spec_for`` equals the reference's exactly for every leaf (the
    port's trees have the reference's paths, shapes and logical axes)."""
    trules, jrules = tshd.rules_for(profile), jshd.rules_for(profile)
    cells = _cells(arch)
    for sizes, names in MESHES:
        tmesh = tshd.abstract_mesh(sizes, names)
        jmesh = jshd.abstract_mesh(sizes, names)
        for what, port, ref in cells:
            assert port == ref, what
            for path, (shape, axes) in port.items():
                got = tshd.spec_for(shape, axes, tmesh, trules)
                want = tuple(jshd.spec_for(shape, axes, jmesh, jrules))
                assert got == want, (what, path, sizes, got, want)


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_shardings_match_reference(arch):
    tcfg, jcfg = tc.get_config(arch), jc.get_config(arch)
    for name in sorted(tc.SHAPES):
        tshape, jshape = tc.get_shape(name), jc.get_shape(name)
        got = _leaves(tinputs.input_specs(tcfg, tshape))
        want = _leaves(jinputs.input_specs(jcfg, jshape))
        assert set(got) == set(want), name
        for p in got:
            assert tuple(got[p].shape) == tuple(want[p].shape), (name, p)
            assert _dtype(got[p]) == str(np.dtype(want[p].dtype)), (name, p)
        if "batch" not in got and not any(p.startswith("batch/")
                                          for p in got):
            continue
        batch_t = tinputs.input_specs(tcfg, tshape)["batch"]
        batch_j = jinputs.input_specs(jcfg, jshape)["batch"]
        for sizes, names in MESHES:
            devs = np.array(jax.devices()[:1] * int(np.prod(sizes)))
            jmesh = jax.sharding.Mesh(devs.reshape(sizes), names)
            tmesh = tshd.abstract_mesh(sizes, names)
            ws = jshd.input_shardings(batch_j, jmesh, jshape.global_batch)
            gs = tshd.input_shardings(batch_t, tmesh, tshape.global_batch)
            for k in batch_t:
                assert gs[k] == tuple(ws[k].spec), (name, k, sizes)
            for nd in (1, 2, 3):
                assert tshd.batch_spec(nd, tmesh) == tuple(
                    jshd.batch_spec(nd, jmesh))


def test_run_context_mesh_fields():
    """A mesh runs the plain path: ``impl="cuda"`` with a mesh raises; the
    reference's fields and properties are there."""
    import torch
    from repro_torch.models.context import RunContext
    ctx = RunContext(torch.device("cpu"), "torch")
    assert (ctx.mesh, ctx.model_size, ctx.dp_size, ctx.dp_spec()) == \
        (None, 1, 1, "data")
    assert ctx.fsdp_weights and not ctx.zero_sp
    with pytest.raises(ValueError, match="plain path"):
        RunContext(torch.device("cpu"), "cuda", mesh=object())
    with pytest.raises(ValueError, match="sharding_profile"):
        RunContext(torch.device("cpu"), "torch", sharding_profile="x")


@pytest.mark.parametrize("chunks", [1, 2, 4, 8])
def test_query_chunked_and_row_block_attention_match_reference(chunks):
    """``attention_xla`` taking its query rows in ``chunks`` blocks (1: at
    once) against the reference's flat path, and the chunked gradients
    (each chunk recomputed in the backward pass) against the unchunked
    ones."""
    import torch
    from repro.models.layers import attention_xla as j_attn
    from repro_torch.models.layers import attention_xla
    rng = np.random.default_rng(11)
    b, s, hq, hkv, d = 2, 256, 6, 2, 32
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    want = np.asarray(j_attn(jax.numpy.asarray(q), jax.numpy.asarray(k),
                             jax.numpy.asarray(v), causal=True))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = attention_xla(tq, tk, tv, causal=True, q_chunk=s // chunks)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-5,
                               rtol=2e-5)
    w = torch.from_numpy(rng.standard_normal(got.shape).astype(np.float32))
    g_chunk = torch.autograd.grad((got * w).sum(), [tq, tk, tv])
    flat = attention_xla(tq, tk, tv, causal=True)
    g_flat = torch.autograd.grad((flat * w).sum(), [tq, tk, tv])
    for a, c in zip(g_chunk, g_flat):
        assert float((a - c).abs().max()) <= 1e-5 * float(c.abs().max())
