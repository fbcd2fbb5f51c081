"""Port model functions vs the reference on shared weights (CPU, float32).

Weights come from the reference's ``model.init(cfg, PRNGKey(0))`` through
``weights.from_jax``; pools and inputs are drawn with numpy and handed to
both.  Tolerances: logits atol 1e-4 (float32 sums in another order over a
two-layer reduced model), KV pools atol 1e-5; greedy tokens must be equal.
Each port function runs through both of its paths: ``impl="torch"``
(plain gathered attention) and ``impl="cuda"`` (the kernel wrappers, which
run their plain versions on CPU tensors).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced_config
from repro.models import model as jm
from repro.models.context import RunContext as JContext
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced_config as t_reduced_config
from repro_torch.models import model as tm
from repro_torch.models import weights
from repro_torch.models.context import RunContext
from repro_torch.models.spec import spec_leaves

LOGIT_TOL = 1e-4
KV_TOL = 1e-5
BS = 4
M = 4
CAP = BS * M
N_BLOCKS = 1 + 3 * M
IMPLS = ["torch", "cuda"]
_SETUP = {}


def _setup():
    if not _SETUP:
        cfg = reduced_config(get_config("smollm-360m"))
        tcfg = t_reduced_config(t_get_config("smollm-360m"))
        jp = jm.init(cfg, jax.random.PRNGKey(0))
        tp = weights.from_jax(jax.tree.map(np.asarray, jp), tcfg)
        _SETUP.update(cfg=cfg, tcfg=tcfg, jp=jp, tp=tp)
    return _SETUP


def _ctx(impl):
    return RunContext(torch.device("cpu"), impl)


def _pools(seed=0):
    """Random pool contents (stale data everywhere, trash block included),
    as a reference tree and a port tree."""
    s = _setup()
    cfg = s["cfg"]
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, N_BLOCKS, BS, cfg.n_kv_heads, cfg.head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    jpool = {"stack": {"b0": {"k": jnp.asarray(k), "v": jnp.asarray(v)}},
             "rest": {}}
    tpool = {"stack": {"b0": {"k": torch.from_numpy(k.copy()),
                              "v": torch.from_numpy(v.copy())}},
             "rest": {}}
    return jpool, tpool


def _tables(rows):
    """Block tables: row i owns blocks 1 + i*M .. ; rows in ``dead`` are
    all-zero (trash)."""
    t = np.zeros((len(rows), M), np.int32)
    for i, live in enumerate(rows):
        if live:
            t[i] = 1 + i * M + np.arange(M)
    return t


def _cmp_pool(jpool, tpool):
    for kk in ("k", "v"):
        np.testing.assert_allclose(
            tpool["stack"]["b0"][kk].numpy(),
            np.asarray(jpool["stack"]["b0"][kk]), atol=KV_TOL, rtol=0)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch", ["smollm-360m", "qwen2.5-3b",
                                  "stablelm-1.6b", "phi3-mini-3.8b"])
def test_param_specs_match_reference(arch, reduced):
    """Key paths, shapes and dtypes equal the reference's param_specs."""
    cfg, tcfg = get_config(arch), t_get_config(arch)
    if reduced:
        cfg, tcfg = reduced_config(cfg), t_reduced_config(tcfg)
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jm.param_specs(cfg),
            is_leaf=lambda x: hasattr(x, "axes"))[0]:
        key = "/".join(p.key for p in path)
        want[key] = (tuple(leaf.shape), str(jnp.dtype(leaf.dtype)))
    got = {p: (tuple(s.shape), str(s.dtype).replace("torch.", ""))
           for p, s in spec_leaves(tm.param_specs(tcfg))}
    assert got == want
    assert tm.n_params(tcfg) == jm.n_params(cfg)


def test_from_jax_checks_paths_and_shapes():
    s = _setup()
    tree = jax.tree.map(np.asarray, s["jp"])
    tree["embed"] = tree["embed"][:, :3]
    with pytest.raises(ValueError, match="embed"):
        weights.from_jax(tree, s["tcfg"])
    tree = jax.tree.map(np.asarray, s["jp"])
    del tree["final_norm"]
    with pytest.raises(ValueError, match="final_norm"):
        weights.from_jax(tree, s["tcfg"])


def test_init_is_seeded_and_shaped():
    tcfg = _setup()["tcfg"]
    a = tm.init(tcfg, torch.Generator().manual_seed(3), torch.device("cpu"))
    b = tm.init(tcfg, torch.Generator().manual_seed(3), torch.device("cpu"))
    assert torch.equal(a["embed"], b["embed"])
    assert a["layers"]["stack"]["b0"]["attn"]["wq"].shape == (2, 64, 6, 16)
    assert float(a["final_norm"]["scale"].abs().sum()) == 0.0


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_prefill_matches_reference(impl):
    s = _setup()
    toks = np.random.default_rng(1).integers(0, 256, (3, 13), dtype=np.int32)
    jl, jc = jm.forward(s["cfg"], s["jp"], {"tokens": jnp.asarray(toks)},
                        JContext(), "prefill", cache_capacity=16)
    tl, tc = tm.forward(s["tcfg"], s["tp"], {"tokens": _t(toks)},
                        _ctx(impl), "prefill", cache_capacity=16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL)
    assert (tl.argmax(-1).numpy() == np.asarray(jl).argmax(-1)).all()
    _cmp_pool(jc, tc)


@pytest.mark.parametrize("impl", IMPLS)
def test_decode_step_matches_reference(impl):
    """Per-slot cursors, an inactive row (all-trash table, pos 0) and a
    cursor at capacity - 1."""
    s = _setup()
    jpool, tpool = _pools(2)
    tables = _tables([True, True, False])
    pos = np.array([5, CAP - 1, 0], np.int32)
    tok = np.array([[7], [200], [0]], np.int32)
    jl, jpool = jm.decode_step(s["cfg"], s["jp"], jpool, jnp.asarray(tok),
                               jnp.asarray(pos), JContext(),
                               block_tables=jnp.asarray(tables),
                               block_size=BS)
    tl, tpool = tm.decode_step(s["tcfg"], s["tp"], tpool, _t(tok), _t(pos),
                               _ctx(impl), block_tables=_t(tables),
                               block_size=BS)
    np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2],
                               atol=LOGIT_TOL)
    assert (tl[:2].argmax(-1).numpy() == np.asarray(jl)[:2].argmax(-1)).all()
    jpool = jax.tree.map(lambda a: a.at[:, 0].set(0), jpool)   # trash block
    tpool["stack"]["b0"]["k"][:, 0] = 0
    tpool["stack"]["b0"]["v"][:, 0] = 0
    _cmp_pool(jpool, tpool)


@pytest.mark.parametrize("impl", IMPLS)
def test_decode_loop_matches_reference(impl):
    """A window with a mid-window completion, an empty slot, and a row
    decoding past capacity (write position pinned at capacity - 1)."""
    s = _setup()
    jpool, tpool = _pools(3)
    tables = _tables([True, True, False])
    pos = np.array([5, CAP - 2, 0], np.int32)
    tok = np.array([[3], [90], [0]], np.int32)
    left = np.array([2, 4, 0], np.int32)
    kw = dict(block_size=BS, num_steps=4, capacity=CAP)
    jt, jpool = jm.decode_loop(s["cfg"], s["jp"], jpool, jnp.asarray(tok),
                               jnp.asarray(pos), jnp.asarray(left),
                               JContext(), block_tables=jnp.asarray(tables),
                               **kw)
    tt, tpool = tm.decode_loop(s["tcfg"], s["tp"], tpool, _t(tok), _t(pos),
                               _t(left), _ctx(impl), block_tables=_t(tables),
                               **kw)
    assert tt.numpy().tolist() == np.asarray(jt).tolist()
    jpool = jax.tree.map(lambda a: a.at[:, 0].set(0), jpool)
    tpool["stack"]["b0"]["k"][:, 0] = 0
    tpool["stack"]["b0"]["v"][:, 0] = 0
    _cmp_pool(jpool, tpool)


def _suffix_case():
    toks = np.random.default_rng(4).integers(0, 256, (3, 8), dtype=np.int32)
    pos0 = np.array([3, CAP - 6, 0], np.int32)     # row 1 runs past capacity
    n = np.array([6, 8, 0], np.int32)              # row 2 is a pad row
    return toks, pos0, n, _tables([True, True, False])


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("chunk", [0, 4, 8])
def test_suffix_prefill_matches_reference(chunk, impl):
    """prefill_loop (chunk 0) and prefill_chunks (chunk 4, 8): first tokens
    equal, pools allclose, including the capacity clamp (last-live-wins)
    and a dead pad row parked in the trash block."""
    s = _setup()
    jpool, tpool = _pools(5)
    toks, pos0, n, tables = _suffix_case()
    args_j = (jnp.asarray(toks), jnp.asarray(pos0), jnp.asarray(n),
              JContext())
    args_t = (_t(toks), _t(pos0), _t(n), _ctx(impl))
    if chunk:
        kw = dict(block_size=BS, chunk=chunk, num_steps=8 // chunk,
                  capacity=CAP)
        jf, jpool = jm.prefill_chunks(s["cfg"], s["jp"], jpool, *args_j,
                                      block_tables=jnp.asarray(tables), **kw)
        tf, tpool = tm.prefill_chunks(s["tcfg"], s["tp"], tpool, *args_t,
                                      block_tables=_t(tables), **kw)
    else:
        kw = dict(block_size=BS, num_steps=8, capacity=CAP)
        jf, jpool = jm.prefill_loop(s["cfg"], s["jp"], jpool, *args_j,
                                    block_tables=jnp.asarray(tables), **kw)
        tf, tpool = tm.prefill_loop(s["tcfg"], s["tp"], tpool, *args_t,
                                    block_tables=_t(tables), **kw)
    assert tf[:2].numpy().tolist() == np.asarray(jf)[:2].tolist()
    jpool = jax.tree.map(lambda a: a.at[:, 0].set(0), jpool)
    tpool["stack"]["b0"]["k"][:, 0] = 0
    tpool["stack"]["b0"]["v"][:, 0] = 0
    _cmp_pool(jpool, tpool)


@pytest.mark.parametrize("impl", IMPLS)
def test_chunk_step_logits_match_reference(impl):
    s = _setup()
    jpool, tpool = _pools(6)
    toks, pos0, n, tables = _suffix_case()
    kw = dict(block_size=BS, capacity=CAP)
    jl, _ = jm.chunk_step(s["cfg"], s["jp"], jpool, jnp.asarray(toks),
                          jnp.asarray(pos0), jnp.asarray(n), JContext(),
                          block_tables=jnp.asarray(tables), **kw)
    tl, _ = tm.chunk_step(s["tcfg"], s["tp"], tpool, _t(toks), _t(pos0),
                          _t(n), _ctx(impl), block_tables=_t(tables), **kw)
    np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2],
                               atol=LOGIT_TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_mixed_loop_matches_reference(impl):
    """One fused loop: a 2-row decode cohort (one finishing mid-window)
    plus 2 joining suffix rows on disjoint blocks."""
    s = _setup()
    jpool, tpool = _pools(7)
    dec_tables = _tables([True, True, False])[:2]
    sfx_tables = np.zeros((2, M), np.int32)
    sfx_tables[0] = 1 + 2 * M + np.arange(M)
    tok = np.array([[11], [12]], np.int32)
    pos = np.array([4, 9], np.int32)
    left = np.array([3, 1], np.int32)
    stoks = np.random.default_rng(8).integers(0, 256, (2, 8), dtype=np.int32)
    spos = np.array([2, 0], np.int32)
    sn = np.array([7, 0], np.int32)
    kw = dict(block_size=BS, chunk=4, num_steps=3, capacity=CAP)
    jt, jf, jpool = jm.mixed_loop(
        s["cfg"], s["jp"], jpool, jnp.asarray(tok), jnp.asarray(pos),
        jnp.asarray(left), jnp.asarray(stoks), jnp.asarray(spos),
        jnp.asarray(sn), JContext(), block_tables=jnp.asarray(dec_tables),
        sfx_tables=jnp.asarray(sfx_tables), **kw)
    tt, tf, tpool = tm.mixed_loop(
        s["tcfg"], s["tp"], tpool, _t(tok), _t(pos), _t(left), _t(stoks),
        _t(spos), _t(sn), _ctx(impl), block_tables=_t(dec_tables),
        sfx_tables=_t(sfx_tables), **kw)
    assert tt.numpy().tolist() == np.asarray(jt).tolist()
    assert int(tf[0]) == int(np.asarray(jf)[0])
    jpool = jax.tree.map(lambda a: a.at[:, 0].set(0), jpool)
    tpool["stack"]["b0"]["k"][:, 0] = 0
    tpool["stack"]["b0"]["v"][:, 0] = 0
    _cmp_pool(jpool, tpool)


def test_supports_chunked_and_unported_paths():
    tcfg = _setup()["tcfg"]
    assert tm.supports_chunked_prefill(tcfg)
    rg = t_reduced_config(t_get_config("recurrentgemma-2b"))
    assert not tm.supports_chunked_prefill(rg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.init_paged_cache(rg, 2, 4, 4)
    with pytest.raises(NotImplementedError, match="training"):
        tm.forward(tcfg, _setup()["tp"], {"tokens": torch.zeros(1, 4)},
                   _ctx("torch"), "train")
    with pytest.raises(ValueError, match="impl"):
        RunContext(torch.device("cpu"), "pallas")
