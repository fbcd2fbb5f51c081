"""The port's RG-LRU hybrid slice (recurrentgemma) vs the reference (CPU,
float32).

Kernel level: the port's ``ops.rglru_scan`` (its plain version on CPU
tensors) against the reference Pallas kernel in interpret mode, at the
shapes of ``tests/test_kernels.py``, atol 1e-5 / rtol 1e-4 as there; the
port's ``flash_attention`` against the reference's at head_dim 256, MQA
10:1 and a sliding window (atol 1e-5).  Model level: reduced recurrentgemma
at 5 layers (one (rglru, rglru, attn) group plus an (rglru, rglru) rest) on
the reference's ``model.init`` weights carried over by
``weights.from_jax``, with the zero-initialised leaves (gate and conv
biases, norm scales) replaced by numpy draws in both trees; prefill logits
atol 1e-4, RG-LRU state and ring KV atol 1e-5, through decode steps that
wrap the window ring and on the linear (non-ring) cache.  Serving level:
the port's contiguous-cohort ``ClientHandler`` must emit the reference
handler's tokens under a fixed-time executor, with and without the ring.
bfloat16: the block's gelu gate against the reference's, under
``test_torch_model.assert_bf16_parity``'s tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced_config
from repro.core import venues as jvenues
from repro.core.scheduler import ServeRequest as JRequest
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.launch import serve as jserve
from repro.models import model as jm
from repro.models import rglru as jrglru
from repro.models.context import RunContext as JContext
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced_config as t_reduced_config
from repro_torch.core.scheduler import ServeRequest
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tm
from repro_torch.models import rglru as trglru
from repro_torch.models import weights
from repro_torch.models.context import RunContext
from repro_torch.models.spec import spec_leaves

ARCH = "recurrentgemma-2b"
N_LAYERS = 5
LOGIT_TOL = 1e-4
STATE_TOL = 1e-5
SCAN_TOL = dict(atol=1e-5, rtol=1e-4)
CAP = 32
IMPLS = ["torch", "cuda"]
_SETUP = {}


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _ctx(impl):
    return RunContext(torch.device("cpu"), impl)


def _scan_inputs(rng, b, s, r):
    """a = sigmoid(N(0, 1)), b ~ N(0, 1), h0 ~ N(0, 1) (the distribution
    of ``tests/test_kernels.py``), as numpy float32."""
    a = (1 / (1 + np.exp(-rng.standard_normal((b, s, r))))).astype(np.float32)
    bb = rng.standard_normal((b, s, r)).astype(np.float32)
    h0 = rng.standard_normal((b, r)).astype(np.float32)
    return a, bb, h0


def _perturbed(tree, seed=5):
    """The reference tree with its zero-initialised leaves drawn from
    numpy: gate and conv biases ~ N(0, 0.5), norm scales ~ N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for key, val in node.items():
            if isinstance(val, dict):
                out[key] = walk(val)
            elif key in ("ba", "bi", "conv_b"):
                out[key] = (0.5 * rng.standard_normal(val.shape)
                            ).astype(np.float32)
            elif key == "scale":
                out[key] = (0.1 * rng.standard_normal(val.shape)
                            ).astype(np.float32)
            else:
                out[key] = np.asarray(val)
        return out
    return walk(tree)


def _setup():
    """Reduced recurrentgemma at N_LAYERS on shared weights, both
    packages (built once per worker)."""
    if not _SETUP:
        cfg = dataclasses.replace(reduced_config(get_config(ARCH)),
                                  n_layers=N_LAYERS)
        tcfg = dataclasses.replace(t_reduced_config(t_get_config(ARCH)),
                                   n_layers=N_LAYERS)
        init = jax.jit(jm.init, static_argnums=0)
        tree = _perturbed(jax.tree.map(np.asarray,
                                       init(cfg, jax.random.PRNGKey(0))))
        jp = jax.tree.map(jnp.asarray, tree)
        _SETUP.update(cfg=cfg, tcfg=tcfg, tree=tree, jp=jp,
                      tp=weights.from_jax(tree, tcfg),
                      jdecode=jax.jit(lambda p, c, t, pos: jm.decode_step(
                          cfg, p, c, t, pos, JContext())))
    return _SETUP


def _cmp_cache(jcache, tcache, tol):
    n = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(jcache)[0]:
        node = tcache
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == tuple(leaf.shape), path
        np.testing.assert_allclose(node.numpy(), np.asarray(leaf), atol=tol,
                                   rtol=0)
        n += 1
    assert n == len(tm.cache_leaves(_setup()["tcfg"], tcache))


# --------------------------------------------------------------------------- #
# kernels: ops.rglru_scan (plain version on CPU) vs the Pallas kernel, and
# flash attention at head_dim 256
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("b,s,r,bs,with_h0", [
    (1, 64, 32, 16, True), (2, 100, 96, 32, True), (3, 256, 128, 256, True),
    (1, 8, 16, 8, True), (2, 100, 96, 32, False),
])
def test_rglru_scan_matches_pallas(b, s, r, bs, with_h0):
    a, bb, h0 = _scan_inputs(np.random.default_rng(b * s + r), b, s, r)
    want_h, want_last = jops.rglru_scan(
        jnp.asarray(a), jnp.asarray(bb),
        jnp.asarray(h0) if with_h0 else None, bs=bs, interpret=True)
    got_h, got_last = ops.rglru_scan(_t(a), _t(bb),
                                     _t(h0) if with_h0 else None)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **SCAN_TOL)
    np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last),
                               **SCAN_TOL)
    init = h0 if with_h0 else np.zeros_like(h0)
    oh, olast = jref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(bb),
                                    jnp.asarray(init))
    ph, plast = ref.rglru_scan_ref(_t(a), _t(bb), _t(init))
    np.testing.assert_allclose(ph.numpy(), np.asarray(oh), **SCAN_TOL)
    np.testing.assert_allclose(plast.numpy(), np.asarray(olast), **SCAN_TOL)


def test_rglru_scan_edge_cases():
    """h0=None means zeros; one step is the decode step's arithmetic; an
    empty sequence returns h0; out_dtype rounds the state once."""
    a, bb, h0 = (_t(x) for x in _scan_inputs(np.random.default_rng(3),
                                              2, 5, 12))
    h_none, last_none = ops.rglru_scan(a, bb)
    h_zero, last_zero = ops.rglru_scan(a, bb, torch.zeros_like(h0))
    assert torch.equal(h_none, h_zero) and torch.equal(last_none, last_zero)
    h1, last1 = ops.rglru_scan(a[:, :1].contiguous(), bb[:, :1].contiguous(),
                               h0)
    assert torch.equal(last1, a[:, 0] * h0 + bb[:, 0])
    assert torch.equal(h1[:, 0], last1)
    he, laste = ops.rglru_scan(a[:, :0].contiguous(), bb[:, :0].contiguous(),
                               h0)
    assert he.shape == (2, 0, 12) and torch.equal(laste, h0)
    hb, lastb = ops.rglru_scan(a, bb, h0, out_dtype=torch.bfloat16)
    hf, lastf = ops.rglru_scan(a, bb, h0)
    assert hb.dtype == torch.bfloat16 and lastb.dtype == torch.float32
    assert torch.equal(hb, hf.bfloat16()) and torch.equal(lastb, lastf)
    # the model's plain scan rounds as the kernel's plain version does
    hm, lastm = trglru.linear_scan(a, bb, h0)
    assert torch.equal(hm, hf) and torch.equal(lastm, lastf)


@pytest.mark.parametrize("case,err", [
    ("shape", ValueError), ("h0_shape", ValueError), ("dtype", TypeError),
    ("h0_dtype", TypeError), ("out_dtype", TypeError),
    ("strided", ValueError),
])
def test_rglru_scan_rejects_bad_inputs(case, err):
    a, bb, h0 = (_t(x) for x in _scan_inputs(np.random.default_rng(4),
                                              2, 4, 8))
    kw = {}
    if case == "shape":
        bb = bb[:, :3]
    elif case == "h0_shape":
        h0 = h0[:1]
    elif case == "dtype":
        a = a.bfloat16()
    elif case == "h0_dtype":
        h0 = h0.double()
    elif case == "out_dtype":
        kw["out_dtype"] = torch.float16
    elif case == "strided":
        a = a.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(err):
        ops.rglru_scan(a, bb, h0, **kw)


def test_flash_attention_head_dim_256_matches_pallas():
    """recurrentgemma's attention: D 256, 10 query heads over 1 KV head,
    window 16, S 40 (a ragged tile edge)."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 40, 10, 256)).astype(np.float32)
    k, v = (rng.standard_normal((2, 40, 1, 256)).astype(np.float32)
            for _ in range(2))
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), window=16, bq=16, bk=16,
                                interpret=True)
    got = ops.flash_attention(_t(q), _t(k), _t(v), window=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    # the CUDA tiles: in bfloat16, the tensor-core kernel's 128 flattened
    # (position, head) rows per CTA at the serving shape, in 192 KiB of
    # shared memory; in float32, the scalar kernel's 8 rows x 256 fill its
    # accumulator.  paged_prefill's per-group tile (10 rows) does not fit
    # and is refused (paged_decode takes 5 of the 10 heads per CTA:
    # tests/test_torch_paged_plan.py)
    plan = ops.flash_plan(8, 2048, 10, 1, 256, torch.bfloat16)
    assert (plan.kernel, plan.rows, plan.grid) == ("tensor_core", 128,
                                                   (160, 1, 8))
    assert plan.smem <= ops._MAX_SMEM
    assert ops.flash_plan(8, 2048, 10, 1, 256, torch.float32).rows == 8
    ops._fits("flash_attention", 8, 8, 256)
    with pytest.raises(ValueError, match="exceeds one CTA"):
        ops._fits("paged_prefill", 10, 8, 256)


# --------------------------------------------------------------------------- #
# model functions
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("reduced", [True, False])
def test_rglru_param_specs_match_reference(reduced):
    cfg, tcfg = get_config(ARCH), t_get_config(ARCH)
    if reduced:
        cfg = dataclasses.replace(reduced_config(cfg), n_layers=N_LAYERS)
        tcfg = dataclasses.replace(t_reduced_config(tcfg), n_layers=N_LAYERS)
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jm.param_specs(cfg), is_leaf=lambda x: hasattr(x, "axes"))[0]:
        want["/".join(p.key for p in path)] = (
            tuple(leaf.shape), str(jnp.dtype(leaf.dtype)))
    got = {p: (tuple(sp.shape), str(sp.dtype).replace("torch.", ""))
           for p, sp in spec_leaves(tm.param_specs(tcfg))}
    assert got == want
    assert tm.n_params(tcfg) == jm.n_params(cfg)
    if not reduced:
        assert tm.n_params(tcfg) == 2_894_574_080
        assert any("/rec/" in p for p in got)


def test_rglru_block_functions_match_reference():
    """conv, gates, the plain scan (sequential here, associative in the
    reference) and the decode step, with and without carried state."""
    lp = jax.tree.map(lambda a: a[0],
                      _setup()["tree"]["layers"]["stack"]["b0"]["rec"])
    tp = {k: _t(v) for k, v in lp.items()}
    jp = {k: jnp.asarray(v) for k, v in lp.items()}
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    carry = rng.standard_normal((2, 3, 64)).astype(np.float32)
    h0 = rng.standard_normal((2, 64)).astype(np.float32)
    for c in (None, carry):
        jy, jc = jrglru._causal_conv(jnp.asarray(x), jp["conv_w"],
                                     jp["conv_b"],
                                     None if c is None else jnp.asarray(c))
        ty, tc = trglru._causal_conv(_t(x), tp["conv_w"], tp["conv_b"],
                                     None if c is None else _t(c))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-6)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    ja, jb = jrglru._gates(jnp.asarray(x), jp)
    ta, tb = trglru._gates(_t(x), tp)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-6)
    for h in (None, h0):
        jh, jl = jrglru.rglru_scan_ref(jnp.asarray(x), jp,
                                       None if h is None else jnp.asarray(h))
        th, tl = trglru.rglru_scan_ref(_t(x), tp, None if h is None else _t(h))
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=STATE_TOL)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=STATE_TOL)
    jh, jl = jrglru.rglru_step(jnp.asarray(x[:, :1]), jp, jnp.asarray(h0))
    th, tl = trglru.rglru_step(_t(x[:, :1]), tp, _t(h0))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=STATE_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=STATE_TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_hybrid_forward_prefill_matches_reference(impl):
    """Prefill of one window (the ring's first fill): logits, RG-LRU state
    (h, conv) and ring KV agree; the kernel wrappers run their plain
    versions on CPU tensors."""
    s = _setup()
    toks = np.random.default_rng(1).integers(0, 256, (3, 8), dtype=np.int32)
    jl, jc = jm.forward(s["cfg"], s["jp"], {"tokens": jnp.asarray(toks)},
                        JContext(), "prefill", cache_capacity=CAP)
    n0 = dict(ops.launches)
    tl, tc = tm.forward(s["tcfg"], s["tp"], {"tokens": _t(toks)},
                        _ctx(impl), "prefill", cache_capacity=CAP)
    assert ops.launches == n0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL)
    assert (tl.argmax(-1).numpy() == np.asarray(jl).argmax(-1)).all()
    assert tc["stack"]["b2"]["k"].shape[2] == s["tcfg"].window
    _cmp_cache(jc, tc, STATE_TOL)


@pytest.mark.parametrize("prompt,cap,steps", [
    (8, CAP, 11),        # prompt = window: ring, wraps once and more
    (16, CAP, 3),        # a multiple of the window: ring from the last 8
    (4, 24, 10),         # shorter than the window: linear cache, window mask
    (4, 8, 6),           # a ring one window long, its unwritten slots masked
])
def test_hybrid_decode_steps_match_reference(prompt, cap, steps):
    s = _setup()
    toks = np.random.default_rng(2).integers(0, 256, (2, prompt),
                                             dtype=np.int32)
    _, jc = jm.forward(s["cfg"], s["jp"], {"tokens": jnp.asarray(toks)},
                       JContext(), "prefill", cache_capacity=cap)
    _, tc = tm.forward(s["tcfg"], s["tp"], {"tokens": _t(toks)},
                       _ctx("torch"), "prefill", cache_capacity=cap)
    ring = prompt >= s["tcfg"].window or cap == s["tcfg"].window
    assert (tc["stack"]["b2"]["k"].shape[2] == s["tcfg"].window) == ring
    nxt = np.array([[7], [200]], np.int32)
    for pos in range(prompt, prompt + steps):
        jl, jc = s["jdecode"](s["jp"], jc, jnp.asarray(nxt), jnp.int32(pos))
        tl, tc = tm.decode_step(s["tcfg"], s["tp"], tc, _t(nxt), pos,
                                _ctx("torch"))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL)
        _cmp_cache(jc, tc, STATE_TOL)
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]


def test_misaligned_window_prefill_raises():
    """A prompt longer than the window and not a multiple of it would fill
    the ring out of phase (the reference's next decode step overwrites a
    key still in the window); the port raises instead."""
    s = _setup()
    for n in (12, 20):
        with pytest.raises(ValueError, match="out of phase"):
            tm.forward(s["tcfg"], s["tp"],
                       {"tokens": torch.zeros((1, n), dtype=torch.int32)},
                       _ctx("torch"), "prefill", cache_capacity=CAP)


def test_hybrid_cache_layout_matches_reference():
    """init_cache shapes (ring capped at the window), cache_axes and
    cache_mem_bytes equal the reference's; state rows are reported."""
    s = _setup()
    jc = jm.init_cache(s["cfg"], 3, CAP)
    tc = tm.init_cache(s["tcfg"], 3, CAP)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jc)[0]:
        node = tc
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == tuple(leaf.shape)
        assert str(node.dtype).replace("torch.", "") == str(leaf.dtype)
    assert tm.cache_axes(s["tcfg"]) == jm.cache_axes(s["cfg"])
    assert tm.has_state_rows(s["tcfg"])
    tb = tserve.LMBackend(s["tcfg"], capacity=CAP, params=s["tp"],
                          device="cpu")
    assert tb.cache_mem_bytes(4) == jvenues.pytree_bytes(
        jm.abstract_cache(s["cfg"], 4, CAP))
    assert not tm.supports_chunked_prefill(s["tcfg"])


# --------------------------------------------------------------------------- #
# serving: the contiguous cohort handler
# --------------------------------------------------------------------------- #
_REF_TOKENS = {}


def _fixed(c, f, a):
    return f(*a), 0.05


def _trace():
    """6 requests of 5-11 tokens, 4-6 new tokens each, arriving 0.08 s
    apart (two cohorts under max_batch 4, rows retiring mid-cohort)."""
    rng = np.random.default_rng(1)
    return [(i, rng.integers(0, 256, int(rng.integers(5, 12)),
                             dtype=np.int32), 6 if i % 3 else 4, 0.08 * i)
            for i in range(6)]


def _kw(prompt_pad, executor=_fixed):
    return dict(max_batch=4, prompt_pad=prompt_pad, kv="contiguous",
                max_secondaries=0, executor=executor)


def _reference_tokens(prompt_pad):
    if prompt_pad not in _REF_TOKENS:
        s = _setup()
        with pytest.MonkeyPatch.context() as mp:    # shared weights
            mp.setattr(jm, "init", lambda cfg, key: s["jp"])
            jb = jserve.LMBackend(s["cfg"], capacity=CAP)
        reqs = [JRequest(i, p, n, arrival_t=t) for i, p, n, t in _trace()]
        rep = jserve.ClientHandler(jb, **_kw(prompt_pad)).run(reqs)
        _REF_TOKENS[prompt_pad] = ({c.rid: [int(x) for x in c.tokens]
                                    for c in rep.completions}, rep)
    return _REF_TOKENS[prompt_pad]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("prompt_pad", [8, 4])
def test_hybrid_handler_tokens_match_reference(prompt_pad, impl):
    """Token streams identical to the reference handler's: prompt_pad 8
    fills the window (decode wraps the ring), 4 stays on the linear
    cache."""
    s = _setup()
    want, jrep = _reference_tokens(prompt_pad)
    backend = tserve.LMBackend(s["tcfg"], capacity=CAP, params=s["tp"],
                               device="cpu", impl=impl)
    reqs = [ServeRequest(i, p, n, arrival_t=t) for i, p, n, t in _trace()]
    rep = tserve.ClientHandler(backend, **_kw(prompt_pad)).run(reqs)
    got = {c.rid: [int(x) for x in c.tokens] for c in rep.completions}
    assert len(want) == 6 and got == want
    assert rep.kv_mode == "contiguous" and rep.kv_util == jrep.kv_util
    assert rep.makespan_s == jrep.makespan_s


def test_hybrid_step_closures_are_idempotent():
    """Cohort prefill and ring decode closures run twice on their inputs
    give the same tokens (in-place ring KV, replaced state)."""
    s = _setup()
    backend = tserve.LMBackend(s["tcfg"], capacity=CAP, params=s["tp"],
                               device="cpu")
    runs = []

    def twice(c, f, a):
        first = f(*a)[0].clone()
        out = f(*a)
        assert torch.equal(first, out[0])
        runs.append(1)
        return out, 0.05

    reqs = [ServeRequest(i, p, n, arrival_t=t) for i, p, n, t in _trace()]
    rep = tserve.ClientHandler(backend, **_kw(8, twice)).run(reqs)
    got = {c.rid: [int(x) for x in c.tokens] for c in rep.completions}
    assert got == _reference_tokens(8)[0] and len(runs) > 6


def test_hybrid_handler_rejects_paged_and_misaligned_pad():
    s = _setup()
    backend = tserve.LMBackend(s["tcfg"], capacity=CAP, params=s["tp"],
                               device="cpu")
    with pytest.raises(NotImplementedError, match="full attention"):
        tserve.ClientHandler(backend, executor=_fixed)
    with pytest.raises(NotImplementedError, match="full attention"):
        tm.init_paged_cache(s["tcfg"], 2, 4, 4)
    with pytest.raises(ValueError, match="window"):
        tserve.ClientHandler(backend, **_kw(12))
    for pad in (4, 8, 16):
        tserve.ClientHandler(backend, **_kw(pad))


def test_cli_serves_recurrentgemma_contiguous_on_cpu(capsys):
    tserve.main(["--handler", "--kv", "contiguous", "--arch", ARCH,
                 "--requests", "3", "--new-tokens", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served=3" in out and "kv=contiguous" in out


def test_rglru_gate_bf16_matches_reference():
    """bf16: the gelu gate takes the float32 product of x and ``wy``, as
    the reference's ``preferred_element_type`` keeps it.  A decode step of
    ``rglru_block_apply`` at recurrentgemma-2b's width reduces to its gate
    on both sides: ``wx`` and the conv bias are zero, so the recurrence's
    input is zero; ``lam`` = -100 makes a = 1, so the carried h0 = 1 stays
    1; ``wout`` is the identity; so y = 1 * gate, exactly.  Tolerance as
    in ``test_torch_model.py`` (2% of elements may differ, each by one
    ulp): 0.02% differ; rounding the product to bf16 first makes 29%
    differ."""
    from test_torch_model import assert_bf16_parity, bf16_pair
    cfg = get_config(ARCH)
    d, w, b = cfg.d_model, cfg.conv1d_width, 16
    rng = np.random.default_rng(7)
    tx, jx = bf16_pair(rng, (b, 1, d))
    twy, jwy = bf16_pair(rng, (d, d), d ** -0.5)
    fill = {"wx": np.zeros((d, d)), "conv_w": np.ones((w, d)),
            "conv_b": np.zeros(d), "wa": np.zeros((d, d)), "ba": np.zeros(d),
            "wi": np.zeros((d, d)), "bi": np.zeros(d),
            "lam": np.full(d, -100.0), "wout": np.eye(d)}
    tp = {k: _t(v.astype(np.float32)).bfloat16() for k, v in fill.items()}
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in fill.items()}
    tp["wy"], jp["wy"] = twy, jwy
    h0 = np.ones((b, d), np.float32)
    conv = np.zeros((b, w - 1, d), np.float32)
    got, _ = trglru.rglru_block_apply(
        tp, tx, t_get_config(ARCH), _ctx("torch"),
        {"h": _t(h0), "conv": _t(conv).bfloat16()}, "decode")
    want, _ = jrglru.rglru_block_apply(
        jp, jx, cfg, JContext(),
        {"h": jnp.asarray(h0), "conv": jnp.asarray(conv, jnp.bfloat16)},
        "decode")
    gate = jax.nn.gelu(jnp.einsum("bsd,dr->bsr", jx, jwy,
                                  preferred_element_type=jnp.float32))
    np.testing.assert_array_equal(np.asarray(want, np.float32),
                                  np.asarray(gate.astype(jnp.bfloat16),
                                             np.float32))
    assert got.dtype == torch.bfloat16
    assert_bf16_parity(got, want)
