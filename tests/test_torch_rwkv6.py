"""The port's RWKV-6 slice vs the reference (CPU, float32).

Kernel level: the port's ``ops.rwkv6_scan`` (its plain version on CPU
tensors) against the reference Pallas kernel in interpret mode, at the
shapes of ``tests/test_kernels.py``, atol 2e-4 / rtol 1e-3 as there.
Model level: reduced rwkv6 on the reference's ``model.init`` weights
carried over by ``weights.from_jax``, with the zero-initialised float32
leaves (token-shift mixes, decay base, bonus ``u``) replaced by numpy
draws in both trees so every term of the recurrence is exercised; logits
atol 1e-4, recurrent state atol 1e-5.  Serving level: the port's
contiguous-cohort ``ClientHandler`` must emit the reference handler's
tokens for reduced rwkv6 and smollm under a fixed-time executor.
bfloat16: the channel mix against the reference's, under
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
from repro.models import rwkv6 as jrwkv
from repro.models.context import RunContext as JContext
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced_config as t_reduced_config
from repro_torch.core.scheduler import ServeRequest
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tm
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models import weights
from repro_torch.models.context import RunContext
from repro_torch.models.spec import spec_leaves

LOGIT_TOL = 1e-4
STATE_TOL = 1e-5
SCAN_TOL = dict(atol=2e-4, rtol=1e-3)
CAP = 32
IMPLS = ["torch", "cuda"]
ARCHS = ["rwkv6-7b", "smollm-360m"]
_SETUP = {}


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _ctx(impl):
    return RunContext(torch.device("cpu"), impl)


def _wkv_inputs(rng, b, s, h, n):
    """r, k, v ~ N(0, 1), decays in (0.29, 0.99), u ~ N(0, 1), s0 ~ N(0, 1)
    (the distribution of ``tests/test_kernels.py``), as numpy."""
    r, k, v = (rng.standard_normal((b, s, h, n)).astype(np.float32)
               for _ in range(3))
    w = (1 / (1 + np.exp(-rng.standard_normal((b, s, h, n))))
         * 0.7 + 0.29).astype(np.float32)
    u = rng.standard_normal((h, n)).astype(np.float32)
    s0 = rng.standard_normal((b, h, n, n)).astype(np.float32)
    return r, k, v, w, u, s0


def _perturbed(tree, seed=5):
    """The reference tree with its zero-initialised float32 RWKV leaves
    drawn from numpy: mixes in [0, 1), decay base and bonus ~ N(0, 0.5)."""
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for key, val in node.items():
            if isinstance(val, dict):
                out[key] = walk(val)
            elif key in ("mu", "mu_k", "mu_r"):
                out[key] = rng.random(val.shape).astype(np.float32)
            elif key in ("w0", "u"):
                out[key] = (0.5 * rng.standard_normal(val.shape)
                            ).astype(np.float32)
            else:
                out[key] = np.asarray(val)
        return out
    return walk(tree)


def _setup(arch):
    """Reference config/params and the port's, on shared weights (built
    once per worker)."""
    if arch not in _SETUP:
        cfg = reduced_config(get_config(arch))
        tcfg = t_reduced_config(t_get_config(arch))
        init = jax.jit(jm.init, static_argnums=0)     # one compile, not
        tree = jax.tree.map(np.asarray,               # one per op
                            init(cfg, jax.random.PRNGKey(0)))
        if arch == "rwkv6-7b":
            tree = _perturbed(tree)
        jp = jax.tree.map(jnp.asarray, tree)
        _SETUP[arch] = dict(cfg=cfg, tcfg=tcfg, tree=tree, jp=jp,
                            tp=weights.from_jax(tree, tcfg))
    return _SETUP[arch]


def _cmp_cache(tcfg, jcache, tcache, tol):
    jl = jax.tree_util.tree_flatten_with_path(jcache)[0]
    assert len(jl) == len(tm.cache_leaves(tcfg, tcache))
    for path, leaf in jl:
        node = tcache
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node.numpy(), np.asarray(leaf), atol=tol,
                                   rtol=0)


# --------------------------------------------------------------------------- #
# kernel: ops.rwkv6_scan (plain version on CPU) vs the Pallas kernel
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("b,s,h,n,chunk", [
    (1, 64, 2, 16, 16), (2, 96, 3, 32, 32), (1, 40, 1, 8, 16),
])
def test_rwkv6_scan_matches_pallas(b, s, h, n, chunk):
    r, k, v, w, u, s0 = _wkv_inputs(np.random.default_rng(b * s + n),
                                    b, s, h, n)
    want_y, want_s = jops.rwkv6_scan(*(jnp.asarray(x)
                                       for x in (r, k, v, w, u, s0)),
                                     chunk=chunk, interpret=True)
    got_y, got_s = ops.rwkv6_scan(*(_t(x) for x in (r, k, v, w, u, s0)))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **SCAN_TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **SCAN_TOL)
    tr = lambda x: np.swapaxes(x, 1, 2)            # noqa: E731
    oy, os_ = jref.rwkv6_scan_ref(*(jnp.asarray(tr(x)) for x in (r, k, v, w)),
                                  jnp.asarray(u), jnp.asarray(s0))
    py, ps = ref.rwkv6_scan_ref(*(_t(tr(x)) for x in (r, k, v, w)), _t(u),
                                _t(s0))
    np.testing.assert_allclose(py.numpy(), np.asarray(oy), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(ps.numpy(), np.asarray(os_), atol=1e-5,
                               rtol=1e-5)


def test_rwkv6_scan_edge_cases():
    """s0=None means zeros; one step and an empty sequence need no
    padding; a bf16 input keeps its dtype with float32 decays."""
    r, k, v, w, u, s0 = (_t(x) for x in _wkv_inputs(
        np.random.default_rng(3), 2, 5, 3, 16))
    y0, sn0 = ops.rwkv6_scan(r, k, v, w, u)
    yz, snz = ops.rwkv6_scan(r, k, v, w, u, torch.zeros_like(s0))
    assert torch.equal(y0, yz) and torch.equal(sn0, snz)
    one = [x[:, :1].contiguous() for x in (r, k, v, w)]
    y1, sn1 = ops.rwkv6_scan(*one, u, s0)
    ys, ss = trwkv.wkv6_step(*one, u, s0)
    torch.testing.assert_close(y1, ys, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(sn1, ss, atol=1e-5, rtol=1e-5)
    ye, se = ops.rwkv6_scan(*(x[:, :0].contiguous() for x in (r, k, v, w)),
                            u, s0)
    assert ye.shape == (2, 0, 3, 16) and torch.equal(se, s0)
    yb, _ = ops.rwkv6_scan(r.bfloat16(), k.bfloat16(), v.bfloat16(), w, u,
                           s0)
    assert yb.dtype == torch.bfloat16
    torch.testing.assert_close(yb.float(), ops.rwkv6_scan(
        r.bfloat16().float(), k.bfloat16().float(), v.bfloat16().float(), w,
        u, s0)[0], atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("case,err", [
    ("shape", ValueError), ("dtype", TypeError), ("s0_dtype", TypeError),
    ("w_dtype", TypeError), ("wide", ValueError), ("strided", ValueError),
])
def test_rwkv6_scan_rejects_bad_inputs(case, err):
    n = 80 if case == "wide" else 16
    r, k, v, w, u, s0 = (_t(x) for x in _wkv_inputs(
        np.random.default_rng(4), 1, 4, 2, n))
    if case == "shape":
        u = u[:1]
    elif case == "dtype":
        k = k.double()
    elif case == "s0_dtype":
        s0 = s0.bfloat16()
    elif case == "w_dtype":
        w = w.bfloat16()
    elif case == "strided":
        r = r.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(err):
        ops.rwkv6_scan(r, k, v, w, u, s0)


# --------------------------------------------------------------------------- #
# model functions
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("s,chunk,with_s0", [
    (64, 16, True), (12, 64, False),
])
def test_wkv6_chunked_and_step_match_reference(s, chunk, with_s0):
    r, k, v, w, u, s0 = _wkv_inputs(np.random.default_rng(s), 2, s, 2, 16)
    js0 = jnp.asarray(s0) if with_s0 else None
    ts0 = _t(s0) if with_s0 else None
    jy, js = jrwkv.wkv6_chunked_ref(*(jnp.asarray(x) for x in (r, k, v, w, u)),
                                    js0, chunk=chunk)
    ty, ts = trwkv.wkv6_chunked_ref(*(_t(x) for x in (r, k, v, w, u)), ts0,
                                    chunk=chunk)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **SCAN_TOL)
    one = lambda x: x[:, :1]                       # noqa: E731
    jy1, js1 = jrwkv.wkv6_step(*(jnp.asarray(one(x)) for x in (r, k, v, w)),
                               jnp.asarray(u), jnp.asarray(s0))
    ty1, ts1 = trwkv.wkv6_step(*(_t(one(x)) for x in (r, k, v, w)), _t(u),
                               _t(s0))
    np.testing.assert_allclose(ty1.numpy(), np.asarray(jy1), atol=STATE_TOL)
    np.testing.assert_allclose(ts1.numpy(), np.asarray(js1), atol=STATE_TOL)
    if s % 64:
        return
    with pytest.raises(ValueError, match="multiple"):
        trwkv.wkv6_chunked_ref(*(_t(x[:, :s - 3]) for x in (r, k, v, w)),
                               _t(u), ts0, chunk=chunk)


@pytest.mark.parametrize("reduced", [True, False])
def test_rwkv6_param_specs_match_reference(reduced):
    cfg, tcfg = get_config("rwkv6-7b"), t_get_config("rwkv6-7b")
    if reduced:
        cfg, tcfg = reduced_config(cfg), t_reduced_config(tcfg)
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
        assert tm.n_params(tcfg) == 7_534_944_256


def test_from_jax_keeps_rwkv_float32_leaves():
    """A bf16 model keeps mu, w0, u, mu_k and mu_r in float32, value for
    value, through ``from_jax``."""
    tcfg = dataclasses.replace(t_reduced_config(t_get_config("rwkv6-7b")),
                               dtype="bfloat16")
    keep32 = ("mu", "w0", "u", "mu_k", "mu_r")
    tree = jax.tree_util.tree_map_with_path(
        lambda path, a: a if path[-1].key in keep32
        else np.asarray(jnp.asarray(a, jnp.bfloat16)),
        _setup("rwkv6-7b")["tree"])
    tp = weights.from_jax(tree, tcfg)
    for sub, names in (("tm", keep32[:3]), ("cm", keep32[3:])):
        for name in names:
            leaf = tp["layers"]["stack"]["b0"][sub][name]
            assert leaf.dtype == torch.float32, name
            np.testing.assert_array_equal(
                leaf.numpy(), tree["layers"]["stack"]["b0"][sub][name])
    assert tp["layers"]["stack"]["b0"]["tm"]["wr"].dtype == torch.bfloat16


@pytest.mark.parametrize("impl", IMPLS)
def test_rwkv6_forward_prefill_matches_reference(impl):
    s = _setup("rwkv6-7b")
    toks = np.random.default_rng(1).integers(0, 256, (3, 16), dtype=np.int32)
    jl, jc = jm.forward(s["cfg"], s["jp"], {"tokens": jnp.asarray(toks)},
                        JContext(), "prefill", cache_capacity=CAP)
    n0 = dict(ops.launches)
    tl, tc = tm.forward(s["tcfg"], s["tp"], {"tokens": _t(toks)},
                        _ctx(impl), "prefill", cache_capacity=CAP)
    assert ops.launches == n0          # CPU tensors: plain versions only
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL)
    assert (tl.argmax(-1).numpy() == np.asarray(jl).argmax(-1)).all()
    _cmp_cache(s["tcfg"], jc, tc, STATE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_contiguous_decode_step_matches_reference(arch):
    """Cohort prefill, then lockstep decode steps at a scalar cursor (the
    last one pinned at capacity - 1): logits and caches agree."""
    s = _setup(arch)
    cap = 16
    toks = np.random.default_rng(2).integers(0, 256, (2, 12), dtype=np.int32)
    _, jc = jm.forward(s["cfg"], s["jp"], {"tokens": jnp.asarray(toks)},
                       JContext(), "prefill", cache_capacity=cap)
    _, tc = tm.forward(s["tcfg"], s["tp"], {"tokens": _t(toks)},
                       _ctx("torch"), "prefill", cache_capacity=cap)
    jdecode = jax.jit(lambda p, c, t, pos: jm.decode_step(
        s["cfg"], p, c, t, pos, JContext()))
    nxt = np.array([[7], [200]], np.int32)
    for pos in (12, 13, 15, 15):
        jl, jc = jdecode(s["jp"], jc, jnp.asarray(nxt), jnp.int32(pos))
        tl, tc = tm.decode_step(s["tcfg"], s["tp"], tc, _t(nxt), pos,
                                _ctx("torch"))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL)
        _cmp_cache(s["tcfg"], jc, tc, STATE_TOL)
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_layout_matches_reference(arch):
    """init_cache shapes, cache_axes and cache_mem_bytes equal the
    reference's; cache_take keeps the listed rows of every leaf."""
    s = _setup(arch)
    jc = jm.init_cache(s["cfg"], 3, 8)
    tc = tm.init_cache(s["tcfg"], 3, 8)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jc)[0]:
        node = tc
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == tuple(leaf.shape)
        assert str(node.dtype).replace("torch.", "") == str(leaf.dtype)
    assert tm.cache_axes(s["tcfg"]) == jm.cache_axes(s["cfg"])
    tb = tserve.LMBackend(s["tcfg"], capacity=CAP, params=s["tp"],
                          device="cpu")
    # the reference LMBackend.cache_mem_bytes, without building a backend
    assert tb.cache_mem_bytes(4) == jvenues.pytree_bytes(
        jm.abstract_cache(s["cfg"], 4, CAP))
    full = tm.tree_map(lambda a: torch.arange(a.numel(), dtype=a.dtype)
                       .reshape(a.shape), tc)
    kept = tb.cache_take(full, [2, 0])
    for (leaf, ax), (got, _) in zip(tm.cache_leaves(s["tcfg"], full),
                                    tm.cache_leaves(s["tcfg"], kept)):
        assert torch.equal(got, leaf.index_select(ax, torch.tensor([2, 0])))
    assert tm.has_state_rows(s["tcfg"]) == (arch == "rwkv6-7b")


# --------------------------------------------------------------------------- #
# serving: the contiguous cohort handler
# --------------------------------------------------------------------------- #
_REF_TOKENS = {}


def _fixed(c, f, a):
    return f(*a), 0.05


def _trace():
    """6 requests of 5-11 tokens, 6 new tokens each, arriving 0.08 s
    apart: with max_batch 4 the first cohort is joined by late arrivals
    only through a second cohort, and rows retire at step granularity."""
    rng = np.random.default_rng(1)
    return [(i, rng.integers(0, 256, int(rng.integers(5, 12)),
                             dtype=np.int32), 6 if i % 3 else 4, 0.08 * i)
            for i in range(6)]


_HANDLER_KW = dict(max_batch=4, prompt_pad=12, kv="contiguous",
                   max_secondaries=0, executor=_fixed)


def _reference_tokens(arch):
    if arch not in _REF_TOKENS:
        s = _setup(arch)
        with pytest.MonkeyPatch.context() as mp:    # shared weights, and
            mp.setattr(jm, "init", lambda cfg, key: s["jp"])  # no re-init
            jb = jserve.LMBackend(s["cfg"], capacity=CAP)
        reqs = [JRequest(i, p, n, arrival_t=t) for i, p, n, t in _trace()]
        rep = jserve.ClientHandler(jb, **_HANDLER_KW).run(reqs)
        _REF_TOKENS[arch] = ({c.rid: [int(x) for x in c.tokens]
                              for c in rep.completions}, rep)
    return _REF_TOKENS[arch]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_contiguous_handler_tokens_match_reference(arch, impl):
    """Per-request token streams identical to the reference handler's,
    through the port's plain path and its kernel wrappers alike."""
    s = _setup(arch)
    want, jrep = _reference_tokens(arch)
    backend = tserve.LMBackend(s["tcfg"], capacity=CAP, params=s["tp"],
                               device="cpu", impl=impl)
    reqs = [ServeRequest(i, p, n, arrival_t=t) for i, p, n, t in _trace()]
    rep = tserve.ClientHandler(backend, **_HANDLER_KW).run(reqs)
    got = {c.rid: [int(x) for x in c.tokens] for c in rep.completions}
    assert len(want) == 6 and got == want
    assert rep.kv_mode == "contiguous" and rep.kv_util == jrep.kv_util
    assert rep.makespan_s == jrep.makespan_s


def test_contiguous_step_closures_are_idempotent():
    """Cohort prefill and decode closures run twice on their inputs give
    the same tokens (the Venue executor re-runs closures)."""
    s = _setup("smollm-360m")
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
    kw = dict(_HANDLER_KW, executor=twice)
    rep = tserve.ClientHandler(backend, **kw).run(reqs)
    got = {c.rid: [int(x) for x in c.tokens] for c in rep.completions}
    assert got == _reference_tokens("smollm-360m")[0] and len(runs) > 6


def test_paged_path_raises_for_recurrent_state():
    s = _setup("rwkv6-7b")
    backend = tserve.LMBackend(s["tcfg"], capacity=CAP, params=s["tp"],
                               device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 3"):
        tserve.ClientHandler(backend, executor=_fixed)
    with pytest.raises(NotImplementedError, match="Queue 3"):
        tm.init_paged_cache(s["tcfg"], 2, 4, 4)
    with pytest.raises(ValueError, match="prefill_chunk"):
        tserve.ClientHandler(backend, kv="contiguous", prefill_chunk=4)


def test_cli_serves_rwkv6_contiguous_on_cpu(capsys):
    tserve.main(["--handler", "--kv", "contiguous", "--arch", "rwkv6-7b",
                 "--requests", "3", "--new-tokens", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served=3" in out and "kv=contiguous" in out


def test_channel_mix_bf16_matches_reference():
    """bf16 channel mix at a quarter of rwkv6-7b's width (d_model 1024,
    d_ff 3584: its 3.5 ratio): ``kk`` is the square of the relu of the
    float32 product, and ``rr`` the sigmoid of the float32 product, as the
    reference's ``preferred_element_type`` keeps them.  Tolerance as in
    ``test_torch_model.py`` (2% of elements may differ), but two ulps: the
    output is round(rr * vv) with ``vv`` already rounded to bf16 and
    rr < 1, so one ulp of ``vv`` is up to two of the output.  Here 0.41%
    differ; rounding both products to bf16 first makes 64% differ."""
    from test_torch_model import assert_bf16_parity, bf16_pair
    d, f = 1024, 3584
    rng = np.random.default_rng(8)
    tx, jx = bf16_pair(rng, (2, 16, d))
    tp, jp = {}, {}
    for name in ("mu_k", "mu_r"):
        mu = rng.uniform(0.0, 1.0, d).astype(np.float32)
        tp[name], jp[name] = _t(mu), jnp.asarray(mu)
    for name, shape in (("wk", (d, f)), ("wv", (f, d)), ("wr", (d, d))):
        tp[name], jp[name] = bf16_pair(rng, shape, shape[0] ** -0.5)
    tcfg = t_get_config("rwkv6-7b")
    got, _ = trwkv.rwkv_channel_apply(tp, tx, tcfg, None, "prefill")
    want, _ = jrwkv.rwkv_channel_apply(jp, jx, get_config("rwkv6-7b"), None,
                                       "prefill")
    assert got.dtype == torch.bfloat16
    assert_bf16_parity(got, want, ulps=2)
