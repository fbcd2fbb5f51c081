"""The port's mixture-of-experts layer against the reference (CPU).

Reduced configurations (2 layers, d_model 64, 8 experts, top-2, head_dim
16, float32) share the reference's ``model.init(cfg, PRNGKey(0))`` weights
through ``weights.from_jax``.  Tolerances:

- routing weights, ids and the aux loss: float32, atol 1e-6 (ids equal,
  exact probability ties included);
- the layer (``_dispatch_compute_combine`` / ``moe_apply``) in float32:
  atol 1e-5, at the serving factor ``E / k`` and at 1.25 and 0.25, where
  tokens are dropped; in bfloat16 against the eager reference
  (``jax.disable_jit()``): one bf16 ulp, at most 2% of the outputs
  differing (``test_torch_model.assert_bf16_parity``), the ulp taken at
  the largest of the element's value, the output's RMS and the token's k
  expert outputs: the two sides sum the float32 gate and up products in
  another order, so a hidden element near a bf16 rounding boundary rounds
  the other way, which moves an expert output by up to one ulp of that
  output; weighting (< 1) and the combine's adds carry that into sums in
  a lower binade, where it spans two of their ulps;
- whole-model logits: atol 1e-4 (as ``tests/test_torch_model.py``);
- handler streams: token-identical to the reference handler's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced_config
from repro.core.scheduler import ServeRequest as JRequest
from repro.launch import serve as jserve
from repro.models import model as jm
from repro.models import moe as jmoe
from repro.models.context import RunContext as JContext
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced_config as t_reduced_config
from repro_torch.core.scheduler import ServeRequest
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tm
from repro_torch.models import moe as tmoe
from repro_torch.models import weights
from repro_torch.models.context import RunContext
from repro_torch.models.spec import spec_leaves
from test_torch_model import assert_bf16_parity, bf16_pair

ARCHS = ["olmoe-1b-7b", "mixtral-8x7b"]
IMPLS = ["torch", "cuda"]
ROUTE_TOL = 1e-6
MOE_TOL = 1e-5
LOGIT_TOL = 1e-4
CAP = 32
_SETUP = {}


def _setup(arch):
    if arch not in _SETUP:
        cfg = reduced_config(get_config(arch))
        tcfg = t_reduced_config(t_get_config(arch))
        jp = jm.init(cfg, jax.random.PRNGKey(0))
        tp = weights.from_jax(jax.tree.map(np.asarray, jp), tcfg)
        _SETUP[arch] = dict(cfg=cfg, tcfg=tcfg, jp=jp, tp=tp)
    return _SETUP[arch]


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _ctx(impl="torch", factor=1.25):
    return RunContext(torch.device("cpu"), impl, moe_capacity_factor=factor)


def _serving_factor(cfg):
    return cfg.n_experts / cfg.top_k


def _layer0_ffn(s):
    """Layer 0's expert parameters (reference, port)."""
    jf = jax.tree.map(lambda a: a[0], s["jp"]["layers"]["stack"]["b0"]["ffn"])
    tf = {k: v[0] for k, v in s["tp"]["layers"]["stack"]["b0"]["ffn"].items()}
    return jf, tf


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# --------------------------------------------------------------------------- #
# specs
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("variant", ["reduced", "reduced_bf16", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, variant):
    """Key paths, shapes and dtypes equal the reference's (expert leaves
    stacked on the expert axis); the router stays float32 in bf16."""
    cfg, tcfg = get_config(arch), t_get_config(arch)
    if variant != "full":
        cfg, tcfg = reduced_config(cfg), t_reduced_config(tcfg)
    if variant == "reduced_bf16":
        cfg = dataclasses.replace(cfg, dtype="bfloat16")
        tcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jm.param_specs(cfg), is_leaf=lambda x: hasattr(x, "axes"))[0]:
        want["/".join(p.key for p in path)] = (
            tuple(leaf.shape), str(jnp.dtype(leaf.dtype)))
    got = {p: (tuple(s.shape), str(s.dtype).replace("torch.", ""))
           for p, s in spec_leaves(tm.param_specs(tcfg))}
    assert got == want
    assert tm.n_params(tcfg) == jm.n_params(cfg)
    router = got["layers/stack/b0/ffn/router"]
    assert router == ((tcfg.n_layers, tcfg.d_model, tcfg.n_experts),
                      "float32")
    assert got["layers/stack/b0/ffn/wi"][0] == (
        tcfg.n_layers, tcfg.n_experts, tcfg.d_model, tcfg.d_ff)
    if variant == "reduced_bf16":
        assert got["layers/stack/b0/ffn/wi"][1] == "bfloat16"
        p = tm.init(tcfg, torch.Generator().manual_seed(0),
                    torch.device("cpu"))
        assert p["layers"]["stack"]["b0"]["ffn"]["router"].dtype == \
            torch.float32


@pytest.mark.parametrize("arch,approx", [("olmoe-1b-7b", 1.282e9),
                                         ("mixtral-8x7b", 12.88e9)])
def test_n_active_params_matches_reference(arch, approx):
    n = tm.n_active_params(t_get_config(arch))
    assert n == jm.n_active_params(get_config(arch))
    assert abs(n / approx - 1) < 1e-3
    dense = t_get_config("smollm-360m")
    assert tm.n_active_params(dense) == tm.n_params(dense)


# --------------------------------------------------------------------------- #
# routing and capacity
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("factor", ["E/k", 1.25, 1.0, 0.25])
def test_capacity_matches_reference(factor):
    for arch in ARCHS:
        cfg = get_config(arch)
        tcfg = t_get_config(arch)
        f = _serving_factor(cfg) if factor == "E/k" else factor
        got = [tmoe._capacity(t, tcfg, f) for t in range(1, 1025)]
        want = [jmoe._capacity(t, cfg, f) for t in range(1, 1025)]
        assert got == want, arch
        if factor == "E/k":
            # the serving factor holds every row: T rounded up to 8
            assert got == [max(8, -(-t // 8) * 8) for t in range(1, 1025)]


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_reference(arch):
    """float32 logits and softmax, top-k, Mixtral's renormalisation (its
    weights sum to 1 - 1e-9), the Switch aux loss."""
    s = _setup(arch)
    jf, tf = _layer0_ffn(s)
    x = _x((40, s["cfg"].d_model), 1)
    jw, ji, ja = jmoe._route(jnp.asarray(x), jf["router"], s["cfg"])
    tw, ti, ta = tmoe._route(_t(x), tf["router"], s["tcfg"])
    assert ti.numpy().tolist() == np.asarray(ji).tolist()
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=ROUTE_TOL,
                               rtol=0)
    np.testing.assert_allclose(float(ta), float(ja), atol=ROUTE_TOL, rtol=0)
    assert tw.dtype == torch.float32
    sums = tw.sum(-1).numpy()
    if arch.startswith("mixtral"):
        np.testing.assert_allclose(sums, 1.0, atol=ROUTE_TOL)
    else:
        assert (sums < 1.0 - 1e-3).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_route_exact_ties_take_lower_ids(arch):
    """Rows whose router probabilities tie exactly (duplicate router
    columns; a zero row ties every expert): ids equal ``lax.top_k``'s,
    the lower expert first."""
    s = _setup(arch)
    cfg, tcfg = s["cfg"], s["tcfg"]
    e = cfg.n_experts
    r = _x((cfg.d_model, e), 2)
    r[:, 5] = r[:, 1]
    r[:, 6] = r[:, 1]
    r[:, 7] = r[:, 3]
    x = _x((6, cfg.d_model), 3)
    x[0] = 0.0
    # row 1: experts 1, 5, 6 tie at the top
    x[1] = 2.0 * r[:, 1] / np.square(r[:, 1]).sum()
    jw, ji, _ = jmoe._route(jnp.asarray(x), jnp.asarray(r), cfg)
    tw, ti, _ = tmoe._route(_t(x), _t(r), tcfg)
    assert ti.numpy().tolist() == np.asarray(ji).tolist()
    assert ti[0].tolist() == list(range(cfg.top_k))
    assert ti[1].tolist() == [1, 5][:cfg.top_k]
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=ROUTE_TOL,
                               rtol=0)


# --------------------------------------------------------------------------- #
# the layer
# --------------------------------------------------------------------------- #
def _dropped(cfg, ids, cap):
    """Assignments beyond an expert's capacity."""
    counts = np.bincount(np.asarray(ids).reshape(-1), minlength=cfg.n_experts)
    return int(np.maximum(counts - cap, 0).sum())


@pytest.mark.parametrize("factor", ["E/k", 1.25, 0.25])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, factor):
    """float32 layer output within 1e-5, through ``moe_apply`` and
    ``_dispatch_compute_combine``; at 1.25 and 0.25 tokens are dropped."""
    s = _setup(arch)
    cfg, tcfg = s["cfg"], s["tcfg"]
    f = _serving_factor(cfg) if factor == "E/k" else factor
    jf, tf = _layer0_ffn(s)
    # a shared offset skews the routing, so the tight factors drop
    x = 0.5 * _x((4, 16, cfg.d_model), 4) + _x((1, 1, cfg.d_model), 9)
    jy, ja = jmoe.moe_apply(jf, jnp.asarray(x), cfg,
                            JContext(moe_capacity_factor=f))
    ty, ta = tmoe.moe_apply(tf, _t(x), tcfg, _ctx(factor=f))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=MOE_TOL,
                               rtol=0)
    np.testing.assert_allclose(float(ta), float(ja), atol=ROUTE_TOL, rtol=0)
    x2 = x.reshape(-1, cfg.d_model)
    cap = tmoe._capacity(x2.shape[0], tcfg, f)
    w, ids, _ = tmoe._route(_t(x2), tf["router"], tcfg)
    got = tmoe._dispatch_compute_combine(
        _t(x2), w, ids, tf["wi"], tf.get("wg"), tf["wo"], cfg=tcfg,
        e_offset=0, e_local=cfg.n_experts, capacity=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(jy).reshape(x2.shape),
                               atol=MOE_TOL, rtol=0)
    dropped = _dropped(cfg, ids, cap)
    assert (dropped == 0) == (factor == "E/k"), dropped


def _bf16_case(arch, rows, seed):
    """bf16 expert weights and activations at a wider reduced shape
    (d_model 256, d_ff 512), drawn once and shared bit for bit; the
    router float32."""
    cfg = dataclasses.replace(reduced_config(get_config(arch)),
                              d_model=256, d_ff=512, dtype="bfloat16")
    tcfg = dataclasses.replace(t_reduced_config(t_get_config(arch)),
                               d_model=256, d_ff=512, dtype="bfloat16")
    rng = np.random.default_rng(seed)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    tp, jp = {}, {}
    for name, shape in (("wi", (e, d, f)), ("wg", (e, d, f)),
                        ("wo", (e, f, d))):
        tp[name], jp[name] = bf16_pair(rng, shape, shape[1] ** -0.5)
    r = (rng.standard_normal((d, e)) * d ** -0.5).astype(np.float32)
    tp["router"], jp["router"] = _t(r), jnp.asarray(r)
    tx, jx = bf16_pair(rng, (rows // 16, 16, d))
    return cfg, tcfg, jp, tp, jx, tx


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_bf16_matches_eager_reference(arch):
    """bf16: float32 up/gate products into the activation, ``act(g) * h``
    rounded once, the down product accumulated in float32, the k terms
    added in ascending expert id; the eager reference rounds op by op
    (tolerance in the module docstring)."""
    cfg, tcfg, jp, tp, jx, tx = _bf16_case(arch, 64, 5)
    f = _serving_factor(cfg)
    with jax.disable_jit():
        jy, _ = jmoe.moe_apply(jp, jx, cfg, JContext(moe_capacity_factor=f))
    ty, _ = tmoe.moe_apply(tp, tx, tcfg, _ctx(factor=f))
    assert ty.dtype == torch.bfloat16
    assert_bf16_parity(ty, jy, mag=_largest_term(tp, tx, tcfg))


def _largest_term(tp, tx, tcfg):
    """Per output element, the largest |expert output| of the token's k
    routed experts (bf16-rounded, as the combine reads them)."""
    d = tcfg.d_model
    x2 = tx.reshape(-1, d)
    w, ids, _ = tmoe._route(x2, tp["router"], tcfg)
    act = tmoe._ACTS[tcfg.mlp_act]
    out = torch.zeros(x2.shape, dtype=torch.float32)
    for j in range(tcfg.top_k):
        e = ids[:, j]
        xf = x2.float()[:, None]
        h = (act(xf @ tp["wg"][e].float()) * (xf @ tp["wi"][e].float()))
        y = (h.bfloat16().float() @ tp["wo"][e].float()).bfloat16()
        term = y[:, 0].float().abs()
        out = torch.maximum(out, term)
    return out.reshape(tx.shape).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("factor", ["E/k", 0.25])
def test_moe_apply_is_bitwise_repeatable(factor, dtype):
    """Two calls on the same inputs give the same bits (no atomics in the
    combine): the serving executors re-run step closures."""
    cfg, tcfg, _, tp, _, tx = _bf16_case("olmoe-1b-7b", 96, 6)
    if dtype == "float32":
        tp = {k: v.float() for k, v in tp.items()}
        tx = tx.float()
    f = _serving_factor(cfg) if factor == "E/k" else factor
    a, _ = tmoe.moe_apply(tp, tx, tcfg, _ctx(factor=f))
    b, _ = tmoe.moe_apply(tp, tx, tcfg, _ctx(factor=f))
    assert torch.equal(a, b) and a.dtype == tx.dtype


# --------------------------------------------------------------------------- #
# whole model
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, impl):
    """Prefill logits and contiguous decode steps at the serving factor;
    mixtral's 8-token window makes the decode cache a ring."""
    s = _setup(arch)
    cfg, tcfg = s["cfg"], s["tcfg"]
    f = _serving_factor(cfg)
    jctx, tctx = JContext(moe_capacity_factor=f), _ctx(impl, f)
    pad = 8 if cfg.window else 13
    toks = np.random.default_rng(7).integers(0, 256, (3, pad), np.int32)
    jl, jc = jm.forward(cfg, s["jp"], {"tokens": jnp.asarray(toks)}, jctx,
                        "prefill", cache_capacity=16)
    tl, tc = tm.forward(tcfg, s["tp"], {"tokens": _t(toks)}, tctx,
                        "prefill", cache_capacity=16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL)
    tok = np.asarray(jl).argmax(-1)[:, None].astype(np.int32)
    for pos in range(pad, pad + 3):
        jl, jc = jm.decode_step(cfg, s["jp"], jc, jnp.asarray(tok),
                                jnp.asarray(pos, jnp.int32), jctx)
        tl, tc = tm.decode_step(tcfg, s["tp"], tc, _t(tok), pos, tctx)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL)
        assert (tl.argmax(-1).numpy() == np.asarray(jl).argmax(-1)).all()
        tok = np.asarray(jl).argmax(-1)[:, None].astype(np.int32)


@pytest.mark.parametrize("impl", IMPLS)
def test_olmoe_paged_steps_match_reference(impl):
    """Paged decode (a dead row, a cursor at capacity - 1) and a chunk
    step with a pad row: every routed row counts, as in the reference."""
    s = _setup("olmoe-1b-7b")
    cfg, tcfg = s["cfg"], s["tcfg"]
    f = _serving_factor(cfg)
    jctx, tctx = JContext(moe_capacity_factor=f), _ctx(impl, f)
    bs, m = 4, 4
    n_blocks = 1 + 3 * m
    rng = np.random.default_rng(8)
    shape = (cfg.n_layers, n_blocks, bs, cfg.n_kv_heads, cfg.head_dim)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in "kv")
    jpool = {"stack": {"b0": {"k": jnp.asarray(k), "v": jnp.asarray(v)}},
             "rest": {}}
    tpool = {"stack": {"b0": {"k": _t(k), "v": _t(v)}}, "rest": {}}
    tables = np.zeros((3, m), np.int32)
    tables[0] = 1 + np.arange(m)
    tables[1] = 1 + m + np.arange(m)
    pos = np.array([5, bs * m - 1, 0], np.int32)
    tok = np.array([[7], [200], [0]], np.int32)
    jl, jpool = jm.decode_step(cfg, s["jp"], jpool, jnp.asarray(tok),
                               jnp.asarray(pos), jctx,
                               block_tables=jnp.asarray(tables),
                               block_size=bs)
    tl, tpool = tm.decode_step(tcfg, s["tp"], tpool, _t(tok), _t(pos), tctx,
                               block_tables=_t(tables), block_size=bs)
    np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2],
                               atol=LOGIT_TOL)
    toks = rng.integers(0, 256, (3, 4), dtype=np.int32)
    p0 = np.array([2, 6, 0], np.int32)
    nl = np.array([4, 2, 0], np.int32)
    kw = dict(block_size=bs, capacity=bs * m)
    jl, _ = jm.chunk_step(cfg, s["jp"], jpool, jnp.asarray(toks),
                          jnp.asarray(p0), jnp.asarray(nl), jctx,
                          block_tables=jnp.asarray(tables), **kw)
    tl, _ = tm.chunk_step(tcfg, s["tp"], tpool, _t(toks), _t(p0), _t(nl),
                          tctx, block_tables=_t(tables), **kw)
    np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2],
                               atol=LOGIT_TOL)


# --------------------------------------------------------------------------- #
# handlers
# --------------------------------------------------------------------------- #
_JB = {}


def _fixed(c, f, a):
    return f(*a), 0.05


def _jax_backend(arch, draft=None):
    key = (arch, draft)
    if key not in _JB:
        s = _setup(arch)
        with pytest.MonkeyPatch.context() as mp:        # shared weights
            mp.setattr(jm, "init", lambda cfg, key: s["jp"])
            _JB[key] = jserve.LMBackend(s["cfg"], capacity=CAP, draft=draft)
    return _JB[key]


def _trace(seed=1, n=8, tail=4, new=6, gap=0.08):
    """An 8-token shared prefix, then tails whose first token pairs the
    requests up: full-block hits and copy-on-write splits."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, 256, 8, dtype=np.int32)
    out = []
    for i in range(n):
        t = rng.integers(0, 256, tail, dtype=np.int32)
        t[0] = i // 2
        out.append((i, np.concatenate([prefix, t]), new, gap * i))
    return out


def _serve(kind, arch, trace, impl="torch", draft=None, **kw):
    s = _setup(arch)
    if kind == "jax":
        backend = _jax_backend(arch, draft)
        reqs = [JRequest(i, p, n, arrival_t=t) for i, p, n, t in trace]
        cls = jserve.ClientHandler
    else:
        backend = tserve.LMBackend(s["tcfg"], capacity=CAP, params=s["tp"],
                                   device="cpu", impl=impl, draft=draft)
        assert backend.ctx.moe_capacity_factor == _serving_factor(s["tcfg"])
        reqs = [ServeRequest(i, p, n, arrival_t=t) for i, p, n, t in trace]
        cls = tserve.ClientHandler
    h = cls(backend, max_secondaries=0, executor=_fixed, **kw)
    rep = h.run(reqs)
    return {c.rid: [int(x) for x in c.tokens] for c in rep.completions}, rep


@pytest.mark.parametrize("impl", IMPLS)
def test_olmoe_paged_handler_matches_reference(impl):
    """Reduced olmoe (MHA, g 1) on the paged path: prefix hits,
    copy-on-write, chunked suffix prefill fused with decode windows."""
    kw = dict(max_batch=4, prompt_pad=12, block_size=4, decode_window=4,
              prefill_chunk=4)
    trace = _trace()
    want, jrep = _serve("jax", "olmoe-1b-7b", trace, **kw)
    got, trep = _serve("torch", "olmoe-1b-7b", trace, impl=impl, **kw)
    assert len(want) == 8 and got == want
    assert trep.prefix_hit_rate == jrep.prefix_hit_rate > 0


def test_olmoe_speculative_handler_matches_reference():
    """The oracle draft: every verify window routes slots x (K + 1) rows
    through the experts; streams, rounds and acceptance equal the
    reference handler's and the plain port stream."""
    kw = dict(max_batch=4, prompt_pad=12, block_size=4, decode_window=1,
              speculative=True, spec_k=3, spec_corruption=0.35,
              prefill_chunk=4)
    trace = _trace(seed=2, n=4, new=8)
    want, jrep = _serve("jax", "olmoe-1b-7b", trace, draft="oracle", **kw)
    got, trep = _serve("torch", "olmoe-1b-7b", trace, impl="cuda",
                       draft="oracle", **kw)
    assert got == want and len(got) == 4
    for key in ("spec_rounds", "spec_tokens", "acceptance_rate",
                "spec_fallbacks"):
        assert getattr(trep, key) == getattr(jrep, key), key
    assert trep.spec_rounds > 0
    plain, _ = _serve("torch", "olmoe-1b-7b", trace, impl="cuda",
                      **dict(kw, speculative=False, spec_corruption=0.0))
    assert got == plain


@pytest.mark.parametrize("impl", IMPLS)
def test_mixtral_contiguous_handler_matches_reference(impl):
    """Reduced mixtral (window 8, renormalised top-2) through the cohort
    mode; prompts padded to two windows, so the prefill leaves a ring in
    phase and decode wraps it."""
    kw = dict(max_batch=4, prompt_pad=16, kv="contiguous", decode_window=1)
    trace = _trace(seed=3, tail=6)
    want, jrep = _serve("jax", "mixtral-8x7b", trace, **kw)
    got, trep = _serve("torch", "mixtral-8x7b", trace, impl=impl, **kw)
    assert len(want) == 8 and got == want
    assert trep.kv_mode == "contiguous"
