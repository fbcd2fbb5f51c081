"""Speculative decoding in the port vs the reference (CPU, float32).

Model level: seeded rounds of ``draft_loop`` + ``verify_window`` +
``spec_accept`` run side by side in both packages on shared weights (the
reference's ``model.init(cfg, PRNGKey(0))`` target and ``PRNGKey(7)``
reduced draft, carried by ``weights.from_jax``): every round's live drafts
and live verify grid must be equal, and the final target and draft pools
(trash block aside) within 1e-5 (the two sides sum the projections in
another order: up to 2.4e-6 apart at magnitudes near 2); the port's
speculative stream must equal its own stepwise ``decode_loop`` stream.  The sweep is the reference's
``test_verify_window_token_identical_sweep`` (proposal flips 0 / 1 / 0.35
/ 0.5, a dead row, ragged budgets) plus its capacity clamp and real-draft
cases.

Handler level: ``ClientHandler(speculative=True)`` against the reference
handler on the same trace and weights: token streams and the counters
``spec_rounds`` / ``spec_tokens`` / ``acceptance_rate`` /
``spec_fallbacks`` equal.  A torch fake backend mirrors the reference's
fake-backend scenarios (validation errors, acceptance collapse, no draft
clone).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import draft_config, get_config, reduced_config
from repro.core.scheduler import ServeRequest as JRequest
from repro.launch import serve as jserve
from repro.models import model as jm
from repro.models.context import RunContext as JContext
from repro_torch.configs import draft_config as t_draft_config
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced_config as t_reduced_config
from repro_torch.core.clock import VirtualClock
from repro_torch.core.clones import ClonePool
from repro_torch.core.scheduler import ServeRequest
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tm
from repro_torch.models import weights
from repro_torch.models.context import RunContext

KV_TOL = 1e-5
BS = 4
_SETUP = {}


def _fixed(c, f, a):
    return f(*a), 0.05


def _setup():
    """Reduced smollm-360m target (PRNGKey(0)) and reduced draft
    (PRNGKey(7)) in both packages, plus one reference LMBackend per draft
    kind, built once per worker."""
    if not _SETUP:
        cfg = reduced_config(get_config("smollm-360m"))
        dcfg = draft_config(get_config("smollm-360m"))
        tcfg = t_reduced_config(t_get_config("smollm-360m"))
        tdcfg = t_draft_config(t_get_config("smollm-360m"))
        jp = jm.init(cfg, jax.random.PRNGKey(0))
        jdp = jm.init(dcfg, jax.random.PRNGKey(7))
        _SETUP.update(
            cfg=cfg, dcfg=dcfg, tcfg=tcfg, tdcfg=tdcfg, jp=jp, jdp=jdp,
            tp=weights.from_jax(jax.tree.map(np.asarray, jp), tcfg),
            tdp=weights.from_jax(jax.tree.map(np.asarray, jdp), tdcfg))
    return _SETUP


# --------------------------------------------------------------------------- #
# model level
# --------------------------------------------------------------------------- #
class _Jax:
    """The reference's model functions on numpy in, numpy out."""

    def __init__(self, real_draft):
        s = _setup()
        self.cfg, self.params = s["cfg"], s["jp"]
        self.dcfg, self.dparams = ((s["dcfg"], s["jdp"]) if real_draft
                                   else (s["cfg"], s["jp"]))
        self.ctx = JContext()

    def pool(self, cfg, slots, blocks):
        return jm.init_paged_cache(cfg, slots, blocks, BS)

    def prefill(self, pool, toks, n, tables, cap):
        first, pool = jm.prefill_loop(
            self.cfg, self.params, pool, jnp.asarray(toks),
            jnp.zeros(len(n), jnp.int32), jnp.asarray(n), self.ctx,
            block_tables=jnp.asarray(tables), block_size=BS,
            num_steps=toks.shape[1], capacity=cap)
        return np.asarray(first, np.int32), pool

    def draft(self, dpool, ctoks, cpos0, n_c, cur, p, k, tables, k_max,
              cap):
        drafts, dpool = jm.draft_loop(
            self.dcfg, self.dparams, dpool, *map(jnp.asarray, (
                ctoks, cpos0, n_c, cur[:, None], p, k)), self.ctx,
            block_tables=jnp.asarray(tables), block_size=BS,
            catchup_steps=ctoks.shape[1], num_steps=k_max, capacity=cap)
        return np.asarray(drafts, np.int32), dpool

    def verify(self, pool, x, pos0, n_live, tables, cap):
        greedy, pool = jm.verify_window(
            self.cfg, self.params, pool, *map(jnp.asarray, (x, pos0, n_live)),
            self.ctx, block_tables=jnp.asarray(tables), block_size=BS,
            capacity=cap)
        return np.asarray(greedy, np.int32), pool

    accept = staticmethod(jm.spec_accept)

    @staticmethod
    def leaves(pool):
        return [np.asarray(x, np.float32) for x in jax.tree.leaves(pool)]


class _Torch:
    """The port's model functions on numpy in, numpy out."""

    def __init__(self, real_draft, impl):
        s = _setup()
        self.cfg, self.params = s["tcfg"], s["tp"]
        self.dcfg, self.dparams = ((s["tdcfg"], s["tdp"]) if real_draft
                                   else (s["tcfg"], s["tp"]))
        self.ctx = RunContext(torch.device("cpu"), impl)

    @staticmethod
    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.int32))

    def pool(self, cfg, slots, blocks):
        return tm.init_paged_cache(cfg, slots, blocks, BS)

    def prefill(self, pool, toks, n, tables, cap):
        first, pool = tm.prefill_loop(
            self.cfg, self.params, pool, self.t(toks),
            self.t(np.zeros(len(n))), self.t(n), self.ctx,
            block_tables=self.t(tables), block_size=BS,
            num_steps=toks.shape[1], capacity=cap)
        return first.numpy(), pool

    def draft(self, dpool, ctoks, cpos0, n_c, cur, p, k, tables, k_max,
              cap):
        drafts, dpool = tm.draft_loop(
            self.dcfg, self.dparams, dpool, *map(self.t, (
                ctoks, cpos0, n_c, cur[:, None], p, k)), self.ctx,
            block_tables=self.t(tables), block_size=BS,
            catchup_steps=ctoks.shape[1], num_steps=k_max, capacity=cap)
        return drafts.numpy(), dpool

    def verify(self, pool, x, pos0, n_live, tables, cap):
        greedy, pool = tm.verify_window(
            self.cfg, self.params, pool, *map(self.t, (x, pos0, n_live)),
            self.ctx, block_tables=self.t(tables), block_size=BS,
            capacity=cap)
        return greedy.numpy(), pool

    accept = staticmethod(tm.spec_accept)

    @staticmethod
    def leaves(pool):
        return [x.float().clone().numpy() for x in tm._tree_leaves(pool)]

    def stepwise(self, pool, tables, cur, p, budgets, cap):
        toks, _ = tm.decode_loop(
            self.cfg, self.params, pool, self.t(cur[:, None]), self.t(p),
            self.t(budgets), self.ctx, block_tables=self.t(tables),
            block_size=BS, num_steps=int(budgets.max()), capacity=cap)
        return toks.numpy()


def _spec_run(side, prompt_lens, budgets, k_max, flip_p, seed, cap):
    """The reference test's round loop (``_run_spec_rounds``) on one
    side: stage seeded prompts, then draft + verify rounds with a random
    per-row k and corrupted proposals until every budget drains.  Returns
    the per-round live records, the streams, and both final pools."""
    slots, max_blk = len(prompt_lens), cap // BS
    n_blocks = slots * max_blk + 1
    tables = np.arange(1, n_blocks, dtype=np.int32).reshape(slots, max_blk)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in prompt_lens]
    pre = np.zeros((slots, max(prompt_lens)), np.int32)
    for i, p in enumerate(prompts):
        pre[i, :len(p)] = p
    pos = np.asarray(prompt_lens, np.int32)
    tok, pool = side.prefill(side.pool(side.cfg, slots, n_blocks), pre, pos,
                             tables, cap)
    staged = (side.leaves(pool), tok.copy())
    dpool = side.pool(side.dcfg, slots, n_blocks)
    hist = [p.tolist() + [int(tok[i])] for i, p in enumerate(prompts)]
    budgets = np.asarray(budgets, np.int32)
    cur, p, left = tok.copy(), pos.copy(), budgets.copy()
    dp = np.zeros(slots, np.int32)
    out = [[] for _ in range(slots)]
    rounds = []
    rng = np.random.default_rng(seed + 1)
    while (left > 0).any():
        live = left > 0
        room = np.maximum(cap - 1 - np.minimum(p, cap - 1), 0)
        k_cap = np.minimum(np.minimum(k_max, left - 1), room)
        k = np.where(live, rng.integers(0, np.maximum(k_cap, 0) + 1), 0)
        k = k.astype(np.int32)
        n_c = np.where(live, p - dp, 0).astype(np.int32)
        ctoks = np.zeros((slots, max(int(n_c.max()), 1)), np.int32)
        for i in range(slots):
            if n_c[i]:
                ctoks[i, :n_c[i]] = hist[i][dp[i]:p[i]]
        drafts, dpool = side.draft(dpool, ctoks, np.where(live, dp, 0), n_c,
                                   cur, np.where(live, p, 0), k, tables,
                                   k_max, cap)
        flips = rng.random((slots, k_max)) < flip_p
        drafts = np.where(flips, (drafts + 1) % 256, drafts).astype(np.int32)
        dp = np.where(live, p + k, dp)
        x = np.concatenate([cur[:, None], drafts], axis=1)
        n_live = np.where(live, k + 1, 0).astype(np.int32)
        greedy, pool = side.verify(pool, x,
                                   np.where(live, np.minimum(p, cap - 1), 0),
                                   n_live, tables, cap)
        acc = side.accept(greedy, drafts, np.where(live, k, 0))
        rounds.append([(drafts[i, :k[i]].tolist(),
                        greedy[i, :n_live[i]].tolist(), int(acc[i]))
                       for i in range(slots) if live[i]])
        for i in np.nonzero(live)[0]:
            got = greedy[i, :acc[i] + 1].tolist()
            out[i].extend(got)
            hist[i].extend(got)
        emitted = np.where(live, acc + 1, 0).astype(np.int32)
        cur = np.where(live, greedy[np.arange(slots), acc], cur)
        p = np.where(live, np.minimum(p + emitted, cap), p)
        left = left - emitted
        dp = np.where(live, np.minimum(dp, p), dp)
    return dict(rounds=rounds, out=out, pool=side.leaves(pool),
                dpool=side.leaves(dpool), staged=staged, tables=tables,
                pos=pos)


# the reference sweep (flip, seed) + its capacity clamp and real-draft cases
SPEC_CASES = {
    "flip0": dict(prompt_lens=[3, 5, 1], budgets=[6, 4, 0], k_max=3,
                  flip_p=0.0, seed=3),
    "flip1": dict(prompt_lens=[3, 5, 1], budgets=[6, 4, 0], k_max=3,
                  flip_p=1.0, seed=5),
    "flip035": dict(prompt_lens=[3, 5, 1], budgets=[6, 4, 0], k_max=3,
                    flip_p=0.35, seed=7),
    "flip05": dict(prompt_lens=[3, 5, 1], budgets=[6, 4, 0], k_max=3,
                   flip_p=0.5, seed=11),
    "capacity": dict(prompt_lens=[6, 4], budgets=[8, 8], k_max=3,
                     flip_p=0.2, seed=13, cap=8),
    "real_draft": dict(prompt_lens=[4, 2], budgets=[5, 3], k_max=3,
                       flip_p=0.0, seed=17, real_draft=True),
}


@pytest.mark.parametrize("name,impl", [
    ("flip0", "cuda"), ("flip1", "cuda"), ("flip035", "torch"),
    ("flip05", "cuda"), ("capacity", "cuda"), ("real_draft", "cuda")])
def test_verify_and_draft_match_reference(name, impl):
    """Equal live drafts, verify grids and accepts every round; pools
    within 1e-6 (the trash block aside: dead rows write it in an order
    neither side defines); the stream equals the port's stepwise one."""
    kw = dict(SPEC_CASES[name])
    real = kw.pop("real_draft", False)
    kw.setdefault("cap", 32)
    want = _spec_run(_Jax(real), **kw)
    side = _Torch(real, impl)
    got = _spec_run(side, **kw)
    assert got["rounds"] == want["rounds"]
    assert len(got["rounds"]) > 1
    for key in ("pool", "dpool"):
        for g, w in zip(got[key], want[key]):
            np.testing.assert_allclose(g[:, 1:], w[:, 1:], atol=KV_TOL,
                                       rtol=0)
    # losslessness inside the port: the stepwise greedy stream
    leaves, tok = got["staged"]
    pool = tm.init_paged_cache(side.cfg, len(tok), leaves[0].shape[1], BS)
    for dst, src in zip(tm._tree_leaves(pool), leaves):
        dst.copy_(torch.from_numpy(src))
    budgets = np.asarray(kw["budgets"], np.int32)
    step = side.stepwise(pool, got["tables"], tok, got["pos"], budgets,
                         kw["cap"])
    for i, n in enumerate(budgets):
        assert got["out"][i] == step[i, :n].tolist()
    if name == "real_draft":
        # a different model mostly disagrees: the rounds really reject
        assert any(a < len(d) for r in got["rounds"] for d, _, a in r)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_spec_accept_matches_reference(seed):
    rng = np.random.default_rng(seed)
    b, k = 6, 5
    greedy = rng.integers(0, 3, (b, k + 1)).astype(np.int32)
    drafts = np.where(rng.random((b, k)) < 0.7, greedy[:, :k],
                      rng.integers(0, 3, (b, k))).astype(np.int32)
    n_spec = rng.integers(0, k + 1, b).astype(np.int32)
    got = tm.spec_accept(greedy, drafts, n_spec)
    np.testing.assert_array_equal(got, jm.spec_accept(greedy, drafts,
                                                      n_spec))
    assert got.dtype == np.int64 and (got <= n_spec).all()


def test_verify_window_dead_rows_park_in_trash():
    """A dead row (n_live 0) writes only the trash block, whatever its
    table row holds."""
    s = _setup()
    cfg, ctx = s["tcfg"], RunContext(torch.device("cpu"), "cuda")
    pool = tm.init_paged_cache(cfg, 2, 9, BS)
    tables = torch.arange(1, 9, dtype=torch.int32).reshape(2, 4)
    toks = torch.tensor([[5, 6, 7], [8, 9, 10]], dtype=torch.int32)
    greedy, pool = tm.verify_window(
        cfg, s["tp"], pool, toks, torch.tensor([2, 3], dtype=torch.int32),
        torch.tensor([3, 0], dtype=torch.int32), ctx, block_tables=tables,
        block_size=BS, capacity=16)
    assert greedy.shape == (2, 3) and greedy.dtype == torch.int32
    for leaf in tm._tree_leaves(pool):
        assert leaf[:, 5:].abs().sum() == 0        # row 1's blocks 5-8
        assert leaf[:, 1].abs().sum() > 0          # row 0 wrote its window


# --------------------------------------------------------------------------- #
# handler level, real reduced model
# --------------------------------------------------------------------------- #
_JB = {}


def _jax_backend(draft):
    if draft not in _JB:
        s = _setup()
        d = "oracle" if draft == "oracle" else s["dcfg"]
        _JB[draft] = jserve.LMBackend(s["cfg"], capacity=32, draft=d)
    return _JB[draft]


def _trace(seed=11, n=4, shared=False):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, 256, 8, dtype=np.int32)
    out = []
    for i in range(n):
        p = rng.integers(0, 256, 6, dtype=np.int32)
        if shared:
            p = np.concatenate([prefix, p[:4]])
        out.append((i, p, 8, float(rng.uniform(0.0, 0.3))))
    return out


def _serve(kind, trace, draft="oracle", impl="torch", **kw):
    s = _setup()
    if kind == "jax":
        backend = _jax_backend(draft)
        reqs = [JRequest(i, p, n, arrival_t=t) for i, p, n, t in trace]
        cls = jserve.ClientHandler
    else:
        d, dp = (("oracle", None) if draft == "oracle"
                 else (s["tdcfg"], s["tdp"]))
        backend = tserve.LMBackend(s["tcfg"], capacity=32, params=s["tp"],
                                   device="cpu", impl=impl, draft=d,
                                   draft_params=dp)
        reqs = [ServeRequest(i, p, n, arrival_t=t) for i, p, n, t in trace]
        cls = tserve.ClientHandler
    h = cls(backend, max_batch=4, block_size=4, max_secondaries=2,
            decode_window=1, executor=_fixed, **kw)
    rep = h.run(reqs)
    return {c.rid: [int(x) for x in c.tokens] for c in rep.completions}, rep


COUNTERS = ("spec_rounds", "spec_tokens", "acceptance_rate",
            "spec_fallbacks")
HANDLER_CASES = {
    # the reference test's settings: stepwise suffix prefill, spec_k 3
    "oracle_torch": dict(corruption=0.0, impl="torch", chunk=0),
    "oracle_flip035_torch": dict(corruption=0.35, impl="torch", chunk=0),
    # chunked suffix prefill of prefix hits folded into the verify closure
    "oracle_cuda_chunk4": dict(corruption=0.0, impl="cuda", chunk=4,
                               shared=True),
    "oracle_flip035_cuda_chunk4": dict(corruption=0.35, impl="cuda",
                                       chunk=4, shared=True),
    # the reduced draft (PRNGKey(7)): acceptance collapses, fallback
    "draft_cuda": dict(corruption=0.0, impl="cuda", chunk=0, draft="real"),
}


@pytest.mark.parametrize("name", sorted(HANDLER_CASES))
def test_spec_handler_matches_reference(name):
    c = HANDLER_CASES[name]
    trace = _trace(shared=c.get("shared", False))
    kw = dict(prompt_pad=12 if c.get("shared") else 8, speculative=True,
              spec_k=3, spec_corruption=c["corruption"],
              prefill_chunk=c["chunk"])
    draft = c.get("draft", "oracle")
    want, jrep = _serve("jax", trace, draft=draft, **kw)
    got, trep = _serve("torch", trace, draft=draft, impl=c["impl"], **kw)
    assert got == want and len(got) == 4
    for key in COUNTERS:
        assert getattr(trep, key) == getattr(jrep, key), key
    assert trep.spec_rounds > 0
    if draft == "oracle":
        # lossless: the plain (non-speculative) port streams
        plain, _ = _serve("torch", trace, impl=c["impl"],
                          **dict(kw, speculative=False, spec_corruption=0.0))
        assert got == plain
        assert trep.acceptance_rate > (0.5 if c["corruption"] == 0 else 0)


def test_lm_backend_draft_binding():
    s = _setup()
    kw = dict(capacity=32, params=s["tp"], device="cpu")
    b = tserve.LMBackend(s["tcfg"], **kw, draft=s["tdcfg"],
                         draft_params=s["tdp"])
    assert b.supports_speculative and 0 < b.draft_cost_ratio < 1
    assert b.draft_params is s["tdp"]
    drawn = tserve.LMBackend(s["tcfg"], **kw, draft=s["tdcfg"])
    assert drawn.draft_params["embed"].shape == s["tdp"]["embed"].shape
    oracle = tserve.LMBackend(s["tcfg"], **kw, draft="oracle")
    assert oracle.draft_params is oracle.params
    assert oracle.draft_cost_ratio == 1.0
    plain = tserve.LMBackend(s["tcfg"], **kw)
    assert not plain.supports_speculative
    with pytest.raises(ValueError, match="share the target's vocab"):
        tserve.LMBackend(s["tcfg"], **kw, draft=dataclasses.replace(
            s["tdcfg"], vocab_size=512))
    with pytest.raises(ValueError, match="without a draft"):
        tserve.LMBackend(s["tcfg"], **kw, draft_params=s["tdp"])


# --------------------------------------------------------------------------- #
# handler level, fake backend (the reference's SpecFakeBackend scenarios)
# --------------------------------------------------------------------------- #
class FakeBackend:
    """Token i+1 follows token i on the paged slot protocol, with torch
    tensors in and out; KV content is not modeled.  ``cfg`` (reduced
    smollm-360m) only answers the handler's configuration checks and the
    handoff's byte model."""

    capacity = 64
    params = None
    device = torch.device("cpu")
    cfg = t_reduced_config(t_get_config("smollm-360m"))

    @staticmethod
    def tensor(x):
        return torch.tensor(np.asarray(x), dtype=torch.int32)

    def init_paged_pool(self, max_slots, num_blocks, block_size):
        return {}

    def paged_fns(self, block_size, window=1):
        def prefill_into(params, toks, pool, blk_ids, slots):
            return torch.zeros(toks.shape[0], dtype=torch.int32), pool

        def decode_window(params, pool, tok, pos, steps_left, tables):
            cur = tok[:, 0].clone()
            out = torch.zeros((cur.numel(), window), dtype=torch.int32)
            for t in range(window):
                cur = torch.where(t < steps_left, cur + 1, cur)
                out[:, t] = cur
            return out, pool

        return prefill_into, decode_window

    def prefill_window_fn(self, block_size, num_steps, chunk=0):
        def prefill_window(params, pool, toks, pos0, n_tok, tables):
            return torch.zeros(toks.shape[0], dtype=torch.int32), pool

        return prefill_window

    def copy_fn(self):
        return lambda pool, src, dst: pool


class SpecFakeBackend(FakeBackend):
    """The draft proposes the counting continuation and the verify maps
    every window token v to v + 1: acceptance is 1.0 unless the handler's
    corruption flips proposals."""

    supports_speculative = True
    draft_params = None

    def init_draft_pool(self, max_slots, num_blocks, block_size):
        return {}

    def spec_draft_fn(self, block_size, catchup_steps, k_max):
        def draft(dparams, dpool, ctoks, cpos0, n_c, tok, pos, k_live,
                  tables):
            step = torch.arange(1, k_max + 1, dtype=torch.int32)
            drafts = torch.where(step[None, :] <= k_live[:, None],
                                 tok + step[None, :], 0)
            return drafts.to(torch.int32), dpool

        return draft

    def spec_verify_fn(self, block_size):
        def verify(params, pool, toks, pos0, n_live, tables):
            return toks + 1, pool

        return verify


def _fake_run(speculative, backend=None, **kw):
    kw.setdefault("max_secondaries", 2)
    h = tserve.ClientHandler(backend or SpecFakeBackend(), prompt_pad=4,
                             max_batch=4, speculative=speculative,
                             executor=_fixed, **kw)
    rep = h.run([ServeRequest(i, np.zeros(4, np.int32), 9,
                              arrival_t=0.15 * i) for i in range(6)])
    return {c.rid: [int(x) for x in c.tokens] for c in rep.completions}, \
        rep, h


@pytest.mark.parametrize("kw,match", [
    (dict(backend=FakeBackend()), "draft model"),
    (dict(spec_k=0), "spec_k"),
    (dict(kv="contiguous"), "paged"),
    (dict(mixed_dispatch=True), "mutually exclusive"),
    (dict(disagg=True), "chunked"),
])
def test_spec_validation_errors(kw, match):
    backend = kw.pop("backend", SpecFakeBackend())
    with pytest.raises(ValueError, match=match):
        tserve.ClientHandler(backend, prompt_pad=4, speculative=True,
                             executor=_fixed, **kw)


@pytest.mark.parametrize("corruption", [0.0, 0.4])
def test_fake_spec_token_identical_and_fewer_dispatches(corruption):
    plain, _, _ = _fake_run(False, decode_window=1)
    got, rep, h = _fake_run(True, spec_k=4, spec_corruption=corruption)
    assert got == plain and len(got) == 6
    assert rep.spec_rounds > 0 and rep.spec_fallbacks == 0
    assert h.spec_draft_cids
    if corruption == 0.0:
        assert rep.acceptance_rate == 1.0
        assert rep.spec_tokens / rep.spec_rounds > 1.5
    else:
        assert 0.0 < rep.acceptance_rate < 1.0


def test_fake_spec_acceptance_collapse_falls_back():
    plain, _, _ = _fake_run(False, decode_window=1)
    got, rep, h = _fake_run(True, spec_k=4, spec_corruption=0.95)
    assert got == plain
    assert rep.spec_fallbacks >= 1
    assert not any(c.busy for c in h.pool.clones)   # drafts released


def test_fake_spec_no_draft_clone_serves_plainly():
    """A pool with nothing to pair (the primary is the only clone) serves
    every request plainly, counted as a fallback."""
    pool = ClonePool(clock=VirtualClock(), max_clones=1)
    got, rep, _ = _fake_run(True, spec_k=4, pool=pool, max_secondaries=0)
    assert len(got) == 6
    assert rep.spec_rounds == 0 and rep.spec_fallbacks >= 1


def _twice(checked):
    """Executor running each closure twice: the second run must leave the
    pool it was handed (args[1]) and return what the first did, as the
    Venue executor's re-runs need."""
    def run(c, f, a):
        out1 = f(*a)
        snap = [t.clone() for t in tm._tree_leaves(a[1])]
        vals1 = [x.clone() for x in out1[:-1] if x is not None]
        out2 = f(*a)
        for x, y in zip(snap, tm._tree_leaves(a[1])):
            assert torch.equal(x, y)
        for x, y in zip(vals1, [v for v in out2[:-1] if v is not None]):
            assert torch.equal(x, y)
        checked.append(f.__name__)
        return out2, 0.05
    return run


@pytest.mark.parametrize("mode", ["spec", "disagg_compress"])
def test_spec_and_disagg_closures_are_idempotent(mode):
    """Draft, verify, partner-prefill and handoff closures re-run on
    their inputs leave the same pools and tokens, and the streams equal a
    single-run executor's."""
    s = _setup()
    if mode == "spec":
        kw = dict(speculative=True, spec_k=3, spec_corruption=0.35,
                  prefill_chunk=4, draft=s["tdcfg"], draft_params=s["tdp"])
        want_names = {"draft", "step_fn"}
    else:
        kw = dict(fleet=["basic", "large"], clone_type="basic", disagg=True,
                  disagg_min_prompt=1, disagg_prefill_type="large",
                  disagg_compress=True, prefill_chunk=4)
        want_names = {"prefill_window", "step_fn"}
    draft = {k: kw.pop(k) for k in ("draft", "draft_params") if k in kw}
    checked = []
    runs = []
    for ex in (_twice(checked), _fixed):
        backend = tserve.LMBackend(s["tcfg"], capacity=32, params=s["tp"],
                                   device="cpu", impl="cuda", **draft)
        h = tserve.ClientHandler(backend, max_batch=4, block_size=4,
                                 max_secondaries=2, prompt_pad=12,
                                 decode_window=2, executor=ex, **kw)
        rep = h.run([ServeRequest(i, p, n, arrival_t=t)
                     for i, p, n, t in _trace(shared=True)])
        runs.append({c.rid: list(c.tokens) for c in rep.completions})
    assert runs[0] == runs[1] and len(runs[0]) == 4
    assert want_names <= set(checked)
