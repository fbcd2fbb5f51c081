"""Fault injection, clone recovery and hedged dispatch in the port (CPU).

Mirrors of the reference's ``tests/test_faults.py`` (circuit breaker,
reconnect backoff, fault injector, dispatcher cancel, chaos runs on a
fake backend and on reduced smollm-360m, hedging, the draft-kill
degrade), of ``tests/test_handler.py``'s partner-death test and of the
fault property of ``tests/test_property.py``, against the port's modules.

Then the port's ``ClientHandler`` against the reference's on shared
weights (``weights.from_jax`` of ``model.init(cfg, PRNGKey(0))``) under
one fixed-time executor and the same schedules: drain, kill, permanent
kill, slow + hedge, draft kill and partner kill.  Token streams, the
fault, hedge, speculation and disaggregation counters and ``makespan_s``
must be equal; the survivors' KV blocks (the trash block aside) within
``KV_TOL`` (chunked prefill is not bitwise in the reference, ROADMAP
Queue 3 item 4).

Last, the three hazards of a pool updated in place: a drain landing on a
step in flight (the dropped step has already written the source pool), a
revived clone's pool (it must not reuse what a pending migration reads)
and a hedge running a step closure twice.
"""
import gc
import weakref

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import test_torch_spec as ts
from repro.configs import get_config, reduced_config
from repro.core import clones as jclones
from repro.core import faults as jfaults
from repro.core import scheduler as jsched
from repro.launch import serve as jserve
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced_config as t_reduced_config
from repro_torch.core import clones as tclones
from repro_torch.core import faults as tfaults
from repro_torch.core import scheduler as tsched
from repro_torch.core.clock import SystemClock, VirtualClock
from repro_torch.core.clones import (CB_FAIL_THRESHOLD, CircuitBreaker,
                                     CloneHealth, ClonePool, CloneState)
from repro_torch.core.dispatch import Dispatcher
from repro_torch.core.faults import (CloneFault, FaultInjector,
                                     ReconnectManager)
from repro_torch.core.scheduler import ServeRequest, poisson_arrivals
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tm
from repro_torch.models import weights

KV_TOL = ts.KV_TOL


# --------------------------------------------------------------- breaker
def test_breaker_threshold_opens_and_allow_gates():
    cb = CircuitBreaker()
    assert cb.state == "closed"
    for _ in range(CB_FAIL_THRESHOLD - 1):
        cb.record_failure(now=0.0)
    assert cb.state == "closed"
    cb.record_failure(now=0.0)
    assert cb.state == "open" and cb.opens == 1
    assert not cb.allow(now=0.5)
    assert cb.state == "open"
    assert cb.allow(now=1.5)             # past open_seconds=1.0
    assert cb.state == "half_open"
    cb.record_success()
    assert cb.state == "closed" and cb.failures == 0


def test_breaker_halfopen_failure_reopens_with_doubled_cooldown():
    cb = CircuitBreaker()
    cb.trip(now=0.0)
    assert cb.allow(now=1.5) and cb.state == "half_open"
    cb.record_failure(now=1.5)
    assert cb.state == "open" and cb.opens == 2
    assert not cb.allow(now=2.5)         # cooldown doubled to 2.0 s
    assert cb.allow(now=3.6)
    cb.record_success()
    assert cb.state == "closed"
    cb.trip(now=10.0)                    # success reset the cooldown
    assert not cb.allow(now=10.9)
    assert cb.allow(now=11.1)


def test_breaker_clock_probe_chain_closes_on_success():
    clock = VirtualClock()
    healthy = {"v": False}
    cb = CircuitBreaker()
    cb.bind(clock, lambda: healthy["v"])
    cb.trip(clock.now())
    assert cb.state == "open"
    clock.advance(1.1)                   # first probe: target still down
    assert cb.state == "open" and cb.opens == 2
    healthy["v"] = True
    clock.advance(2.1)                   # doubled cooldown, second probe
    assert cb.state == "closed"
    assert cb.probes == 2


def test_breaker_probe_budget_exhausts():
    clock = VirtualClock()
    cb = CircuitBreaker(max_probes=3)
    cb.bind(clock, lambda: False)
    cb.trip(clock.now())
    clock.advance(1000.0)
    assert cb.probes == 3 and cb.state == "open"


def test_breaker_success_cancels_pending_probe():
    clock = VirtualClock()
    calls = []
    cb = CircuitBreaker()
    cb.bind(clock, lambda: calls.append(1) or True)
    cb.trip(clock.now())
    cb.record_success()                  # recovered before the probe
    clock.advance(50.0)
    assert calls == [] and cb.state == "closed"


# ----------------------------------------------------------- reconnect
def test_reconnect_clock_mode_backoff_timing():
    clock = VirtualClock()
    times = []

    def attempt():
        times.append(clock.now())
        return len(times) >= 4           # succeed on the 4th try

    rm = ReconnectManager(attempt, base_delay=0.1, max_delay=0.5,
                          max_attempts=8, clock=clock)
    rm.notify_failure()
    assert not rm.connected and times == []     # nothing runs inline
    clock.advance(10.0)
    np.testing.assert_allclose(times, [0.1, 0.3, 0.7, 1.2])
    assert rm.connected and rm.attempts == 4


def test_reconnect_clock_mode_burst_cap_and_rearm():
    clock = VirtualClock()
    rm = ReconnectManager(lambda: False, base_delay=0.1, max_delay=0.2,
                          max_attempts=3, clock=clock)
    rm.notify_failure()
    rm.notify_failure()                  # pending event: not re-armed
    clock.advance(10.0)
    assert rm.attempts == 3 and not rm.connected
    rm.notify_failure()                  # burst spent: a new failure re-arms
    clock.advance(10.0)
    assert rm.attempts == 6


def test_reconnect_synchronous_mode_unchanged():
    calls = []
    rm = ReconnectManager(lambda: calls.append(1) or len(calls) >= 3)
    rm.notify_failure()
    assert rm.connected and len(calls) == 3


def test_reconnect_rejects_wall_clock():
    with pytest.raises(TypeError):
        ReconnectManager(clock=SystemClock())


# ------------------------------------------------------------- injector
def _pool_with_running(n=2):
    clock = VirtualClock()
    pool = ClonePool(clock=clock)
    pool.provision("main", n, state=CloneState.RUNNING)
    return clock, pool


def test_injector_kill_marks_dead_and_trips_breaker():
    clock, pool = _pool_with_running()
    sec = pool.running_secondaries()[0]
    sec.busy = True
    inj = FaultInjector(pool, [CloneFault(at=0.5, kind="kill")])
    inj.arm()
    inj.arm()                            # idempotent
    assert inj.next_event_time() == 0.5
    clock.advance(1.0)
    assert sec.health is CloneHealth.DEAD
    assert sec.state is CloneState.POWERED_OFF
    assert sec.breaker.state == "open" and not sec.serveable
    assert inj.stats == {"injected": 1, "kills": 1, "drains": 0,
                         "slowdowns": 0, "misses": 0, "clone_recoveries": 0}
    failed = inj.drain_failed()
    assert len(failed) == 1 and failed[0][0] is sec
    assert inj.drain_failed() == []
    assert inj.next_event_time() is None


def test_injector_revive_needs_probe_to_serve_again():
    clock, pool = _pool_with_running()
    sec = pool.running_secondaries()[0]
    sec.busy = True
    inj = FaultInjector(pool, [CloneFault(at=0.0, kind="kill",
                                          duration=2.0)])
    inj.arm()
    clock.advance(1.5)                   # the probe at ~1.0 fails
    assert sec.health is CloneHealth.DEAD
    clock.advance(1.0)                   # revived at 2.0: answers pings
    assert sec.health is CloneHealth.SUSPECT and not sec.serveable
    clock.advance(3.0)                   # the next probe promotes it
    assert sec.health is CloneHealth.HEALTHY
    assert sec.breaker.state == "closed"
    assert inj.stats["clone_recoveries"] == 1


def test_injector_targets_lowest_cid_busy_secondary_and_cid_pin():
    clock, pool = _pool_with_running(3)
    secs = sorted(pool.running_secondaries(), key=lambda c: c.cid)
    secs[1].busy = secs[2].busy = True
    inj = FaultInjector(pool, [CloneFault(at=0.0),
                               CloneFault(at=1.0, cid=secs[2].cid)])
    inj.arm()
    clock.advance(0.1)
    assert secs[1].health is CloneHealth.DEAD     # busy beats idle
    assert secs[0].health is CloneHealth.HEALTHY
    clock.advance(1.0)
    assert secs[2].health is CloneHealth.DEAD     # cid pin


def test_injector_miss_when_no_target():
    clock, pool = _pool_with_running(1)
    sec = pool.running_secondaries()[0]
    inj = FaultInjector(pool, [CloneFault(at=0.0, kind="kill"),
                               CloneFault(at=1.0, kind="kill")])
    inj.arm()
    clock.advance(0.5)                   # an idle secondary is killable
    assert sec.health is CloneHealth.DEAD
    clock.advance(1.0)                   # nothing healthy left: a miss
    assert inj.stats["injected"] == 1 and inj.stats["misses"] == 1


def test_injector_slowdown_scales_dispatch_and_clears():
    clock, pool = _pool_with_running()
    sec = pool.running_secondaries()[0]
    sec.busy = True
    inj = FaultInjector(pool, [CloneFault(at=0.0, kind="slow",
                                          duration=5.0, factor=4.0)])
    inj.arm()
    clock.advance(0.1)
    assert sec.slowdown == 4.0
    disp = Dispatcher(pool, clock)
    t = disp.submit(sec, lambda: 1, (),
                    executor=lambda c, f, a: (f(*a), 0.05))
    assert t.venue_seconds == pytest.approx(0.2)  # 0.05 x 4
    clock.advance(5.1)
    assert sec.slowdown == 1.0
    t2 = disp.submit(sec, lambda: 1, (),
                     executor=lambda c, f, a: (f(*a), 0.05))
    assert t2.venue_seconds == pytest.approx(0.05)


def test_injector_rejects_unknown_kind_and_wall_clock():
    _, pool = _pool_with_running()
    with pytest.raises(ValueError):
        FaultInjector(pool, [CloneFault(at=0.0, kind="explode")])
    with pytest.raises(TypeError):
        FaultInjector(pool, [], clock=SystemClock())


def test_dispatcher_cancel_revokes_completion():
    clock, pool = _pool_with_running()
    sec = pool.running_secondaries()[0]
    disp = Dispatcher(pool, clock)
    t = disp.submit(sec, lambda: 42, (),
                    executor=lambda c, f, a: (f(*a), 0.5))
    assert disp.cancel(t)
    assert not disp.cancel(t)            # idempotent
    clock.advance(1.0)
    assert not t.done and t.cancelled
    t2 = disp.submit(sec, lambda: 42, (),
                     executor=lambda c, f, a: (f(*a), 0.5))
    disp.wait([t2])
    assert not disp.cancel(t2)           # too late: already completed


# ------------------------------------------------- serving, fake backends
class FakeBackend(ts.FakeBackend):
    """The port's counting fake plus a cross-pool copy that models no
    content: the host-side token carry keeps decode deterministic."""

    def migrate_fn(self, compress=False):
        return lambda dst, src, sids, dids: dst


class SpecFakeBackend(ts.SpecFakeBackend, FakeBackend):
    pass


def assert_no_block_leak(handler):
    """Block conservation on every surviving pool: each block's refcount
    equals its slot-table references, and free + cached-free + live is
    every allocatable block."""
    for kv in handler._kv_pools.values():
        refs = np.zeros(kv.num_blocks, np.int64)
        for slot in range(kv.max_slots):
            for j in range(int(kv.n_blocks_of[slot])):
                refs[kv.tables[slot, j]] += 1
        live = set(np.nonzero(kv.ref)[0].tolist())
        for b in range(1, kv.num_blocks):
            assert kv.ref[b] == refs[b], (b, kv.ref[b], refs[b])
        accounted = set(kv._free_blocks) | set(kv._cached_free) | live
        assert accounted == set(range(1, kv.num_blocks)), "block leak"


def _chaos_handler(faults=None, hedge=0.0, backend=None, spare=True, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("prompt_pad", 8)
    kw.setdefault("block_size", 4)
    kw.setdefault("max_secondaries", 3)
    kw.setdefault("decode_window", 2)
    kw.setdefault("executor", ts._fixed)
    h = tserve.ClientHandler(backend or FakeBackend(), faults=faults,
                             hedge_factor=hedge, hedge_min_samples=4, **kw)
    if spare:
        h.pool.provision(h.clone_type, 1, state=CloneState.RUNNING)
    return h


def _observe(rep, n):
    return {"tokens": {c.rid: tuple(map(int, c.tokens))
                       for c in rep.completions},
            "served": len(rep.completions), "offered": n,
            "injected": rep.faults_injected,
            "migrated": rep.recoveries_migrated,
            "restored": rep.recoveries_restored,
            "breaker_opens": rep.breaker_opens,
            "hedges_fired": rep.hedges_fired, "hedge_wins": rep.hedge_wins,
            "makespan_s": rep.makespan_s,
            "p99_latency_s": rep.p99_latency_s, "cost_usd": rep.cost_usd}


def run_chaos_trace(faults=None, hedge=0.0, *, seed=0, n=12, rate=8.0,
                    backend=None, vocab=64, new_tokens=10):
    """The reference's ``run_chaos_trace`` on the port: one seeded
    Poisson trace under a fault schedule, blocks checked for leaks."""
    h = _chaos_handler(faults=faults, hedge=hedge, backend=backend)
    reqs = poisson_arrivals(rate, n, seed=seed, prompt_len=8, vocab=vocab,
                            max_new_tokens=new_tokens, prefix_len=4)
    rep = h.run(reqs)
    assert_no_block_leak(h)
    return _observe(rep, n)


def test_chaos_drain_recovers_by_migration_token_identical():
    base = run_chaos_trace()
    assert base["injected"] == 0 and base["served"] == 12
    out = run_chaos_trace([CloneFault(at=0.5 * base["makespan_s"],
                                      kind="drain", duration=2.0)])
    assert out["injected"] == 1 and out["migrated"] >= 1
    assert out["breaker_opens"] >= 1
    assert out["served"] == 12 and out["tokens"] == base["tokens"]


def test_chaos_kill_recovers_by_restore_token_identical():
    base = run_chaos_trace()
    out = run_chaos_trace([CloneFault(at=0.5 * base["makespan_s"],
                                      kind="kill", duration=2.0)])
    assert out["injected"] == 1 and out["restored"] >= 1
    assert out["migrated"] == 0          # killed memory is not salvageable
    assert out["served"] == 12 and out["tokens"] == base["tokens"]


def test_chaos_permanent_kill_still_serves_everything():
    base = run_chaos_trace()
    out = run_chaos_trace([CloneFault(at=0.5 * base["makespan_s"],
                                      kind="kill", duration=0.0)])
    assert out["served"] == 12 and out["tokens"] == base["tokens"]


def test_hedged_dispatch_wins_race_and_bills_once():
    base = run_chaos_trace()
    span = base["makespan_s"]
    slow = lambda: [CloneFault(at=0.6 * span, kind="slow",  # noqa: E731
                               duration=0.4 * span, factor=40.0)]
    unhedged = run_chaos_trace(slow())
    hedged = run_chaos_trace(slow(), hedge=2.0)
    assert unhedged["hedges_fired"] == 0
    assert hedged["hedges_fired"] >= 1 and hedged["hedge_wins"] >= 1
    assert hedged["tokens"] == unhedged["tokens"] == base["tokens"]
    assert hedged["p99_latency_s"] < unhedged["p99_latency_s"]
    assert hedged["cost_usd"] <= unhedged["cost_usd"] + 1e-9


def test_hedge_loser_is_cancelled():
    base = run_chaos_trace()
    span = base["makespan_s"]
    h = _chaos_handler(faults=[CloneFault(at=0.6 * span, kind="slow",
                                          duration=0.4 * span,
                                          factor=40.0)], hedge=2.0)
    submitted = []
    orig = h.dispatcher.submit

    def spy(*a, **k):
        t = orig(*a, **k)
        submitted.append(t)
        return t

    h.dispatcher.submit = spy
    h.run(poisson_arrivals(8.0, 12, seed=0, prompt_len=8, vocab=64,
                           max_new_tokens=10, prefix_len=4))
    hedges = [t for t in submitted if t.label == "hedge"]
    assert h.hedges_fired >= 1 and hedges
    for t in submitted:
        assert t.done or t.cancelled, f"task {t.label!r} left dangling"
    cancelled = sum(t.cancelled for t in submitted)
    assert cancelled >= len(hedges) or h.hedge_wins == len(hedges)


def test_faults_require_paged_kv():
    with pytest.raises(ValueError, match="kv='paged'"):
        tserve.ClientHandler(FakeBackend(), kv="contiguous",
                             faults=[CloneFault(at=1.0)],
                             executor=ts._fixed)
    with pytest.raises(ValueError, match="kv='paged'"):
        tserve.ClientHandler(FakeBackend(), kv="contiguous",
                             hedge_factor=2.0, executor=ts._fixed)


def _run_spec_chaos(faults=None, *, speculative=True, seed=0, n=12):
    h = _chaos_handler(faults=faults, backend=SpecFakeBackend(),
                       speculative=speculative, spec_k=4)
    rep = h.run(poisson_arrivals(8.0, n, seed=seed, prompt_len=8, vocab=64,
                                 max_new_tokens=10, prefix_len=4))
    assert_no_block_leak(h)
    return h, rep


def _streams(rep):
    return {c.rid: tuple(map(int, c.tokens)) for c in rep.completions}


def test_chaos_spec_draft_kill_degrades_token_identical():
    """A dead draft clone: the interrupted round completes as a
    zero-draft verify, the engine decodes plainly from then on, and the
    streams equal the non-speculative ones."""
    _, plain = _run_spec_chaos(speculative=False)
    h0, spec = _run_spec_chaos()
    assert _streams(spec) == _streams(plain)
    assert spec.spec_rounds > 0 and h0.spec_draft_cids
    _, out = _run_spec_chaos(
        [CloneFault(at=0.5 * spec.makespan_s, kind="kill", duration=0.0,
                    cid=h0.spec_draft_cids[0])])
    assert _streams(out) == _streams(plain) and len(out.completions) == 12
    assert out.faults_injected == 1 and out.spec_fallbacks >= 1
    assert 0 < out.spec_rounds <= spec.spec_rounds
    assert out.recoveries_migrated == 0 and out.recoveries_restored == 0


class DisaggFakeBackend(FakeBackend):
    """The reference's DisaggFakeBackend on the port's protocol: every
    prefill emits first token 0 and decode counts up, so streams do not
    depend on where a prefill ran."""

    supports_chunked = True

    def mixed_fn(self, block_size, chunk, num_steps):
        _, decode_window = self.paged_fns(block_size, num_steps)

        def mixed(params, pool, tok, pos, steps_left, tables, stoks, spos,
                  sn, stabs):
            out, pool = decode_window(params, pool, tok, pos, steps_left,
                                      tables)
            return out, torch.zeros(stoks.shape[0], dtype=torch.int32), pool

        return mixed


def test_disagg_partner_death_degrades_to_colocated_prefill():
    """Killing the shared prefill partner degrades its engines to
    co-located prefill, counted as fallbacks, with no token lost."""
    def run(faults):
        # decode on the primary: the large partner is then the only
        # running secondary, so cid=None targets it
        h = tserve.ClientHandler(
            DisaggFakeBackend(), executor=ts._fixed, prompt_pad=4,
            max_batch=8, max_secondaries=2, block_size=4, prefill_chunk=4,
            fleet=["main", "large"], disagg=True, disagg_min_prompt=1,
            disagg_prefill_type="large", faults=faults)
        rep = h.run([ServeRequest(i, np.full(8, i + 1, np.int32), 4,
                                  arrival_t=0.3 * i) for i in range(4)])
        return rep, {c.rid: list(map(int, c.tokens))
                     for c in rep.completions}

    rep0, t0 = run(None)
    assert rep0.disagg_handoffs == 4 and rep0.disagg_fallbacks == 0
    rep1, t1 = run([CloneFault(at=0.35, kind="kill")])
    assert t1 == t0
    assert rep1.disagg_fallbacks >= 1 and rep1.disagg_handoffs < 4
    assert rep1.faults_injected == 1


@settings(deadline=None, max_examples=20)
@given(seed=st.integers(0, 7),
       hedge=st.sampled_from([0.0, 2.0]),
       faults=st.lists(
           st.tuples(st.floats(min_value=0.05, max_value=0.95),
                     st.sampled_from(["kill", "drain", "slow"]),
                     st.sampled_from([0.0, 0.5, 2.0]),
                     st.sampled_from([4.0, 40.0])),
           min_size=1, max_size=3))
def test_fault_recovery_conserves_requests_and_blocks(seed, hedge, faults):
    """The reference's fault property on the port: for any schedule of
    kill / drain / slow faults, hedged or not, no request is lost, no
    block leaks, the streams equal the faultless run's and the recovery
    counters stay consistent."""
    base = run_chaos_trace(seed=seed)
    span = base["makespan_s"]
    sched = [CloneFault(at=frac * span, kind=kind, duration=dur,
                        factor=factor)
             for frac, kind, dur, factor in faults]
    out = run_chaos_trace(sched, hedge=hedge, seed=seed)
    assert out["served"] == out["offered"] == base["served"]
    assert out["tokens"] == base["tokens"]
    assert out["injected"] <= len(sched)
    assert out["hedge_wins"] <= out["hedges_fired"]
    if hedge == 0.0:
        assert out["hedges_fired"] == 0
    if not any(k == "drain" for _, k, _, _ in faults):
        assert out["migrated"] == 0


# ------------------------------------- real reduced model, port vs reference
_SIDES = {"jax": (jserve, jfaults, jsched, jclones),
          "torch": (tserve, tfaults, tsched, tclones)}
_LM = {}


def _lm():
    """Reduced smollm-360m in both packages on the reference's
    PRNGKey(0) weights; one reference backend (oracle draft bound, so it
    also serves the speculative runs) per worker."""
    if not _LM:
        cfg = reduced_config(get_config("smollm-360m"))
        jb = jserve.LMBackend(cfg, capacity=32, draft="oracle")
        tcfg = t_reduced_config(t_get_config("smollm-360m"))
        _LM.update(jb=jb, tcfg=tcfg, vocab=cfg.vocab_size,
                   tp=weights.from_jax(jax.tree.map(np.asarray, jb.params),
                                       tcfg))
    return _LM


def _backend(kind, draft=None):
    s = _lm()
    if kind == "jax":
        return s["jb"]
    return tserve.LMBackend(s["tcfg"], capacity=32, params=s["tp"],
                            device="cpu", impl="cuda", draft=draft)


def _lm_chaos(kind, faults=None, hedge=0.0, *, prefix_len=4, hook=None,
              executor=ts._fixed, tenants=False, **kw):
    """One handler of either package on the chaos settings and trace;
    ``hook(handler)`` runs before the trace; ``tenants`` makes every third
    request an interactive "premium" one with a 1 s deadline, the rest
    "bulk" batch work.  Returns (handler, report)."""
    serve, faults_mod, sched, clones = _SIDES[kind]
    fl = [faults_mod.CloneFault(**f) for f in faults] if faults else None
    h = serve.ClientHandler(
        _backend(kind, "oracle" if kw.get("speculative") else None),
        executor=executor, faults=fl, hedge_factor=hedge,
        hedge_min_samples=4, max_batch=4, prompt_pad=8, block_size=4,
        max_secondaries=3, decode_window=2, **kw)
    h.pool.provision(h.clone_type, 1, state=clones.CloneState.RUNNING)
    if hook is not None:
        hook(h)
    reqs = sched.poisson_arrivals(8.0, 12, seed=0, prompt_len=8,
                                  vocab=_lm()["vocab"], max_new_tokens=10,
                                  prefix_len=prefix_len)
    if tenants:
        for r in reqs:
            premium = r.rid % 3 == 0
            r.tenant = "premium" if premium else "bulk"
            r.slo = "interactive" if premium else "batch"
            r.deadline_s = 1.0 if premium else None
    return h, h.run(reqs)


def _blocks(leaf, ax):
    """A pool leaf as float32 numpy without the trash block."""
    x = np.asarray(leaf.float() if torch.is_tensor(leaf) else leaf,
                   np.float32)
    return np.take(x, range(1, x.shape[ax]), axis=ax)


def _assert_survivor_kv(jh, th):
    """Every surviving pool of the port within KV_TOL of the reference's
    (same clones, same block ids), the trash block aside."""
    assert sorted(jh._kv_pools) == sorted(th._kv_pools)
    cfg = _lm()["tcfg"]
    for cid, kv in th._kv_pools.items():
        want = jax.tree.leaves(jh._kv_pools[cid].pool)
        for (leaf, ax), w in zip(tm.cache_leaves(cfg, kv.pool), want):
            np.testing.assert_allclose(_blocks(leaf, ax), _blocks(w, ax),
                                       atol=KV_TOL, rtol=0)


COUNTERS = ("faults_injected", "recoveries_migrated", "recoveries_restored",
            "hedges_fired", "hedge_wins", "breaker_opens", "spec_rounds",
            "spec_fallbacks", "disagg_handoffs", "disagg_fallbacks",
            "makespan_s")
_BASE = {}


def _lm_base():
    if not _BASE:
        _, rep = _lm_chaos("torch")
        _BASE.update(span=rep.makespan_s, tokens=_streams(rep))
    return _BASE


SCHEDULES = {
    "drain": (lambda s: [dict(at=0.5 * s, kind="drain", duration=2.0)], 0.0),
    "kill": (lambda s: [dict(at=0.5 * s, kind="kill", duration=2.0)], 0.0),
    "permanent_kill": (lambda s: [dict(at=0.5 * s, kind="kill")], 0.0),
    "slow_hedge": (lambda s: [dict(at=0.6 * s, kind="slow",
                                   duration=0.4 * s, factor=40.0)], 2.0),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lm_chaos_matches_reference(name):
    """Reduced smollm-360m under one schedule: streams, counters and
    makespan equal to the reference handler's, streams equal to the
    faultless run's, survivors' KV within KV_TOL, no block leaked."""
    sched, hedge = SCHEDULES[name]
    base = _lm_base()
    faults = sched(base["span"])
    jh, jrep = _lm_chaos("jax", faults, hedge)
    th, trep = _lm_chaos("torch", faults, hedge)
    assert _streams(trep) == _streams(jrep) == base["tokens"]
    assert len(trep.completions) == 12
    for key in COUNTERS:
        assert getattr(trep, key) == getattr(jrep, key), key
    assert trep.faults_injected == 1
    if name == "drain":
        assert trep.recoveries_migrated >= 1
    elif name == "slow_hedge":
        assert trep.hedges_fired >= 1 and trep.hedge_wins >= 1
    else:
        assert trep.recoveries_restored >= 1
        assert trep.recoveries_migrated == 0
    assert_no_block_leak(th)
    _assert_survivor_kv(jh, th)


def test_lm_spec_draft_kill_matches_reference():
    """The oracle draft's clone dies mid-trace: the zero-draft verify and
    the plain decode after it give the reference's streams and counters,
    which equal the plain non-speculative streams."""
    _, plain = _lm_chaos("torch")
    h0, spec = _lm_chaos("torch", speculative=True, spec_k=4)
    faults = [dict(at=0.5 * spec.makespan_s, kind="kill", duration=0.0,
                   cid=h0.spec_draft_cids[0])]
    jh, jrep = _lm_chaos("jax", faults, speculative=True, spec_k=4)
    th, trep = _lm_chaos("torch", faults, speculative=True, spec_k=4)
    assert _streams(trep) == _streams(jrep) == _streams(plain)
    for key in COUNTERS:
        assert getattr(trep, key) == getattr(jrep, key), key
    assert trep.spec_fallbacks >= 1 and trep.faults_injected == 1
    assert 0 < trep.spec_rounds < spec.spec_rounds
    assert_no_block_leak(th)
    _assert_survivor_kv(jh, th)


def _lm_disagg(kind, faults=None):
    serve, faults_mod, sched, _ = _SIDES[kind]
    fl = [faults_mod.CloneFault(**f) for f in faults] if faults else None
    # one link for both sides (the port's default is "nvlink", the
    # reference's "ici": link seconds would move the makespan)
    h = serve.ClientHandler(
        _backend(kind), executor=ts._fixed, prompt_pad=8, max_batch=8,
        max_secondaries=2, block_size=4, prefill_chunk=4,
        fleet=["main", "large"], disagg=True, disagg_min_prompt=1,
        disagg_prefill_type="large", disagg_link="wifi-local", faults=fl)
    rng = np.random.default_rng(5)
    reqs = [sched.ServeRequest(i, rng.integers(0, 256, 8).astype(np.int32),
                               4, arrival_t=0.3 * i) for i in range(4)]
    return h, h.run(reqs)


def test_lm_partner_kill_matches_reference():
    """The shared prefill partner dies while a handoff is pending: the
    engines fall back to co-located prefill with the reference's
    streams and counters, equal to the faultless streams."""
    _, base = _lm_disagg("torch")
    faults = [dict(at=0.35, kind="kill")]
    jh, jrep = _lm_disagg("jax", faults)
    th, trep = _lm_disagg("torch", faults)
    assert _streams(trep) == _streams(jrep) == _streams(base)
    for key in COUNTERS:
        assert getattr(trep, key) == getattr(jrep, key), key
    assert trep.disagg_fallbacks >= 1 and trep.faults_injected == 1
    assert trep.disagg_handoffs < base.disagg_handoffs
    _assert_survivor_kv(jh, th)


# --------------------------------------------------- the in-place hazards
def _spy_migrations(h, log):
    """Wrap ``h._try_migrate`` to snapshot, for every slot it moves, the
    source blocks (float32 numpy per leaf) and the cursor."""
    orig = h._try_migrate

    def spy(src_engine, slot, s, engines):
        pos = int(src_engine.kv.pos[slot])
        ids = [int(b) for b in src_engine.kv.tables[slot]]
        ok = orig(src_engine, slot, s, engines)
        if ok:
            pool = src_engine.kv.pool
            leaves = (tm._tree_leaves(pool) if torch.is_tensor(
                tm._tree_leaves(pool)[0]) else jax.tree.leaves(pool))
            nb = (pos - 1) // src_engine.kv.bs + 1
            log.append((s.req.rid, pos, [
                np.take(np.asarray(x.float() if torch.is_tensor(x) else x,
                                   np.float32), ids[:nb], axis=1)
                for x in leaves]))
        return ok
    h._try_migrate = spy


def test_drain_with_step_in_flight_matches_reference():
    """(a) The drain lands while the dying clone's step is in flight.
    The port's source pool already holds that step's writes at positions
    pos and later of the last copied block (the reference drops them with
    the step); they are overwritten on the survivor before any step reads
    them, so the streams and the survivors' KV equal the reference's."""
    base = _lm_base()
    # at 0.4 of the makespan the moved slot's cursor stands mid-block, so
    # the step in flight wrote into the last block that moves (at 0.5 the
    # cursors stand on block edges and the writes land in blocks that stay)
    faults = [dict(at=0.4 * base["span"], kind="drain", duration=2.0)]
    logs = {"jax": [], "torch": []}
    cancelled = []

    def hook(kind):
        def run(h):
            _spy_migrations(h, logs[kind])
            if kind == "torch":
                orig = h.dispatcher.cancel

                def cancel(task):
                    cancelled.append(task.label)
                    return orig(task)
                h.dispatcher.cancel = cancel
        return run

    jh, jrep = _lm_chaos("jax", faults, hook=hook("jax"))
    th, trep = _lm_chaos("torch", faults, hook=hook("torch"))
    assert "step" in cancelled                 # a step was in flight
    assert _streams(trep) == _streams(jrep) == base["tokens"]
    assert len(logs["torch"]) == len(logs["jax"]) \
        == trep.recoveries_migrated >= 1
    bs = 4
    dropped_writes = 0
    for (rid, pos, got), (rid_j, pos_j, want) in zip(logs["torch"],
                                                     logs["jax"]):
        assert (rid, pos) == (rid_j, pos_j)
        off = pos % bs or bs                   # live cells of the last block
        for g, w in zip(got, want):
            # every live position agrees with the reference's source
            np.testing.assert_allclose(g[:, :-1], w[:, :-1], atol=KV_TOL,
                                       rtol=0)
            np.testing.assert_allclose(g[:, -1, :off], w[:, -1, :off],
                                       atol=KV_TOL, rtol=0)
            if off < bs:
                dropped_writes += int(np.abs(g[:, -1, off:]
                                             - w[:, -1, off:]).max()
                                      > KV_TOL)
    assert dropped_writes > 0                  # the hazard was exercised
    assert_no_block_leak(th)
    _assert_survivor_kv(jh, th)


def test_revived_clone_pool_shares_no_tensor_with_pending_migration():
    """(b) After a drain, the dead engine's pool is the source of pending
    migrations.  A clone revived at that moment gets a fresh pool: no
    storage shared with the source, the source left as it was; once the
    migrations fold, nothing holds the dead pool (its memory returns)."""
    checked, refs = [], []

    def hook(h):
        orig = h._recover_failed

        def recover(inflight, engines):
            dead = [c for c, _ in h.injector.failed]
            orig(inflight, engines)
            pending = [m for e in engines.values() for m in e.migrations
                       if m[9] == "recover"]
            for clone in dead:
                if not pending or clone.cid in h._kv_pools:
                    continue
                src = pending[0][4]
                before = [x.clone() for x in tm._tree_leaves(src)]
                refs.extend(weakref.ref(x) for x in tm._tree_leaves(src))
                busy = clone.busy
                fresh = h._start_engine(clone)          # as if revived
                h._kv_pools.pop(clone.cid)
                clone.busy = busy
                used = {x.untyped_storage().data_ptr()
                        for x in tm._tree_leaves(src)}
                assert not used & {x.untyped_storage().data_ptr()
                                   for x in tm._tree_leaves(fresh.kv.pool)}
                for x, y in zip(before, tm._tree_leaves(src)):
                    assert torch.equal(x, y)
                checked.append(clone.cid)
        h._recover_failed = recover

    faults = SCHEDULES["drain"][0](_lm_base()["span"])
    h, rep = _lm_chaos("torch", faults, hook=hook)
    assert checked and rep.recoveries_migrated >= 1
    assert _streams(rep) == _lm_base()["tokens"]
    gc.collect()
    assert refs and all(r() is None for r in refs)


def _closure_cells(fn):
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__ or ())))


def test_hedged_closure_rerun_is_bitwise_one_run():
    """(c) A hedge re-runs a step closure on the engine's own pool.  With
    an executor running every closure twice, under a drain (folded
    migrations), a shared prefix that splits a block (copy-on-write) and
    a slowdown with hedging, the second run of each closure leaves the
    pool and the tokens bitwise as the first did; the real hedges too;
    and the streams and counters equal a single-run executor's."""
    seen = set()
    hedge_checks = []

    def twice(clone, fn, args):
        out1 = fn(*args)
        snap = [x.clone() for x in tm._tree_leaves(args[1])]
        toks1 = [x.clone() for x in out1[:-1] if torch.is_tensor(x)]
        out2 = fn(*args)
        for x, y in zip(snap, tm._tree_leaves(args[1])):
            assert torch.equal(x, y)
        for x, y in zip(toks1, [v for v in out2[:-1] if torch.is_tensor(v)]):
            assert torch.equal(x, y)
        cells = _closure_cells(fn)
        if cells.get("mig_batches"):
            seen.add("migration")
        if cells.get("cow_batch") is not None:
            seen.add("cow")
        return out2, 0.05

    def hook(h):
        orig = h.dispatcher.submit
        first = {}

        def submit(clone, fn, args=(), **kw):
            pool = args[1] if len(args) > 1 else None
            snap = ([x.clone() for x in tm._tree_leaves(pool)]
                    if kw.get("label") == "hedge" else None)
            task = orig(clone, fn, args, **kw)
            if snap is not None:
                one = first[fn]
                for x, y in zip(snap, tm._tree_leaves(pool)):
                    assert torch.equal(x, y)
                for x, y in zip(one.value[:-1], task.value[:-1]):
                    assert (x is None and y is None) or torch.equal(x, y)
                hedge_checks.append(task)
            else:
                first[fn] = task
            return task
        h.dispatcher.submit = submit

    # a 7-token shared prefix splits the second block (copy-on-write);
    # on this trace the slowdown at 0.6 of the makespan fires two hedges
    # and the drain at 0.9 moves a slot
    _, base = _lm_chaos("torch", prefix_len=7)
    span = base.makespan_s
    faults = [dict(at=0.9 * span, kind="drain", duration=2.0),
              dict(at=0.6 * span, kind="slow", duration=0.4 * span,
                   factor=40.0)]
    _, once = _lm_chaos("torch", faults, 2.0, prefix_len=7)
    th, trep = _lm_chaos("torch", faults, 2.0, prefix_len=7, hook=hook,
                         executor=twice)
    assert _streams(trep) == _streams(once) == _streams(base)
    assert len(trep.completions) == 12
    for key in COUNTERS:
        assert getattr(trep, key) == getattr(once, key), key
    assert trep.hedges_fired >= 1 and hedge_checks
    assert trep.recoveries_migrated >= 1
    assert seen == {"migration", "cow"}
    assert_no_block_leak(th)
