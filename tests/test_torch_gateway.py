"""The SLO-aware streaming gateway in the port (CPU).

Mirrors of the reference's ``tests/test_gateway.py`` (token bucket,
tenant policy, response cache, admission estimator, DRR release,
shedding, predictive rejection, seeded Retry-After, the breaker caps and
gated ``ClientHandler`` runs on a fake backend) and of the quota property
of ``tests/test_property.py``, against the port's modules.

Then the port against the reference: ``run_quota_trace``'s release
records equal to the reference gateway's, and gated handler runs (fake
backend; reduced smollm-360m on shared weights under a drain) giving
equal streams and equal ``slo_attainment``, ``goodput_tps``,
``gateway_*``, ``cache_hits``, ``shed_by_slo``, ``per_tenant`` and
``peak_queue_depth``.
"""
import math

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import test_gateway as jtg
import test_handler as jth
import test_torch_faults as tf
import test_torch_spec as ts
from repro.core import gateway as jgw
from repro.core import scheduler as jsched
from repro_torch.core import gateway as tgw
from repro_torch.core.clock import SystemClock, VirtualClock
from repro_torch.core.clones import CircuitBreaker, ClonePool, CloneState
from repro_torch.core.gateway import (AdmissionEstimator, ResponseCache,
                                      StreamingGateway, TenantPolicy,
                                      TokenBucket)
from repro_torch.core.scheduler import ServeCompletion, ServeRequest
from repro_torch.launch import serve as tserve


# --------------------------------------------------------------------------- #
# token bucket + policy units
# --------------------------------------------------------------------------- #
def test_token_bucket_validates_rate_and_policy_weight():
    with pytest.raises(ValueError):
        TokenBucket(rate=0.0)
    with pytest.raises(ValueError):
        TokenBucket(rate=-1.0)
    with pytest.raises(ValueError):
        TenantPolicy(weight=0.0)
    assert math.isinf(TokenBucket().burst)      # unmetered default


def test_token_bucket_starts_full_then_refills_continuously():
    b = TokenBucket(rate=4.0, burst=8.0)
    assert b.take(0.0, 8.0)
    assert not b.take(0.0, 1.0)
    assert b.eta(0.0, 2.0) == pytest.approx(0.5)    # 2 tokens at 4/s
    assert not b.take(0.25, 2.0)
    assert b.take(0.5, 2.0)
    assert b.take(100.0, 8.0) and not b.take(100.0, 1e-9 + 1.0)


def test_response_cache_exact_match_lru():
    cache = ResponseCache(max_entries=2)
    reqs = [ServeRequest(i, np.full(4, i, np.int32), max_new_tokens=4)
            for i in range(3)]
    for r in reqs:
        assert cache.get(r) is None
        cache.put(r, [1, 2, 3, 4])
    assert len(cache) == 2
    assert cache.get(reqs[0]) is None           # LRU-evicted
    assert cache.get(reqs[2]) == [1, 2, 3, 4]
    other = ServeRequest(9, np.full(4, 2, np.int32), max_new_tokens=8)
    assert cache.get(other) is None             # another budget, another key
    assert cache.hits == 1 and cache.misses == 5


def test_estimator_ema_and_fault_inflation():
    est = AdmissionEstimator(tpot0=0.1, alpha=0.5)
    est.observe(0.3)
    assert est.tpot_s == pytest.approx(0.2)
    assert est.wait_s(10.0, 2, 0.5) == pytest.approx(
        2 * est.wait_s(10.0, 2, 1.0))


def test_gateway_clock_binding():
    gw = StreamingGateway()
    with pytest.raises(TypeError):
        gw.adopt_clock(SystemClock())
    clk = VirtualClock()
    gw.adopt_clock(clk)
    gw.adopt_clock(clk)                         # idempotent
    with pytest.raises(ValueError):
        gw.adopt_clock(VirtualClock())


# --------------------------------------------------------------------------- #
# release: DRR fair share, class priority, quota backpressure
# --------------------------------------------------------------------------- #
class _Sink:
    """Stand-in for the handler's AdmissionQueue: records releases."""

    def __init__(self):
        self.released = []                      # (t, tenant, rid, cost)

    def offer(self, req, now):
        self.released.append((now, req.tenant, req.rid,
                              max(1, req.max_new_tokens)))
        return True


def _req(rid, tenant, *, cost=1, arrival=0.0, slo="batch", deadline=None,
         priority=0, prompt=None, cls=ServeRequest):
    p = prompt if prompt is not None else np.zeros(4, np.int32)
    return cls(rid, p, max_new_tokens=cost, arrival_t=arrival,
               priority=priority, tenant=tenant, slo=slo,
               deadline_s=deadline)


def test_drr_release_is_weighted_fair():
    gw = StreamingGateway(clock=VirtualClock(), quantum=1.0, tenants={
        "heavy": TenantPolicy(weight=3.0), "light": TenantPolicy()})
    for i in range(10):
        gw.offer(_req(i, "heavy"), 0.0)
        gw.offer(_req(100 + i, "light"), 0.0)
    sink = _Sink()
    assert gw.release(0.0, sink, budget=8) == 8
    by = {"heavy": 0, "light": 0}
    for _, tenant, _, _ in sink.released:
        by[tenant] += 1
    assert by == {"heavy": 6, "light": 2}       # 3:1 deficit split


def test_interactive_releases_before_any_batch():
    gw = StreamingGateway(clock=VirtualClock())
    gw.offer(_req(0, "a", arrival=0.0), 0.0)
    gw.offer(_req(1, "b", arrival=0.5, slo="interactive", deadline=9.0),
             0.5)
    sink = _Sink()
    gw.release(0.5, sink, budget=2)
    assert [r[2] for r in sink.released] == [1, 0]


def test_quota_blocked_head_surfaces_bucket_eta():
    clk = VirtualClock()
    gw = StreamingGateway(clock=clk, quantum=8.0, tenants={
        "metered": TenantPolicy(rate=4.0, burst=4.0)})
    gw.offer(_req(0, "metered", cost=4), 0.0)
    gw.offer(_req(1, "metered", cost=4), 0.0)
    sink = _Sink()
    assert gw.release(0.0, sink, budget=4) == 1
    assert gw.next_event_time() == pytest.approx(1.0)   # 4 tokens at 4/s
    clk.advance_to(1.0)
    assert gw.release(1.0, sink, budget=4) == 1
    assert gw.queued == 0


# --------------------------------------------------------------------------- #
# admission: predictive rejection, shedding, backpressure
# --------------------------------------------------------------------------- #
def test_predictive_rejection_is_link_honest():
    big = np.zeros(25_000, np.int32)            # 100 KB prompt
    for link, want in (("wifi-local", "queued"), ("3g", "rejected")):
        gw = StreamingGateway(clock=VirtualClock(), link=link, tpot0=1e-3)
        r = _req(0, "t", cost=1, slo="interactive", deadline=0.3,
                 prompt=big)
        assert gw.offer(r, 0.0) == want, link
    assert gw.rejected_by_slo == {"interactive": 1}


def test_shedding_never_victimizes_interactive():
    gw = StreamingGateway(clock=VirtualClock(), max_backlog_tokens=8.0,
                          retry_max=0)
    assert gw.offer(_req(0, "t", cost=4, priority=1), 0.0) == "queued"
    assert gw.offer(_req(1, "t", cost=4, priority=0), 0.1) == "queued"
    assert gw.offer(_req(2, "t", cost=4, priority=2), 0.2) == "queued"
    assert gw.shed == 1
    assert gw.offer(_req(3, "t", cost=4, slo="interactive"), 0.3) \
        == "queued"
    assert gw.shed == 2 and gw.shed_by_slo == {"batch": 2}
    assert sorted(r.rid for q in gw._queues.values() for r in q) == [2, 3]


def test_retry_after_is_deterministic_and_bounded():
    def run():
        clk = VirtualClock()
        gw = StreamingGateway(clock=clk, max_backlog_tokens=1.0,
                              retry_base_s=0.25, retry_max=2, seed=7)
        gw.offer(_req(0, "t", cost=4), 0.0)      # over bound: shed + retry
        while gw.pending:
            nxt = gw.next_event_time()
            assert nxt is not None and nxt > clk.now()
            clk.advance_to(nxt)
        return list(gw.retry_log), gw.shed, gw.dropped
    log1, shed1, dropped1 = run()
    log2, shed2, dropped2 = run()
    assert log1 == log2
    assert [a for _, a, _ in log1] == [1, 2]
    assert shed1 == shed2 == 3 and dropped1 == dropped2 == 1
    assert log1[1][2] - log1[0][2] > log1[0][2]


def test_deadline_work_is_never_retried():
    gw = StreamingGateway(clock=VirtualClock(), max_backlog_tokens=1.0,
                          tpot0=1e-6)
    gw.offer(_req(0, "t", cost=4, deadline=50.0), 0.0)
    assert gw.shed == 1 and gw.retries == 0 and gw.pending == 0


def test_completion_feedback_populates_cache():
    gw = StreamingGateway(clock=VirtualClock())
    prompt = np.arange(6, dtype=np.int32)
    gw.offer(_req(0, "t", cost=4, prompt=prompt), 0.0)
    gw.release(0.0, _Sink(), budget=1)
    gw.observe_completion(ServeCompletion(
        0, [5, 6, 7, 8], 0.0, 0.2, 0.5, "venue:0",
        token_ts=[0.2, 0.3, 0.4, 0.5]))
    assert gw.estimator.samples == 1
    assert gw.offer(_req(1, "t", cost=4, prompt=prompt), 1.0) == "cached"
    out = gw.drain_cached()
    assert len(out) == 1 and out[0].cached
    assert out[0].venue == "gateway-cache" and out[0].tokens == [5, 6, 7, 8]
    assert out[0].met_deadline


# --------------------------------------------------------------------------- #
# the deterministic quota / fairness twin
# --------------------------------------------------------------------------- #
def run_quota_trace(*, adv_weight=1.0, adv_cost=2, adv_n=60, victim_n=16,
                    rate=8.0, burst=8.0, metered_n=30, horizon=8.0,
                    dt=0.25, budget=4, quantum=2.0, seed=0):
    """The reference's ``run_quota_trace`` on the port's gateway: a
    victim, a flooding adversary and a metered tenant; returns the
    release record."""
    rng = np.random.default_rng(seed)
    clk = VirtualClock()
    gw = StreamingGateway(clock=clk, quantum=quantum, seed=seed, tenants={
        "victim": TenantPolicy(weight=1.0),
        "adversary": TenantPolicy(weight=adv_weight),
        "metered": TenantPolicy(weight=1.0, rate=rate, burst=burst),
    })
    arrivals = (
        [_req(i, "victim", cost=1, arrival=0.0) for i in range(victim_n)]
        + [_req(1000 + i, "adversary", cost=adv_cost,
                arrival=0.0 if i < adv_n // 2 else horizon / 2)
           for i in range(adv_n)]
        + [_req(2000 + i, "metered", cost=2,
                arrival=float(rng.uniform(0, horizon / 2)))
           for i in range(metered_n)])
    arrivals.sort(key=lambda r: (r.arrival_t, r.rid))
    sink = _Sink()
    i, t = 0, 0.0
    while t <= horizon + 1e-9:
        if t > clk.now():
            clk.advance_to(t)
        while i < len(arrivals) and arrivals[i].arrival_t <= t + 1e-9:
            gw.offer(arrivals[i], t)
            i += 1
        gw.release(t, sink, budget)
        t += dt
    return {"released": sink.released, "rate": rate, "burst": burst,
            "adv_weight": adv_weight, "quantum": quantum,
            "victim_n": victim_n, "max_cost": max(adv_cost, 2)}


def check_quota_invariants(out):
    """Quota (the metered tenant within burst + rate * t at every release)
    and fairness (the backlogged victim within a DRR bound of the
    adversary's weight-normalized service, never starved)."""
    rate, burst = out["rate"], out["burst"]
    tok = 0.0
    for t, tenant, _, cost in out["released"]:
        if tenant == "metered":
            tok += cost
            assert tok <= burst + rate * t + 1e-6, (t, tok)
    v_tok = a_tok = v_seen = 0.0
    slack = 2 * out["quantum"] * max(1.0, out["adv_weight"]) \
        + 2 * out["max_cost"]
    for _, tenant, _, cost in out["released"]:
        if tenant == "victim":
            v_tok += cost
            v_seen += 1
        elif tenant == "adversary":
            a_tok += cost
        if v_seen < out["victim_n"]:
            assert a_tok / out["adv_weight"] - v_tok <= slack, \
                (v_tok, a_tok)
    assert v_seen == out["victim_n"]


def test_quota_trace_deterministic_twin():
    for kw in ({}, {"adv_weight": 6.0, "adv_cost": 4},
               {"rate": 2.0, "burst": 2.0, "adv_weight": 0.5}):
        check_quota_invariants(run_quota_trace(**kw))
    assert run_quota_trace(seed=3) == run_quota_trace(seed=3)


@settings(deadline=None, max_examples=15)
@given(seed=st.integers(0, 2 ** 31 - 1),
       adv_weight=st.floats(min_value=0.25, max_value=8.0,
                            allow_nan=False),
       adv_cost=st.sampled_from([1, 2, 4, 8]),
       adv_n=st.integers(10, 80),
       rate=st.sampled_from([2.0, 4.0, 8.0, 16.0]),
       burst=st.sampled_from([2.0, 8.0, 16.0]))
def test_gateway_quota_and_fair_share(seed, adv_weight, adv_cost, adv_n,
                                      rate, burst):
    """The reference's quota property on the port's gateway, and the
    release record equal to the reference gateway's on the same draw."""
    kw = dict(adv_weight=adv_weight, adv_cost=adv_cost, adv_n=adv_n,
              rate=rate, burst=burst, seed=seed)
    out = run_quota_trace(**kw)
    check_quota_invariants(out)
    assert out == jtg.run_quota_trace(**kw)


@pytest.mark.parametrize("kw", [{}, {"adv_weight": 6.0, "adv_cost": 4},
                                {"rate": 2.0, "burst": 2.0,
                                 "adv_weight": 0.5}, {"seed": 3}])
def test_quota_trace_matches_reference(kw):
    assert run_quota_trace(**kw) == jtg.run_quota_trace(**kw)


# --------------------------------------------------------------------------- #
# breaker caps
# --------------------------------------------------------------------------- #
def test_breaker_custom_caps_bound_probe_chain():
    clk = VirtualClock()
    b = CircuitBreaker(open_seconds=0.5, max_open_seconds=1.0,
                       max_probes=3)
    b.bind(clk, lambda: False)
    b.trip(0.0)
    clk.advance_to(2.6)                         # probes at 0.5, 1.5, 2.5
    assert b.probes == 3 and b.state == "open"
    clk.advance_to(100.0)
    assert b.probes == 3
    clk2 = VirtualClock()
    d = CircuitBreaker(open_seconds=0.5)
    d.bind(clk2, lambda: False)
    d.trip(0.0)
    clk2.advance_to(2.6)
    assert d.probes == 2                        # the 30 s cap: third at 3.5


def _make_handler(**kw):
    kw.setdefault("executor", ts._fixed)
    return tserve.ClientHandler(tf.FakeBackend(), prompt_pad=4, **kw)


def test_handler_surfaces_breaker_caps():
    h = _make_handler(max_secondaries=2, breaker_max_open_s=3.0,
                      breaker_max_probes=2)
    assert h.pool.clones
    for c in h.pool.clones:
        assert c.breaker.max_open_seconds == 3.0
        assert c.breaker.max_probes == 2
    clk = VirtualClock()
    pool = ClonePool(clock=clk)
    pool.provision("main", 2, state=CloneState.RUNNING)
    tserve.ClientHandler(tf.FakeBackend(), executor=ts._fixed, pool=pool,
                         clock=clk, breaker_max_open_s=2.5)
    for c in pool.clones:
        assert c.breaker.max_open_seconds == 2.5


# --------------------------------------------------------------------------- #
# end to end through the Client Handler
# --------------------------------------------------------------------------- #
def _trace(n, *, rate=20.0, cost=4, seed=0, dup_every=0, deadline=None,
           cls=ServeRequest):
    rng = np.random.default_rng(seed)
    dup = rng.integers(0, 50, 6).astype(np.int32)
    reqs = []
    for i in range(n):
        prompt = dup if dup_every and i % dup_every == 2 \
            else rng.integers(0, 50, 6).astype(np.int32)
        reqs.append(cls(
            i, prompt, max_new_tokens=cost, arrival_t=i / rate,
            tenant=("premium" if i % 3 == 0 else "bulk"),
            slo=("interactive" if i % 3 == 0 else "batch"),
            deadline_s=deadline if i % 3 == 0 else None))
    return reqs


def _gated_handler(gw, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_secondaries", 1)
    return _make_handler(gateway=gw, **kw)


def test_gated_run_serves_everything_at_low_load():
    rep0 = _make_handler(max_batch=2, max_secondaries=1).run(
        _trace(8), drain_idle_s=40.0)
    gw = StreamingGateway(tenants={"premium": TenantPolicy(weight=4.0)})
    rep1 = _gated_handler(gw).run(_trace(8), drain_idle_s=40.0)
    toks = {c.rid: c.tokens for c in rep0.completions}
    assert {c.rid: c.tokens for c in rep1.completions} == toks
    assert gw.shed == 0 and gw.rejected == 0
    assert rep1.slo_attainment.get("batch") == 1.0
    assert set(rep1.per_tenant) == {"premium", "bulk"}
    for row in rep1.per_tenant.values():
        assert row["served"] > 0 and row["p50_tpot_s"] >= 0.0


def test_gateway_cache_end_to_end():
    gw = StreamingGateway()
    rep = _gated_handler(gw).run(_trace(10, rate=3.0, dup_every=3),
                                 drain_idle_s=40.0)
    assert rep.cache_hits >= 1
    cached = [c for c in rep.completions if c.cached]
    assert cached and all(c.venue == "gateway-cache" for c in cached)
    by_rid = {c.rid: c for c in rep.completions}
    for c in cached:                             # identical to the miss
        first = min(r for r, cc in by_rid.items()
                    if cc.tokens == c.tokens and not cc.cached)
        assert by_rid[first].tokens == c.tokens
    assert len(rep.completions) == 10


def test_retry_replay_is_deterministic_end_to_end():
    def run():
        gw = StreamingGateway(max_backlog_tokens=8.0, quantum=4.0,
                              retry_base_s=0.3, retry_max=2, seed=11)
        rep = _gated_handler(gw, queue_depth=4).run(
            _trace(16, rate=200.0), drain_idle_s=40.0)
        return gw, rep
    gw1, rep1 = run()
    gw2, rep2 = run()
    assert gw1.retry_log and gw1.retry_log == gw2.retry_log
    for field in ("gateway_shed", "gateway_retries", "gateway_rejected",
                  "slo_attainment", "goodput_tps", "peak_queue_depth",
                  "makespan_s"):
        assert getattr(rep1, field) == getattr(rep2, field), field
    assert sorted(c.rid for c in rep1.completions) == \
        sorted(c.rid for c in rep2.completions)


def test_fault_signal_tightens_admission():
    gw = StreamingGateway(clock=VirtualClock(), max_backlog_tokens=100.0)
    gw.observe_fleet(4, 4, 8)
    assert gw.healthy_frac() == 1.0
    gw.note_fault()
    gw.note_fault()
    assert gw.healthy_frac() == pytest.approx(0.5)
    assert gw.fault_signals == 2
    gw.observe_fleet(2, 4, 4)                    # the census supersedes
    assert gw.healthy_frac() == pytest.approx(0.5)


# --------------------------------------------------------------------------- #
# port against reference: gated handler runs
# --------------------------------------------------------------------------- #
REPORT_FIELDS = ("slo_attainment", "goodput_tps", "gateway_shed",
                 "gateway_rejected", "gateway_retries", "cache_hits",
                 "shed_by_slo", "per_tenant", "peak_queue_depth",
                 "makespan_s", "accepted", "rejected")
GATED = {
    "low_load": (dict(tenants={"premium": {"weight": 4.0}}),
                 dict(n=8), {}),
    "cache": ({}, dict(n=10, rate=3.0, dup_every=3), {}),
    "overload_retry": (dict(max_backlog_tokens=8.0, quantum=4.0,
                            retry_base_s=0.3, retry_max=2, seed=11),
                       dict(n=16, rate=200.0), dict(queue_depth=4)),
    "deadlines": (dict(max_backlog_tokens=12.0, tpot0=0.02),
                  dict(n=12, rate=40.0, deadline=0.4), {}),
}


def _gated_run(kind, name):
    gw_kw, trace_kw, h_kw = GATED[name]
    gw_kw = dict(gw_kw)
    mod = jgw if kind == "jax" else tgw
    if "tenants" in gw_kw:
        gw_kw["tenants"] = {t: mod.TenantPolicy(**p)
                            for t, p in gw_kw["tenants"].items()}
    gw = mod.StreamingGateway(**gw_kw)
    reqs = _trace(cls=(jsched.ServeRequest if kind == "jax"
                       else ServeRequest), **trace_kw)
    if kind == "jax":
        h = jth._make_handler(gateway=gw, max_batch=2, max_secondaries=1,
                              **h_kw)
    else:
        h = _gated_handler(gw, **h_kw)
    return gw, h.run(reqs, drain_idle_s=40.0)


@pytest.mark.parametrize("name", sorted(GATED))
def test_gated_handler_matches_reference(name):
    jg, jrep = _gated_run("jax", name)
    tg, trep = _gated_run("torch", name)
    assert tf._streams(trep) == tf._streams(jrep)
    assert [c.cached for c in trep.completions] == \
        [c.cached for c in jrep.completions]
    for key in REPORT_FIELDS:
        assert getattr(trep, key) == getattr(jrep, key), key
    assert tg.retry_log == jg.retry_log
    if name == "cache":
        assert trep.cache_hits >= 1
    if name == "overload_retry":
        assert trep.gateway_shed >= 1 and trep.gateway_retries >= 1


def test_gated_lm_drain_matches_reference():
    """Reduced smollm-360m on shared weights behind a gateway with an
    interactive tenant (deadline) and a batch tenant, under a drain: the
    fault reaches the gateway at its instant (``note_fault``); streams,
    recovery counters and every gateway field equal the reference's."""
    base = tf._lm_base()
    runs = {}
    for kind, mod in (("jax", jgw), ("torch", tgw)):
        gw = mod.StreamingGateway(tenants={
            "premium": mod.TenantPolicy(weight=4.0)}, tpot0=0.02)
        runs[kind] = (gw,) + tf._lm_chaos(
            kind, [dict(at=0.5 * base["span"], kind="drain",
                        duration=2.0)], tenants=True, gateway=gw)
    (jg, _, jrep), (tg, th, trep) = runs["jax"], runs["torch"]
    assert tf._streams(trep) == tf._streams(jrep)
    assert len(trep.completions) == 12
    assert tg.fault_signals == jg.fault_signals == 1
    for key in REPORT_FIELDS + tf.COUNTERS:
        assert getattr(trep, key) == getattr(jrep, key), key
    assert trep.recoveries_migrated >= 1
    assert set(trep.per_tenant) == {"premium", "bulk"}
    tf.assert_no_block_leak(th)
