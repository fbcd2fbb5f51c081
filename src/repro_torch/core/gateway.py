"""SLO-aware streaming gateway: admission, quotas, shedding, backpressure.

The serving fleet's front door (ADR-007).  ThinkAir's elasticity story
("millions of users", §5) has no defense when offered load exceeds what
the fleet can serve: the bounded :class:`~repro_torch.core.scheduler.
AdmissionQueue` sheds blindly and everything admitted eventually misses
any latency target.  The :class:`StreamingGateway` sits *between*
arrivals and the Client Handler's queue and degrades gracefully instead,
following Phone2Cloud's deadline-aware offload decision: reject work that
cannot finish in time *up front*, rather than accepting it and failing
slowly.  Everything runs on the shared
:class:`~repro_torch.core.clock.VirtualClock` — retries and quota refills are
deterministic timeline events, never wall-clock sleeps.

Pieces:

``TokenBucket`` / ``TenantPolicy``
    Per-tenant quota (tokens of *generated output* per virtual second,
    with a burst allowance) plus a fair-share ``weight``.  A tenant at
    its rate limit queues; it never starves the others.

``StreamingGateway.offer``
    The admission pipeline, in order: (1) an **exact-match LRU response
    cache** short-circuits duplicate prompts — a hit synthesizes the
    completion at the gateway, costing zero fleet work; (2) **predictive
    admission**: a request carrying a deadline is rejected immediately
    when its estimated completion time — link transfer
    (:class:`~repro_torch.core.profilers.NetworkProfiler`, so a 3g client gets
    an honest earlier rejection than a wifi-local one) + backlog drain at
    the observed TPOT + its own decode time — exceeds the deadline;
    (3) **bounded-backlog load shedding**: past the backlog bound the
    lowest-priority *batch* request is shed (the incoming request can be
    its own victim); interactive work is never shed.

``StreamingGateway.release``
    Weighted fair-share dequeueing into the handler's admission queue:
    **deficit round-robin** across per-tenant queues (each rotation
    grants ``quantum x weight`` deficit; a release costs the request's
    token cost), gated by the tenant's token bucket.  Within a tenant the
    queue is **deadline-ordered** (interactive/EDF first, then batch in
    arrival order).

Backpressure: a shed *deadline-less* request is replayed after a
**deterministic jittered exponential backoff** (seeded per (rid,
attempt), scheduled as a clock event) up to ``retry_max`` attempts —
the virtual analogue of HTTP 503 + Retry-After.  Deadline-carrying work
is never retried: its deadline is fixed at arrival, so a request the
estimator already judged infeasible stays infeasible.

Fleet-capacity feedback (ADR-006 -> ADR-007): the handler reports
``observe_fleet(healthy, total, slots)`` every scheduler round — DEAD
clones and open breakers shrink both the estimator's service rate and
the backlog bound — and a
:class:`~repro_torch.core.faults.FaultInjector` ``on_fire`` hook tightens
admission the instant a clone dies, before the next round's census.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from bisect import insort
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.clock import ensure_clock
from repro_torch.core.profilers import NetworkProfiler
from repro_torch.core.scheduler import ServeCompletion, ServeRequest

SLO_CLASSES = ("interactive", "batch")


class TokenBucket:
    """Continuous-refill token bucket on virtual time.

    ``rate`` is tokens per virtual second, ``burst`` the bucket depth
    (default: one second of rate).  The bucket starts full.  ``eta``
    reports the absolute time a ``take`` of the given cost will succeed
    — the gateway schedules its next release around it instead of
    polling."""

    def __init__(self, rate: float = math.inf,
                 burst: Optional[float] = None):
        if rate <= 0:
            raise ValueError(f"token-bucket rate must be > 0: {rate}")
        self.rate = float(rate)
        if burst is None:
            burst = rate if math.isfinite(rate) else math.inf
        self.burst = float(burst)
        self.tokens = self.burst
        self._t = 0.0

    def _refill(self, now: float) -> None:
        if now > self._t:
            if math.isfinite(self.rate):
                self.tokens = min(self.burst,
                                  self.tokens + (now - self._t) * self.rate)
            self._t = now

    def take(self, now: float, cost: float) -> bool:
        """Consume ``cost`` tokens if available right now."""
        self._refill(now)
        if self.tokens + 1e-9 >= cost:
            self.tokens = min(self.tokens - cost, self.burst)
            return True
        return False

    def eta(self, now: float, cost: float) -> float:
        """Earliest time a ``take(cost)`` will succeed (== now if it
        would succeed already)."""
        self._refill(now)
        if self.tokens + 1e-9 >= cost:
            return now
        return now + (cost - self.tokens) / self.rate


@dataclasses.dataclass
class TenantPolicy:
    """Per-tenant quota + fair-share weight.

    ``rate``/``burst`` bound the tenant's *output-token* throughput
    (``math.inf`` = unmetered); ``weight`` scales its deficit-round-robin
    share of contended release capacity."""

    weight: float = 1.0
    rate: float = math.inf
    burst: Optional[float] = None

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"tenant weight must be > 0: {self.weight}")


class ResponseCache:
    """Exact-match LRU response cache (prompt bytes + token budget ->
    generated tokens).  Greedy decoding is deterministic, so an exact
    prompt repeat *is* the same response — the gateway serves it without
    touching the fleet."""

    def __init__(self, max_entries: int = 64):
        self.max_entries = max_entries
        self._d: "OrderedDict[tuple, List[int]]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key(req: ServeRequest) -> tuple:
        p = np.asarray(req.prompt)
        return (p.tobytes(), int(p.size), int(req.max_new_tokens))

    def get(self, req: ServeRequest) -> Optional[List[int]]:
        k = self.key(req)
        toks = self._d.get(k)
        if toks is None:
            self.misses += 1
            return None
        self._d.move_to_end(k)
        self.hits += 1
        return list(toks)

    def put(self, req: ServeRequest, tokens: List[int]) -> None:
        if self.max_entries <= 0:
            return
        k = self.key(req)
        self._d[k] = list(tokens)
        self._d.move_to_end(k)
        while len(self._d) > self.max_entries:
            self._d.popitem(last=False)

    def __len__(self) -> int:
        return len(self._d)


class AdmissionEstimator:
    """Completion-time estimator behind predictive admission.

    Tracks the fleet's observed time-per-output-token as an EMA (seeded
    with ``tpot0`` until the first completion reports) and converts the
    current backlog into an expected queueing delay:
    ``backlog_tokens x tpot / service_slots``, inflated by
    ``1 / healthy_frac`` during fault-induced capacity loss so admission
    tightens exactly when breakers open (ADR-006 signal)."""

    def __init__(self, tpot0: float = 0.05, alpha: float = 0.35):
        self.tpot_s = float(tpot0)
        self.alpha = alpha
        self.samples = 0

    def observe(self, tpot_s: float) -> None:
        if tpot_s <= 0:
            return
        self.tpot_s += self.alpha * (tpot_s - self.tpot_s)
        self.samples += 1

    def wait_s(self, backlog_tokens: float, slots: int,
               healthy_frac: float) -> float:
        return (backlog_tokens * self.tpot_s / max(1, slots)
                / max(healthy_frac, 1e-3))

    def service_s(self, new_tokens: int) -> float:
        return new_tokens * self.tpot_s


class StreamingGateway:
    """SLO-aware front door between arrivals and the Client Handler.

    Construct with the serving timeline's clock (or let
    :meth:`adopt_clock` bind it when the handler takes the gateway).
    ``tenants`` maps tenant name -> :class:`TenantPolicy`; requests from
    unknown tenants (or ``tenant=None``) use ``default_policy``.
    ``max_backlog_tokens`` bounds the *queued* output-token backlog —
    beyond it batch work is shed; the bound shrinks with fleet health.
    """

    def __init__(self, *, clock=None,
                 tenants: Optional[Dict[str, TenantPolicy]] = None,
                 default_policy: Optional[TenantPolicy] = None,
                 max_backlog_tokens: float = 512.0,
                 quantum: float = 16.0,
                 link: str = "wifi-local",
                 net: Optional[NetworkProfiler] = None,
                 retry_base_s: float = 0.5, retry_max: int = 3,
                 retry_jitter: float = 0.5,
                 cache_entries: int = 64,
                 tpot0: float = 0.05,
                 seed: int = 0):
        self.clock = None
        if clock is not None:
            self.adopt_clock(clock)
        self.policies: Dict[str, TenantPolicy] = dict(tenants or {})
        self.default_policy = default_policy or TenantPolicy()
        self.max_backlog_tokens = float(max_backlog_tokens)
        self.quantum = float(quantum)
        self.net = net or NetworkProfiler(link)
        self.retry_base_s = retry_base_s
        self.retry_max = retry_max
        self.retry_jitter = retry_jitter
        self.cache = ResponseCache(cache_entries)
        self.estimator = AdmissionEstimator(tpot0=tpot0)
        self.seed = seed
        # per-tenant EDF queues + DRR state
        self._queues: Dict[str, List[ServeRequest]] = {}
        self._rr: List[str] = []                   # rotation order
        self._deficit: Dict[str, float] = {}
        self._buckets: Dict[str, TokenBucket] = {}
        self._queued_tokens = 0.0
        self._inflight_tokens = 0.0
        self._released: Dict[int, ServeRequest] = {}
        # fleet-capacity signal (ADR-006): healthy/total serveable clones
        # + decode slots, refreshed by the handler each round; on_fire
        # faults tighten it immediately until the next census
        self._healthy = 1
        self._total = 1
        self._slots = 1
        self._fault_pressure = 0
        # backpressure (Retry-After) state
        self._retry_events: List[object] = []
        self._pending_retries = 0
        self._bucket_next: Optional[float] = None
        self._cached_out: List[ServeCompletion] = []
        # telemetry
        self.offered = 0
        self.admitted = 0
        self.cache_hits = 0
        self.rejected = 0
        self.shed = 0
        self.retries = 0
        self.dropped = 0
        self.expired = 0
        self.fault_signals = 0
        self.shed_by_slo: Dict[str, int] = {}
        self.rejected_by_slo: Dict[str, int] = {}
        self.retry_log: List[Tuple[int, int, float]] = []

    # ------------------------------------------------------------- plumbing
    def adopt_clock(self, clock) -> None:
        """Bind the serving timeline (idempotent; disagreement raises)."""
        clock = ensure_clock(clock)
        if not getattr(clock, "virtual", False):
            raise TypeError("StreamingGateway schedules retry events — it "
                            "needs a VirtualClock")
        if self.clock is not None and self.clock is not clock:
            raise ValueError("gateway already bound to a different clock")
        self.clock = clock

    def policy(self, tenant: Optional[str]) -> TenantPolicy:
        return self.policies.get(tenant or "", self.default_policy) \
            if tenant is not None else self.default_policy

    def _bucket(self, tenant: str) -> TokenBucket:
        b = self._buckets.get(tenant)
        if b is None:
            pol = self.policy(tenant)
            b = self._buckets[tenant] = TokenBucket(pol.rate, pol.burst)
        return b

    @staticmethod
    def cost(req: ServeRequest) -> int:
        """A request's service cost in output tokens (the unit quotas,
        the backlog bound, and DRR deficits are all denominated in)."""
        return max(1, int(req.max_new_tokens))

    @staticmethod
    def _order_key(req: ServeRequest) -> tuple:
        """Deadline-ordered admission within a tenant: interactive (EDF)
        ahead of batch, then earliest absolute deadline, then FIFO."""
        dl = (req.arrival_t + req.deadline_s
              if req.deadline_s is not None else math.inf)
        return (req.slo != "interactive", dl, req.arrival_t, req.rid)

    # ----------------------------------------------------- capacity signal
    def observe_fleet(self, healthy: int, total: int, slots: int) -> None:
        """Per-round fleet census: serveable vs total clones and the
        decode slots the healthy set offers.  Resets any interim
        ``note_fault`` pressure (the census supersedes it)."""
        self._healthy = max(0, int(healthy))
        self._total = max(1, int(total))
        self._slots = max(1, int(slots))
        self._fault_pressure = 0

    def note_fault(self, clone=None, fault=None) -> None:
        """FaultInjector ``on_fire`` hook: a clone just died — count it
        against the healthy set *now*, before the next round's census,
        so admission tightens at the fault instant."""
        self._fault_pressure += 1
        self.fault_signals += 1

    def healthy_frac(self) -> float:
        healthy = min(max(self._healthy - self._fault_pressure, 0),
                      self._total)
        return max(healthy / self._total, 0.05)

    # ----------------------------------------------------------- admission
    def backlog_tokens(self, ahead_of: Optional[ServeRequest] = None
                       ) -> float:
        """Output tokens queued at the gateway plus released-but-unserved
        in-flight work — what a new arrival queues behind.  With
        ``ahead_of``, only queued work that would be released before it
        counts (release is class-priority: batch never delays an
        interactive request at the gateway)."""
        queued = self._queued_tokens
        if ahead_of is not None and ahead_of.slo == "interactive":
            queued = float(sum(self.cost(r) for q in self._queues.values()
                               for r in q if r.slo == "interactive"))
        # released work is on average half-served (continuous batching
        # starts a newcomer as soon as ONE slot frees, not when the whole
        # in-flight cohort drains) — count it at half weight
        return queued + 0.5 * self._inflight_tokens

    def estimate_done(self, req: ServeRequest, now: float) -> float:
        """Predicted completion time for ``req`` admitted now: link
        transfer (prompt up + tokens down, honest per link profile) +
        backlog drain at observed TPOT + its own decode time."""
        nbytes = int(np.asarray(req.prompt).nbytes + 8 * req.max_new_tokens)
        xfer = self.net.transfer_time(nbytes)
        wait = self.estimator.wait_s(
            self.backlog_tokens(ahead_of=req) + self.cost(req),
            self._slots, self.healthy_frac())
        return now + xfer + wait + self.estimator.service_s(
            req.max_new_tokens)

    def offer(self, req: ServeRequest, now: float) -> str:
        """Admission pipeline; returns one of ``"cached"``, ``"queued"``,
        ``"rejected"``, ``"shed"`` (see the module docstring for the
        order and semantics)."""
        self.offered += 1
        toks = self.cache.get(req)
        if toks is not None:
            self.cache_hits += 1
            self._cached_out.append(ServeCompletion(
                req.rid, toks, req.arrival_t, now, now, "gateway-cache",
                tenant=req.tenant, slo=req.slo, deadline_s=req.deadline_s,
                token_ts=[now] * len(toks), cached=True))
            return "cached"
        if req.deadline_s is not None:
            est = self.estimate_done(req, now)
            if est - req.arrival_t > req.deadline_s:
                self._count(self.rejected_by_slo, req.slo)
                self.rejected += 1
                return "rejected"
        c = self.cost(req)
        bound = self.max_backlog_tokens * self.healthy_frac()
        if self._queued_tokens + c > bound:
            victim = self._shed_victim(req)
            if victim is req:
                self._shed(req, now)
                return "shed"
            if victim is not None:
                self._queues[victim.tenant or ""].remove(victim)
                self._queued_tokens -= self.cost(victim)
                self._shed(victim, now)
            # interactive overflow with no batch victim left: admit — the
            # predictive check above already rejected infeasible deadlines
        self._enqueue(req, now)
        return "queued"

    def _count(self, d: Dict[str, int], slo: str) -> None:
        d[slo] = d.get(slo, 0) + 1

    def _enqueue(self, req: ServeRequest, now: float) -> None:
        t = req.tenant or ""
        q = self._queues.get(t)
        if q is None:
            q = self._queues[t] = []
            self._rr.append(t)
            self._deficit.setdefault(t, 0.0)
        insort(q, req, key=self._order_key)
        self._queued_tokens += self.cost(req)

    def _shed_victim(self, incoming: ServeRequest
                     ) -> Optional[ServeRequest]:
        """The request bounded-backlog shedding evicts: the *batch*-class
        request with the lowest priority, breaking ties toward the newest
        arrival (it has waited least).  The incoming request competes on
        the same terms.  Interactive work is never a victim; ``None``
        means nothing batch is queued and the incoming request is
        interactive."""
        cands = [r for q in self._queues.values() for r in q
                 if r.slo != "interactive"]
        if incoming.slo != "interactive":
            cands.append(incoming)
        if not cands:
            return None
        return min(cands, key=lambda r: (r.priority, -r.arrival_t, -r.rid))

    # -------------------------------------------------------- backpressure
    def _shed(self, req: ServeRequest, now: float) -> None:
        self.shed += 1
        self._count(self.shed_by_slo, req.slo)
        if req.deadline_s is not None:
            return                   # deadline fixed at arrival: no retry
        attempt = req.retries + 1
        if attempt > self.retry_max:
            self.dropped += 1
            return
        req.retries = attempt
        # deterministic jittered exponential backoff: the jitter draw is
        # keyed on (seed, rid, attempt), so one request's retry timeline
        # is identical across runs — replayable backpressure
        jit = float(np.random.default_rng(
            (self.seed, req.rid, attempt)).random())
        delay = (self.retry_base_s * (2.0 ** (attempt - 1))
                 * (1.0 + self.retry_jitter * jit))
        self.retries += 1
        self._pending_retries += 1
        self.retry_log.append((req.rid, attempt, now + delay))
        self._retry_events.append(
            self.clock.schedule(delay, functools.partial(self._reoffer,
                                                         req)))

    def _reoffer(self, req: ServeRequest) -> None:
        self._pending_retries -= 1
        self.offer(req, self.clock.now())

    # -------------------------------------------------------------- release
    def release(self, now: float, queue, budget: int) -> int:
        """Deficit-round-robin dequeue into the handler's admission
        queue, at most ``budget`` requests.  Two class-priority phases —
        every tenant's *interactive* heads drain before anyone's batch
        work, so a burst of batch arrivals never delays interactive
        release.  Within a phase, each rotation grants every backlogged
        tenant ``quantum x weight`` deficit; releasing a request costs
        its token cost and must pass the tenant's token bucket (a
        blocked head parks the tenant until its bucket's ``eta``,
        surfaced via :meth:`next_event_time`).  Expired deadlines are
        dropped here rather than served dead."""
        self._bucket_next = None
        released = self._release_phase(now, queue, budget, "interactive")
        released += self._release_phase(now, queue, budget - released,
                                        None)
        return released

    def _release_phase(self, now: float, queue, budget: int,
                       only_slo: Optional[str]) -> int:
        released = 0
        while released < budget:
            advanced = False
            needs_deficit = False
            for t in list(self._rr):
                q = self._queues.get(t)
                if not q:
                    self._deficit[t] = 0.0
                    continue
                self._deficit[t] += self.quantum * self.policy(t).weight
                bucket = self._bucket(t)
                while q and released < budget:
                    head = q[0]
                    if only_slo is not None and head.slo != only_slo:
                        break    # EDF order: nothing of this class left
                    if (head.deadline_s is not None
                            and now - head.arrival_t > head.deadline_s):
                        q.pop(0)
                        self._queued_tokens -= self.cost(head)
                        self.expired += 1
                        self.rejected += 1
                        self._count(self.rejected_by_slo, head.slo)
                        continue
                    c = self.cost(head)
                    if self._deficit[t] < c:
                        needs_deficit = True
                        break
                    if not bucket.take(now, c):
                        self._note_event(max(bucket.eta(now, c),
                                             now + 1e-9))
                        break
                    q.pop(0)
                    self._deficit[t] -= c
                    self._queued_tokens -= c
                    queue.offer(head, now)
                    self._released[head.rid] = head
                    self._inflight_tokens += c
                    self.admitted += 1
                    released += 1
                    advanced = True
                if not q:
                    self._deficit[t] = 0.0
            if released >= budget or not (advanced or needs_deficit):
                break
        return released

    def _note_event(self, t: float) -> None:
        if self._bucket_next is None or t < self._bucket_next:
            self._bucket_next = t

    # ------------------------------------------------------------ feedback
    def observe_completion(self, c: ServeCompletion) -> None:
        """Fold a served completion back: release its in-flight tokens,
        feed the TPOT estimator, and populate the response cache."""
        if c.cached:
            return
        req = self._released.pop(c.rid, None)
        if req is None:
            return
        self._inflight_tokens = max(
            0.0, self._inflight_tokens - self.cost(req))
        tpot = c.tpot_s
        if tpot > 0:
            self.estimator.observe(tpot)
        self.cache.put(req, list(map(int, c.tokens)))

    def drain_cached(self) -> List[ServeCompletion]:
        out, self._cached_out = self._cached_out, []
        return out

    # ------------------------------------------------------------- queries
    @property
    def queued(self) -> int:
        return sum(len(q) for q in self._queues.values())

    @property
    def pending(self) -> int:
        """Work the gateway still owes the serving loop: queued requests
        plus scheduled Retry-After replays."""
        return self.queued + self._pending_retries

    def next_event_time(self) -> Optional[float]:
        """Earliest time the gateway can make progress it cannot make
        now: a scheduled retry replay or a quota-blocked head's bucket
        eta.  The serving loop bounds its idle waits on this."""
        times = [ev.time for ev in self._retry_events
                 if not ev.fired and not ev.cancelled]
        if self._bucket_next is not None:
            times.append(self._bucket_next)
        return min(times) if times else None

    def stats(self) -> Dict[str, float]:
        return {
            "offered": self.offered, "admitted": self.admitted,
            "cache_hits": self.cache_hits, "rejected": self.rejected,
            "shed": self.shed, "retries": self.retries,
            "dropped": self.dropped, "expired": self.expired,
            "queued": self.queued, "tpot_ema_s": self.estimator.tpot_s,
        }
