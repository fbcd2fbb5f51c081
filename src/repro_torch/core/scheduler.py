"""Client Handler scheduling primitives (paper §5.2-§5.3).

The paper's Client Handler "manages the connections coming from multiple
clients" and drives the VM manager's elasticity.  This module holds the
request-level pieces the event-driven :class:`~repro_torch.launch.serve.ClientHandler`
is built from:

``AdmissionQueue``
    Bounded FIFO with admission control — offered load beyond the bound is
    rejected up front (shed) rather than queued into unbounded latency.

``PoissonArrivals``
    Deterministic (seeded) open-loop arrival process for load generation on
    the virtual timeline.

``PlacementEngine``
    Cost/energy-aware tier selection (ADR-004): for one demand bucket it
    ranks the eligible clone-type tiers by a :func:`~repro_torch.core.policy.
    placement_key` over (provisioning latency, $-rate, chips-aware energy
    rate), and walks :meth:`ClonePool.escalate_type` to find the smallest
    tier whose KV block pool can hold a request — the serving-layer
    analogue of the paper's OutOfMemoryError -> bigger-VM flow (§5.4).

``FleetAutoscaler``
    Heterogeneous elasticity: demand arrives as *buckets* per (required
    tier, urgency) — the Client Handler derives them per tenant/priority
    class and per KV-footprint — each bucket is placed onto a tier by the
    ``PlacementEngine``, and per-type targets grow the RUNNING secondary
    set through :meth:`ClonePool.ensure_secondaries` under one global
    cap; shrink stays TTL-driven (:meth:`ClonePool.reap_idle`) — the
    paper's "secondary clones are kept in pause state" policy.

Provisioning latency is *not* hidden: newly activated clones carry a
``ready_at`` timestamp and the handler must not start work on them before
it (resume ~300 ms, boot ~32 s on the shared timeline).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.clones import (BOOT_SECONDS, CLONE_TYPES, ClonePool,
                               CloneState, chips_for, resume_time,
                               usd_per_second)
from repro_torch.core.energy import GpuEnergyModel
from repro_torch.core.policy import (PLACEMENT_HORIZON_S, Policy, Prediction,
                               placement_key)


@dataclasses.dataclass
class ServeRequest:
    """One client request to the serving fleet.

    ``priority`` orders preemption victim selection (lower = evicted
    first); it never reorders the FIFO admission queue.  The restore
    fields are written by the serving layer when a slot is *preempted*
    (KV blocks reclaimed mid-decode, ADR-003): ``generated`` carries the
    tokens already emitted so a restore resumes instead of restarting,
    ``first_token_t`` preserves the client-visible TTFT, and
    ``preemptions`` counts how often this request was evicted.

    The SLO fields are read by the gateway (ADR-007): ``slo`` classes
    the request ("interactive" vs "batch"), ``deadline_s`` is a relative
    end-to-end latency target fixed at arrival (None = best-effort),
    ``token_ts`` carries streamed delivery timestamps across preempt /
    restore so TPOT survives eviction, and ``retries`` counts
    Retry-After replays of a shed request.

    The lifecycle stamps split the time to first token on the serving
    timeline, and survive preemption and restore like ``token_ts``:
    ``slot_t`` is when a slot first took the request, ``prefill_t`` when
    the step carrying its prefill was dispatched, and ``stall_s`` sums the
    timeline seconds of the steps it decoded through that also carried
    other requests' prefill.
    """

    rid: int
    prompt: np.ndarray               # (prompt_len,) int32
    max_new_tokens: int = 16
    arrival_t: float = 0.0           # offered-load timestamp (virtual)
    priority: int = 0
    generated: List[int] = dataclasses.field(default_factory=list)
    first_token_t: Optional[float] = None
    preemptions: int = 0
    tenant: Optional[str] = None     # multi-tenant demand bucketing
    slo: str = "batch"               # SLO class: "interactive" | "batch"
    deadline_s: Optional[float] = None   # latency target (relative)
    token_ts: List[float] = dataclasses.field(default_factory=list)
    retries: int = 0                 # gateway Retry-After replays
    # speculative decoding (ADR-008): per-request draft acceptance-rate
    # EMA — carried on the request so preemption / migration / restore
    # keep the adaptive window K where the request left off
    spec_ema: float = 1.0
    slot_t: Optional[float] = None
    prefill_t: Optional[float] = None
    stall_s: float = 0.0


@dataclasses.dataclass
class ServeCompletion:
    """A finished request with its client-visible timeline stamps.

    ``token_ts`` holds per-token streamed delivery times (same length as
    ``tokens``), ``cached`` marks responses served from the gateway's
    response cache without touching the fleet.  ``slot_t``, ``prefill_t``
    and ``stall_s`` are the request's lifecycle stamps
    (:class:`ServeRequest`); a cached reply has none."""

    rid: int
    tokens: List[int]
    arrival_t: float
    first_token_t: float
    done_t: float
    venue: str
    tenant: Optional[str] = None
    slo: str = "batch"
    deadline_s: Optional[float] = None
    token_ts: List[float] = dataclasses.field(default_factory=list)
    cached: bool = False
    slot_t: Optional[float] = None
    prefill_t: Optional[float] = None
    stall_s: float = 0.0

    @property
    def latency_s(self) -> float:
        """End-to-end request latency: arrival to last token."""
        return self.done_t - self.arrival_t

    @property
    def ttft_s(self) -> float:
        """Time to first token: arrival to the first emitted token."""
        return self.first_token_t - self.arrival_t

    @property
    def tpot_s(self) -> float:
        """Mean time per output token after the first, from streamed
        delivery stamps (0.0 for single-token or unstamped replies)."""
        n = len(self.tokens)
        if n > 1 and len(self.token_ts) == n:
            return (self.token_ts[-1] - self.token_ts[0]) / (n - 1)
        if n > 1:
            return (self.done_t - self.first_token_t) / (n - 1)
        return 0.0

    @property
    def met_deadline(self) -> bool:
        """True when the request had no deadline or finished inside it."""
        return (self.deadline_s is None
                or self.latency_s <= self.deadline_s + 1e-9)


class AdmissionQueue:
    """Bounded request queue; beyond ``max_depth`` arrivals are shed."""

    def __init__(self, max_depth: int = 64):
        self.max_depth = max_depth
        self._q: Deque[ServeRequest] = deque()
        self.accepted = 0
        self.rejected = 0

    def offer(self, req: ServeRequest, now: float) -> bool:
        """Admit ``req`` or shed it; returns True when admitted."""
        if len(self._q) >= self.max_depth:
            self.rejected += 1
            return False
        self._q.append(req)
        self.accepted += 1
        return True

    def take(self, n: int) -> List[ServeRequest]:
        """Pop up to ``n`` requests in FIFO order."""
        out = []
        while self._q and len(out) < n:
            out.append(self._q.popleft())
        return out

    def requeue(self, req: ServeRequest) -> None:
        """Return a *preempted* request to the head of the queue.

        The request was already admitted once (it counted toward
        ``accepted``), so it bypasses
        the depth bound — preemption must never turn into load shedding —
        and goes to the *front*: evicted work restores before any fresh
        arrival is admitted.  Among several evictions in one exhaustion
        round this is LIFO (the most recent eviction restores first);
        starvation is bounded because every restored request's remaining
        budget only shrinks."""
        self._q.appendleft(req)

    def peek(self) -> Optional[ServeRequest]:
        """The request ``take`` would pop next, without popping it."""
        return self._q[0] if self._q else None

    def snapshot(self) -> List[ServeRequest]:
        """The queued requests in FIFO order (read-only view for demand
        bucketing and placement — never mutate the returned requests'
        queue membership directly)."""
        return list(self._q)

    def take_where(self, pred: Callable[["ServeRequest"], bool]
                   ) -> Optional[ServeRequest]:
        """Pop the *first* queued request satisfying ``pred`` (FIFO scan).

        The heterogeneous spawn path uses this so a head request whose
        required tier is still provisioning (e.g. a long-context request
        waiting for a ``large`` boot) does not head-of-line-block the
        short-prompt bulk behind it."""
        for i, r in enumerate(self._q):
            if pred(r):
                del self._q[i]
                return r
        return None

    @property
    def depth(self) -> int:
        """Requests currently queued (admitted, not yet taken)."""
        return len(self._q)


def poisson_arrivals(rate: float, n: int, *, seed: int = 0,
                     prompt_len: int = 8, vocab: int = 256,
                     max_new_tokens: int = 8, start: float = 0.0,
                     prefix_len: int = 0,
                     prefix_share: float = 1.0) -> List[ServeRequest]:
    """Open-loop Poisson arrival trace (seeded, deterministic).

    ``prefix_len > 0`` models a shared system prompt: a fraction
    ``prefix_share`` of requests start with one common ``prefix_len``-token
    prefix (drawn once per seed) followed by a random tail, the rest stay
    fully random — the workload shape the block-level prefix cache exists
    for (thousands of users, one system prompt).  The trace is identical
    for a given seed whatever serving configuration consumes it."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, size=prefix_len, dtype=np.int32)
    t = start
    out = []
    for i in range(n):
        t += float(rng.exponential(1.0 / max(rate, 1e-9)))
        prompt = rng.integers(0, vocab, size=prompt_len, dtype=np.int32)
        if prefix_len > 0 and rng.random() < prefix_share:
            prompt[:prefix_len] = prefix
        out.append(ServeRequest(i, prompt, max_new_tokens, arrival_t=t))
    return out


class SlotLedger:
    """Open decode slots across in-flight engines (paged serving).

    The admission policy the paged Client Handler consults *before* it
    spawns new engines: queued requests are offered to partially-full
    in-flight engines first (a mid-flight cohort join — ThinkAir's
    dynamic-provisioning claim at the request level), and only residual
    demand counts toward autoscaling.  Keys are opaque engine handles; the
    ledger holds only free-slot counts, never requests.
    """

    def __init__(self):
        self._free: Dict[object, int] = {}

    def update(self, key, free_slots: int) -> None:
        """Record that engine ``key`` has ``free_slots`` open slots."""
        if free_slots > 0:
            self._free[key] = free_slots
        else:
            self._free.pop(key, None)

    def drop(self, key) -> None:
        """Forget a retired engine."""
        self._free.pop(key, None)

    @staticmethod
    def pick_victim(candidates) -> Optional[int]:
        """Priority-ordered preemption policy (ADR-003).

        ``candidates``: iterable of ``(slot, priority, generated_tokens)``
        for the engine's active slots when its KV pool exhausts mid-decode.
        The victim is the slot with the *lowest priority*; among equals,
        the one with the *fewest generated tokens* (cheapest to restore —
        its re-prefill suffix is shortest and its prompt blocks are most
        likely still resident in the prefix cache); remaining ties break
        by highest slot id, so the choice is deterministic.  Returns the
        victim slot, or None when there is no candidate."""
        best = min(candidates, key=lambda c: (c[1], c[2], -c[0]),
                   default=None)
        return None if best is None else best[0]

    @property
    def total_free(self) -> int:
        return sum(self._free.values())

    def assign(self, queue: "AdmissionQueue",
               fits: Optional[Callable] = None,
               on_assign: Optional[Callable] = None,
               prefer: Optional[Callable] = None) -> List[tuple]:
        """Drain the queue into open slots; returns [(key, request)].

        Tightest-fit first: the engine with the fewest open slots is
        filled before emptier ones, so nearly-drained engines refill (and
        surplus clones go idle for the TTL reaper) instead of every engine
        hovering half-full.  Deterministic: ties break by insertion order.

        ``fits(key, request) -> bool`` (optional) is re-checked per
        assignment so engines can veto on resources beyond slot count —
        e.g. KV block commitments; a vetoing engine leaves this round.
        ``on_assign(key, request)`` (optional) runs *immediately* after
        each pop, before the next ``fits`` check — admission must happen
        here so resource checks see the commitments of earlier
        assignments in the same round, not stale pre-round state.
        ``prefer(key, request) -> float`` (optional) biases the engine
        choice for the head request: the highest-scoring engine wins and
        ties fall back to tightest-fit — prefix-affinity routing passes
        the clone's ``match_prefix`` depth here so same-prefix requests
        land where their blocks already live (ADR-009).
        """
        out = []
        while queue.depth > 0 and self._free:
            head = queue.peek()
            if prefer is None:
                key = min(self._free,
                          key=self._free.get)  # type: ignore[arg-type]
            else:
                key = min(self._free,
                          key=lambda k: (-prefer(k, head), self._free[k]))
            if fits is not None and not fits(key, head):
                del self._free[key]        # can't take the head request
                continue
            req = queue.take(1)[0]
            out.append((key, req))
            if on_assign is not None:
                on_assign(key, req)
            self._free[key] -= 1
            if self._free[key] <= 0:
                del self._free[key]
        return out




class PlacementEngine:
    """Cost/energy-aware clone-type selection for one demand bucket.

    Two decisions live here (ADR-004):

    ``required_type`` — the KV floor: walk the paper's escalation ladder
    (:meth:`ClonePool.escalate_type`, the §5.4 OutOfMemoryError flow) from
    the base tier until a tier's block pool can hold the request's
    prompt+window KV demand; a request that outgrows every tier degrades
    gracefully to the biggest fleet tier (preemption absorbs the squeeze)
    instead of raising.

    ``choose_type`` — among the tiers at or above the floor, rank by the
    policy's :func:`~repro_torch.core.policy.placement_key` over a
    :class:`~repro_torch.core.policy.Prediction` of (provisioning latency,
    chips-aware energy over the horizon, $ over the horizon); ties break
    to the smallest tier.  Urgent buckets (high-priority tenants) always
    rank by ``EXEC_TIME`` — a warm big clone beats booting a cheap one.
    """

    def __init__(self, pool: ClonePool, fleet: Optional[Sequence[str]] = None,
                 policy: Policy = Policy.EXEC_TIME_AND_ENERGY,
                 energy: Optional[GpuEnergyModel] = None):
        self.pool = pool
        self.policy = policy
        self.energy = energy or GpuEnergyModel()
        names = list(fleet) if fleet is not None else list(CLONE_TYPES)
        unknown = [n for n in names if n not in CLONE_TYPES]
        if unknown:
            raise ValueError(f"unknown clone types in fleet: {unknown}")
        self.fleet = sorted(set(names), key=lambda n: CLONE_TYPES[n].rank())
        # type -> demand buckets actually placed on it (recorded by the
        # FleetAutoscaler, not by speculative choose_type evaluations)
        self.decisions: Dict[str, int] = {}
        # cid -> usable-from time, shared by the FleetAutoscaler so a
        # clone resumed *this tick* is not mistaken for a warm one
        self.ready_at: Dict[int, float] = {}

    def chips(self, type_name: str) -> int:
        return chips_for(type_name, self.pool.gpu)

    def provision_pred(self, type_name: str) -> Prediction:
        """Marginal cost of putting one more work unit on this tier now.

        Time is the tier's provisioning latency given the pool's current
        inventory: an idle RUNNING secondary is available at its
        ``ready_at`` residue (0 when warm — a clone resumed this tick
        still carries its resume), a PAUSED one costs a resume, otherwise
        a cold boot.  Energy and $ are the tier's burn rates over the
        placement horizon (chips-aware)."""
        now = self.pool.clock()
        # open-breaker / dead clones are not capacity (ADR-006): placing
        # a bucket on them would dispatch into a tripped circuit
        idle = [max(0.0, self.ready_at.get(c.cid, 0.0) - now)
                for c in self.pool.running_secondaries(type_name)
                if not c.busy and c.serveable]
        paused = any(c.state is CloneState.PAUSED
                     and c.ctype.name == type_name and not c.is_primary
                     and c.serveable
                     for c in self.pool.clones)
        t = (min(idle) if idle
             else resume_time(1) if paused else BOOT_SECONDS)
        e = self.energy.busy_j(chips=self.chips(type_name),
                               seconds=PLACEMENT_HORIZON_S)
        usd = usd_per_second(type_name) * PLACEMENT_HORIZON_S
        return Prediction(time_s=t, energy_j=e, cost_usd=usd)

    def eligible(self, required_type: str) -> List[str]:
        """Fleet tiers at or above the required tier's rank."""
        rmin = CLONE_TYPES[required_type].rank()
        return [t for t in self.fleet if CLONE_TYPES[t].rank() >= rmin]

    def choose_type(self, required_type: str, *,
                    urgent: bool = False,
                    hint: Optional[str] = None,
                    affinity: Optional[Dict[str, int]] = None
                    ) -> Optional[str]:
        """The tier this bucket's capacity should be provisioned on.

        ``hint="spec_draft"`` picks the *cheapest adequate* tier by $-rate
        regardless of the fleet policy: a speculative-decoding draft clone
        (ADR-008) exists precisely to burn the cheap tier's cycles, so
        latency/energy scoring — which would happily pin the draft next to
        the verifier on premium — is overridden.

        ``hint="prefix_affinity"`` ranks by cached-prefix depth first
        (``affinity``: type -> deepest ``match_prefix`` token depth among
        that tier's live clones, supplied by the serving layer):
        re-prefilling tokens the fleet already holds is pure waste, so
        the deepest match wins, with the normal PLACEMENT_HORIZON policy
        key (provisioning latency / energy / $) breaking ties — which is
        also the full ranking for the zero-depth tiers.  A tier's depth
        only counts while it still has a *serveable* RUNNING clone: the
        cached blocks live on a specific clone, and if its breaker
        tripped (ADR-006) a fresh boot would come up with a cold pool, so
        the hint degrades to the plain policy ranking instead of chasing
        dead blocks.
        """
        cands = self.eligible(required_type)
        if not cands:
            return None
        if hint == "spec_draft":
            return min(cands, key=lambda t: (usd_per_second(t),
                                             CLONE_TYPES[t].rank()))
        policy = Policy.EXEC_TIME if urgent else self.policy
        if hint == "prefix_affinity" and affinity:
            def live_depth(t: str) -> int:
                alive = any(c.ctype.name == t and c.serveable
                            and c.state is CloneState.RUNNING
                            for c in self.pool.clones)
                return affinity.get(t, 0) if alive else 0
            return min(cands,
                       key=lambda t: (-live_depth(t),
                                      placement_key(policy,
                                                    self.provision_pred(t)),
                                      CLONE_TYPES[t].rank()))
        return min(cands,
                   key=lambda t: (placement_key(policy,
                                                self.provision_pred(t)),
                                  CLONE_TYPES[t].rank()))

    def required_type(self, base_type: str, blocks_needed: int,
                      real_blocks_of: Callable[[str], int]) -> str:
        """Smallest fleet tier (walking ``escalate_type`` from the base)
        whose block pool holds ``blocks_needed``; the biggest fleet tier
        when even the top of the ladder cannot (``escalate_type`` returns
        None — the caller degrades gracefully, ADR-004)."""
        fleet = set(self.fleet)
        t: Optional[str] = base_type
        last_fleet = base_type
        while t is not None:
            if t in fleet:
                last_fleet = t
                if real_blocks_of(t) >= blocks_needed:
                    return t
            t = self.pool.escalate_type(t)
        return last_fleet


class FleetAutoscaler:
    """Placement-driven elastic sizing of a heterogeneous secondary fleet.

    Demand arrives as buckets ``(required_type, urgent, work_units)`` —
    the Client Handler derives them per tenant/priority class and per
    KV-footprint tier.  Each bucket is placed on a tier by the
    :class:`PlacementEngine` (urgent buckets place first, then cheaper
    tiers), per-type targets are ``ceil(units / work_per_clone)`` under
    one global ``max_secondaries`` budget, and growth provisions through
    the pool (resume preferred over boot — costs land on the shared
    timeline via ``ready_at``).  Shrink is delegated to the pool's idle
    TTLs via ``reap_idle``: pause after ``PAUSE_IDLE_TTL``, power-off
    after ``OFF_IDLE_TTL``.
    """

    def __init__(self, pool: ClonePool, placement: PlacementEngine,
                 base_type: str = "main", work_per_clone: int = 1,
                 min_secondaries: int = 0, max_secondaries: int = 8):
        self.pool = pool
        self.placement = placement
        self.base_type = base_type
        self.work_per_clone = max(1, work_per_clone)
        self.min_secondaries = min_secondaries
        self.max_secondaries = max_secondaries
        # cid -> usable-from time; the dict is *shared* with the placement
        # engine so tier availability accounts for in-flight provisioning
        self.ready_at: Dict[int, float] = placement.ready_at
        self.peak_secondaries = 0
        self.scale_ups = 0
        self.samples: List[tuple] = []           # (t, running_secondaries)
        self.targets: Dict[str, int] = {}        # last tick's per-type target

    def clone_ready_delay(self, clone, now: float) -> float:
        """Seconds until ``clone`` is actually usable (0 if warm)."""
        return max(0.0, self.ready_at.get(clone.cid, 0.0) - now)

    def step(self, now: float, buckets: Sequence[tuple],
             in_flight: Optional[Dict[str, int]] = None) -> Dict[str, int]:
        """One control-loop tick; returns the per-type target sizes.

        ``buckets``: iterable of ``(required_type, urgent, work_units)``
        for the queued demand.  ``in_flight``: work units currently being
        served, per clone type — they hold their tier's capacity."""
        demand: Dict[str, int] = {}
        order: List[str] = []                    # budget-allocation order
        for rtype, urgent, units in sorted(
                buckets, key=lambda b: (not b[1], CLONE_TYPES[b[0]].rank())):
            t = self.placement.choose_type(rtype, urgent=urgent) or rtype
            self.placement.decisions[t] = \
                self.placement.decisions.get(t, 0) + 1
            demand[t] = demand.get(t, 0) + units
            if t not in order:
                order.append(t)
        for t, n in (in_flight or {}).items():
            demand[t] = demand.get(t, 0) + n
            if t not in order:
                order.append(t)
        if self.base_type not in order:
            order.append(self.base_type)
            demand.setdefault(self.base_type, 0)
        budget = self.max_secondaries
        self.targets = {}
        if self.min_secondaries > 0:     # warm base floor reserved FIRST,
            grant = min(self.min_secondaries, budget)   # never starved by
            self.targets[self.base_type] = grant        # other tiers
            budget -= grant
        for t in order:
            want = -(-demand[t] // self.work_per_clone)
            have = self.targets.get(t, 0)
            grant = max(0, min(want - have, budget))
            self.targets[t] = have + grant
            budget -= grant
        for t, target in self.targets.items():
            if target > len(self.pool.running_secondaries(t)):
                fresh, costs = self.pool.ensure_secondaries(t, target)
                for c, cost in zip(fresh, costs):
                    self.ready_at[c.cid] = now + cost
                if fresh:
                    self.scale_ups += 1
        total = len(self.pool.running_secondaries())
        if total > self.max_secondaries:
            # over cap (demand shifted tiers): pause idle surplus *per
            # type, over-target tiers first* — an untyped sweep would
            # pause the just-provisioned target tier and keep the stale
            # one, livelocking the shift until the idle TTL reaped it
            running_types = sorted(
                {c.ctype.name for c in self.pool.running_secondaries()},
                key=lambda t: (self.targets.get(t, 0),
                               CLONE_TYPES[t].rank()))
            for t in running_types:
                if total <= self.max_secondaries:
                    break
                total -= self.pool.pause_surplus(self.targets.get(t, 0), t)
        # shrink: TTL-driven (paper: idle secondaries are paused, then off)
        self.pool.reap_idle()
        running = len(self.pool.running_secondaries())
        self.peak_secondaries = max(self.peak_secondaries, running)
        self.samples.append((now, running))
        return dict(self.targets)
