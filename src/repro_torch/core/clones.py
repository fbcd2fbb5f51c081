"""Clone pool: the paper's VM manager (§5.3), adapted to GPU sub-meshes.

Paper Table 1 (6 VM types) -> ``CLONE_TYPES``.  Paper VM states
powered-off / paused / running -> our cold / paused / running, with the
accelerator cost structure: "boot" is loading weights and building the
kernels (paper: ~32 s), "resume" is reloading cached kernels + weights
(paper: ~300 ms), "running" is a warm process.  The paper's observed
resume contention (7 simultaneous resumes -> 6-7 s) is modeled with a linear
contention factor, calibrated against their numbers.

The pool supports an injected clock so that scheduling behavior is
deterministic under test; with the default clock it tracks real time.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Callable, Dict, List, Optional

from repro_torch.core.clock import ensure_clock
from repro_torch.core.venues import (LINKS, VenueSpec, make_cloud_vm,
                                     make_gpu_venue)


class CloneState(enum.Enum):
    POWERED_OFF = "powered_off"
    PAUSED = "paused"
    RUNNING = "running"


@dataclasses.dataclass(frozen=True)
class CloneType:
    name: str
    cpus: int
    mem_mb: int
    heap_mb: int

    def rank(self) -> int:
        return self.cpus * self.mem_mb


# Paper Table 1, verbatim.
CLONE_TYPES: Dict[str, CloneType] = {
    "basic": CloneType("basic", 1, 200, 32),
    "main": CloneType("main", 1, 512, 100),
    "large": CloneType("large", 1, 1024, 100),
    "x2large": CloneType("x2large", 2, 1024, 100),
    "x4large": CloneType("x4large", 4, 1024, 100),
    "x8large": CloneType("x8large", 8, 1024, 100),
}

# Fleet adaptation: GPU sub-mesh clone types (cards per clone).  The chip
# counts of the reference's accelerator ladder are kept as they are.
GPU_CLONE_TYPES: Dict[str, int] = {
    "gpu-1": 1, "gpu-4": 4, "gpu-16": 16, "gpu-64": 64,
    "gpu-pod": 256, "gpu-2pod": 512,
}

# Explicit CloneType -> GPU sub-mesh mapping for gpu=True pools: the
# escalation path (basic -> ... -> x8large) covers the whole card ladder.
GPU_BY_CLONE_TYPE: Dict[str, str] = {
    "basic": "gpu-1",
    "main": "gpu-4",
    "large": "gpu-16",
    "x2large": "gpu-64",
    "x4large": "gpu-pod",
    "x8large": "gpu-2pod",
}

# Fleet adaptation: on-demand $ price per clone type (per hour, EC2-2011-era
# ladder — the paper ran on Amazon EC2).  The placement engine (ADR-004)
# trades these rates against provisioning latency and energy.
USD_PER_HOUR: Dict[str, float] = {
    "basic": 0.02,
    "main": 0.085,
    "large": 0.17,
    "x2large": 0.34,
    "x4large": 0.68,
    "x8large": 1.36,
}


def usd_per_second(type_name: str) -> float:
    """On-demand $ per clone-second for a clone type."""
    return USD_PER_HOUR[type_name] / 3600.0


def chips_for(type_name: str, gpu: bool = False) -> int:
    """Per-type chip count: GPU sub-mesh cards for gpu pools, CPU count
    for the paper's cloud-VM pools — the quantity the chips-aware energy
    model bills (``GpuEnergyModel.energy_j(chips=...)``)."""
    if gpu:
        return GPU_CLONE_TYPES[GPU_BY_CLONE_TYPE[type_name]]
    return CLONE_TYPES[type_name].cpus


# Serving-layer KV capacity multiplier per clone type (ADR-004).  The
# escalation ladder must strictly widen the KV block pool at every step,
# which the paper's RAM column cannot express (flat at 1024 MB above
# ``large``); the GPU sub-mesh ladder (cards -> HBM) is the fleet's
# memory ladder, so it scales the per-type block budget for VM pools too.
KV_SCALE_BY_CLONE_TYPE: Dict[str, int] = {
    t: GPU_CLONE_TYPES[GPU_BY_CLONE_TYPE[t]] for t in CLONE_TYPES
}

# Transition-cost model, calibrated to the paper's §5.3 measurements.
RESUME_SECONDS = 0.300            # paused -> running
BOOT_SECONDS = 32.0               # powered_off -> running (VM boot / kernel build)
CONTENTION_FACTOR = 3.3           # k simultaneous resumes: t = R*(1+f*(k-1))
PAUSE_IDLE_TTL = 30.0             # auto-pause after idle (s)
OFF_IDLE_TTL = 600.0              # auto-power-off after paused (s)

# Circuit-breaker defaults (ADR-006): consecutive dispatch failures on a
# clone trip its breaker open; after a cooldown a single half-open probe
# decides between closing it and re-opening with doubled cooldown.
CB_FAIL_THRESHOLD = 3             # consecutive failures -> open
CB_OPEN_SECONDS = 1.0             # first open -> half-open cooldown (s)
CB_MAX_OPEN_SECONDS = 30.0        # backoff cap for repeated re-opens (s)
CB_MAX_PROBES = 8                 # probe-chain length per clock binding


def resume_time(k_simultaneous: int) -> float:
    """Paper: 1 resume ~300 ms, 7 simultaneous -> 6-7 s (super-linear)."""
    k = max(1, k_simultaneous)
    return RESUME_SECONDS * (1.0 + CONTENTION_FACTOR * (k - 1))


class CloneHealth(enum.Enum):
    HEALTHY = "healthy"     # serving normally
    SUSPECT = "suspect"     # recovered from a fault, awaiting a probe
    DEAD = "dead"           # failed; only a successful probe revives it


class CircuitBreaker:
    """Per-clone circuit breaker (ADR-006): closed → open on the fail
    threshold (or a hard :meth:`trip`), half-open after a cooldown, and
    back to closed only when a probe succeeds.  ``bind`` attaches a
    VirtualClock and a probe callable, after which every open schedules
    its own half-open probe event with capped exponential backoff;
    without a clock the classic :meth:`allow` gate drives the
    transitions instead."""

    def __init__(self, fail_threshold: int = CB_FAIL_THRESHOLD,
                 open_seconds: float = CB_OPEN_SECONDS,
                 max_open_seconds: float = CB_MAX_OPEN_SECONDS,
                 max_probes: int = CB_MAX_PROBES):
        self.fail_threshold = fail_threshold
        self.open_seconds = open_seconds
        self.max_open_seconds = max_open_seconds
        self.max_probes = max_probes
        self.state = "closed"            # closed | open | half_open
        self.failures = 0                # consecutive, reset on success
        self.opened_at = 0.0
        self.opens = 0                   # lifetime open transitions
        self.probes = 0                  # lifetime half-open probes
        self._cooldown = open_seconds
        self._clock = None
        self._probe_fn: Optional[Callable[[], bool]] = None
        self._probe_ev = None

    def bind(self, clock, probe_fn: Callable[[], bool]) -> None:
        """Attach a clock + probe; resets the probe-chain budget."""
        self._clock = clock
        self._probe_fn = probe_fn
        self.probes = 0

    def record_failure(self, now: float) -> None:
        self.failures += 1
        if self.state == "half_open" or self.failures >= self.fail_threshold:
            self.trip(now)

    def trip(self, now: float) -> None:
        """Force-open (a clone death is definitive, no threshold)."""
        reopening = self.state != "closed"
        self.state = "open"
        self.opened_at = now
        self.opens += 1
        if reopening:      # half-open probe failed: back off the cooldown
            self._cooldown = min(self._cooldown * 2, self.max_open_seconds)
        if self._clock is not None and self.probes < self.max_probes:
            self._probe_ev = self._clock.schedule(self._cooldown,
                                                  self._probe)
    def record_success(self) -> None:
        self.state = "closed"
        self.failures = 0
        self._cooldown = self.open_seconds
        if self._probe_ev is not None:
            self._probe_ev.cancel()
            self._probe_ev = None

    def allow(self, now: float) -> bool:
        """Dispatch gate for clock-less use: closed always allows; open
        allows one trial once the cooldown has elapsed (transitioning to
        half-open); half-open allows nothing until the trial reports."""
        if self.state == "closed":
            return True
        if self.state == "open" and now >= self.opened_at + self._cooldown:
            self.state = "half_open"
            return True
        return False

    def _probe(self) -> None:
        """Scheduled half-open probe: success closes, failure re-opens
        with doubled cooldown (next probe auto-scheduled, chain capped)."""
        if self.state != "open" or self._probe_fn is None:
            return
        self.state = "half_open"
        self.probes += 1
        if self._probe_fn():
            self.record_success()
        else:
            self.trip(self._clock.now())


@dataclasses.dataclass
class Clone:
    cid: int
    ctype: CloneType
    spec: VenueSpec
    state: CloneState = CloneState.POWERED_OFF
    is_primary: bool = False
    last_used: float = 0.0
    busy: bool = False
    executable_cache: dict = dataclasses.field(default_factory=dict)
    # $-accounting (ADR-004): clone-seconds accrue while RUNNING — an idle
    # running clone still bills, which is what makes TTL pausing worth $
    running_since: Optional[float] = None
    running_seconds: float = 0.0
    # fault tolerance (ADR-006): health gates placement, the breaker
    # gates re-use after failures, slowdown scales dispatched venue time
    health: CloneHealth = CloneHealth.HEALTHY
    breaker: CircuitBreaker = dataclasses.field(
        default_factory=CircuitBreaker)
    slowdown: float = 1.0

    @property
    def warm(self) -> bool:
        return bool(self.executable_cache)

    @property
    def serveable(self) -> bool:
        """Placement-eligible: healthy with a closed breaker.  Callers
        still check RUNNING/busy — this is the fault gate only."""
        return (self.health is CloneHealth.HEALTHY
                and self.breaker.state == "closed")


class ClonePool:
    """On-demand allocation of clones (paper §5.3), primary + secondaries."""

    def __init__(self, link_name: str = "wifi-local",
                 clock: Optional[Callable[[], float]] = None,
                 max_clones: int = 64, gpu: bool = False,
                 breaker_kwargs: Optional[Dict[str, float]] = None):
        # one injected timeline: a clock object, a bare callable (tests), or
        # None for a fresh deterministic VirtualClock
        self.clock = ensure_clock(clock)
        self.link = LINKS[link_name]
        self.max_clones = max_clones
        self.gpu = gpu
        # non-default CircuitBreaker ctor args (e.g. max_open_seconds,
        # max_probes) applied to every clone this pool creates — must be
        # set before the primary below
        self.breaker_kwargs = dict(breaker_kwargs or {})
        self._ids = itertools.count()
        self.clones: List[Clone] = []
        self.stats = {"resumes": 0, "boots": 0, "pauses": 0, "offs": 0,
                      "resume_seconds": 0.0, "boot_seconds": 0.0}
        # the primary server is always online (paper: "main server")
        self.primary = self._new_clone("main", primary=True)
        self.primary.state = CloneState.RUNNING
        self.primary.running_since = self.clock()

    # ---------------------------------------------------------------- utils
    def _make_spec(self, ctype: CloneType) -> VenueSpec:
        if self.gpu:
            gpu_name = GPU_BY_CLONE_TYPE[ctype.name]
            chips = GPU_CLONE_TYPES[gpu_name]
            return make_gpu_venue(gpu_name, chips, self.link)
        return make_cloud_vm(ctype.name, ctype.cpus, ctype.mem_mb,
                             ctype.heap_mb, self.link)

    def _new_clone(self, type_name: str, primary: bool = False) -> Clone:
        ctype = CLONE_TYPES[type_name]
        clone = Clone(next(self._ids), ctype, self._make_spec(ctype),
                      is_primary=primary, last_used=self.clock())
        if self.breaker_kwargs:
            clone.breaker = CircuitBreaker(**self.breaker_kwargs)
        self.clones.append(clone)
        return clone

    def running(self) -> List[Clone]:
        return [c for c in self.clones if c.state is CloneState.RUNNING]

    # ------------------------------------------------------- $-accounting
    def _mark_running(self, clone: Clone, now: float) -> None:
        """Open a billing interval (idempotent for already-running clones)."""
        if clone.running_since is None:
            clone.running_since = now

    def _mark_stopped(self, clone: Clone, now: float) -> None:
        """Close the billing interval on pause / power-off."""
        if clone.running_since is not None:
            clone.running_seconds += now - clone.running_since
            clone.running_since = None

    def clone_seconds_by_type(self, now: Optional[float] = None
                              ) -> Dict[str, float]:
        """RUNNING clone-seconds accrued so far, per clone type (live
        intervals included up to ``now``) — the quantity the $-cost model
        bills (primary included: the always-on main server is a standing
        cost the fleet pays whether or not it serves)."""
        now = self.clock() if now is None else now
        out: Dict[str, float] = {}
        for c in self.clones:
            s = c.running_seconds
            if c.running_since is not None:
                s += now - c.running_since
            if s > 0.0:
                out[c.ctype.name] = out.get(c.ctype.name, 0.0) + s
        return out

    def cost_usd(self, now: Optional[float] = None) -> float:
        """Total on-demand $ cost of the fleet's running time so far."""
        return sum(usd_per_second(t) * s
                   for t, s in self.clone_seconds_by_type(now).items())

    def provision(self, type_name: str, n: int,
                  state: CloneState = CloneState.PAUSED) -> List[Clone]:
        """Pre-create secondaries (paper: 'secondary clones are kept in
        pause state to minimize the resources allocated')."""
        out = []
        now = self.clock()
        for _ in range(n):
            c = self._new_clone(type_name)
            c.state = state
            if state is CloneState.RUNNING:
                self._mark_running(c, now)
            out.append(c)
        return out

    # ------------------------------------------------------------- lifecycle
    def acquire(self, type_name: str = "main", n: int = 1,
                exclude_primary: bool = False) -> tuple:
        """Resume/boot n clones of the given type.

        Returns (clones, provisioning_seconds) — the latency cost charged to
        the request (paper: resume time is part of the execution overhead).
        """
        want = CLONE_TYPES[type_name]
        ready, to_resume, to_boot = [], [], []
        for c in self.clones:
            if len(ready) + len(to_resume) + len(to_boot) >= n:
                break
            if c.busy or (exclude_primary and c.is_primary):
                continue
            if c.ctype.name != type_name or not c.serveable:
                continue
            if c.state is CloneState.RUNNING:
                ready.append(c)
            elif c.state is CloneState.PAUSED:
                to_resume.append(c)
            else:
                to_boot.append(c)
        while len(ready) + len(to_resume) + len(to_boot) < n:
            if len(self.clones) >= self.max_clones:
                raise RuntimeError("clone pool exhausted")
            to_boot.append(self._new_clone(type_name))

        cost = 0.0
        if to_resume:
            dt = resume_time(len(to_resume))
            cost = max(cost, dt)
            self.stats["resumes"] += len(to_resume)
            self.stats["resume_seconds"] += dt
        if to_boot:
            cost = max(cost, BOOT_SECONDS)
            self.stats["boots"] += len(to_boot)
            self.stats["boot_seconds"] += BOOT_SECONDS * len(to_boot)
        now = self.clock()
        out = ready + to_resume + to_boot
        for c in out:
            c.state = CloneState.RUNNING
            self._mark_running(c, now)
            c.busy = True
            c.last_used = now
        return out, cost

    def release(self, clones) -> None:
        now = self.clock()
        for c in clones:
            c.busy = False
            c.last_used = now

    def pause(self, clone: Clone) -> None:
        if clone.is_primary or clone.state is not CloneState.RUNNING:
            return
        self._mark_stopped(clone, self.clock())
        clone.state = CloneState.PAUSED
        self.stats["pauses"] += 1

    def power_off(self, clone: Clone) -> None:
        if clone.is_primary:
            return
        self._mark_stopped(clone, self.clock())
        clone.state = CloneState.POWERED_OFF
        clone.executable_cache.clear()
        self.stats["offs"] += 1

    def reap_idle(self) -> None:
        """Paper: the Client Handler pauses/offs idle secondaries."""
        now = self.clock()
        for c in self.clones:
            if c.is_primary or c.busy:
                continue
            idle = now - c.last_used
            if c.state is CloneState.RUNNING and idle > PAUSE_IDLE_TTL:
                self.pause(c)
            elif c.state is CloneState.PAUSED and idle > OFF_IDLE_TTL:
                self.power_off(c)

    # ------------------------------------------------------------ elasticity
    def running_secondaries(self, type_name: Optional[str] = None
                            ) -> List[Clone]:
        return [c for c in self.clones
                if not c.is_primary and c.state is CloneState.RUNNING
                and (type_name is None or c.ctype.name == type_name)]

    def ensure_secondaries(self, type_name: str, n: int
                           ) -> tuple:
        """Scale up: resume/boot until >= n secondaries of this type RUN.

        Unlike :meth:`acquire` the clones are left *idle* (not busy) — this
        is the Client Handler's capacity knob, not a per-request grab.
        Returns (newly_activated_clones, per_clone_ready_seconds): a resumed
        clone is usable after the (contended) resume time, a booted one only
        after the full boot — they must not share one aggregate delay.
        """
        have = len(self.running_secondaries(type_name))
        if have >= n:
            return [], []
        need = n - have
        # dead / suspect clones are not capacity: a failed secondary sits
        # powered off until its breaker's probe revives it (ADR-006)
        to_resume = [c for c in self.clones
                     if not c.is_primary and c.ctype.name == type_name
                     and c.serveable
                     and c.state is CloneState.PAUSED][:need]
        n_boot = need - len(to_resume)
        to_boot = [c for c in self.clones
                   if not c.is_primary and c.ctype.name == type_name
                   and c.serveable
                   and c.state is CloneState.POWERED_OFF][:n_boot]
        while len(to_resume) + len(to_boot) < need:
            if len(self.clones) >= self.max_clones:
                break
            to_boot.append(self._new_clone(type_name))
        costs = []
        if to_resume:
            dt = resume_time(len(to_resume))
            costs += [dt] * len(to_resume)
            self.stats["resumes"] += len(to_resume)
            self.stats["resume_seconds"] += dt
        if to_boot:
            costs += [BOOT_SECONDS] * len(to_boot)
            self.stats["boots"] += len(to_boot)
            self.stats["boot_seconds"] += BOOT_SECONDS * len(to_boot)
        now = self.clock()
        out = to_resume + to_boot
        for c in out:
            c.state = CloneState.RUNNING
            self._mark_running(c, now)
            c.last_used = now
        return out, costs

    def pause_surplus(self, keep: int, type_name: Optional[str] = None
                      ) -> int:
        """Scale down: pause idle running secondaries beyond ``keep``."""
        idle = [c for c in self.running_secondaries(type_name)
                if not c.busy]
        paused = 0
        for c in idle[max(0, keep):]:
            self.pause(c)
            paused += 1
        return paused

    # ------------------------------------------------------------ escalation
    def escalate_type(self, type_name: str) -> Optional[str]:
        """Next more powerful clone type (paper: OutOfMemoryError handling)."""
        order = sorted(CLONE_TYPES.values(), key=CloneType.rank)
        names = [t.name for t in order]
        i = names.index(type_name)
        return names[i + 1] if i + 1 < len(names) else None
