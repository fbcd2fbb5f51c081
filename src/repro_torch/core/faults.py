"""Fault injection + fallback semantics (paper §4.4).

"If the connection fails for any reason during remote execution, the
framework falls back to local execution, discarding any data collected by
the profiler [for that run].  At the same time, the Execution Controller
initiates asynchronous reconnection to the server."

Two layers live here (ADR-006):

- :class:`FaultPlan` / :class:`ReconnectManager`: the seed's per-execution
  fault check and reconnect backoff used by the ``ExecutionController``'s
  offload path.  The manager's backoff now also runs as events on a
  :class:`~repro_torch.core.clock.VirtualClock` (pass ``clock=``) so reconnect
  attempts land deterministically on the simulated timeline; the original
  synchronous and threaded modes are preserved for clock-less callers.
- :class:`CloneFault` / :class:`FaultInjector`: clock-driven per-clone
  failure and slowdown schedules for the serving stack.  A fired kill or
  drain marks the clone DEAD, trips its circuit breaker (which then
  probes itself back half-open → closed on the same clock), and parks the
  clone on ``injector.failed`` for the serving handler to recover its
  in-flight requests (KV migration or prefix-accelerated restore).
"""
from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Callable, List, Optional, Tuple

from repro_torch.core.clock import ensure_clock
from repro_torch.core.clones import Clone, CloneHealth, ClonePool, CloneState


class VenueFailure(RuntimeError):
    """Raised when a remote venue dies mid-execution."""


@dataclasses.dataclass
class FaultPlan:
    """Deterministic fault schedule for tests/benchmarks."""
    fail_next: int = 0                 # fail the next N remote executions
    fail_every: Optional[int] = None   # or every k-th execution
    _count: int = 0

    def check(self) -> bool:
        """True -> this remote execution should fail."""
        self._count += 1
        if self.fail_next > 0:
            self.fail_next -= 1
            return True
        if self.fail_every and self._count % self.fail_every == 0:
            return True
        return False


class ReconnectManager:
    """Asynchronous reconnect with capped exponential backoff.

    Three execution modes, chosen at construction:

    - ``clock=``: attempts are :class:`VirtualClock` events — the first
      fires ``base_delay`` after the failure, each retry doubles the
      delay up to ``max_delay``, at most ``max_attempts`` per failure
      burst.  Fully deterministic on the simulated timeline.
    - ``synchronous=True`` (default, no clock): the whole backoff loop
      runs inline with no sleeping — the seed's deterministic test mode.
    - ``synchronous=False`` (no clock): a daemon thread with real
      ``time.sleep`` between attempts (the paper's live mode).
    """

    def __init__(self, reconnect_fn: Optional[Callable[[], bool]] = None,
                 base_delay: float = 0.05, max_delay: float = 2.0,
                 max_attempts: int = 8, synchronous: bool = True,
                 clock=None):
        self.reconnect_fn = reconnect_fn or (lambda: True)
        self.base_delay = base_delay
        self.max_delay = max_delay
        self.max_attempts = max_attempts
        self.synchronous = synchronous
        self.clock = None if clock is None else ensure_clock(clock)
        if self.clock is not None and not getattr(self.clock, "virtual",
                                                  False):
            raise TypeError("ReconnectManager backoff events need a "
                            "VirtualClock; omit clock for wall-clock use")
        self.connected = True
        self.attempts = 0                 # lifetime attempt count
        self._burst = 0                   # attempts since last failure
        self._event = None                # pending clock event
        self._thread: Optional[threading.Thread] = None

    def notify_failure(self) -> None:
        self.connected = False
        if self.clock is not None:
            if self._event is None or self._event.fired \
                    or self._event.cancelled:
                self._burst = 0
                self._schedule(self.base_delay)
        elif self.synchronous:
            self._run()                      # deterministic under test
        elif self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()

    # ------------------------------------------------------- clock-mode
    def _schedule(self, delay: float) -> None:
        self._event = self.clock.schedule(
            delay, functools.partial(self._attempt, delay))

    def _attempt(self, delay: float) -> None:
        self.attempts += 1
        self._burst += 1
        if self.reconnect_fn():
            self.connected = True
            return
        if self._burst < self.max_attempts:
            self._schedule(min(delay * 2, self.max_delay))

    # -------------------------------------------------- wall-clock mode
    def _run(self) -> None:
        import time
        delay = self.base_delay
        for i in range(self.max_attempts):
            self.attempts += 1
            if self.reconnect_fn():
                self.connected = True
                return
            if not self.synchronous:
                time.sleep(delay)
            delay = min(delay * 2, self.max_delay)


FAULT_KINDS = ("kill", "drain", "slow")


@dataclasses.dataclass
class CloneFault:
    """One scheduled fault on the virtual timeline (ADR-006).

    ``kind="kill"``: abrupt fail-stop — the clone's memory (KV pool
    included) is lost; in-flight requests can only be restored by
    re-prefill.  ``kind="drain"``: graceful failure with notice (a
    preemption warning / NIC-level drop with the VM still up): the
    clone stops serving but its KV blocks stay salvageable, so the
    handler may migrate them to a survivor.  ``kind="slow"``: the clone
    degrades by ``factor`` for ``duration`` seconds — hedged dispatch's
    target.  ``cid=None`` targets the lowest-cid busy healthy running
    secondary at fire time (deterministic); for kill/drain a positive
    ``duration`` schedules the clone's recovery (health SUSPECT, then a
    breaker probe closes the loop), ``0`` is permanent.
    """

    at: float
    kind: str = "kill"
    cid: Optional[int] = None
    duration: float = 0.0
    factor: float = 4.0


class FaultInjector:
    """Clock-driven per-clone failure/slowdown schedules for a pool.

    ``arm()`` turns every :class:`CloneFault` into a VirtualClock event.
    Firing a kill/drain marks the target DEAD, powers it off (memory and
    executable cache gone), trips its breaker — binding the breaker's
    half-open probe chain to the same clock — and appends ``(clone,
    fault)`` to :attr:`failed` for the serving handler's recovery pass.
    Slowdowns scale the clone's dispatched venue seconds until their
    window elapses.  A fault whose target cannot be resolved (no busy
    healthy clone, or the named cid is not running) counts as a miss.
    """

    def __init__(self, pool: ClonePool, faults: List[CloneFault],
                 clock=None, on_fire=None):
        for f in faults:
            if f.kind not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {f.kind!r}; "
                                 f"expected one of {FAULT_KINDS}")
        self.pool = pool
        #: optional ``(clone, fault) -> None`` callback invoked at the
        #: instant a kill/drain lands — capacity-loss signal for
        #: admission control (the gateway tightens before the serving
        #: loop's next fleet census)
        self.on_fire = on_fire
        self.clock = pool.clock if clock is None else ensure_clock(clock)
        if not getattr(self.clock, "virtual", False):
            raise TypeError("FaultInjector schedules need a VirtualClock")
        self.faults = sorted(faults, key=lambda f: f.at)
        self.stats = {"injected": 0, "kills": 0, "drains": 0,
                      "slowdowns": 0, "misses": 0, "clone_recoveries": 0}
        self.failed: List[Tuple[Clone, CloneFault]] = []
        self._armed = False
        self._events: List[tuple] = []     # (fault, Event)

    # ----------------------------------------------------------- schedule
    def arm(self) -> None:
        """Schedule every fault; idempotent."""
        if self._armed:
            return
        self._armed = True
        for f in self.faults:
            ev = self.clock.at(max(f.at, self.clock.now()),
                               functools.partial(self._fire, f))
            self._events.append((f, ev))

    def next_event_time(self) -> Optional[float]:
        """Earliest unfired fault time — the serving loop bounds its
        waits on this so a mid-window death is detected when it happens,
        not when the doomed dispatch would have completed."""
        times = [ev.time for _, ev in self._events
                 if not ev.fired and not ev.cancelled]
        return min(times) if times else None

    def drain_failed(self) -> List[Tuple[Clone, CloneFault]]:
        out, self.failed = self.failed, []
        return out

    # --------------------------------------------------------------- fire
    def _target(self, f: CloneFault) -> Optional[Clone]:
        if f.cid is not None:
            for c in self.pool.clones:
                if (c.cid == f.cid and c.state is CloneState.RUNNING
                        and c.health is CloneHealth.HEALTHY):
                    return c
            return None
        cands = [c for c in self.pool.clones
                 if not c.is_primary and c.state is CloneState.RUNNING
                 and c.health is CloneHealth.HEALTHY]
        busy = [c for c in cands if c.busy]
        pick = busy or cands
        return min(pick, key=lambda c: c.cid) if pick else None

    def _fire(self, f: CloneFault) -> None:
        now = self.clock.now()
        clone = self._target(f)
        if clone is None:
            self.stats["misses"] += 1
            return
        self.stats["injected"] += 1
        if f.kind == "slow":
            clone.slowdown = max(1.0, f.factor)
            self.stats["slowdowns"] += 1
            if f.duration > 0:
                self.clock.schedule(
                    f.duration, functools.partial(self._clear_slow, clone))
            return
        self.stats["kills" if f.kind == "kill" else "drains"] += 1
        clone.health = CloneHealth.DEAD
        clone.slowdown = 1.0
        clone.breaker.bind(self.clock,
                           functools.partial(self._probe, clone))
        clone.breaker.trip(now)
        if not clone.is_primary:
            # memory + executable cache die with the clone; the primary
            # is standing capacity — it stays billed but health-gated
            self.pool.power_off(clone)
        self.failed.append((clone, f))
        if self.on_fire is not None:
            self.on_fire(clone, f)
        if f.duration > 0:
            self.clock.schedule(f.duration,
                                functools.partial(self._revive, clone))

    def _clear_slow(self, clone: Clone) -> None:
        clone.slowdown = 1.0

    def _revive(self, clone: Clone) -> None:
        """The fault window elapsed: the clone answers pings again, but
        serves only after its breaker's probe promotes it (ADR-006)."""
        if clone.health is CloneHealth.DEAD:
            clone.health = CloneHealth.SUSPECT

    def _probe(self, clone: Clone) -> bool:
        """Breaker half-open probe: a dead clone fails it; a suspect one
        passes and returns to the placement-eligible set."""
        if clone.health is CloneHealth.DEAD:
            return False
        clone.health = CloneHealth.HEALTHY
        self.stats["clone_recoveries"] += 1
        return True
