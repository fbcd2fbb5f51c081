"""The system timeline: one injected clock for every latency in the fleet.

The paper's Client Handler multiplexes many phone clients onto an elastic
clone pool; every cost it reasons about (resume, boot, transfer, execution,
idle TTLs) is a *duration on one timeline*.  The seed code mixed
``time.monotonic()`` stamps with returned-cost arithmetic, which made
overlap (k clones running in parallel) impossible to express and idle
reaping dependent on real wall clock.

This module provides that single timeline:

``VirtualClock``
    A deterministic discrete-event clock.  ``schedule(delay, cb)`` enqueues
    an event; ``advance_to(t)`` / ``sleep(dt)`` move time forward, firing
    events in timestamp order as they are crossed.  All simulated latency in
    the repo flows through one of these — there are *no real sleeps* on the
    simulated path.

``SystemClock`` / ``FunctionClock``
    Adapters so existing callers (real wall clock, or the tests'
    ``lambda: t[0]`` fakes) satisfy the same interface.  Their ``sleep`` is
    a no-op: modeled costs never block the host.

Every clock is callable (``clock()`` == ``clock.now()``) for backward
compatibility with the seed's ``Callable[[], float]`` convention.
"""
from __future__ import annotations

import heapq
import itertools
import time
from typing import Callable, List, Optional, Tuple


class BaseClock:
    """Minimal clock interface: ``now()``, ``sleep(dt)``, callable."""

    #: True when time is simulated and events can be scheduled on it.
    virtual = False

    def now(self) -> float:
        """Current time in seconds on this clock's timeline."""
        raise NotImplementedError

    def sleep(self, dt: float) -> None:
        """Charge ``dt`` seconds to the timeline (no-op on real clocks:
        modeled costs must never block the host)."""

    def __call__(self) -> float:
        return self.now()


class SystemClock(BaseClock):
    """Real wall clock (``time.monotonic``); sleep is a no-op."""

    def now(self) -> float:
        return time.monotonic()


class FunctionClock(BaseClock):
    """Wraps a bare ``Callable[[], float]`` (the seed/test convention)."""

    def __init__(self, fn: Callable[[], float]):
        self.fn = fn

    def now(self) -> float:
        return float(self.fn())


class Event:
    """A scheduled occurrence on a :class:`VirtualClock`."""

    __slots__ = ("time", "seq", "callback", "cancelled", "fired")

    def __init__(self, t: float, seq: int, callback: Optional[Callable]):
        self.time = t
        self.seq = seq
        self.callback = callback
        self.cancelled = False
        self.fired = False

    def cancel(self) -> None:
        """Mark the event dead; it will be skipped (and pruned) unfired."""
        self.cancelled = True


class VirtualClock(BaseClock):
    """Deterministic event-queue clock.

    Invariants:
      - time never moves backwards;
      - events fire in (time, insertion) order, with ``now`` set to the
        event's timestamp while its callback runs;
      - callbacks may schedule further events (at or after the current
        time) but must not re-enter ``advance_to`` (single timeline).
    """

    virtual = True

    def __init__(self, start: float = 0.0):
        self._now = float(start)
        self._heap: List[Tuple[float, int, Event]] = []
        self._seq = itertools.count()
        self._advancing = False

    # ------------------------------------------------------------- reading
    def now(self) -> float:
        """Current simulated time (seconds since ``start``)."""
        return self._now

    def pending(self) -> int:
        """Number of scheduled, not-yet-fired, not-cancelled events."""
        return sum(1 for _, _, e in self._heap if not e.cancelled)

    def next_event_time(self) -> Optional[float]:
        """Timestamp of the earliest live event, or None when idle."""
        self._prune()
        return self._heap[0][0] if self._heap else None

    # ---------------------------------------------------------- scheduling
    def schedule(self, delay: float, callback: Optional[Callable] = None
                 ) -> Event:
        """Enqueue an event ``delay`` seconds from now (>= 0)."""
        return self.at(self._now + max(0.0, float(delay)), callback)

    def at(self, t: float, callback: Optional[Callable] = None) -> Event:
        """Enqueue an event at absolute time ``t`` (>= now)."""
        if t < self._now - 1e-12:
            raise ValueError(f"cannot schedule in the past: {t} < {self._now}")
        ev = Event(max(t, self._now), next(self._seq), callback)
        heapq.heappush(self._heap, (ev.time, ev.seq, ev))
        return ev

    def _prune(self) -> None:
        while self._heap and self._heap[0][2].cancelled:
            heapq.heappop(self._heap)

    # ----------------------------------------------------------- advancing
    def advance_to(self, t: float) -> None:
        """Move time forward to ``t``, firing every due event in order."""
        if t < self._now - 1e-12:
            raise ValueError(f"time cannot run backwards: {t} < {self._now}")
        if self._advancing:
            raise RuntimeError("re-entrant VirtualClock.advance_to")
        self._advancing = True
        try:
            while True:
                self._prune()
                if not self._heap or self._heap[0][0] > t:
                    break
                _, _, ev = heapq.heappop(self._heap)
                self._now = max(self._now, ev.time)
                ev.fired = True
                if ev.callback is not None:
                    ev.callback()
            self._now = max(self._now, t)
        finally:
            self._advancing = False

    def advance(self, dt: float) -> None:
        self.advance_to(self._now + max(0.0, float(dt)))

    def sleep(self, dt: float) -> None:
        """Simulated sleep: advances the timeline (fires crossed events)."""
        self.advance(dt)

    def run_next(self) -> bool:
        """Advance to the next pending event; False when queue is empty."""
        t = self.next_event_time()
        if t is None:
            return False
        self.advance_to(t)
        return True

    def run_until_idle(self, max_events: int = 1_000_000) -> None:
        for _ in range(max_events):
            if not self.run_next():
                return
        raise RuntimeError("VirtualClock.run_until_idle: event storm")


def ensure_clock(clock) -> BaseClock:
    """Coerce None / bare callables / clocks into the clock interface.

    ``None`` yields a fresh :class:`VirtualClock` — the deterministic
    default for every simulated component.
    """
    if clock is None:
        return VirtualClock()
    if isinstance(clock, BaseClock):
        return clock
    if callable(clock):
        return FunctionClock(clock)
    raise TypeError(f"not a clock: {clock!r}")
