"""Dispatcher: non-blocking execution of remoteable work onto clones.

This is the execution half of the seed's ``ExecutionController`` split out
(the controller keeps the *decision* layer — predictions, policy, placement
— with unchanged semantics).  ``submit()`` issues work onto a clone and
returns a :class:`CloneTask` future immediately; the task's *completion* is
an event on the shared :class:`~repro_torch.core.clock.VirtualClock`, so k
submissions genuinely overlap on the timeline: waiting for all of them
advances virtual time to ``max(done_at)``, not the sum.

Simulation honesty (DESIGN.md §2) is preserved: the callable runs eagerly
on the host to obtain its *value* and its measured-then-scaled venue
seconds; only the *latency* is played out on the virtual timeline.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

from repro_torch.core.clock import VirtualClock
from repro_torch.core.clones import Clone, ClonePool


@dataclasses.dataclass(eq=False)          # identity semantics: usable as a key
class CloneTask:
    """Future-style handle for one unit of work issued onto a clone."""

    clone: Clone
    label: str = ""
    submitted_at: float = 0.0
    venue_seconds: float = 0.0     # modeled execution time on the clone
    extra_delay: float = 0.0       # provisioning / transfer charged up front
    done_at: float = 0.0           # submitted_at + extra_delay + venue_seconds
    done: bool = False
    cancelled: bool = False        # completion event revoked (ADR-006)
    value: object = None
    # the submitted work, kept so a hedged duplicate can re-issue the
    # exact closure on a second clone (the closure is pure — ADR-002)
    fn: Optional[Callable] = None
    fn_args: tuple = ()
    _event: object = None          # the clock completion Event
    _callbacks: List[Callable] = dataclasses.field(default_factory=list)

    @property
    def duration(self) -> float:
        """Total timeline seconds from submission to completion."""
        return self.done_at - self.submitted_at

    def add_done_callback(self, cb: Callable[["CloneTask"], None]) -> None:
        """Run ``cb(task)`` at completion (immediately if already done)."""
        if self.done:
            cb(self)
        else:
            self._callbacks.append(cb)

    def _complete(self) -> None:
        self.done = True
        for cb in self._callbacks:
            cb(self)
        self._callbacks.clear()


class Dispatcher:
    """Issues work onto clones; completions are virtual-clock events."""

    def __init__(self, pool: ClonePool, clock: VirtualClock):
        if not getattr(clock, "virtual", False):
            raise TypeError("Dispatcher needs a VirtualClock — overlap is "
                            "only well-defined on a simulated timeline")
        self.pool = pool
        self.clock = clock
        self.submitted = 0

    # ----------------------------------------------------------------- api
    def submit(self, clone: Clone, fn: Callable, args: Sequence = (),
               *, executor: Optional[Callable] = None,
               extra_delay: float = 0.0, label: str = "") -> CloneTask:
        """Run ``fn(*args)`` on ``clone``; returns immediately.

        ``executor(clone, fn, args) -> (value, venue_seconds)`` defaults to
        host execution scaled to the clone's venue (``Venue.execute``).
        ``extra_delay`` charges provisioning/transfer seconds that must
        elapse on the timeline before execution starts.
        """
        if executor is None:
            from repro_torch.core.venues import Venue

            def executor(c, f, a):
                return Venue(c.spec).execute(f, *a)

        value, venue_s = executor(clone, fn, args)
        # fault-injected slowdowns (ADR-006) scale the modeled venue time
        # at the one choke point every dispatch passes through, so test
        # and benchmark executors stay fault-agnostic
        venue_s = float(venue_s) * max(1.0, getattr(clone, "slowdown", 1.0))
        task = CloneTask(clone=clone, label=label,
                         submitted_at=self.clock.now(),
                         venue_seconds=venue_s,
                         extra_delay=float(extra_delay),
                         fn=fn, fn_args=tuple(args))
        task.value = value
        task.done_at = task.submitted_at + task.extra_delay + task.venue_seconds
        task._event = self.clock.at(task.done_at, task._complete)
        self.submitted += 1
        return task

    def cancel(self, task: CloneTask) -> bool:
        """Revoke an in-flight task: its completion event never fires and
        its value is discarded (hedge losers, dispatches on dead clones).
        Returns False when the task already completed or was cancelled."""
        if task.done or task.cancelled:
            return False
        task.cancelled = True
        if task._event is not None:
            task._event.cancel()
        return True

    def wait(self, tasks: Sequence[CloneTask]) -> List[CloneTask]:
        """Advance the timeline until every task has completed."""
        for t in sorted(tasks, key=lambda t: t.done_at):
            if not t.done:
                self.clock.advance_to(t.done_at)
        return list(tasks)

    def wait_any(self, tasks: Sequence[CloneTask]) -> List[CloneTask]:
        """Advance until at least one of ``tasks`` completes; returns the
        completed subset."""
        live = [t for t in tasks if not t.done]
        if not live:
            return [t for t in tasks if t.done]
        first = min(live, key=lambda t: t.done_at)
        self.clock.advance_to(first.done_at)
        return [t for t in tasks if t.done]
