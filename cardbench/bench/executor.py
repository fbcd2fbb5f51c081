"""The wall-paced executor: puts the serving handler's timeline on the
host's clock.

``ClientHandler`` plays every dispatch out on its ``VirtualClock``: an
executor runs the step closure and returns the seconds the step takes on
that timeline.  This one runs each closure exactly once, waits for the
card (``sync``), and charges the wall seconds elapsed since it last
returned: the closure and the handler's own host work since the step
before it.  So while the engine is busy the timeline advances with the
wall clock; while it idles the handler skips to the next arrival, which
costs no latency.  The executor's own bookkeeping after a step is not
charged.

Each step leaves a :class:`Step` record: its host-clock call and return,
its charge, its kind (``join`` or ``decode``, from the batches the handler
captured in the closure; ``counts.check_step`` fails the run where those
names are gone) and, while a ``counter`` is set, the attention work it
asked for (``counts.step_work``).  ``on_call`` and ``on_return`` hooks
let the harness start and stop the profiler at step boundaries.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

from torch.profiler import record_function

from bench import counts


@dataclasses.dataclass
class Step:
    call_s: float           # host clock at the call
    end_s: float            # host clock once the card finished the step
    charge_s: float         # seconds charged to the serving timeline
    kind: Optional[str]     # "join", "decode" or None
    rows: int = 0           # cold prefill rows + suffix rows (padded)
    decodes: bool = False   # the step runs a decode window


class WallExecutor:
    """``executor(clone, fn, args) -> (value, charged seconds)``."""

    def __init__(self, sync: Callable[[], None], *,
                 clock: Callable[[], float] = time.perf_counter):
        self.sync = sync
        self.clock = clock
        self.steps: List[Step] = []
        self.last: Optional[float] = None
        self.on_call: Optional[Callable[[], None]] = None
        self.on_return: Optional[Callable[[], None]] = None
        self.counter: Optional[Callable] = None

    def start(self) -> None:
        """Start the timeline's wall clock and forget earlier steps."""
        self.steps = []
        self.last = self.clock()

    def __call__(self, clone, fn, args):
        if self.on_call is not None:
            h0 = self.clock()
            self.on_call()
            if self.last is not None:       # the hook's time is not charged
                self.last += self.clock() - h0
        free = counts.closure_vars(fn)
        counts.check_step(fn, free)
        kind = counts.step_kind(free)
        t0 = self.clock()
        if self.last is None:
            self.last = t0
        with record_function(f"cardbench.step.{kind}"):
            value = fn(*args)
            self.sync()
        t1 = self.clock()
        charge = t1 - self.last
        self.steps.append(Step(t0, t1, charge, kind,
                               counts.join_rows(free),
                               bool(free["do_decode"])))
        if self.counter is not None:
            self.counter(free, args)
        if self.on_return is not None:
            self.on_return()
        self.last = self.clock()
        return value, charge
