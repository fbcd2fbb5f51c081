"""The traced run: ``torch.profiler`` over a steady stretch of the window,
reduced in memory (nothing is written to disk) to what the per-layer
metrics and the result line read.

The stretch starts at the first step the handler dispatches once
``start_s`` of the window have passed and ends at the first step that
returns ``length_s`` later, so it holds whole steps.  Its device
operations (kernels, copies, sets) give the busy time, as the union of
their intervals; kernels are attributed to an operation by name through
the pattern files of ``cardbench/kernels/<operation>/`` (one regular
expression a line; a later kernel for the same operation adds a file).
"""
from __future__ import annotations

import bisect
import dataclasses
import pathlib
import re
from typing import Callable, Dict, List, Optional, Tuple

import torch

KERNELS = pathlib.Path(__file__).resolve().parents[1] / "kernels"
STEP_RANGE = "cardbench.step."


def patterns(op: str) -> List[re.Pattern]:
    """The kernel-name patterns of operation ``op``."""
    out = []
    for f in sorted((KERNELS / op).glob("*.txt")):
        for line in f.read_text().splitlines():
            if line.strip() and not line.startswith("#"):
                out.append(re.compile(line.strip()))
    if not out:
        raise FileNotFoundError(f"no kernel patterns for {op!r} under "
                                f"{KERNELS / op}")
    return out


@dataclasses.dataclass
class Trace:
    """What the stretch showed, in seconds."""

    window_s: float
    busy_s: float
    device: List[Tuple[str, float, float]]      # (name, start_s, end_s)
    idle_by_host: List[Tuple[str, float]]       # (what the host ran, s)

    def op_seconds(self, op: str) -> float:
        """Device time of the kernels of operation ``op``."""
        pats = patterns(op)
        return sum(b - a for n, a, b in self.device
                   if any(p.search(n) for p in pats))

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for name, a, b in self.device:
            by[name] = by.get(name, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                ][:n]


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def reduce(events, scan: int = 4000) -> Trace:
    """Reduce the profiler's raw events (``kineto_results.events()``)."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, cpu, steps = [], [], []
    for e in events:
        a, b = e.start_ns() * 1e-9, e.end_ns() * 1e-9
        if e.device_type() == cuda and e.name().startswith(STEP_RANGE):
            continue                    # the step ranges, mirrored on the card
        if e.device_type() == cuda:
            dev.append((e.name(), a, b))
        elif e.name().startswith(STEP_RANGE):
            steps.append((a, b))
        else:
            cpu.append((a, b, e.name()))
    if not steps:
        raise RuntimeError("the traced stretch holds no serving step")
    lo, hi = min(a for a, _ in steps), max(b for _, b in steps)
    dev = [(n, max(a, lo), min(b, hi)) for n, a, b in dev if b > lo and a < hi]
    busy = _union([(a, b) for _, a, b in dev])
    busy_s = sum(b - a for a, b in busy)
    # idle gaps, each labelled by the innermost host operation running at
    # its midpoint, and whether a step or the handler between steps ran
    cpu.sort()
    starts = [c[0] for c in cpu]
    step_u = _union(steps)
    step_starts = [a for a, _ in step_u]
    idle: Dict[str, float] = {}
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        m = 0.5 * (a + b)
        k = bisect.bisect_right(step_starts, m) - 1
        scope = "step" if k >= 0 and step_u[k][1] >= m else "handler"
        op = "python"
        i = bisect.bisect_right(starts, m) - 1
        for j in range(i, max(i - scan, -1), -1):
            if cpu[j][1] >= m:
                op = cpu[j][2]
                break
        key = f"{scope}: {op}"
        idle[key] = idle.get(key, 0.0) + (b - a)
    return Trace(hi - lo, busy_s, dev,
                 sorted(idle.items(), key=lambda kv: -kv[1]))


class Tracer:
    """Starts and stops the profiler at step boundaries of the window
    (through the executor's hooks) and counts the steps it covers;
    ``clock`` places the stretch (the serving timeline)."""

    def __init__(self, executor, start_s: float, length_s: float,
                 counter: Callable, clock: Callable[[], float]):
        self.ex = executor
        self.start_s, self.length_s = start_s, length_s
        self.counter = counter
        self.clock = clock
        self.t0: Optional[float] = None
        self.prof = None
        self.begun: Optional[float] = None
        self.trace: Optional[Trace] = None

    def arm(self) -> None:
        """Start counting the window's time now."""
        self.t0 = self.clock()
        self.ex.on_call = self._on_call
        self.ex.on_return = self._on_return

    def _on_call(self) -> None:
        if (self.prof is None and self.trace is None
                and self.clock() - self.t0 >= self.start_s):
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
            self.ex.counter = self.counter
            self.begun = self.clock()

    def _on_return(self) -> None:
        if self.prof is not None and \
                self.clock() - self.begun >= self.length_s:
            self.stop()

    def stop(self) -> None:
        """End the stretch (at the latest when the window ends)."""
        if self.prof is None:
            return
        self.ex.counter = None
        self.prof.stop()
        events = self.prof.profiler.kineto_results.events()
        self.prof = None
        self.trace = reduce(events)
