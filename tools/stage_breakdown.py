#!/usr/bin/env python3
"""A traced run of the port's benchmark with the program's stages named:
runs ``cardbench/run.py`` of the checkout it is started from, and besides
prints on standard error (lines starting ``PROBE``):

- ``stage_idle``: the stretch's idle seconds by the innermost program
  range (``serve.*`` / ``model.*``, see ``repro_torch.core.trace``) at
  each idle gap's midpoint, scope ``step`` or ``handler`` as the harness
  tells them; the harness's own per-step counter (``bench.counts.
  step_work``, traced runs only) is a stage of its own here,
  ``stage_breakdown.counter``;
- ``stage_device``: device seconds by the innermost program range around
  each kernel's launch (linked by correlation id);
- ``python_gaps``: idle seconds that the harness labels ``python``, by
  the host event that ended last before the gap and the one after it;
- ``device_range_names``: program range names among the device events
  (a range that the card mirrored; none is expected);
- ``stretch_steps``: the profiled stretch's steps by kind and by kind and
  rows (count, median charge in ms), and ``harness_counter_s``, the
  seconds the harness's counter took in the stretch.

The result line on standard output is the one ``cardbench/run.py``
prints: the harness's reduction sees the events without the counter's
range, as in a run without this probe.

    cd <checkout> && python3 <repo>/tools/stage_breakdown.py \\
        --workload qwen2.5-3b.code --seed 2147491301 --seconds 51 --trace 1

Needs a card; a checkout without the program's ranges reports every
stage as ``none``.
"""
import bisect
import json
import runpy
import statistics
import sys
import time

sys.path.insert(0, "cardbench")
sys.path.insert(0, "src")
import torch  # noqa: E402

import bench.counts as bc  # noqa: E402
import bench.trace as bt  # noqa: E402

CUDA = torch.autograd.DeviceType.CUDA
PROGRAM = ("serve.", "model.")
COUNTER = "stage_breakdown.counter"


def probe(obj) -> None:
    print("PROBE " + json.dumps(obj), file=sys.stderr, flush=True)


def split(events):
    """Device events, host events and step ranges as (start, end, ...)
    in seconds; the harness's step ranges mirrored on the card left
    out."""
    dev, host, steps = [], [], []
    for e in events:
        a, b, n = e.start_ns() * 1e-9, e.end_ns() * 1e-9, e.name()
        if n.startswith(bt.STEP_RANGE):
            if e.device_type() != CUDA:
                steps.append((a, b))
            continue
        if e.device_type() == CUDA:
            dev.append((a, b, n, e.correlation_id(),
                        e.linked_correlation_id()))
        else:
            host.append((a, b, n, e.correlation_id()))
    return dev, host, steps


def idle_gaps(dev, steps):
    """The stretch's bounds and its idle gaps, each with its scope."""
    lo, hi = min(a for a, _ in steps), max(b for _, b in steps)
    busy = bt._union([(max(a, lo), min(b, hi)) for a, b, *_ in dev
                      if b > lo and a < hi])
    step_u = bt._union(steps)
    ss = [a for a, _ in step_u]
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    out = []
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        m = 0.5 * (a + b)
        k = bisect.bisect_right(ss, m) - 1
        out.append((a, b, "step" if k >= 0 and step_u[k][1] >= m
                    else "handler"))
    return lo, hi, out


def innermost(ranges, scan):
    """A function of time: the name of the innermost of ``ranges`` (sorted
    (start, end, name)) open then, or ``none``."""
    starts = [r[0] for r in ranges]

    def at(t):
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(i - scan, -1), -1):
            if ranges[j][1] >= t:
                return ranges[j][2]
        return "none"
    return at


def by_stage(dev, host, steps):
    lo, hi, gaps = idle_gaps(dev, steps)
    rng = sorted((a, b, n) for a, b, n, _ in host
                 if n.startswith(PROGRAM) or n == COUNTER)
    stage = innermost(rng, 400)
    idle = {}
    for a, b, scope in gaps:
        key = f"{scope}: {stage(0.5 * (a + b))}"
        idle[key] = idle.get(key, 0.0) + (b - a)
    launch = {c: a for a, _, n, c in host if n.startswith("cu")}
    devs, unlinked = {}, 0.0
    for a, b, _, c, lc in dev:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        t = launch.get(c, launch.get(lc))
        if t is None:
            unlinked += b - a
            continue
        key = stage(t)
        devs[key] = devs.get(key, 0.0) + (b - a)

    def top(d):
        return sorted(d.items(), key=lambda kv: -kv[1])
    return {"window_s": hi - lo, "stage_idle": top(idle),
            "stage_device": top(devs), "device_unlinked_s": unlinked}


def python_gaps(dev, host, steps, scan):
    """Idle seconds the harness labels ``python``, by the host event that
    ended last before the gap's midpoint and the one that starts next."""
    _, _, gaps = idle_gaps(dev, steps)
    cpu = sorted((a, b, n) for a, b, n, _ in host if n != COUNTER)
    open_at = innermost(cpu, scan)
    starts = [c[0] for c in cpu]
    by_end = sorted(cpu, key=lambda c: c[1])
    ends = [c[1] for c in by_end]
    out = {}
    for a, b, _ in gaps:
        m = 0.5 * (a + b)
        if open_at(m) != "none":
            continue
        k = bisect.bisect_right(ends, m) - 1
        i = bisect.bisect_right(starts, m)
        key = (f"{by_end[k][2] if k >= 0 else '-'} > "
               f"{cpu[i][2] if i < len(cpu) else '-'}")
        out[key] = out.get(key, 0.0) + (b - a)
    return sorted(out.items(), key=lambda kv: -kv[1])[:25]


_reduce = bt.reduce


def reduce(events, scan=4000):
    events = list(events)
    dev, host, steps = split(events)
    probe({"device_range_names": sorted(
        {n for _, _, n, *_ in dev if n.startswith(PROGRAM)})})
    probe(by_stage(dev, host, steps))
    probe({"python_gaps": python_gaps(dev, host, steps, scan)})
    # the harness's reduction, as in a run without the counter's range
    return _reduce([e for e in events if e.name() != COUNTER], scan)


_step_work = bc.step_work
COUNTER_S = [0.0]


def step_work(*a, **k):
    t0 = time.perf_counter()
    with torch._C._profiler._RecordFunctionFast(COUNTER):
        _step_work(*a, **k)
    COUNTER_S[0] += time.perf_counter() - t0


_on_call, _stop = bt.Tracer._on_call, bt.Tracer.stop


def on_call(self):
    was = self.prof
    _on_call(self)
    if was is None and self.prof is not None:
        self.first_step = len(self.ex.steps)


def stop(self):
    if self.prof is not None:
        steps = self.ex.steps[self.first_step:]
        kinds, buckets = {}, {}
        for s in steps:
            kinds.setdefault(s.kind, []).append(s.charge_s)
            buckets.setdefault(f"{s.kind}:{s.rows}", []).append(s.charge_s)

        def med(d):
            return {k: [len(v), 1e3 * statistics.median(v)]
                    for k, v in sorted(d.items())}
        probe({"stretch_steps": med(kinds), "stretch_buckets": med(buckets),
               "harness_counter_s": COUNTER_S[0]})
    _stop(self)


bt.reduce = reduce
bc.step_work = step_work
bt.Tracer._on_call, bt.Tracer.stop = on_call, stop
sys.argv = ["cardbench/run.py"] + sys.argv[1:]
runpy.run_path("cardbench/run.py", run_name="__main__")
