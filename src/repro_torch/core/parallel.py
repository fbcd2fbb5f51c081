"""Parallelization across clones (paper §7.4) + straggler mitigation.

The primary clone acts as a transparent proxy for k secondaries.  Shards
are *submitted* onto clones through the
:class:`~repro_torch.core.dispatch.Dispatcher` and their completions are
events on the shared :class:`~repro_torch.core.clock.VirtualClock` — k
shards genuinely overlap, so the parallel makespan observed on the timeline
is
    resume(k) + max_i(shard_i) + sync(k)
exactly mirroring the paper's accounting ("the resume time is included in
the overhead time, which in turn is included in the execution time").

Straggler mitigation is detected *at event time*: once half the shards
have completed, a deadline of ``straggler_factor x median(completed)`` is
placed on the timeline; any shard still pending when the deadline fires is
re-dispatched to a spare clone, and its effective completion is the
earlier of (original, rescue).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.clock import VirtualClock, ensure_clock
from repro_torch.core.clones import ClonePool
from repro_torch.core.dispatch import Dispatcher

# Per-secondary synchronization cost charged by the primary proxy (paper:
# "incurring extra synchronization overheads"; calibrated so that 8-queens
# gains flatten past ~4 clones as in Fig. 12).
SYNC_SECONDS_PER_CLONE = 0.050


@dataclasses.dataclass
class ParallelResult:
    value: object
    makespan_s: float              # resume + max shard + sync + merge
    shard_times: List[float]
    resume_s: float
    sync_s: float
    redispatches: int
    n_clones: int


def _split_tree(tree, k: int, axis: int) -> List:
    """``tree`` (nested dicts, lists and tuples) as k trees of the same
    structure; a tensor leaf is split on its own device
    (``torch.tensor_split``), any other leaf as a numpy array."""
    if isinstance(tree, dict):
        parts = {key: _split_tree(v, k, axis) for key, v in tree.items()}
        return [{key: p[i] for key, p in parts.items()} for i in range(k)]
    if isinstance(tree, (list, tuple)):
        parts = [_split_tree(v, k, axis) for v in tree]
        return [type(tree)(p[i] for p in parts) for i in range(k)]
    if tree is None:
        return [None] * k
    if isinstance(tree, torch.Tensor):
        return list(torch.tensor_split(tree, k, dim=axis))
    return np.array_split(np.asarray(tree), k, axis=axis)


def split_batch(args: tuple, k: int, axis: int = 0) -> List[tuple]:
    """Default splitter: split every array leaf's leading axis into k parts
    (the first ``n % k`` parts one longer, as ``np.array_split``)."""
    return _split_tree(args, k, axis)


def split_range(lo: int, hi: int, k: int) -> List[tuple]:
    """Range splitter (paper: N-queens board regions)."""
    edges = np.linspace(lo, hi, k + 1).astype(int)
    return [(int(edges[i]), int(edges[i + 1])) for i in range(k)]


class Parallelizer:
    def __init__(self, pool: ClonePool, straggler_factor: float = 2.0,
                 sync_seconds: float = SYNC_SECONDS_PER_CLONE,
                 clock: Optional[VirtualClock] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.pool = pool
        self.straggler_factor = straggler_factor
        self.sync_seconds = sync_seconds
        if clock is not None:
            self.clock = ensure_clock(clock)
        elif getattr(pool.clock, "virtual", False):
            self.clock = pool.clock          # share the pool's timeline
        else:
            self.clock = VirtualClock()      # private deterministic timeline
        self.device = device
        self.dispatcher = Dispatcher(self.pool, self.clock, device)

    def run(self, fn: Callable, shards: Sequence[tuple], *,
            clone_type: str = "main",
            merge: Callable = None,
            shard_delays: Optional[Sequence[float]] = None,
            venue_executor: Callable = None) -> ParallelResult:
        """Execute ``fn(*shard)`` across len(shards) clones, overlapped.

        ``venue_executor(clone, fn, shard) -> (value, venue_seconds)``
        defaults to running on the parallelizer's device, scaled to the
        clone's venue spec.  ``shard_delays`` injects extra venue-seconds
        per shard (tests / straggler demos).
        """
        k = len(shards)
        clock = self.clock
        t0 = clock.now()
        clones, provision_s = self.pool.acquire(clone_type, n=k)
        exec_start = t0 + provision_s
        if venue_executor is None:
            from repro_torch.core.venues import Venue
            device = self.device

            def venue_executor(clone, f, shard):
                return Venue(clone.spec, device).execute(f, *shard)

        def make_executor(i):
            def ex(clone, f, args):
                val, dt = venue_executor(clone, f, args)
                if shard_delays is not None:
                    dt += shard_delays[i]
                return val, dt
            return ex

        tasks = [self.dispatcher.submit(clone, fn, shard,
                                        executor=make_executor(i),
                                        extra_delay=provision_s,
                                        label=f"shard{i}")
                 for i, (clone, shard) in enumerate(zip(clones, shards))]
        done_at = [t.done_at for t in tasks]       # effective completion
        values = [t.value for t in tasks]

        # ---- straggler detection + re-dispatch, at event time ----
        redispatches = 0
        spares = []
        if k > 1:
            # advance until half the shards have completed, then set the
            # deadline from the median of what the timeline has shown so far
            order = sorted(range(k), key=lambda i: done_at[i])
            half = order[:(k + 1) // 2]
            clock.advance_to(max(done_at[i] for i in half))
            med = float(np.median([done_at[i] - exec_start for i in half]))
            deadline_t = exec_start + self.straggler_factor * max(med, 1e-9)
            stragglers = [i for i in order[(k + 1) // 2:]
                          if done_at[i] > max(deadline_t, clock.now())]
            if stragglers:
                clock.advance_to(max(deadline_t, clock.now()))
                for i in stragglers:
                    spare, spare_cost = self.pool.acquire(
                        clone_type, n=1, exclude_primary=True)
                    val, fresh = venue_executor(spare[0], fn, shards[i])
                    rescue_done = clock.now() + spare_cost + fresh
                    if rescue_done < done_at[i]:
                        values[i] = val
                        done_at[i] = rescue_done
                        redispatches += 1
                    spares.extend(spare)

        clock.advance_to(max(max(done_at), clock.now()))
        sync_s = self.sync_seconds * max(0, k - 1)
        clock.sleep(sync_s)
        shard_times = [t - exec_start for t in done_at]
        makespan = clock.now() - t0                # provision+max(shard)+sync
        merged = merge(values) if merge is not None else values
        self.pool.release(clones + spares)
        self.pool.reap_idle()
        return ParallelResult(merged, makespan, shard_times, provision_s,
                              sync_s, redispatches, k)
