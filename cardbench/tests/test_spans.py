"""The readers of the program's own stamps: ``slot_wait_p95_ms``,
``join_wait_p50_ms``, ``prefill_step_p50_ms`` and ``decode_stall_share``,
on synthetic runs and on a tiny traced cell served on the CPU."""
import time
import types

import pytest
import torch

from bench import cells, harness

NAMES = ("slot_wait_p95_ms", "join_wait_p50_ms", "prefill_step_p50_ms",
         "decode_stall_share")


def _run(due, completions):
    return harness.Run(cell=None, shape=None, seed=0, setup_s=0.0,
                       window_s=1.0, arrivals=[], due=due,
                       completions=completions, slot_admit={}, steps=[],
                       hit_tokens=0, prompt_tokens=0, memory_peak_bytes=0)


def _done(rid, due, slot, prefill, first, ts, stall):
    from repro_torch.core.scheduler import ServeCompletion
    return ServeCompletion(rid, list(range(len(ts))), due, first, ts[-1],
                           "primary", token_ts=list(ts), slot_t=slot,
                           prefill_t=prefill, stall_s=stall)


def _synthetic():
    """Twenty requests: request r is due at r, waits 0.01 r for a slot,
    0.1 for the step in flight, takes a 0.2 s prefill step, then decodes
    4 tokens a second, a quarter of that time behind other joins."""
    due, done = {}, {}
    for r in range(20):
        slot = r + 0.01 * r
        first = slot + 0.3
        due[r] = float(r)
        done[r] = _done(r, float(r), slot, slot + 0.1, first,
                        [first + 0.25 * j for j in range(5)], 0.25)
    return due, done


def test_readers_on_a_synthetic_run():
    read = {n: cells.reader(n) for n in NAMES}
    due, done = _synthetic()
    run = _run(due, done)
    assert read["slot_wait_p95_ms"](run) == pytest.approx(180.0)  # 19th
    assert read["join_wait_p50_ms"](run) == pytest.approx(100.0)
    assert read["prefill_step_p50_ms"](run) == pytest.approx(200.0)
    assert read["decode_stall_share"](run) == pytest.approx(25.0)


def test_slot_wait_counts_missing_requests_as_infinite():
    read = cells.reader("slot_wait_p95_ms")
    due, done = _synthetic()
    del done[3]                          # never answered
    done[4].slot_t = None                # answered without a stamp
    assert read(_run(due, done)) == float("inf")
    del done[5]
    assert cells.reader("join_wait_p50_ms")(_run(due, done)) == \
        pytest.approx(100.0)


def test_step_medians_are_not_set_by_a_slowed_stretch():
    """Three of twenty requests (a profiled stretch) wait and prefill ten
    times as long: a p95 would read them, the medians do not move."""
    due, done = _synthetic()
    for r in (11, 12, 13):
        c = done[r]
        c.prefill_t = c.slot_t + 1.0
        c.first_token_t = c.prefill_t + 2.0
    run = _run(due, done)
    assert cells.reader("join_wait_p50_ms")(run) == pytest.approx(100.0)
    assert cells.reader("prefill_step_p50_ms")(run) == pytest.approx(200.0)


def test_readers_find_nothing_in_a_program_without_stamps():
    """A program whose completions carry none of the stamps (the parent of
    the change that adds them) gives every reader nothing to read."""
    due, done = _synthetic()
    bare = {r: types.SimpleNamespace(
        rid=r, tokens=c.tokens, arrival_t=c.arrival_t,
        first_token_t=c.first_token_t, done_t=c.done_t, token_ts=c.token_ts)
        for r, c in done.items()}
    for n in NAMES:
        assert cells.reader(n)(_run(due, bare)) is None, n
    assert cells.reader("decode_stall_share")(_run(due, {})) is None


def test_traced_cpu_cell_reads_the_stamps(tiny_cell):
    """A tiny traced cell on the CPU: the program's slot stamp and the
    harness's own around ``_admit`` give the same p95, and every reader
    finds its stamps."""
    torch.set_num_threads(2)
    cell = tiny_cell("dense", "rag")
    cell.mix["arrivals"]["rate"] = 24.0
    run = harness.run_cell(cell, 2 ** 31 + 7, 1.0, True,
                           t_start=time.perf_counter(), device="cpu",
                           impl="torch", log=lambda m: None)
    assert run.trace is not None and len(run.completions) == len(run.due)
    got = {n: cells.reader(n)(run) for n in NAMES}
    assert got["slot_wait_p95_ms"] == \
        cells.reader("queue_wait_p95_ms")(run)
    assert all(v is not None and v >= 0 for v in got.values()), got
    assert got["prefill_step_p50_ms"] > 0
    for c in run.completions.values():
        assert c.slot_t <= c.prefill_t < c.first_token_t
