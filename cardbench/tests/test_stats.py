"""The metric arithmetic: a percentile over every request (a missing one
counts as infinitely late), a rate over the whole window, and a stall
that moves both."""
import math
import types

import pytest

from bench import cells, stats


def test_percentile_nearest_rank():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == 95
    assert stats.percentile(xs, 100) == 100
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], 95) == 10
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_missing_request_wins_the_tail():
    xs = [0.1] * 19 + [math.inf]
    assert stats.percentile(xs, 95) == 0.1
    assert stats.percentile(xs + [math.inf], 95) == math.inf


def _run(n=40, stall_at=None, stall=0.0, missing=()):
    """A window of n requests due every 0.1 s, each answered 0.05 s later
    with 10 tokens 0.02 s apart; a stall of ``stall`` seconds at
    ``stall_at`` delays every token from then on."""
    comps, due = {}, {}
    for r in range(n):
        d = 0.1 * (r + 1)
        due[r] = d
        if r in missing:
            continue
        ts = [d + 0.05 + 0.02 * j for j in range(10)]
        if stall_at is not None:
            ts = [t + stall if t >= stall_at else t for t in ts]
        comps[r] = types.SimpleNamespace(tokens=[1] * 10, token_ts=ts,
                                         first_token_t=ts[0], done_t=ts[-1])
    last = max(c.done_t for c in comps.values())
    return types.SimpleNamespace(due=due, completions=comps,
                                 window_s=last - min(due.values()))


def _read(name, run):
    return cells.reader(name)(run)


def test_rate_is_over_the_whole_window():
    run = _run()
    assert _read("output_tok_s", run) == pytest.approx(
        400 / (0.1 * 40 + 0.05 + 0.18 - 0.1))


def test_ttft_and_tpot_p95_over_every_request():
    run = _run()
    assert _read("ttft_p95_ms", run) == pytest.approx(50.0)
    assert _read("tpot_p95_ms", run) == pytest.approx(20.0)
    # three of forty missing: more than 5% of the requests never answered
    assert _read("ttft_p95_ms", _run(missing={3, 30, 31})) == math.inf
    assert _read("ttft_p95_ms", _run(missing={3, 30})) == pytest.approx(50.0)


def test_a_stall_moves_the_tail_and_the_rate():
    calm, stalled = _run(), _run(stall_at=2.0, stall=0.5)
    assert _read("ttft_p95_ms", stalled) > _read("ttft_p95_ms", calm) + 400
    assert _read("output_tok_s", stalled) < _read("output_tok_s", calm)
