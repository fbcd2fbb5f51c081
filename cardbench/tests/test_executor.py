"""The wall-paced executor charges the host time between closures."""
import pytest

from bench import counts
from bench.executor import WallExecutor


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_charges_host_work_since_it_last_returned():
    clk = Clock()
    syncs = []
    ex = WallExecutor(lambda: syncs.append(clk.t), clock=clk)
    ex.start()

    def step(dt):
        def advance(join_batch, do_decode):
            clk.t += dt
            return dt
        return engine_step(advance)

    clk.t += 0.3                     # the handler's host work
    v, charge = ex(None, step(0.2), ())
    assert v == 0.2 and charge == pytest.approx(0.5)
    clk.t += 0.01
    v, charge = ex(None, step(0.04), ())
    assert charge == pytest.approx(0.05)
    assert len(syncs) == 2           # every closure ends in a sync
    assert [s.charge_s for s in ex.steps] == pytest.approx([0.5, 0.05])
    assert ex.steps[1].end_s - ex.steps[1].call_s == pytest.approx(0.04)


def test_hooks_and_bookkeeping_are_not_charged():
    clk = Clock()
    ex = WallExecutor(lambda: None, clock=clk)
    ex.start()

    def slow_hook():
        clk.t += 1.0

    ex.on_call = slow_hook
    ex.on_return = slow_hook
    ex.counter = lambda free, args: None

    def advance(join_batch, do_decode):
        clk.t += 0.1
    fn = engine_step(advance)
    _, c1 = ex(None, fn, ())
    _, c2 = ex(None, fn, ())
    assert c1 == pytest.approx(0.1) and c2 == pytest.approx(0.1)


def engine_step(action, join_batch=None, prefill_tokens=0):
    """A closure that captures the engine step's names, as the handler's
    ``_submit_engine_step`` makes it, and runs ``action``."""
    mixed_batch = sfx_batch = None
    do_decode = True

    def step_fn(*args):
        assert mixed_batch is None and sfx_batch is None
        return action(join_batch, do_decode)
    step_fn.prefill_tokens = prefill_tokens
    return step_fn


def test_runs_each_closure_once_and_reads_its_kind():
    import numpy as np
    calls = []
    joins = engine_step(lambda j, d: calls.append("j"),
                        (np.zeros((4, 8)), None, None), prefill_tokens=8)
    decodes = engine_step(lambda j, d: calls.append("d"))
    ex = WallExecutor(lambda: None)
    ex(None, joins, ())
    ex(None, decodes, ())
    assert calls == ["j", "d"]
    assert [s.kind for s in ex.steps] == ["join", "decode"]
    assert [s.rows for s in ex.steps] == [4, 0]
    assert [s.decodes for s in ex.steps] == [True, True]
    assert counts.step_kind({"do_decode": False}) is None


@pytest.mark.parametrize("drift", ["renamed", "prefill_tokens"])
def test_a_step_that_hides_what_the_yardstick_reads_fails_the_run(drift):
    """A renamed closure variable, or a join that the program's own
    ``prefill_tokens`` does not show, stops the run before the step runs,
    instead of moving the step to another kind."""
    import numpy as np
    calls = []
    if drift == "renamed":
        join_batch = sfx_batch = mixed_rows = None
        do_decode = True

        def fn():
            calls.append((join_batch, sfx_batch, mixed_rows, do_decode))
    else:
        fn = engine_step(lambda j, d: calls.append(j),
                         (np.zeros((4, 8)), None, None), prefill_tokens=0)
    ex = WallExecutor(lambda: None)
    with pytest.raises(counts.StepDrift):
        ex(None, fn, ())
    assert calls == [] and ex.steps == []
