"""join_step_ms: median over the window's engine steps that carry joins
(a cold batched prefill or prefix-hit suffix rows) of the seconds each was
charged on the timeline."""
from bench.stats import median


def read(run):
    m = median([s.charge_s for s in run.steps if s.kind == "join"])
    return None if m is None else 1e3 * m
