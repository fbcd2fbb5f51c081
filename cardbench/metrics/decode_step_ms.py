"""decode_step_ms: median over the window's engine steps that carry no
join of the seconds each was charged on the timeline (the step and the
handler's host work since the step before)."""
from bench.stats import median


def read(run):
    m = median([s.charge_s for s in run.steps if s.kind == "decode"])
    return None if m is None else 1e3 * m
