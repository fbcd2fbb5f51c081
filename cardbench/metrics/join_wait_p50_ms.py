"""join_wait_p50_ms: median over the window's finished requests of the
time from a slot taking the request (``slot_t``) until the step carrying
its prefill was dispatched (``prefill_t``): the wait for the step in
flight.  A median, not a tail: the traced run's profiled stretch slows
the steps of a few per cent of the requests, enough to set a p95 but not
the median.  None where the program stamps neither."""
from bench.stats import median


def read(run):
    m = median([c.prefill_t - c.slot_t for c in run.completions.values()
                if getattr(c, "slot_t", None) is not None
                and getattr(c, "prefill_t", None) is not None])
    return None if m is None else 1e3 * m
