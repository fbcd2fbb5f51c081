"""prefill_step_p50_ms: median over the window's finished requests of
the time from the dispatch of the step carrying the request's prefill
(``prefill_t``) to its first token: the request's own prefill step.  A
median, not a tail: the traced run's profiled stretch slows the steps of
a few per cent of the requests, enough to set a p95 but not the median.
None where the program stamps no ``prefill_t``."""
from bench.stats import median


def read(run):
    m = median([c.first_token_t - c.prefill_t
                for c in run.completions.values()
                if getattr(c, "prefill_t", None) is not None])
    return None if m is None else 1e3 * m
