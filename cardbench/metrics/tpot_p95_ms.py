"""tpot_p95_ms: 95th percentile over every request of the window of
(last token's time - first token's time) / (tokens - 1), from the
handler's streamed delivery stamps; a request that never answered counts
as infinitely late."""
from bench.stats import percentile


def tpot_s(c):
    n = len(c.tokens)
    if n < 2 or len(c.token_ts) != n:
        return float("inf")
    return (c.token_ts[-1] - c.token_ts[0]) / (n - 1)


def read(run):
    vals = [tpot_s(run.completions[r]) if r in run.completions
            else float("inf") for r in run.due]
    return 1e3 * percentile(vals, 95)
