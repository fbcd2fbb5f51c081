"""ttft_p95_ms: 95th percentile over every request of the window of its
first token's time minus its due time; a request that never answered
counts as infinitely late."""
from bench.stats import percentile


def read(run):
    ttft = []
    for rid, due in run.due.items():
        c = run.completions.get(rid)
        ttft.append(float("inf") if c is None else c.first_token_t - due)
    return 1e3 * percentile(ttft, 95)
