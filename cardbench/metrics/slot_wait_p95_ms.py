"""slot_wait_p95_ms: 95th percentile over every request of the window of
the time from its due time until a slot of the engine took it, from the
program's own stamp (``ServeCompletion.slot_t``); a request with no
completion or no stamp counts as infinitely late.  None where the program
stamps no ``slot_t``."""
from bench.stats import percentile


def read(run):
    if not any(hasattr(c, "slot_t") for c in run.completions.values()):
        return None
    waits = []
    for rid, due in run.due.items():
        t = getattr(run.completions.get(rid), "slot_t", None)
        waits.append(float("inf") if t is None else t - due)
    return 1e3 * percentile(waits, 95)
