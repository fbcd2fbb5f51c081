"""queue_wait_p95_ms: 95th percentile over every request of the time from
its due time until a slot of the engine took it (the harness stamps the
handler's slot admission on the serving timeline; the handler's own
``admitted_t`` is the time the queue took it, which is the due time)."""
from bench.stats import percentile


def read(run):
    waits = [run.slot_admit[r] - due if r in run.slot_admit
             else float("inf") for r, due in run.due.items()]
    return 1e3 * percentile(waits, 95)
