"""ttft_p95_ms.overload: ttft_p95_ms (see its file) in a cell offered
more than the system completes, where the queue grows all through the
window and the tail swings with the smallest change; read there as a
per-layer metric that moves output_tok_s."""
from bench.cells import reader

read = reader("ttft_p95_ms")
