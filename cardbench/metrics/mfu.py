"""mfu: the model operations the window's traffic needs (``bench.counts.
request_flops``: 2 per multiply-add of the weights each token uses, for a
mixture of experts only its top-k experts, causal attention at each
token's position, one unembedding per output token; a shared prefix
counted once, at its first use in the window) over the window's length
times the card's bf16 peak, in percent."""
from bench import counts


def read(run):
    if run.window_s <= 0:
        return None
    p = run.cell.mix["prompt"]
    seen = set()
    total = 0
    for a in sorted(run.arrivals, key=lambda a: (a.due_s, a.rid)):
        c = run.completions.get(a.rid)
        if c is None:
            continue
        start = 0
        if a.prefix >= 0:
            if a.prefix in seen:
                start = int(p["prefix_tokens"])
            seen.add(a.prefix)
        total += counts.request_flops(run.shape, len(a.prompt),
                                      len(c.tokens), start)
    return 100.0 * total / (run.window_s * counts.PEAK_FLOPS_BF16)
