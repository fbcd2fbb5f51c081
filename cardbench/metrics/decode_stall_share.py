"""decode_stall_share: the share of the window's decoding time spent in
steps that also carried other requests' prefill, in percent: the sum of
``ServeCompletion.stall_s`` over the sum of (last token's time - first
token's time), over the finished requests with two tokens or more.  None
where the program counts no ``stall_s``."""


def read(run):
    stall = span = 0.0
    for c in run.completions.values():
        if not hasattr(c, "stall_s"):
            return None
        if len(c.tokens) >= 2 and len(c.token_ts) == len(c.tokens):
            stall += c.stall_s
            span += c.token_ts[-1] - c.token_ts[0]
    return 100.0 * stall / span if span > 0 else None
