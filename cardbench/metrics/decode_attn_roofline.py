"""decode_attn_roofline: the least time of the decode attention the traced
steps asked for (``bench.counts.decode_attn``, from the steps' positions,
budgets and block tables) over the device time of the kernels that
``cardbench/kernels/decode_attn/`` names, in percent."""


def read(run):
    if run.trace is None or not run.decode_work.groups:
        return None
    t = run.trace.op_seconds("decode_attn")
    if t <= 0:
        return None
    return 100.0 * run.decode_work.least_s(run.shape.layers) / t
