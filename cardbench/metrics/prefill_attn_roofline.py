"""prefill_attn_roofline: the least time of the prefill attention the
traced steps asked for (cold batched prefills and chunked suffix prefills,
``bench.counts``) over the device time of the kernels that
``cardbench/kernels/prefill_attn/`` names, in percent."""


def read(run):
    if run.trace is None or not run.prefill_work.groups:
        return None
    t = run.trace.op_seconds("prefill_attn")
    if t <= 0:
        return None
    return 100.0 * run.prefill_work.least_s(run.shape.layers) / t
