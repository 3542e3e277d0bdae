"""The KDA preparation's share of its roofline (%): the least time of every
``kda_prepare`` call in the sub-window (the convolution's inputs and
windows, the gate's and beta's inputs, the f32 q, k, v, g and beta out,
by bytes at the memory rate) over the device time of the work launched
inside those calls' ranges."""


def read(ctx):
    if ctx.trace is None or not ctx.work.get("kda_prepare_calls"):
        return None
    dev = ctx.trace.device_s_under(["kda_prepare"])
    return 100.0 * ctx.work["kda_prepare_bound_s"] / dev if dev > 0 else None
