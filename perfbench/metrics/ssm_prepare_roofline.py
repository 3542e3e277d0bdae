"""The Mamba-2 preparation's share of its roofline (%): the least time of
every ``ssm_prepare`` call in the sub-window (the convolution's inputs and
windows, the steps' inputs, the x | B | C and the f32 steps out, by bytes
at the memory rate) over the device time of the work launched inside those
calls' ranges."""


def read(ctx):
    if ctx.trace is None or not ctx.work.get("ssm_prepare_calls"):
        return None
    dev = ctx.trace.device_s_under(["ssm_prepare"])
    return 100.0 * ctx.work["ssm_prepare_bound_s"] / dev if dev > 0 else None
