"""The KDA layers' share of the device's busy time: device time of the work
launched inside ``kda_block`` ranges (one KDA layer from its merged GEMM
through the output projection) over the sub-window's busy time."""


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0 or not ctx.work.get("kda_calls"):
        return None
    return ctx.trace.device_s_under(["kda_block"]) / ctx.trace.busy_s
