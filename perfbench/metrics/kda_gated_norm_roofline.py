"""The KDA gated output norm's share of its roofline (%): the least time of
every ``kda_gated_norm`` call in the sub-window (o and the gate in, the
output out, by bytes at the memory rate) over the device time of the work
launched inside those calls' ranges."""


def read(ctx):
    if ctx.trace is None or not ctx.work.get("kda_gated_norm_calls"):
        return None
    dev = ctx.trace.device_s_under(["kda_gated_norm"])
    return 100.0 * ctx.work["kda_gated_norm_bound_s"] / dev if dev > 0 else None
