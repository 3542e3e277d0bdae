"""The Mamba-2 gated grouped norm's share of its roofline (%): the least
time of every ``ssm_gated_norm`` call in the sub-window (y and the gate z
in, the output out, by bytes at the memory rate) over the device time of
the work launched inside those calls' ranges."""


def read(ctx):
    if ctx.trace is None or not ctx.work.get("ssm_gated_norm_calls"):
        return None
    dev = ctx.trace.device_s_under(["ssm_gated_norm"])
    return 100.0 * ctx.work["ssm_gated_norm_bound_s"] / dev if dev > 0 else None
