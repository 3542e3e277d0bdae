"""The mixture-of-experts block's share of the device's busy time: device
time of the work launched inside ``moe_block`` ranges (the router, the
counts and sort, both grouped GEMMs, the combine and the shared experts)
over the sub-window's busy time."""


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0 or not ctx.work.get("expert_calls"):
        return None
    return ctx.trace.device_s_under(["moe_block"]) / ctx.trace.busy_s
