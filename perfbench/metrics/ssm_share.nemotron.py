"""The Mamba-2 blocks' share of the device's busy time: device time of the
work launched inside ``ssm_block`` ranges (one SSM block from its W_in GEMM
through W_out) over the sub-window's busy time."""


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0 or not ctx.work.get("ssm_calls"):
        return None
    return ctx.trace.device_s_under(["ssm_block"]) / ctx.trace.busy_s
