"""The grouped weight-only int8 expert GEMM's share of its roofline (%):
the least time of every ``moe_w8_grouped_gemm`` call in the sub-window (the
larger of 2 x assignments x K x N operations at the bf16 peak and the bytes
of the int8 weights and scales of every expert that received rows, the rows
in and the output out, at the memory rate) over the device time of the
work launched inside those calls' ``expert_gemm`` ranges."""


def read(ctx):
    if ctx.trace is None or not ctx.work.get("expert_calls"):
        return None
    dev = ctx.trace.device_s_under(["expert_gemm"])
    return 100.0 * ctx.work["expert_bound_s"] / dev if dev > 0 else None
