"""The Qwen2 weight-only int8 GEMMs' share of their roofline (%): the least
time of every ``w8_matmul`` / ``w8_matmul_stacked`` call in the sub-window
(the larger of 2 M K N operations at the bf16 peak and the bytes of x, the
int8 weight, its scales and the output at the memory rate) over the device
time of the work launched inside those calls' ranges."""


def read(ctx):
    if ctx.trace is None or not ctx.work.get("w8_calls"):
        return None
    dev = ctx.trace.device_s_under(["w8_gemm"])
    return 100.0 * ctx.work["w8_bound_s"] / dev if dev > 0 else None
