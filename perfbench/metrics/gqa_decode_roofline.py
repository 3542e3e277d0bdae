"""The grouped-query decode attention's share of its roofline (%): the least
time of every ``decode_gqa_attention_stacked`` call in the sub-window (the
larger of its two products at the bf16 peak and the bytes of q, the keys
and values of the S slots the call is given, the f32 mask and the output
at the memory rate) over the device time of the work launched inside
those calls' ranges (``gqa_decode_attention``)."""


def read(ctx):
    if ctx.trace is None or not ctx.work.get("gqa_calls"):
        return None
    dev = ctx.trace.device_s_under(["gqa_decode_attention"])
    return 100.0 * ctx.work["gqa_bound_s"] / dev if dev > 0 else None
