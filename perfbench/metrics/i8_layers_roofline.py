"""The int8 tower layers' share of their roofline (%): the least time of
every int8 attention and MLP sub-block call in the sub-window (the larger
of its operations at the int8 / bf16 peaks and its bytes at the memory
rate, from the shapes it ran at) over the device time of the work launched
inside those calls' ranges."""


def read(ctx):
    if ctx.trace is None or not ctx.work.get("i8_layer_calls"):
        return None
    dev = ctx.trace.device_s_under(["i8_attention_layer", "i8_mlp_layer"])
    return 100.0 * ctx.work["i8_layers_bound_s"] / dev if dev > 0 else None
