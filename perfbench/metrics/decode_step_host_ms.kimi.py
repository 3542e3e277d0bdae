"""Host time of one step of the Kimi-Linear decode's token loop (ms): the
mean ``kimi.decode_step`` span (sampling, masks, the layers' launches)
over the steps that started in the profiled sub-window."""

from perfbench import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, "kimi.decode_step")
