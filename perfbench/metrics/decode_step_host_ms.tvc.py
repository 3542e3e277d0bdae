"""Host time of one step of the Qwen2 decode's token loop (ms): the mean
``qwen.decode_step`` span (sampling, masks, the layers' launches) over the
steps that started in the profiled sub-window."""

from perfbench import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, "qwen.decode_step")
