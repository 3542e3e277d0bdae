"""Host time of one step of the DeepSeek-V2 decode's token loop (ms): the
mean ``dsv2.decode_step`` span (sampling, masks, the routing's and the
layers' launches) over the steps that started in the profiled
sub-window."""

from perfbench import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, "dsv2.decode_step")
