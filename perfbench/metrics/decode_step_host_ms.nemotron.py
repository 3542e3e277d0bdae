"""Host time of one step of the Nemotron-H decode's token loop (ms): the
mean ``nemotron.decode_step`` span (sampling, masks, the blocks' launches)
over the steps that started in the profiled sub-window."""

from perfbench import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, "nemotron.decode_step")
