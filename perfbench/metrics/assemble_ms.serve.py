"""Host time the serving runtime spends concatenating and padding a
micro-batch's images (ms): the mean, over the program's ``serve.batch``
spans that started in the profiled sub-window, of their ``serve.assemble``
children summed (one for the whole batch, one per chunk of the largest
bucket)."""

from perfbench import program_spans


def read(ctx):
    return program_spans.children_ms(ctx, "serve.batch", ("serve.assemble",))
