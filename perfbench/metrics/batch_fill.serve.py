"""Queries over padded bucket rows of the serving runtime's micro-batches
in the window, from ``ServingRuntime``'s counters (``batch_size_sum`` and
``batch_bucket_counts``)."""


def read(ctx):
    return ctx.work.get("batch_fill")
