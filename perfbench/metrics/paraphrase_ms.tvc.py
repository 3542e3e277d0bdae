"""Host time per batch inside the paraphrase adapter's ``batch_async``
(the decode, queued up to its last chunk) plus inside the finalizer it
returns (readback and detokenization), over the traced sub-window's
batches (ms)."""


def read(ctx):
    return ctx.work.get("paraphrase_ms")
