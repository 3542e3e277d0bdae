"""The detector step's share of the card's peak (%): the sub-window's
matrix products (int8 tower GEMMs, bf16 attention products, the bf16 patch
embedding, the f32 projections and bank scores; counted by ``work.py`` from
the shapes each call ran at), each at the peak rate of its operand type,
over the sub-window's wall time."""

from perfbench import work


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0 or not ctx.work["ops"]:
        return None
    return 100.0 * work.peak_seconds(ctx.work["ops"]) / ctx.trace.window_s
