"""Full TVC's share of the card's peak (%): the sub-window's Qwen2 prefill,
decode and tied-head products and the detector's (as in ``mfu.detect``),
counted by ``work.py`` from the shapes each call ran at, each at the peak
rate of its operand type, over the sub-window's wall time."""

from perfbench import work


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0 or not ctx.work["ops"]:
        return None
    return 100.0 * work.peak_seconds(ctx.work["ops"]) / ctx.trace.window_s
