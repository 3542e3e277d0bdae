"""Full TVC with the DeepSeek-V2 paraphraser: its share of the card's peak
(%). The sub-window's w8 GEMMs (attention projections, dense layer, shared
experts, head), grouped expert GEMMs, the absorbed up-projections, the
latent attention, the router and the detector's products, counted by
``work.py`` / ``work_moe.py`` from the shapes each call ran at, each at the
peak rate of its operand type, over the sub-window's wall time. The
prefill's decompressed attention products are not counted."""

from perfbench import work


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0 or not ctx.work.get("expert_calls") or not ctx.work["ops"]:
        return None
    return 100.0 * work.peak_seconds(ctx.work["ops"]) / ctx.trace.window_s
