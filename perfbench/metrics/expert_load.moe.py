"""How unevenly the router spreads the rows: the mean rows of the busiest
expert of a layer-step over the mean rows an expert gets, from the
program's counters ``moe.rows_max``, ``moe.assignments`` and
``moe.layer_steps`` read where the profiled sub-window starts and stops
(1: even; 64: every row to one expert)."""


def read(ctx):
    return ctx.work.get("expert_load")
