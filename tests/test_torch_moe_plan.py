"""The grouped expert GEMM's plan, on the CPU, and a model of its work list.

``moe_plan`` picks the row tile from the mean rows an expert at both MoE
configurations' decode and prefill shapes, with a ring that fits the
block's shared memory, and the shapes ``chip_smoke`` and the card tests
hold against the plain version run every row tile it can pick.
``_work_items`` is a Python model of the list each block of ``moe_w8.cu``
derives from the offsets (``item_at`` and the prefix): these cases show
that the walk it describes covers every busy expert's rows exactly once in
each column tile, touches no empty expert and nothing past ``offsets[E]``.
That the device walks it so is shown on the card only, by the grouped
GEMM's card tests against the plain version.
"""

import numpy as np
import pytest

from chip_smoke import MOE_CASES, moe_spread
from tvc_torch.core.kernels.moe_kernel import (
    MOE_BN,
    MOE_MAX_EXPERTS,
    MOE_ROWS,
    _SMEM,
    _smem,
    moe_plan,
    moe_stages,
)


def _work_items(offsets, rows, N):
    """The work list as ``moe_w8.cu`` derives it, item by item: ``(expert,
    first row, rows, first channel)``. Expert e has ``ceil(rows_e / rows)``
    row tiles times ``ceil(N / 256)`` column tiles of items, column tile
    outer and row tile inner, the experts in order; item i belongs to the
    last expert whose items start at or before i (a binary search over the
    prefix)."""
    off = [int(o) for o in offsets]
    E, nt = len(off) - 1, -(-N // MOE_BN)
    pre = [0]
    for e in range(E):
        n = off[e + 1] - off[e]
        pre.append(pre[-1] + (-(-n // rows) * nt if n > 0 else 0))
    items = []
    for i in range(pre[E]):
        lo, hi = 0, E
        while hi - lo > 1:
            mid = (lo + hi) >> 1
            lo, hi = (mid, hi) if pre[mid] <= i else (lo, mid)
        tiles = -(-(off[lo + 1] - off[lo]) // rows)
        c, rt = divmod(i - pre[lo], tiles)
        m0 = off[lo] + rt * rows
        items.append((lo, m0, min(rows, off[lo + 1] - m0), c * MOE_BN))
    return items


@pytest.mark.parametrize("M,E,N,K,rows", [
    (480 * 8, 256, 2048, 2304, 32),      # Kimi-Linear decode, gate|up (~15 rows an expert)
    (480 * 8, 256, 2304, 1024, 32),      # and down
    (96 * 24 * 8, 256, 2048, 2304, 128),  # Kimi-Linear's suffix prefill (~72)
    (16 * 8, 256, 2048, 2304, 16),       # Kimi-Linear's shared-prefix prefill (half a row)
    (960 * 6, 64, 2816, 2048, 128),      # DeepSeek-V2-Lite decode, gate|up (~90)
    (960 * 6, 64, 2048, 1408, 128),      # and down
    (3072 * 6, 64, 2816, 2048, 128),     # DeepSeek-V2-Lite prefill (~290)
    (16 * 6, 64, 2816, 2048, 16),        # DeepSeek-V2-Lite's shared-prefix prefill (1.5)
    (64 * 6, 64, 2816, 2048, 16),        # a small decode batch (6 an expert)
    (64 * 16, 64, 2816, 2048, 32),       # 16 an expert
    (64 * 30, 64, 2816, 2048, 128),      # 30 an expert: past 32, the widest tile
])
def test_plan_picks_the_row_tile_from_the_mean_rows_an_expert(M, E, N, K, rows):
    plan = moe_plan(M, E, N, K)
    assert (plan.rows, plan.counter) == (rows, f"moe.gemm_plan.swap{rows}")
    assert plan.stages == moe_stages(rows) >= 6
    assert _smem(plan.rows, plan.stages, MOE_MAX_EXPERTS) <= _SMEM
    assert moe_plan(M, E, N, K) is plan  # cached: the wrapper's host work stays one lookup


@pytest.mark.parametrize("rows", MOE_ROWS)
def test_ring_fills_the_shared_memory_a_row_tile_leaves(rows):
    """One more stage would not fit beside the largest expert table."""
    s = moe_stages(rows)
    assert s >= 6 and _smem(rows, s, MOE_MAX_EXPERTS) <= _SMEM
    assert s == 12 or _smem(rows, s + 1, MOE_MAX_EXPERTS) > _SMEM


@pytest.mark.parametrize("case,E,rows", [
    ("dsv2_step", 64, 128), ("dsv2_decode", 64, 128), ("dsv2_prefill", 64, 128), ("dsv2_prefix", 64, 16),
    ("kimi_decode", 256, 32), ("kimi_prefill", 256, 128), ("kimi_prefix", 256, 16),
])
def test_each_held_spread_takes_the_tile_its_cell_counts(case, E, rows):
    """The spreads ``chip_smoke`` times and the card tests hold take the
    tile the cells' ``moe.gemm_plan.*`` counters show for that call: the
    decodes ``swap32`` (Kimi-Linear) and ``swap128`` (DeepSeek-V2-Lite), the
    suffix prefills ``swap128``, the shared prefix's prefill ``swap16``."""
    counts = moe_spread(case)
    assert len(counts) == E and counts.min() >= 0
    assert moe_plan(int(counts.sum()), E, 2048, 2304).rows == rows


def test_the_timed_shapes_run_every_row_tile():
    """No instantiation of the kernel goes unheld: ``chip_smoke.MOE_CASES``
    runs each row tile ``moe_plan`` can pick."""
    picked = {moe_plan(int(moe_spread(case).sum()), E, N, K).rows for case, _, E, K, N in MOE_CASES}
    assert picked == set(MOE_ROWS)


def _offsets(kind: str, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "kimi_decode":  # 3,840 rows over 256 experts, skewed, some empty
        counts = rng.multinomial(3840, rng.dirichlet(np.full(256, 0.3)))
        counts[rng.choice(256, 8, replace=False)] = 0
        counts[rng.choice(256, 4, replace=False)] = 1
    elif kind == "dsv2_decode":  # 5,760 rows over 64 experts, one busy
        counts = rng.multinomial(5760, rng.dirichlet(np.full(64, 0.5)))
        counts[rng.integers(64)] += 700
    elif kind == "single":  # every row to one expert
        counts = np.zeros(64, np.int64)
        counts[rng.integers(64)] = int(rng.integers(1, 600))
    elif kind == "empty":  # no rows at all
        counts = np.zeros(32, np.int64)
    else:  # "short": rows sorted past offsets[E] belong to no expert
        counts = rng.multinomial(500, rng.dirichlet(np.full(48, 1.0)))
    off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    M = int(off[-1]) + (37 if kind == "short" else 0)
    return off, M


@pytest.mark.parametrize("kind,seed", [("kimi_decode", 0), ("kimi_decode", 1), ("dsv2_decode", 2),
                                       ("dsv2_decode", 3), ("single", 4), ("single", 5), ("empty", 6),
                                       ("short", 7), ("short", 8)])
@pytest.mark.parametrize("rows", MOE_ROWS)
def test_work_list_covers_every_busy_experts_rows_once(kind, seed, rows):
    off, M = _offsets(kind, seed)
    E, N = len(off) - 1, 2304  # nine column tiles, the last one full
    items = _work_items(off, rows, N)
    covered = np.zeros((M, -(-N // MOE_BN)), np.int64)
    for e, m0, r, n0 in items:
        assert off[e + 1] > off[e], "an item of an expert with no rows"
        assert 1 <= r <= rows and off[e] <= m0 and m0 + r <= off[e + 1]
        assert n0 % MOE_BN == 0 and n0 < N
        covered[m0 : m0 + r, n0 // MOE_BN] += 1
    assert (covered[: off[-1]] == 1).all(), "a row of a busy expert missed or taken twice"
    assert (covered[off[-1] :] == 0).all(), "a row past offsets[E]"
    # an expert's row tiles lie next to each other, column tile outer
    tiles = -(-(off[1:] - off[:-1]) // rows)
    assert len(items) == int(tiles.sum()) * (-(-N // MOE_BN))
    assert [it[0] for it in items] == sorted(it[0] for it in items)
