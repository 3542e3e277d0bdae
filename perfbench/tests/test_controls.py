"""The control of each cell, at tiny widths on the CPU: the reference one
precision below (int4), put in the program's place, reads at least three
times what the program reads on the same rows. The card's readings at the
cells' own sizes are in PERF.md (``python3 -m perfbench.controls``)."""

import pytest

from perfbench import controls
from perfbench.tests.conftest import tiny_bench


def test_detect_control_reads_far_above_the_program(tmp_path):
    import time

    from perfbench import run

    bd = tiny_bench(tmp_path)
    cell = "clip-vit-b32-int8.batch256"
    prog = run.run_cell(cell, 41, 1.0, False, device="cpu", bench_dir=bd, root=bd.parent,
                        t_start=time.perf_counter())["checks"]
    ctl = controls.control(cell, 41, 4, "cpu", bd)
    assert ctl["score_gap"] > 3 * prog["score_gap"]["value"]
    assert ctl["topk_gap"] > 3 * prog["topk_gap"]["value"]


@pytest.mark.parametrize("cell", ["tvc-qwen2-1.5b-w8.fresh", "tvc-qwen2-1.5b-w8.cached"])
def test_pipeline_control_reads_far_above_the_program(tmp_path, cell):
    bd = tiny_bench(tmp_path)
    got = controls.control(cell, 43, 2, "cpu", bd)
    prog, ctl = got["program"], got["control"]
    assert ctl["score_gap"] > 3 * prog["score_gap"]
    if "decode_gap" in prog:
        assert ctl["decode_gap"] > 3 * max(prog["decode_gap"], 1e-3)


def test_serving_control_reads_far_above_the_program(tmp_path):
    import time

    from perfbench import run

    bd = tiny_bench(tmp_path)
    cell = "clip-vit-b32-int8.saturated"
    prog = run.run_cell(cell, 47, 2.0, False, device="cpu", bench_dir=bd, root=bd.parent,
                        t_start=time.perf_counter())["checks"]
    ctl = controls.control(cell, 47, 2, "cpu", bd)
    assert ctl["score_gap"] > 3 * prog["score_gap"]["value"]
