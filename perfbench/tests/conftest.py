"""Helpers of the benchmark's CPU tests: a copy of the benchmark in a
temporary directory with the cells cut to tiny widths, so that a whole run
fits a test."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from perfbench import common

TINY_CLIP = dict(image_size=32, patch_size=16, vision_width=64, vision_layers=2, vision_heads=2,
                 text_width=64, text_layers=2, text_heads=2, embed_dim=32, bank_rows=1024)
TINY_QWEN = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
                 num_key_value_heads=2)


def _edit(path: Path, fn) -> None:
    d = json.loads(path.read_text())
    fn(d)
    path.write_text(json.dumps(d))


def tiny_bench(tmp: Path) -> Path:
    """A checkout-like directory: ``BENCHMARK.json`` and ``perfbench/``
    with every configuration, mix and check cut to a size a CPU test holds.
    Returns the copy's ``perfbench`` directory."""
    bd = tmp / "perfbench"
    shutil.copytree(common.BENCH_DIR, bd, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(common.ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    _edit(bd / "configs" / "clip-vit-b32-int8.json", lambda d: d.update(TINY_CLIP))

    def tvc(d):
        d["clip"].update(TINY_CLIP)
        d["qwen"].update(TINY_QWEN)
        d["max_new_tokens"] = 8

    _edit(bd / "configs" / "tvc-qwen2-1.5b-w8.json", tvc)
    for mix in (bd / "traffic").glob("*.json"):
        _edit(mix, lambda d: d.update(batch=6 if d.get("batch", 0) < 256 else 8, image_batches=2)
              if "batch" in d else d.update(rate_qps=100.0, image_pool=64, clients=16))
    for wl in (bd / "workloads").glob("*.json"):
        def cut(d):
            d["check"]["rows"] = 12
            if "sequences" in d["check"]:
                d["check"]["sequences"] = min(3, d["check"]["sequences"])
        _edit(wl, cut)
    return bd


@pytest.fixture
def tiny(tmp_path) -> Path:
    return tiny_bench(tmp_path)
