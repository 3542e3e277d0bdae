"""A whole run, the look for a card skipped, with the timed path broken
underneath: each fault a cell can have must turn ``correct`` false, and the
unbroken run must stay true. Tiny widths on the CPU; the limits are set
for them here (the cells' own limits are set from the card's readings at
full width)."""

import json
import time

import numpy as np
import pytest

from perfbench import run
from perfbench.tests.conftest import tiny_bench

TINY_LIMITS = {"score_gap": 0.05, "topk_gap": 0.05, "flag_flips": 0, "decode_gap": 0.5}


def _bench(tmp_path, cell):
    bd = tiny_bench(tmp_path)
    p = bd / "workloads" / f"{cell}.json"
    wl = json.loads(p.read_text())
    wl["check"]["limits"] = {k: TINY_LIMITS[k] for k in wl["check"]["limits"]}
    p.write_text(json.dumps(wl))
    return bd


def _run(bd, cell, seconds=1.5):
    return run.run_cell(cell, 2**31 + 99, seconds, False, device="cpu", bench_dir=bd, root=bd.parent,
                        t_start=time.perf_counter())


def _shift_scores(res):
    res.aggregated_score = np.asarray(res.aggregated_score) + 0.2
    return res


def _flip_flags(res):
    res.is_adversarial = ~np.asarray(res.is_adversarial, bool)
    return res


def _other_refs(res):
    res.details["ref_idx"] = (np.asarray(res.details["ref_idx"]) + 1) % 1024
    return res


@pytest.mark.parametrize("fault", [None, _shift_scores, _flip_flags, _other_refs])
def test_detect_cell_catches_an_answer_altered_where_produced(tmp_path, monkeypatch, fault):
    from tvc_torch.detector import AdversarialDetector

    cell = "clip-vit-b32-int8.batch256"
    bd = _bench(tmp_path, cell)
    if fault is not None:
        orig = AdversarialDetector._detect_batch_fused
        monkeypatch.setattr(AdversarialDetector, "_detect_batch_fused", lambda self, *a, **k: fault(orig(self, *a, **k)))
    out = _run(bd, cell)
    assert out["correct"] is (fault is None), out["checks"]
    assert list(out)[-1] == "checks"


def _alter_tokens(monkeypatch):
    from tvc_torch.models.qwen import QwenModel

    orig = QwenModel.decode

    def decode(self, inp, *a, **k):
        rows = orig(self, inp, *a, **k)
        rows[:, 0] = (rows[:, 0] + 7919) % 150000  # the first served token of every row replaced
        return rows

    monkeypatch.setattr(QwenModel, "decode", decode)


def _alter_scores(monkeypatch):
    from tvc_torch.detector import AdversarialDetector

    orig = AdversarialDetector._detect_batch_fused
    monkeypatch.setattr(AdversarialDetector, "_detect_batch_fused",
                        lambda self, *a, **k: _shift_scores(orig(self, *a, **k)))


@pytest.mark.parametrize("cell,fault", [
    ("tvc-qwen2-1.5b-w8.fresh", None),
    ("tvc-qwen2-1.5b-w8.fresh", _alter_tokens),
    ("tvc-qwen2-1.5b-w8.fresh", _alter_scores),
    ("tvc-qwen2-1.5b-w8.cached", None),
    ("tvc-qwen2-1.5b-w8.cached", _alter_scores),
])
def test_pipeline_cells_catch_a_token_or_answer_altered_where_produced(tmp_path, monkeypatch, cell, fault):
    bd = _bench(tmp_path, cell)
    if fault is not None:
        fault(monkeypatch)
    out = _run(bd, cell, seconds=2.0)
    assert out["correct"] is (fault is None), out["checks"]


@pytest.mark.parametrize("fault", [None, _shift_scores, _flip_flags])
def test_serving_cell_catches_an_answer_altered_where_produced(tmp_path, monkeypatch, fault):
    from tvc_torch.detector import AdversarialDetector

    cell = "clip-vit-b32-int8.saturated"
    bd = _bench(tmp_path, cell)
    if fault is not None:
        orig = AdversarialDetector._detect_batch_fused
        monkeypatch.setattr(AdversarialDetector, "_detect_batch_fused", lambda self, *a, **k: fault(orig(self, *a, **k)))
    out = _run(bd, cell, seconds=2.0)
    assert out["correct"] is (fault is None), out["checks"]


def test_serving_cell_counts_an_unanswered_request(tmp_path, monkeypatch):
    from tvc_torch.serving import ServingRuntime

    cell = "clip-vit-b32-int8.saturated"
    bd = _bench(tmp_path, cell)
    orig = ServingRuntime._run_batch
    calls = []

    def run_batch(self, batch):
        calls.append(1)
        if len(calls) == 3:  # one micro-batch's requests get an error instead of answers
            for r in batch:
                r.error = "dropped"
                r.event.set()
            return None
        return orig(self, batch)

    monkeypatch.setattr(ServingRuntime, "_run_batch", run_batch)
    out = _run(bd, cell, seconds=2.0)
    assert out["failed"] > 0 and out["correct"] is False
