"""A run that finds no card fails and prints no result; so does a run in a
directory that holds only the benchmark."""

import os
import shutil
import subprocess
import sys

import pytest

from perfbench import common

ARGS = ["-m", "perfbench.run", "--workload", "clip-vit-b32-int8.batch256", "--seed", "3000000001",
        "--seconds", "1", "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, *ARGS], capture_output=True, text=True, cwd=cwd, timeout=300,
                          env=env)


def test_no_card_fails_without_a_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(common.ROOT, env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "card" in out.stderr


def test_the_benchmark_alone_fails_without_a_result(tmp_path):
    shutil.copytree(common.BENCH_DIR, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(common.ROOT / "BENCHMARK.json", tmp_path)
    out = _run(tmp_path, dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
def test_one_short_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = _run(common.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    import json

    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"
