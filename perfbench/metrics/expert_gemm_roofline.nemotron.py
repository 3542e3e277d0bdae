"""The grouped weight-only int8 expert GEMM's share of its roofline (%) at
Nemotron-H's 128 non-gated experts (up N 1,856, down K 1,856):
``expert_gemm_roofline``'s reader, over the ranges and the ``work()`` of
the Nemotron-H driver."""

import runpy
from pathlib import Path

read = runpy.run_path(str(Path(__file__).with_name("expert_gemm_roofline.py")))["read"]
