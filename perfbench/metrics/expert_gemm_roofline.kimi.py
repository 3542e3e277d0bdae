"""The grouped weight-only int8 expert GEMM's share of its roofline (%) at
Kimi-Linear's 256 experts: ``expert_gemm_roofline``'s reader, over the
ranges and the ``work()`` of the Kimi-Linear driver."""

import runpy
from pathlib import Path

read = runpy.run_path(str(Path(__file__).with_name("expert_gemm_roofline.py")))["read"]
