"""The weight-only int8 GEMMs' share of their roofline (%) in the Nemotron-H
cell (the Mamba-2 blocks' W_in and W_out, the attention blocks' q|k|v and
W_o, the shared experts and the head): ``w8_gemm_roofline``'s reader, over
the ranges and the ``work()`` of the Nemotron-H driver."""

import runpy
from pathlib import Path

read = runpy.run_path(str(Path(__file__).with_name("w8_gemm_roofline.py")))["read"]
