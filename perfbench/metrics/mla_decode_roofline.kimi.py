"""The latent decode attention's share of its roofline (%) at Kimi-Linear's 32
heads: ``mla_decode_roofline``'s reader, over the ranges and the ``work()``
of the Kimi-Linear driver."""

import runpy
from pathlib import Path

read = runpy.run_path(str(Path(__file__).with_name("mla_decode_roofline.py")))["read"]
