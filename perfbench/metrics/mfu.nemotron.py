"""Full TVC with the Nemotron-H paraphraser: its share of the card's peak (%),
the SSM kernels' f32 products and the squared ReLU (``work_ssm.py``) among the
work counted: ``mfu.moe``'s reader, over the ranges and the
``work()`` of the Nemotron-H driver."""

import runpy
from pathlib import Path

read = runpy.run_path(str(Path(__file__).with_name("mfu.moe.py")))["read"]
