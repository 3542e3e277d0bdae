"""Full TVC with the Kimi-Linear paraphraser: its share of the card's peak (%),
the KDA kernels' f32 products (``work_kda.py``) among the work counted:
``mfu.moe``'s reader, over the ranges and the ``work()`` of the Kimi-Linear
driver."""

import runpy
from pathlib import Path

read = runpy.run_path(str(Path(__file__).with_name("mfu.moe.py")))["read"]
