"""The mixture-of-experts block's share of the device's busy time at
Nemotron-H's 128 experts: ``moe_share.moe``'s reader, over the ranges and the
``work()`` of the Nemotron-H driver."""

import runpy
from pathlib import Path

read = runpy.run_path(str(Path(__file__).with_name("moe_share.moe.py")))["read"]
