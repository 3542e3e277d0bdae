"""How unevenly Nemotron-H's router spreads the rows over its 128 experts (1:
even; 128: every row to one expert): ``expert_load.moe``'s reader, over the ranges and the
``work()`` of the Nemotron-H driver."""

import runpy
from pathlib import Path

read = runpy.run_path(str(Path(__file__).with_name("expert_load.moe.py")))["read"]
