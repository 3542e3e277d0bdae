"""The device's idle share of the Nemotron-H cell's profiled sub-window: ``idle_share.moe``'s reader, over the ranges and the
``work()`` of the Nemotron-H driver."""

import runpy
from pathlib import Path

read = runpy.run_path(str(Path(__file__).with_name("idle_share.moe.py")))["read"]
