"""Mean host time of the pipeline's ``detection`` stage over the window's
batches (ms) in the Nemotron-H cell: ``detection_ms.tvc``'s reader, over
the ``work()`` of the Nemotron-H driver."""

import runpy
from pathlib import Path

read = runpy.run_path(str(Path(__file__).with_name("detection_ms.tvc.py")))["read"]
