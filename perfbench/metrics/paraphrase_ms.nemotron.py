"""Host time per batch inside the paraphrase adapter's ``batch_async`` and
the finalizer it returns (ms) in the Nemotron-H cell: ``paraphrase_ms.tvc``'s
reader, over the ``work()`` of the Nemotron-H driver."""

import runpy
from pathlib import Path

read = runpy.run_path(str(Path(__file__).with_name("paraphrase_ms.tvc.py")))["read"]
