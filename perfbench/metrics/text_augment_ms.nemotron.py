"""Host time of the pipeline's text augmentation per batch (ms) in the
Nemotron-H cell: ``text_augment_ms.tvc``'s reading of the
``pipeline.text_augment`` and ``pipeline.text_augment.finalize`` spans."""

import runpy
from pathlib import Path

read = runpy.run_path(str(Path(__file__).with_name("text_augment_ms.tvc.py")))["read"]
