"""``detect_host_ms.detect`` in the Nemotron-H cell: the same reading of the
``detect.batch`` spans that ``process_stream``'s detection stage makes."""

from pathlib import Path

from perfbench.run import load_reader

read = load_reader("detect_host_ms.detect", Path(__file__).resolve().parents[1])
