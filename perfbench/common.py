"""Shared plumbing of the benchmark: where its files are, how a cell, a
configuration and a mix are found by name, the card's identity, and the
check that nothing of the JAX package was loaded.

Nothing here imports the program under test (``tvc_torch``)."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
#: the build and kernel caches of a run: fixed paths inside the checkout,
#: so that only the first run of a cell there builds and compiles
CACHE_DIR = ROOT / "build" / "perfbench_cache"

#: top-level module names that may not be loaded by a run (compared whole:
#: ``tvc_torch`` is the program, ``tvc`` the JAX package)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "tvc")


def load_json(path: Path) -> Dict[str, Any]:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def workload(name: str, bench_dir: Path = BENCH_DIR) -> Dict[str, Any]:
    """``workloads/<name>.json``: the cell's configuration, mix, driver and
    the limits of its correctness check."""
    wl = load_json(bench_dir / "workloads" / f"{name}.json")
    if wl.get("name") != name:
        raise ValueError(f"workloads/{name}.json names itself {wl.get('name')!r}")
    return wl


def config(name: str, bench_dir: Path = BENCH_DIR) -> Dict[str, Any]:
    """``configs/<name>.json``: the model configuration as it is run."""
    return load_json(bench_dir / "configs" / f"{name}.json")


def mix(name: str, bench_dir: Path = BENCH_DIR) -> Dict[str, Any]:
    """``traffic/<name>.json``: the parameters the traffic generator reads."""
    return load_json(bench_dir / "traffic" / f"{name}.json")


def benchmark_spec(root: Path = ROOT) -> Dict[str, Any]:
    return load_json(root / "BENCHMARK.json")


def cell_metrics(spec: Dict[str, Any], cell: str) -> Dict[str, List[Dict[str, Any]]]:
    """The end-to-end and per-layer metrics ``BENCHMARK.json`` asks of a
    cell: an end-to-end metric with a ``workloads`` list names its cells,
    one without is every cell's; a per-layer metric with a list names its
    cells, one without goes with every cell that reports what it moves."""
    e2e = [m for m in spec["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [
        m for m in spec["per_layer"]
        if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)
    ]
    return {"end_to_end": e2e, "per_layer": layer}


def forbidden_loaded(modules=None) -> List[str]:
    """Top-level names of loaded modules that belong to JAX or to the JAX
    package, compared whole (``tvc_torch`` is not ``tvc``)."""
    mods = sys.modules if modules is None else modules
    tops = {name.split(".", 1)[0] for name in mods}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def set_cache_env() -> None:
    """Point every kernel and extension cache a library may use at fixed
    directories inside the checkout."""
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    os.environ["TRITON_CACHE_DIR"] = str(CACHE_DIR / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE_DIR / "torch_extensions")
    os.environ.setdefault("USE_FLAX", "0")


def power_limit_w() -> Optional[float]:
    """The card's power limit as ``nvidia-smi`` reads it (None where it
    cannot)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20,
        ).stdout.strip().splitlines()
        return float(out[0]) if out else None
    except (OSError, ValueError, subprocess.SubprocessError):
        return None
