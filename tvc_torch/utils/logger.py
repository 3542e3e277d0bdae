"""Structured experiment logging.

Covers reference experiments/utils/logger.py (ExperimentInfo :16,
ExperimentLogger :30: experiment_id = name+timestamp, JSON records with
status lifecycle / metrics / artifacts, file+console handlers :63).
Port of ``tvc/utils/logger.py``: a copy, host code only.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
from pathlib import Path
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class ExperimentInfo:
    """(reference :16-29)"""

    experiment_id: str
    name: str
    status: str = "created"  # created | running | completed | failed
    start_time: float = 0.0
    end_time: float = 0.0
    config: Dict[str, Any] = dataclasses.field(default_factory=dict)
    metrics: Dict[str, Any] = dataclasses.field(default_factory=dict)
    artifacts: List[str] = dataclasses.field(default_factory=list)
    error: Optional[str] = None


class ExperimentLogger:
    """(reference :30-200)"""

    def __init__(
        self,
        name: str,
        output_dir: str = "./results/logs",
        console: bool = True,
        level: int = logging.INFO,
    ):
        self.info = ExperimentInfo(
            experiment_id=f"{name}_{int(time.time())}", name=name
        )
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.logger = logging.getLogger(f"tvc_torch.experiment.{self.info.experiment_id}")
        self.logger.setLevel(level)
        self.logger.handlers.clear()
        fh = logging.FileHandler(self.output_dir / f"{self.info.experiment_id}.log")
        fh.setFormatter(
            logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
        )
        self.logger.addHandler(fh)
        if console:
            sh = logging.StreamHandler()
            sh.setFormatter(logging.Formatter("%(levelname)s %(message)s"))
            self.logger.addHandler(sh)

    # -- lifecycle -------------------------------------------------------------
    def start(self, config: Optional[Dict[str, Any]] = None) -> None:
        self.info.status = "running"
        self.info.start_time = time.time()
        self.info.config = config or {}
        self.logger.info(f"experiment {self.info.experiment_id} started")
        self._flush()

    def log_metrics(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        key = f"step_{step}" if step is not None else "final"
        self.info.metrics.setdefault(key, {}).update(metrics)
        self.logger.info(f"metrics[{key}]: {json.dumps(metrics, default=str)}")
        self._flush()

    def log_artifact(self, path: str) -> None:
        self.info.artifacts.append(str(path))
        self._flush()

    def complete(self, metrics: Optional[Dict[str, Any]] = None) -> None:
        if metrics:
            self.log_metrics(metrics)
        self.info.status = "completed"
        self.info.end_time = time.time()
        self.logger.info(
            f"experiment completed in {self.info.end_time - self.info.start_time:.1f}s"
        )
        self._flush()

    def fail(self, error: str) -> None:
        self.info.status = "failed"
        self.info.end_time = time.time()
        self.info.error = error
        self.logger.error(f"experiment failed: {error}")
        self._flush()

    # -- persistence ------------------------------------------------------------
    def _flush(self) -> None:
        record = dataclasses.asdict(self.info)
        (self.output_dir / f"{self.info.experiment_id}.json").write_text(
            json.dumps(record, indent=2, default=str)
        )

    def record_path(self) -> str:
        return str(self.output_dir / f"{self.info.experiment_id}.json")
