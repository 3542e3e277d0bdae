"""Checkpoint / resume utilities (port of ``tvc/utils/checkpoint.py``).

* ``CheckpointManager``: versioned, retention-limited checkpoints of
  parameter and optimizer trees (nested dicts, lists and tuples of torch
  tensors, numpy arrays and Python scalars), one ``step_XXXXXXXX/``
  directory a step with ``tree.msgpack`` (the bytes
  ``flax.serialization.to_bytes`` writes for the tree, through the port's
  own writer) and an optional ``metadata.json``; ``latest_step`` +
  ``restore`` resume. The JAX manager writes orbax where orbax imports and
  this msgpack otherwise; the port writes and reads the msgpack branch
  only, so it restores what the JAX manager's msgpack branch wrote, not an
  orbax directory.
* ``StageCheckpointer``: resumable stage snapshots of an experiment (an
  atomic npz and JSON per stage under ``<dir>/<fingerprint>/``).
"""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from tvc_torch._flax_msgpack import from_state_dict, read_state_dict, write_state_dict


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    # -- bookkeeping -----------------------------------------------------------
    def _step_dir(self, step: int) -> Path:
        return self.dir / f"step_{step:08d}"

    def steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("step_*"):
            m = re.match(r"step_(\d+)$", p.name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: -self.max_to_keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- save/restore -----------------------------------------------------------
    def save(self, step: int, tree: Any, metadata: Optional[Dict] = None) -> str:
        d = self._step_dir(step)
        d.mkdir(parents=True, exist_ok=True)
        write_state_dict(d / "tree.msgpack", tree)
        if metadata:
            (d / "metadata.json").write_text(json.dumps(metadata, default=str))
        self._gc()
        return str(d)

    def restore(self, template: Any, step: Optional[int] = None) -> Any:
        """The tree saved at ``step`` (default: the latest) in
        ``template``'s structure; tensors of the template come back as
        tensors on its device."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = self._step_dir(step) / "tree.msgpack"
        if not path.exists():
            raise FileNotFoundError(f"{path}: the port restores msgpack checkpoints only (not orbax)")
        return from_state_dict(template, read_state_dict(path))

    def metadata(self, step: Optional[int] = None) -> Dict:
        step = step if step is not None else self.latest_step()
        p = self._step_dir(step) / "metadata.json"
        return json.loads(p.read_text()) if p.exists() else {}


def _host(v) -> np.ndarray:
    if hasattr(v, "detach"):  # a torch tensor, on any device
        return v.detach().cpu().numpy()
    return np.asarray(v)


class StageCheckpointer:
    """Resumable stage snapshots for long experiment runs.

    Each completed stage saves one npz (+ optional JSON payload) under
    ``directory/<fingerprint>/``; a resumed run with the same fingerprint
    (config + data hash) skips completed stages and a changed fingerprint
    starts fresh, so stale snapshots never leak into another experiment.
    """

    def __init__(self, directory: str, fingerprint: str):
        self.dir = Path(directory) / fingerprint
        self.dir.mkdir(parents=True, exist_ok=True)

    def _paths(self, stage: str):
        safe = re.sub(r"[^A-Za-z0-9_.-]", "_", stage)
        return self.dir / f"{safe}.npz", self.dir / f"{safe}.json"

    def has(self, stage: str) -> bool:
        npz, js = self._paths(stage)
        return npz.exists() or js.exists()

    def save(self, stage: str, arrays: Optional[Dict[str, Any]] = None, meta: Optional[Dict[str, Any]] = None) -> None:
        npz, js = self._paths(stage)
        if arrays:
            # the tmp name keeps the .npz suffix: np.savez appends one to
            # anything else, breaking the rename
            tmp = npz.with_name(npz.stem + ".tmp.npz")
            np.savez_compressed(tmp, **{k: _host(v) for k, v in arrays.items() if v is not None})
            tmp.replace(npz)  # atomic: a kill mid-write never leaves a half-snapshot
        if meta is not None:
            tmpj = js.with_suffix(".json.tmp")
            tmpj.write_text(json.dumps(meta, default=float))
            tmpj.replace(js)

    def load(self, stage: str):
        """Returns (arrays dict or {}, meta dict or None)."""
        npz, js = self._paths(stage)
        arrays = {}
        if npz.exists():
            with np.load(npz, allow_pickle=False) as z:
                arrays = {k: z[k] for k in z.files}
        meta = json.loads(js.read_text()) if js.exists() else None
        return arrays, meta

    def clear(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)
