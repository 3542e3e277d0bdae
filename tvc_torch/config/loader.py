"""YAML config system with ``inherits:`` / ``overrides:`` semantics.

Behavior parity with the reference config stack
(reference: src/config.py:132-169, src/utils/config_manager.py — resolved
experiment configs declare a list of parent YAMLs under ``inherits:`` and a
final ``overrides:`` mapping applied last; see
reference configs/experiments/coco_pgd_full.yaml:7-43 for the schema).

Port of ``tvc/config/loader.py``: pure host code. YAML goes through the
port's own reader and writer (``tvc_torch/_yaml.py``), since the card's
machine has no PyYAML. Deep merges are dict-recursive; lists are replaced
wholesale (matching the reference's merge semantics).
"""

from __future__ import annotations

import copy
import os
from pathlib import Path
from typing import Any, Dict, Iterable, Mapping, Optional, Union

from tvc_torch import _yaml

PathLike = Union[str, os.PathLike]


def deep_merge(base: Mapping[str, Any], update: Mapping[str, Any]) -> Dict[str, Any]:
    """Recursively merge ``update`` into ``base`` (returns a new dict).

    Nested dicts merge key-by-key; any other value (including lists) in
    ``update`` replaces the value in ``base``.
    """
    out: Dict[str, Any] = {k: copy.deepcopy(v) for k, v in base.items()}
    for key, val in update.items():
        if key in out and isinstance(out[key], dict) and isinstance(val, Mapping):
            out[key] = deep_merge(out[key], val)
        else:
            out[key] = copy.deepcopy(val)
    return out


def apply_overrides(config: Mapping[str, Any], overrides: Mapping[str, Any]) -> Dict[str, Any]:
    """Apply an overrides mapping. Keys may be nested dicts or dotted paths.

    ``{"attack.epsilon": 0.05}`` and ``{"attack": {"epsilon": 0.05}}`` are
    equivalent.
    """
    expanded: Dict[str, Any] = {}
    for key, val in overrides.items():
        if "." in key:
            parts = key.split(".")
            node: Dict[str, Any] = expanded
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = val
        else:
            if key in expanded and isinstance(expanded[key], dict) and isinstance(val, Mapping):
                expanded[key] = deep_merge(expanded[key], val)
            else:
                expanded[key] = val
    return deep_merge(config, expanded)


class ConfigLoader:
    """Loads experiment YAMLs, resolving ``inherits`` chains and ``overrides``.

    Parameters
    ----------
    config_dir:
        Root directory for relative ``inherits`` entries. Defaults to the
        repo-level ``configs/`` next to the ``tvc_torch`` package.
    """

    def __init__(self, config_dir: Optional[PathLike] = None):
        if config_dir is None:
            config_dir = Path(__file__).resolve().parents[2] / "configs"
        self.config_dir = Path(config_dir)

    # -- raw IO ------------------------------------------------------------
    def load_yaml(self, path: PathLike) -> Dict[str, Any]:
        p = self._resolve(path)
        with open(p, "r") as f:
            data = _yaml.load(f)
        return data or {}

    def save_yaml(self, config: Mapping[str, Any], path: PathLike) -> None:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        with open(p, "w") as f:
            f.write(_yaml.dump(dict(config)))

    def _resolve(self, path: PathLike) -> Path:
        p = Path(path)
        if p.is_absolute():
            return p
        cand = self.config_dir / p
        if cand.exists():
            return cand
        # allow names without .yaml and dataset/attack shorthand
        if not str(p).endswith((".yaml", ".yml")):
            for suffix in (".yaml", ".yml"):
                c = self.config_dir / (str(p) + suffix)
                if c.exists():
                    return c
        return p  # let open() raise a useful error

    # -- resolution --------------------------------------------------------
    def load(self, path: PathLike, _stack: Optional[Iterable[str]] = None) -> Dict[str, Any]:
        """Load a config file, resolving ``inherits`` (list of parents, merged
        in order) and applying its ``overrides`` section last."""
        stack = list(_stack or [])
        p = str(self._resolve(path))
        if p in stack:
            raise ValueError(f"circular config inheritance: {' -> '.join(stack + [p])}")
        raw = self.load_yaml(p)

        inherits = raw.pop("inherits", None) or []
        if isinstance(inherits, str):
            inherits = [inherits]
        overrides = raw.pop("overrides", None) or {}

        merged: Dict[str, Any] = {}
        for parent in inherits:
            parent_cfg = self.load(parent, _stack=stack + [p])
            merged = deep_merge(merged, parent_cfg)
        merged = deep_merge(merged, raw)
        if overrides:
            merged = apply_overrides(merged, overrides)
        return merged


def get_by_path(config: Mapping[str, Any], dotted: str, default: Any = None) -> Any:
    """``get_by_path(cfg, "models.clip.default_model")``."""
    node: Any = config
    for part in dotted.split("."):
        if not isinstance(node, Mapping) or part not in node:
            return default
        node = node[part]
    return node


class Config:
    """Process-wide config facade (reference: src/config.py:75 ``Config``).

    Loads ``configs/default.yaml`` on first use; ``load_experiment_config``
    resolves an experiment file over the defaults.
    """

    _instance: Optional["Config"] = None

    def __init__(self, config_dir: Optional[PathLike] = None):
        self.loader = ConfigLoader(config_dir)
        default_path = self.loader.config_dir / "default.yaml"
        self._config: Dict[str, Any] = (
            self.loader.load(default_path) if default_path.exists() else {}
        )

    @classmethod
    def instance(cls) -> "Config":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    @property
    def data(self) -> Dict[str, Any]:
        return self._config

    def get(self, dotted: str, default: Any = None) -> Any:
        return get_by_path(self._config, dotted, default)

    def load_experiment_config(self, path: PathLike) -> Dict[str, Any]:
        exp = self.loader.load(path)
        self._config = deep_merge(self._config, exp)
        return self._config

    # typed accessors (reference src/config.py:206-240)
    def get_dataset_config(self) -> Dict[str, Any]:
        return dict(self.get("data", {}) or {})

    def get_attack_config(self) -> Dict[str, Any]:
        return dict(self.get("attack", {}) or {})

    def get_defense_config(self) -> Dict[str, Any]:
        return dict(self.get("defense", {}) or {})

    def get_model_config(self, name: str = "clip") -> Dict[str, Any]:
        return dict(self.get(f"models.{name}", {}) or {})

    def validate(self) -> None:
        """Minimal invariant checks (reference: src/config.py:330-340)."""
        batch = self.get("batch.default_size", 32)
        if not isinstance(batch, int) or batch < 1:
            raise ValueError(f"batch.default_size must be a positive int, got {batch!r}")
        seed = self.get("experiments.seed", 42)
        if not isinstance(seed, int):
            raise ValueError(f"experiments.seed must be an int, got {seed!r}")


def get_config() -> Config:
    return Config.instance()
