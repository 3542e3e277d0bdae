"""Reference bank (port of ``tvc/bank/store.py``): a bounded store of
reference vectors with dedup, eviction and clustering.

Thread-safe inserts with a sampled similarity dedup, max-size eviction
(fifo / lru / random / most-similar), periodic KMeans clustering when
scikit-learn imports (none when it does not), and npz + JSON persistence
in the JAX package's layout, so either package loads the other's files.
The bookkeeping and the similarity checks are host numpy, as in the JAX
package (``tvc_torch.bank.index`` does the bulk retrieval on the device;
this class is the mutable, incremental store feeding it).
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _host(x) -> np.ndarray:
    """An array, or a tensor on any device, as an f32 host array."""
    if torch.is_tensor(x):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


@dataclasses.dataclass
class ReferenceBankConfig:
    max_size: int = 10000
    similarity_threshold: float = 0.95  # dedup: drop near-duplicates on insert
    eviction_policy: str = "fifo"  # fifo | lru | random | most_similar
    clustering_interval: int = 100  # re-cluster every N inserts (0 = never)
    num_clusters: int = 10
    dedup_sample_size: int = 256  # sampled dedup
    seed: int = 42

    def __post_init__(self):
        if self.max_size < 1:
            raise ValueError("max_size must be >= 1")
        if not 0.0 <= self.similarity_threshold <= 1.0:
            raise ValueError("similarity_threshold must be in [0, 1]")
        if self.eviction_policy not in {"fifo", "lru", "random", "most_similar"}:
            raise ValueError(f"unknown eviction policy {self.eviction_policy}")


@dataclasses.dataclass
class ReferenceItem:
    vector: np.ndarray
    text: str = ""
    source: str = ""  # "retrieval" | "sd" | ...
    added_at: float = 0.0
    last_used: float = 0.0
    use_count: int = 0
    metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)


class ReferenceBank:
    """Thread-safe bounded reference-vector store."""

    def __init__(self, dim: int, config: Optional[ReferenceBankConfig] = None):
        self.dim = dim
        self.config = config or ReferenceBankConfig()
        self._lock = threading.Lock()
        self._items: List[ReferenceItem] = []
        self._matrix = np.zeros((0, dim), dtype=np.float32)  # normalized rows
        self._rng = np.random.default_rng(self.config.seed)
        self._inserts_since_clustering = 0
        self.clusters: Optional[np.ndarray] = None  # [num_clusters, dim]
        self.cluster_labels: Optional[np.ndarray] = None
        self.stats = {"added": 0, "rejected_duplicates": 0, "evicted": 0, "queries": 0}

    def __len__(self) -> int:
        return len(self._items)

    @staticmethod
    def _normalize(v: np.ndarray) -> np.ndarray:
        n = np.linalg.norm(v)
        return (v / n if n > 1e-8 else v).astype(np.float32)

    # -- insert -----------------------------------------------------------
    def add_reference(
        self,
        vector: np.ndarray,
        text: str = "",
        source: str = "",
        metadata: Optional[Dict[str, Any]] = None,
    ) -> bool:
        """Insert one vector; returns False when rejected as near-duplicate."""
        v = self._normalize(_host(vector).reshape(-1))
        if v.shape[0] != self.dim:
            raise ValueError(f"expected dim {self.dim}, got {v.shape[0]}")
        with self._lock:
            if self._is_too_similar(v):
                self.stats["rejected_duplicates"] += 1
                return False
            if len(self._items) >= self.config.max_size:
                self._evict()
            now = time.time()
            self._items.append(
                ReferenceItem(
                    vector=v, text=text, source=source, added_at=now,
                    last_used=now, metadata=metadata or {},
                )
            )
            self._matrix = np.concatenate([self._matrix, v[None, :]], axis=0)
            self.stats["added"] += 1
            self._inserts_since_clustering += 1
            if (
                self.config.clustering_interval
                and self._inserts_since_clustering >= self.config.clustering_interval
                and len(self._items) >= self.config.num_clusters
            ):
                self._perform_clustering()
                self._inserts_since_clustering = 0
            return True

    def add_batch(
        self, vectors: np.ndarray, texts: Optional[List[str]] = None, source: str = ""
    ) -> int:
        texts = texts or [""] * len(vectors)
        return sum(
            self.add_reference(v, text=t, source=source)
            for v, t in zip(_host(vectors), texts)
        )

    def _is_too_similar(self, v: np.ndarray) -> bool:
        """Sampled dedup check."""
        n = self._matrix.shape[0]
        if n == 0:
            return False
        if n > self.config.dedup_sample_size:
            idx = self._rng.choice(n, size=self.config.dedup_sample_size, replace=False)
            sample = self._matrix[idx]
        else:
            sample = self._matrix
        return bool(np.max(sample @ v) >= self.config.similarity_threshold)

    # -- eviction -----------------------------------------------------------
    def _evict(self) -> None:
        policy = self.config.eviction_policy
        if policy == "fifo":
            idx = int(np.argmin([it.added_at for it in self._items]))
        elif policy == "lru":
            idx = int(np.argmin([it.last_used for it in self._items]))
        elif policy == "random":
            idx = int(self._rng.integers(len(self._items)))
        else:  # most_similar: drop the most redundant vector
            sims = self._matrix @ self._matrix.T
            np.fill_diagonal(sims, -np.inf)
            idx = int(np.argmax(sims.max(axis=1)))
        del self._items[idx]
        self._matrix = np.delete(self._matrix, idx, axis=0)
        self.stats["evicted"] += 1

    # -- query -----------------------------------------------------------
    def query_similar(
        self, vector: np.ndarray, top_k: int = 5
    ) -> List[Tuple[int, float]]:
        """Top-k most similar stored references."""
        v = self._normalize(_host(vector).reshape(-1))
        with self._lock:
            self.stats["queries"] += 1
            if not self._items:
                return []
            sims = self._matrix @ v
            k = min(top_k, len(self._items))
            top = np.argpartition(-sims, k - 1)[:k]
            top = top[np.argsort(-sims[top])]
            now = time.time()
            for i in top:
                self._items[int(i)].last_used = now
                self._items[int(i)].use_count += 1
            return [(int(i), float(sims[i])) for i in top]

    def vectors(self) -> np.ndarray:
        """Snapshot of all stored (normalized) vectors as [N, D]."""
        with self._lock:
            return self._matrix.copy()

    # -- clustering ---------------------------------------------------------
    def _perform_clustering(self) -> None:
        """KMeans over stored vectors."""
        try:
            from sklearn.cluster import KMeans
        except ImportError:  # no scikit-learn: no clustering
            return
        k = min(self.config.num_clusters, len(self._items))
        km = KMeans(n_clusters=k, n_init=4, random_state=self.config.seed)
        self.cluster_labels = km.fit_predict(self._matrix)
        self.clusters = km.cluster_centers_.astype(np.float32)

    # -- persistence --------------------------------------------------------
    def save(self, directory: str) -> None:
        """npz vectors + JSON metadata."""
        d = Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(d / "references.npz", matrix=self._matrix)
        meta = {
            "dim": self.dim,
            "config": dataclasses.asdict(self.config),
            "stats": self.stats,
            "items": [
                {
                    "text": it.text,
                    "source": it.source,
                    "added_at": it.added_at,
                    "last_used": it.last_used,
                    "use_count": it.use_count,
                    "metadata": it.metadata,
                }
                for it in self._items
            ],
        }
        (d / "bank.json").write_text(json.dumps(meta))

    @classmethod
    def load(cls, directory: str) -> "ReferenceBank":
        d = Path(directory)
        meta = json.loads((d / "bank.json").read_text())
        bank = cls(meta["dim"], ReferenceBankConfig(**meta["config"]))
        matrix = np.load(d / "references.npz")["matrix"]
        bank._matrix = matrix.astype(np.float32)
        bank.stats = meta["stats"]
        bank._items = [
            ReferenceItem(vector=matrix[i], **meta["items"][i])
            for i in range(len(meta["items"]))
        ]
        return bank
