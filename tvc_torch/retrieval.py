"""Dual-encoder retrieval over embedding banks (port of ``tvc/retrieval.py``):
``MultiModalRetriever`` with its image and text indexes, text -> image and
image -> text retrieval, the detector's reference embeddings, the full
similarity matrix, save / load of both banks, and ``create_retriever``.

Banks live on the model's device; the index is exact (``index_type``
"flat", "ivf", "hnsw" and "pq" all mean the exact matmul top-k, as in the
JAX package). With a ``mesh`` both banks shard their rows over the mesh's
bank axis (``EmbeddingBank(mesh=...)``): every rank encodes the same
queries and gets the global results.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from tvc_torch.bank.index import EmbeddingBank
from tvc_torch.models.clip import CLIPModel
from tvc_torch.parallel.mesh import barrier, is_first_rank


@dataclasses.dataclass
class RetrievalConfig:
    top_k: int = 10
    batch_size: int = 256
    index_type: str = "exact"  # every index type is the exact top-k
    normalize: bool = True
    cache_enabled: bool = True

    def __post_init__(self):
        if self.top_k < 1:
            raise ValueError("top_k must be >= 1")


@dataclasses.dataclass
class RetrievalResult:
    indices: np.ndarray  # [B, k]
    scores: np.ndarray  # [B, k]
    items: List[List[Any]]  # the retrieved items (paths, captions, ids)
    query_time: float


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


class MultiModalRetriever:
    """Text -> image and image -> text retrieval against CLIP banks."""

    def __init__(self, model: CLIPModel, config: Optional[RetrievalConfig] = None, mesh=None):
        self.model = model
        self.config = config or RetrievalConfig()
        self.mesh = mesh
        self.image_bank: Optional[EmbeddingBank] = None
        self.text_bank: Optional[EmbeddingBank] = None
        self.image_items: List[Any] = []
        self.text_items: List[Any] = []
        self._cache: Dict[str, RetrievalResult] = {}
        self.stats = {"queries": 0, "cache_hits": 0, "total_query_time": 0.0}

    def _bank(self, embeddings) -> EmbeddingBank:
        emb = np.asarray(embeddings)
        return EmbeddingBank(
            dim=emb.shape[1], mesh=self.mesh, normalize=self.config.normalize, device=self.model.device
        ).build(emb)

    # -- index construction ------------------------------------------------------
    def build_image_index(
        self,
        images: Optional[Sequence] = None,
        embeddings: Optional[np.ndarray] = None,
        items: Optional[Sequence[Any]] = None,
    ) -> None:
        """From raw images (encoded in batches) or precomputed embeddings."""
        if embeddings is None:
            if images is None:
                raise ValueError("need images or embeddings")
            embeddings = self._encode_images_batched(images)
        self.image_bank = self._bank(embeddings)
        self.image_items = list(items) if items is not None else list(range(len(embeddings)))
        self._cache.clear()

    def build_text_index(
        self,
        texts: Optional[Sequence[str]] = None,
        embeddings: Optional[np.ndarray] = None,
    ) -> None:
        """From texts (encoded in batches) or precomputed embeddings."""
        if embeddings is None:
            if texts is None:
                raise ValueError("need texts or embeddings")
            embeddings = self._encode_texts_batched(texts)
        self.text_bank = self._bank(embeddings)
        if texts is not None:
            self.text_items = list(texts)
        elif not self.text_items:
            self.text_items = list(range(len(embeddings)))
        self._cache.clear()

    def _encode_images_batched(self, images: Sequence) -> np.ndarray:
        bs = self.config.batch_size
        return np.concatenate(
            [_np(self.model.encode_image(list(images[i : i + bs]))) for i in range(0, len(images), bs)], axis=0
        )

    def _encode_texts_batched(self, texts: Sequence[str]) -> np.ndarray:
        bs = self.config.batch_size
        return np.concatenate(
            [_np(self.model.encode_text(list(texts[i : i + bs]))) for i in range(0, len(texts), bs)], axis=0
        )

    # -- retrieval -------------------------------------------------------------------
    def retrieve_images_by_text(self, texts, top_k: Optional[int] = None) -> RetrievalResult:
        """One str or a list of texts -> the top-k image bank items of each;
        with ``cache_enabled`` a single text's result is cached under its
        text and k."""
        if self.image_bank is None:
            raise RuntimeError("image index not built")
        single = isinstance(texts, str)
        texts = [texts] if single else list(texts)
        k = top_k or self.config.top_k
        key = f"t2i:{k}:{texts[0]}" if self.config.cache_enabled and single else None
        if key in self._cache:
            self.stats["cache_hits"] += 1
            return self._cache[key]
        t0 = time.time()
        scores, idx = self.image_bank.search(self.model.encode_text(texts), k)
        result = self._make_result(scores, idx, self.image_items, t0)
        if key is not None:
            self._cache[key] = result
        return result

    def retrieve_texts_by_image(self, images, top_k: Optional[int] = None) -> RetrievalResult:
        """One PIL image, a PIL list or raw [0, 1] pixels -> the top-k text
        bank items of each."""
        if self.text_bank is None:
            raise RuntimeError("text index not built")
        if not isinstance(images, (list, tuple)) and hasattr(images, "convert"):
            images = [images]
        k = top_k or self.config.top_k
        t0 = time.time()
        scores, idx = self.text_bank.search(self.model.encode_image(images), k)
        return self._make_result(scores, idx, self.text_items, t0)

    def retrieve_reference_embeddings(self, texts, top_k: Optional[int] = None) -> np.ndarray:
        """[B, k, D] bank rows retrieved by the texts (the detector's staged
        reference stage)."""
        if self.image_bank is None:
            raise RuntimeError("image index not built")
        k = top_k or self.config.top_k
        q = self.model.encode_text([texts] if isinstance(texts, str) else list(texts))
        _, idx = self.image_bank.search(q, k)
        return _np(self.image_bank.rows(idx))

    def compute_similarity_matrix(self, texts, images=None) -> np.ndarray:
        """The full [T, N] text vs image-bank similarity (``images`` is
        accepted for the reference signature and unused, as in the JAX
        package)."""
        if self.image_bank is None:
            raise RuntimeError("image index not built")
        q = self.model.encode_text([texts] if isinstance(texts, str) else list(texts))
        return _np(self.image_bank.similarity_matrix(q))

    def _make_result(self, scores, idx, items, t0) -> RetrievalResult:
        idx_np = _np(idx)
        elapsed = time.time() - t0
        self.stats["queries"] += idx_np.shape[0]
        self.stats["total_query_time"] += elapsed
        got = [[items[j] if 0 <= j < len(items) else None for j in row] for row in idx_np]
        return RetrievalResult(indices=idx_np, scores=_np(scores), items=got, query_time=elapsed)

    # -- persistence -------------------------------------------------------------------
    def save(self, directory: str) -> None:
        """Both banks and ``retriever.json``; over a mesh every rank calls
        it and the mesh's first rank writes the files."""
        d = Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        if self.image_bank is not None:
            self.image_bank.save(str(d / "image_bank"))
        if self.text_bank is not None:
            self.text_bank.save(str(d / "text_bank"))
        meta = {
            "config": dataclasses.asdict(self.config),
            "image_items": [str(x) for x in self.image_items],
            "text_items": [str(x) for x in self.text_items],
        }
        if self.mesh is None or is_first_rank(self.mesh):
            (d / "retriever.json").write_text(json.dumps(meta))
        if self.mesh is not None:
            barrier(self.mesh)

    def load(self, directory: str) -> None:
        d = Path(directory)
        meta = json.loads((d / "retriever.json").read_text())
        self.config = RetrievalConfig(**meta["config"])
        device = self.model.device
        if (d / "image_bank.npz").exists():
            self.image_bank = EmbeddingBank.load(
                str(d / "image_bank"), mesh=self.mesh, normalize=self.config.normalize, device=device
            )
        if (d / "text_bank.npz").exists():
            self.text_bank = EmbeddingBank.load(
                str(d / "text_bank"), mesh=self.mesh, normalize=self.config.normalize, device=device
            )
        self.image_items = meta["image_items"]
        self.text_items = meta.get("text_items", [])

    def get_stats(self) -> Dict[str, Any]:
        return dict(self.stats)


def create_retriever(model: CLIPModel, config: Optional[RetrievalConfig] = None, **kw) -> MultiModalRetriever:
    return MultiModalRetriever(model, config, **kw)
