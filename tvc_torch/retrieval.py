"""Dual-encoder retrieval over an embedding bank (port of ``tvc/retrieval.py``:
the image index the detector and the serving runtime use, and text ->
image retrieval, the pipeline's fallback when the fused step's top-k does
not cover ``retrieval_top_k``).

Banks live on the model's device.
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


@dataclasses.dataclass
class RetrievalConfig:
    top_k: int = 10
    batch_size: int = 256
    normalize: bool = True

    def __post_init__(self):
        if self.top_k < 1:
            raise ValueError("top_k must be >= 1")


@dataclasses.dataclass
class RetrievalResult:
    indices: np.ndarray  # [B, k]
    scores: np.ndarray  # [B, k]
    items: List[List[Any]]  # the retrieved items (paths, captions, ids)
    query_time: float


class MultiModalRetriever:
    """Text -> image retrieval against a CLIP image-embedding bank."""

    def __init__(self, model: CLIPModel, config: Optional[RetrievalConfig] = None):
        self.model = model
        self.config = config or RetrievalConfig()
        self.image_bank: Optional[EmbeddingBank] = None
        self.image_items: List[Any] = []
        self._cache: Dict[str, RetrievalResult] = {}
        self.stats = {"queries": 0, "cache_hits": 0, "total_query_time": 0.0}

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
            bs = self.config.batch_size
            embeddings = np.concatenate(
                [
                    self.model.encode_image(list(images[i : i + bs])).cpu().numpy()
                    for i in range(0, len(images), bs)
                ]
            )
        self.image_bank = EmbeddingBank(
            dim=np.asarray(embeddings).shape[1],
            normalize=self.config.normalize,
            device=self.model.device,
        ).build(np.asarray(embeddings))
        self.image_items = list(items) if items is not None else list(range(len(embeddings)))
        self._cache.clear()

    def retrieve_images_by_text(self, texts, top_k: Optional[int] = None) -> RetrievalResult:
        """One str or a list of texts -> the top-k bank items of each; a
        single text's result is cached under its text and k."""
        if self.image_bank is None:
            raise RuntimeError("image index not built")
        single = isinstance(texts, str)
        texts = [texts] if single else list(texts)
        k = top_k or self.config.top_k
        key = f"t2i:{k}:{texts[0]}" if single else None
        if key in self._cache:
            self.stats["cache_hits"] += 1
            return self._cache[key]
        t0 = time.time()
        scores, idx = self.image_bank.search(self.model.encode_text(texts), k)
        idx_np = idx.cpu().numpy()
        elapsed = time.time() - t0
        self.stats["queries"] += idx_np.shape[0]
        self.stats["total_query_time"] += elapsed
        items = [[self.image_items[j] if 0 <= j < len(self.image_items) else None for j in row] for row in idx_np]
        result = RetrievalResult(indices=idx_np, scores=scores.cpu().numpy(), items=items, query_time=elapsed)
        if key is not None:
            self._cache[key] = result
        return result

    def retrieve_reference_embeddings(self, texts, top_k: Optional[int] = None) -> np.ndarray:
        """[B, k, D] bank rows retrieved by the texts (the detector's staged
        reference stage)."""
        if self.image_bank is None:
            raise RuntimeError("image index not built")
        k = top_k or self.config.top_k
        q = self.model.encode_text([texts] if isinstance(texts, str) else list(texts))
        _, idx = self.image_bank.search(q, k)
        self.stats["queries"] += int(idx.shape[0])
        return self.image_bank._bank[idx].cpu().numpy()

    def save(self, directory: str) -> None:
        d = Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        if self.image_bank is not None:
            self.image_bank.save(str(d / "image_bank"))
        meta = {
            "config": dataclasses.asdict(self.config),
            "image_items": [str(x) for x in self.image_items],
        }
        (d / "retriever.json").write_text(json.dumps(meta))

    def load(self, directory: str) -> None:
        d = Path(directory)
        meta = json.loads((d / "retriever.json").read_text())
        self.config = RetrievalConfig(**meta["config"])
        if (d / "image_bank.npz").exists():
            self.image_bank = EmbeddingBank.load(
                str(d / "image_bank"), normalize=self.config.normalize, device=self.model.device
            )
        self.image_items = meta["image_items"]

    def get_stats(self) -> Dict[str, Any]:
        return dict(self.stats)
