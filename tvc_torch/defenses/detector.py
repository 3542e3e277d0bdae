"""Dependency-injected alt-stack detector (port of
``tvc/defenses/detector.py``): the model and the variant / retrieval /
generative reference sources come in as constructor arguments, the
consistency metrics come from ``tvc_torch.core.consistency`` and the
decision from :class:`ConsistencyChecker`.

Batched: one image encode, one flattened variant-text encode, the
reference sets from the injected generators.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from tvc_torch.core import consistency as C
from tvc_torch.core.similarity import batched_set_cosine, cosine_similarity
from tvc_torch.defenses.consistency_checker import ConsistencyChecker, _np


@dataclasses.dataclass
class DetectionConfig:
    num_text_variants: int = 5
    num_retrieval_refs: int = 10
    num_generative_refs: int = 3
    threshold: float = 0.5
    adaptive_threshold: bool = True
    voting_strategy: str = "weighted"
    text_variant_weight: float = 0.3
    reference_weight: float = 0.4
    dedup_similarity: float = 0.98


class MultiModalDefenseDetector:
    """Alt-stack detector with injected components; it computes on the
    CLIP model's device."""

    def __init__(
        self,
        clip_model,
        config: Optional[DetectionConfig] = None,
        text_variant_generator: Optional[Callable[[str, int], List[str]]] = None,
        retrieval_generator: Optional[Callable[[List[str], int], np.ndarray]] = None,
        generative_generator: Optional[Callable[[List[str], int], np.ndarray]] = None,
        checker: Optional[ConsistencyChecker] = None,
    ):
        self.clip = clip_model
        self.config = config or DetectionConfig()
        self.text_variant_generator = text_variant_generator
        self.retrieval_generator = retrieval_generator
        self.generative_generator = generative_generator
        self.checker = checker or ConsistencyChecker(
            threshold=self.config.threshold,
            adaptive_threshold=self.config.adaptive_threshold,
            voting_strategy=self.config.voting_strategy,
        )
        self.stats = {"detections": 0}

    # -- embedding assembly ------------------------------------------------
    def _variant_embeddings(self, texts: Sequence[str]):
        V = self.config.num_text_variants
        B = len(texts)
        D = self.clip.config.embed_dim
        emb = np.zeros((B, V, D), np.float32)
        mask = np.zeros((B, V), bool)
        if self.text_variant_generator is not None:
            lists = [self.text_variant_generator(t, V) for t in texts]
            flat = [v for vl in lists for v in vl]
            if flat:
                fe = _np(self.clip.encode_text(flat).float())
                pos = 0
                for b, vl in enumerate(lists):
                    n = min(len(vl), V)
                    emb[b, :n] = fe[pos : pos + n][:n]
                    mask[b, :n] = True
                    pos += len(vl)
        return emb, mask

    def _refs(self, generator, texts: Sequence[str], count: int):
        B = len(texts)
        D = self.clip.config.embed_dim
        if generator is None:
            return np.zeros((B, count, D), np.float32), np.zeros((B, count), bool)
        refs = np.asarray(_np(generator(list(texts), count)), np.float32)
        refs = self._deduplicate_references(refs)
        mask = np.any(refs != 0, axis=-1)
        return refs, mask

    def _deduplicate_references(self, refs: np.ndarray) -> np.ndarray:
        """Zero out near-duplicate reference vectors per query: a row whose
        cosine to an earlier kept row reaches ``dedup_similarity``."""
        thr = self.config.dedup_similarity
        out = refs.copy()
        for b in range(refs.shape[0]):
            norms = np.linalg.norm(refs[b], axis=-1, keepdims=True)
            normed = refs[b] / np.maximum(norms, 1e-8)
            sims = normed @ normed.T
            keep = np.ones(refs.shape[1], bool)
            for i in range(refs.shape[1]):
                if not keep[i]:
                    continue
                dup = (sims[i] >= thr) & (np.arange(refs.shape[1]) > i)
                keep &= ~dup
            out[b, ~keep] = 0.0
        return out

    # -- detection ------------------------------------------------------------
    def detect(self, images, texts: Sequence[str], return_details: bool = False) -> Dict[str, Any]:
        """Batched alt-stack detection."""
        img = self.clip.encode_image(images).float()
        txt = self.clip.encode_text(list(texts)).float()
        dev = img.device
        orig = cosine_similarity(img, txt)

        var_emb, var_mask = self._variant_embeddings(texts)
        ret_emb, ret_mask = self._refs(self.retrieval_generator, texts, self.config.num_retrieval_refs)
        gen_emb, gen_mask = self._refs(self.generative_generator, texts, self.config.num_generative_refs)

        def t(a):
            return torch.as_tensor(a, device=dev)

        metrics = C.compute_consistency_metrics(
            orig,
            batched_set_cosine(img, t(var_emb)),
            batched_set_cosine(img, t(ret_emb)),
            batched_set_cosine(img, t(gen_emb)),
            variant_mask=t(var_mask),
            retrieval_mask=t(ret_mask),
            generative_mask=t(gen_mask),
        )
        self.stats["detections"] += len(texts)
        result = self.checker.make_decision(metrics, return_details=return_details)
        result["consistency_scores"] = {
            f.name: _np(getattr(metrics, f.name)) for f in dataclasses.fields(metrics)
        }
        return result

    def detect_single(self, image, text: str) -> Dict[str, Any]:
        res = self.detect(image if isinstance(image, (list, tuple)) else [image], [text])
        return {
            "is_adversarial": bool(res["is_adversarial"][0]),
            "confidence": float(res["confidence"][0]),
            "overall_score": float(res["overall_score"][0]),
            "threshold": float(res["threshold"][0]),
            "consistency_scores": {k: float(v[0]) for k, v in res["consistency_scores"].items()},
        }

    def get_stats(self) -> Dict[str, Any]:
        return {**self.stats, "checker": self.checker.get_stats()}
