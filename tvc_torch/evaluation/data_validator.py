"""Dataset hygiene validation.

Covers reference src/evaluation/data_validator.py (DataValidationConfig
:28, ValidationResult :68: exact/near-duplicate detection, train/test
leakage checks, distribution + quality checks via CLIP image features and
TF-IDF text features :30-54).

Port of ``tvc/evaluation/data_validator.py``: image features come from the
port's CLIP (on its device, read back to host numpy); all encodes happen in a
few large batches; duplicate detection is one [N, N] similarity matmul (or
blocked for large N). scikit-learn (TF-IDF, DBSCAN) is imported where used
and raises ``ImportError`` where it is missing.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


@dataclasses.dataclass
class DataValidationConfig:
    """(reference :28-67)"""

    near_duplicate_threshold: float = 0.97
    text_duplicate_threshold: float = 0.95
    min_caption_words: int = 2
    max_caption_words: int = 80
    min_image_std: float = 0.01  # blank-image heuristic
    batch_size: int = 256
    block_size: int = 2048  # similarity matmul blocking
    # distribution-shift check (reference :30-54 distribution checks)
    ks_alpha: float = 0.01
    ks_max_dims: int = 64  # KS-test this many (highest-variance) feature dims
    shift_ks_fraction: float = 0.5  # flag when > this fraction of dims shift
    # DBSCAN cluster / outlier check (reference :30-54)
    dbscan_min_samples: int = 4
    dbscan_eps: Optional[float] = None  # None -> median kNN distance heuristic


@dataclasses.dataclass
class ValidationResult:
    """(reference :68-107)"""

    num_samples: int
    exact_duplicate_pairs: List[tuple]
    near_duplicate_pairs: List[tuple]
    text_duplicate_pairs: List[tuple]
    leakage_pairs: List[tuple]
    invalid_captions: List[int]
    low_quality_images: List[int]
    passed: bool
    summary: Dict[str, Any] = dataclasses.field(default_factory=dict)
    distribution_shift: Optional[Dict[str, Any]] = None
    clusters: Optional[Dict[str, Any]] = None


class DataValidator:
    def __init__(self, clip_model=None, config: Optional[DataValidationConfig] = None):
        self.clip = clip_model
        self.config = config or DataValidationConfig()

    # -- feature extraction -----------------------------------------------------
    def _image_features(self, images: np.ndarray) -> np.ndarray:
        if self.clip is not None:
            bs = self.config.batch_size
            chunks = [
                _np(self.clip.encode_image(images[i : i + bs]))
                for i in range(0, len(images), bs)
            ]
            return np.concatenate(chunks)
        flat = images.reshape(len(images), -1).astype(np.float32)
        return flat / np.maximum(np.linalg.norm(flat, axis=1, keepdims=True), 1e-8)

    def _text_features(self, texts: Sequence[str]) -> np.ndarray:
        from sklearn.feature_extraction.text import TfidfVectorizer

        if len(texts) < 2:
            return np.zeros((len(texts), 1), np.float32)
        vec = TfidfVectorizer().fit_transform(texts)
        arr = np.asarray(vec.todense(), dtype=np.float32)
        norms = np.maximum(np.linalg.norm(arr, axis=1, keepdims=True), 1e-8)
        return arr / norms

    def _duplicate_pairs(self, feats: np.ndarray, threshold: float) -> List[tuple]:
        """Blocked upper-triangular similarity scan."""
        n = len(feats)
        bs = self.config.block_size
        pairs = []
        for i0 in range(0, n, bs):
            a = feats[i0 : i0 + bs]
            for j0 in range(i0, n, bs):
                b = feats[j0 : j0 + bs]
                sims = a @ b.T
                ii, jj = np.where(sims >= threshold)
                for i, j in zip(ii + i0, jj + j0):
                    if i < j:
                        pairs.append((int(i), int(j), float(sims[i - i0, j - j0])))
        return pairs

    # -- distribution shift (reference :30-54 distribution checks) --------------
    def check_distribution_shift(
        self, images_a: np.ndarray, images_b: np.ndarray
    ) -> Dict[str, Any]:
        """Feature-space shift between two splits: mean-embedding distance,
        diagonal Frechet distance, and the fraction of (highest-variance)
        feature dims a two-sample KS test flags as shifted."""
        from scipy import stats as sps

        cfg = self.config
        fa = self._image_features(np.asarray(images_a))
        fb = self._image_features(np.asarray(images_b))
        mu_a, mu_b = fa.mean(0), fb.mean(0)
        var_a, var_b = fa.var(0), fb.var(0)
        mean_dist = float(np.linalg.norm(mu_a - mu_b))
        frechet_diag = float(
            np.sum((mu_a - mu_b) ** 2)
            + np.sum(var_a + var_b - 2.0 * np.sqrt(np.maximum(var_a * var_b, 0.0)))
        )
        dims = np.argsort(-(var_a + var_b))[: cfg.ks_max_dims]
        shifted = sum(
            1 for d in dims if sps.ks_2samp(fa[:, d], fb[:, d]).pvalue < cfg.ks_alpha
        )
        frac = shifted / max(len(dims), 1)
        return {
            "mean_distance": mean_dist,
            "frechet_diag": frechet_diag,
            "ks_dims_tested": int(len(dims)),
            "ks_fraction_shifted": float(frac),
            "shifted": bool(frac > cfg.shift_ks_fraction),
        }

    # -- DBSCAN cluster / outlier check (reference :30-54) -----------------------
    def cluster_check(self, images: np.ndarray) -> Dict[str, Any]:
        """DBSCAN over image features: cluster count + noise (outlier)
        indices. eps defaults to the median 4-NN cosine distance."""
        from sklearn.cluster import DBSCAN

        cfg = self.config
        feats = self._image_features(np.asarray(images))
        n = len(feats)
        if n < cfg.dbscan_min_samples + 1:
            return {"n_clusters": 0, "outlier_indices": [], "eps": 0.0}
        eps = cfg.dbscan_eps
        if eps is None:
            sims = np.clip(feats @ feats.T, -1.0, 1.0)
            dists = 1.0 - sims
            np.fill_diagonal(dists, np.inf)
            knn = np.sort(dists, axis=1)[:, cfg.dbscan_min_samples - 1]
            eps = float(np.median(knn) * 1.5) or 0.1
        labels = DBSCAN(eps=eps, min_samples=cfg.dbscan_min_samples, metric="cosine").fit_predict(feats)
        outliers = [int(i) for i in np.where(labels == -1)[0]]
        return {
            "n_clusters": int(len(set(labels)) - (1 if -1 in labels else 0)),
            "outlier_indices": outliers,
            "outlier_fraction": len(outliers) / n,
            "eps": float(eps),
        }

    # -- checks ------------------------------------------------------------------
    def validate(
        self,
        images: np.ndarray,
        texts: Sequence[str],
        train_images: Optional[np.ndarray] = None,
        reference_images: Optional[np.ndarray] = None,
        check_clusters: bool = False,
    ) -> ValidationResult:
        cfg = self.config
        n = len(texts)

        # caption validity
        invalid = [
            i
            for i, t in enumerate(texts)
            if not (cfg.min_caption_words <= len(t.split()) <= cfg.max_caption_words)
        ]
        # image quality (blank/flat detection)
        stds = np.asarray(images).reshape(n, -1).std(axis=1)
        low_quality = [int(i) for i in np.where(stds < cfg.min_image_std)[0]]

        # duplicates
        feats = self._image_features(np.asarray(images))
        near_dupes = self._duplicate_pairs(feats, cfg.near_duplicate_threshold)
        exact = [(i, j, s) for i, j, s in near_dupes if s > 0.9999]

        tfeats = self._text_features(texts)
        text_dupes = (
            self._duplicate_pairs(tfeats, cfg.text_duplicate_threshold)
            if tfeats.shape[1] > 1
            else []
        )

        # train/test leakage: eval images near-identical to train images
        leakage: List[tuple] = []
        if train_images is not None:
            train_feats = self._image_features(np.asarray(train_images))
            sims = feats @ train_feats.T
            ii, jj = np.where(sims >= cfg.near_duplicate_threshold)
            leakage = [
                (int(i), int(j), float(sims[i, j])) for i, j in zip(ii, jj)
            ]

        shift = (
            self.check_distribution_shift(images, reference_images)
            if reference_images is not None
            else None
        )
        clusters = self.cluster_check(images) if check_clusters else None

        passed = not (exact or leakage or invalid or low_quality) and not (
            shift is not None and shift["shifted"]
        )
        return ValidationResult(
            num_samples=n,
            exact_duplicate_pairs=exact,
            near_duplicate_pairs=near_dupes,
            text_duplicate_pairs=text_dupes,
            leakage_pairs=leakage,
            invalid_captions=invalid,
            low_quality_images=low_quality,
            passed=passed,
            summary={
                "num_samples": n,
                "near_duplicates": len(near_dupes),
                "text_duplicates": len(text_dupes),
                "leakage": len(leakage),
                "invalid_captions": len(invalid),
                "low_quality_images": len(low_quality),
                **({"distribution_shifted": shift["shifted"]} if shift else {}),
                **({"n_clusters": clusters["n_clusters"]} if clusters else {}),
            },
            distribution_shift=shift,
            clusters=clusters,
        )
