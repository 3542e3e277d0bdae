"""Detection and retrieval metrics (port of ``tvc/metrics.py``), numpy on
the host: DetectionEvaluator (ROC AUC, Youden-J optimal threshold, FPR at
95 % TPR, average precision), RetrievalEvaluator (Recall / Precision / NDCG
at K for K in {1, 5, 10, 20, 50}, mAP, MRR), bootstrap confidence
intervals and a per-batch metric aggregator.

The JAX package calls scikit-learn for the detection metrics; the port
computes the same definitions in numpy (the machine with the card has no
scikit-learn): ``roc_curve`` as ``sklearn.metrics.roc_curve`` with its
default ``drop_intermediate=True`` (thresholds at the distinct scores,
descending, after an infinite first one; a score equal to the threshold
counts as positive), the AUC by the trapezoidal rule over that curve, and
average precision as ``sum_n (R_n - R_{n-1}) P_n`` over the distinct
thresholds.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class DetectionMetrics:
    auroc: float
    accuracy: float
    precision: float
    recall: float
    f1: float
    fpr_at_95_tpr: float
    optimal_threshold: float
    confusion_matrix: np.ndarray  # [[tn, fp], [fn, tp]]
    aupr: float = 0.0


@dataclasses.dataclass
class RetrievalMetrics:
    recall_at_k: Dict[int, float]
    precision_at_k: Dict[int, float]
    ndcg_at_k: Dict[int, float]
    mean_average_precision: float
    mean_reciprocal_rank: float


DEFAULT_KS = (1, 5, 10, 20, 50)


def _binary_clf_curve(labels, scores) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(false positives, true positives, thresholds) at each distinct score,
    scores descending."""
    labels = np.asarray(labels).astype(np.float64)
    scores = np.asarray(scores, dtype=np.float64)
    order = np.argsort(scores, kind="mergesort")[::-1]
    scores, labels = scores[order], labels[order]
    idx = np.r_[np.where(np.diff(scores))[0], labels.size - 1]
    tps = np.cumsum(labels)[idx]
    return 1 + idx - tps, tps, scores[idx]


def _confusion(labels: np.ndarray, preds: np.ndarray) -> np.ndarray:
    return np.array([[np.sum((labels == t) & (preds == p)) for p in (0, 1)] for t in (0, 1)], dtype=np.int64)


class DetectionEvaluator:
    @staticmethod
    def roc_curve(labels: np.ndarray, scores: np.ndarray):
        """(fpr, tpr, thresholds) with collinear interior points dropped."""
        fps, tps, thr = _binary_clf_curve(labels, scores)
        if fps.size > 2:
            keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True])[0]
            fps, tps, thr = fps[keep], tps[keep], thr[keep]
        fps, tps, thr = np.r_[0, fps], np.r_[0, tps], np.r_[np.inf, thr]
        return fps / fps[-1], tps / tps[-1], thr

    @staticmethod
    def auroc(labels: np.ndarray, scores: np.ndarray) -> float:
        labels = np.asarray(labels)
        if len(np.unique(labels)) < 2:
            return float("nan")
        fpr, tpr, _ = DetectionEvaluator.roc_curve(labels, scores)
        return float(np.sum(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2))

    @staticmethod
    def average_precision(labels: np.ndarray, scores: np.ndarray) -> float:
        fps, tps, _ = _binary_clf_curve(labels, scores)
        precision = np.r_[(tps / (tps + fps))[::-1], 1.0]
        recall = np.r_[(tps / tps[-1])[::-1], 0.0]
        return float(-np.sum(np.diff(recall) * precision[:-1]))

    @staticmethod
    def optimal_threshold_youden(labels: np.ndarray, scores: np.ndarray) -> float:
        """Youden-J: argmax(tpr - fpr)."""
        fpr, tpr, thresholds = DetectionEvaluator.roc_curve(labels, scores)
        j = tpr - fpr
        return float(thresholds[int(np.argmax(j))])

    @staticmethod
    def fpr_at_tpr(labels: np.ndarray, scores: np.ndarray, target_tpr: float = 0.95) -> float:
        """FPR at the first threshold reaching target TPR."""
        fpr, tpr, _ = DetectionEvaluator.roc_curve(labels, scores)
        idx = np.searchsorted(tpr, target_tpr, side="left")
        if idx >= len(fpr):
            return 1.0
        return float(fpr[idx])

    @staticmethod
    def evaluate(
        labels: Sequence[int],
        scores: Sequence[float],
        threshold: Optional[float] = None,
    ) -> DetectionMetrics:
        labels = np.asarray(labels).astype(int)
        scores = np.asarray(scores, dtype=np.float64)
        auroc = DetectionEvaluator.auroc(labels, scores)
        if len(np.unique(labels)) < 2:
            thr = 0.5 if threshold is None else threshold
            preds = (scores > thr).astype(int)
            acc = float(np.mean(preds == labels))
            return DetectionMetrics(
                auroc=float("nan"), accuracy=acc, precision=0.0, recall=0.0,
                f1=0.0, fpr_at_95_tpr=float("nan"), optimal_threshold=thr,
                confusion_matrix=_confusion(labels, preds),
            )
        opt = DetectionEvaluator.optimal_threshold_youden(labels, scores)
        thr = opt if threshold is None else threshold
        # >= matches the ROC curve's semantics (score == threshold counts as
        # positive), so metrics at the Youden threshold equal the curve's
        preds = (scores >= thr).astype(int)
        cm = _confusion(labels, preds)
        (tn, fp), (fn, tp) = cm
        return DetectionMetrics(
            auroc=auroc,
            accuracy=float(np.mean(preds == labels)),
            precision=float(tp / (tp + fp)) if tp + fp else 0.0,
            recall=float(tp / (tp + fn)) if tp + fn else 0.0,
            f1=float(2 * tp / (2 * tp + fp + fn)) if tp else 0.0,
            fpr_at_95_tpr=DetectionEvaluator.fpr_at_tpr(labels, scores, 0.95),
            optimal_threshold=opt,
            confusion_matrix=cm,
            aupr=DetectionEvaluator.average_precision(labels, scores),
        )


class RetrievalEvaluator:
    """Ranking inputs come from the device (bank top-k); the metric math is
    host numpy."""

    @staticmethod
    def evaluate_from_ranks(
        ranked_indices: np.ndarray,
        relevant: Sequence[set],
        ks: Sequence[int] = DEFAULT_KS,
    ) -> RetrievalMetrics:
        """ranked_indices: [Q, N] result ids by descending score;
        relevant[q]: set of relevant ids for query q."""
        ranked = np.asarray(ranked_indices)
        Q = ranked.shape[0]
        recall, precision, ndcg = {}, {}, {}
        for k in ks:
            r_sum = p_sum = n_sum = 0.0
            for q in range(Q):
                rel = relevant[q]
                if not rel:
                    continue
                topk = ranked[q, :k]
                hits = sum(1 for x in topk if x in rel)
                r_sum += hits / len(rel)
                p_sum += hits / k
                dcg = sum(
                    1.0 / np.log2(i + 2) for i, x in enumerate(topk) if x in rel
                )
                ideal = sum(1.0 / np.log2(i + 2) for i in range(min(k, len(rel))))
                n_sum += dcg / ideal if ideal > 0 else 0.0
            recall[k] = r_sum / Q
            precision[k] = p_sum / Q
            ndcg[k] = n_sum / Q

        # mAP + MRR over the full ranking
        ap_sum = rr_sum = 0.0
        for q in range(Q):
            rel = relevant[q]
            if not rel:
                continue
            hits = 0
            ap = 0.0
            rr = 0.0
            for i, x in enumerate(ranked[q]):
                if x in rel:
                    hits += 1
                    ap += hits / (i + 1)
                    if rr == 0.0:
                        rr = 1.0 / (i + 1)
            ap_sum += ap / len(rel)
            rr_sum += rr
        return RetrievalMetrics(
            recall_at_k=recall,
            precision_at_k=precision,
            ndcg_at_k=ndcg,
            mean_average_precision=ap_sum / Q,
            mean_reciprocal_rank=rr_sum / Q,
        )


def bootstrap_ci(
    values: Sequence[float],
    n_bootstrap: int = 1000,
    confidence: float = 0.95,
    seed: int = 0,
) -> Tuple[float, float, float]:
    """(mean, lo, hi) bootstrap confidence interval."""
    values = np.asarray(values, dtype=np.float64)
    if values.size == 0:
        return 0.0, 0.0, 0.0
    rng = np.random.default_rng(seed)
    means = np.mean(
        values[rng.integers(0, values.size, size=(n_bootstrap, values.size))],
        axis=1,
    )
    alpha = (1 - confidence) / 2
    return (
        float(values.mean()),
        float(np.quantile(means, alpha)),
        float(np.quantile(means, 1 - alpha)),
    )


class MetricsAggregator:
    """Accumulate per-batch metric dicts into mean/std summaries."""

    def __init__(self):
        self._records: List[Dict[str, float]] = []

    def add(self, record: Dict[str, float]) -> None:
        self._records.append(dict(record))

    def summary(self) -> Dict[str, Dict[str, float]]:
        if not self._records:
            return {}
        keys = set().union(*(r.keys() for r in self._records))
        out = {}
        for k in sorted(keys):
            vals = np.asarray(
                [r[k] for r in self._records if k in r and np.isfinite(r[k])]
            )
            if vals.size == 0:
                continue
            out[k] = {
                "mean": float(vals.mean()),
                "std": float(vals.std()),
                "min": float(vals.min()),
                "max": float(vals.max()),
                "count": int(vals.size),
            }
        return out
