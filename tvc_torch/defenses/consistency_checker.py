"""Stateful decision layer of the alt defense stack (port of
``tvc/defenses/consistency_checker.py``): simple / weighted / adaptive
voting, the adaptive threshold smoothed toward the mean of the last ten
thresholds, the confidence, and the ROC-optimal calibration.

The batched math lives in ``tvc_torch.core.consistency``; this class
carries the host-side running state (threshold history, detection
history).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from tvc_torch.core import consistency as C


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


class ConsistencyChecker:
    def __init__(
        self,
        threshold: float = 0.5,
        adaptive_threshold: bool = True,
        voting_strategy: str = "weighted",
        weights: Optional[Dict[str, float]] = None,
    ):
        self.base_threshold = threshold
        self.adaptive = adaptive_threshold
        self.voting_strategy = voting_strategy
        w = weights or {
            "original_similarity": 0.25,
            "text_variant_consistency": 0.25,
            "retrieval_consistency": 0.25,
            "generative_consistency": 0.25,
        }
        self.weights = torch.tensor(
            [
                w.get("original_similarity", 0.25),
                w.get("text_variant_consistency", 0.25),
                w.get("retrieval_consistency", 0.25),
                w.get("generative_consistency", 0.25),
            ],
            dtype=torch.float32,
        )
        self.detection_history: List[Dict[str, Any]] = []
        self.threshold_history: List[float] = []

    def make_decision(self, metrics: C.ConsistencyMetrics, return_details: bool = False) -> Dict[str, Any]:
        """Batched decision. All outputs are [B] arrays."""
        overall = C.overall_score(metrics, self.voting_strategy, self.weights.to(metrics.original_similarity.device))
        if self.adaptive:
            history_mean = (
                torch.tensor(float(np.mean(self.threshold_history[-10:])))
                if len(self.threshold_history) > 10
                else None
            )
            thr = C.adaptive_threshold(metrics, self.base_threshold, history_mean)
        else:
            thr = torch.full_like(overall, self.base_threshold)
        is_adv = C.alt_is_adversarial(overall, thr)
        conf = C.decision_confidence(overall, thr, metrics.cross_modal_variance)

        overall_np, thr_np, adv_np = _np(overall), _np(thr), _np(is_adv)
        for i in range(overall_np.shape[0] if overall_np.ndim else 1):
            self.threshold_history.append(float(np.atleast_1d(thr_np)[i]))
            self.detection_history.append(
                {
                    "overall_score": float(np.atleast_1d(overall_np)[i]),
                    "threshold": float(np.atleast_1d(thr_np)[i]),
                    "is_adversarial": bool(np.atleast_1d(adv_np)[i]),
                }
            )
        result = {
            "is_adversarial": adv_np,
            "confidence": _np(conf),
            "overall_score": overall_np,
            "threshold": thr_np,
        }
        if return_details:
            result["details"] = {
                "voting_strategy": self.voting_strategy,
                "stacked_scores": _np(metrics.stacked()),
                "stds": _np(metrics.stds()),
                "cross_modal_variance": _np(metrics.cross_modal_variance),
            }
        return result

    def calibrate_threshold(self, clean_scores: np.ndarray, adv_scores: np.ndarray) -> float:
        """ROC-optimal base threshold on overall scores. Alt-stack
        direction: LOW score = adversarial, so the ROC runs on negated
        scores."""
        from tvc_torch.metrics import DetectionEvaluator

        labels = np.concatenate([np.zeros(len(clean_scores)), np.ones(len(adv_scores))])
        scores = np.concatenate([clean_scores, adv_scores])
        thr = DetectionEvaluator.optimal_threshold_youden(labels, -scores)
        self.base_threshold = float(-thr)
        return self.base_threshold

    def get_stats(self) -> Dict[str, Any]:
        n = len(self.detection_history)
        adv = sum(1 for d in self.detection_history if d["is_adversarial"])
        return {
            "total_decisions": n,
            "adversarial_detected": adv,
            "mean_threshold": float(np.mean(self.threshold_history)) if n else 0.0,
        }
