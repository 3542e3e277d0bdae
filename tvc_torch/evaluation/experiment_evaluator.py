"""Experiment-level evaluation: cross-validation, significance tests,
baseline deltas.

Covers reference src/evaluation/experiment_evaluator.py
(ExperimentEvaluator :109, ExperimentConfig :33, ExperimentResult :74:
k-fold cross-validation :45-47, paired significance tests :50-51, plots,
baseline comparison :68-71). Port of ``tvc/evaluation/experiment_evaluator.py``
on ``tvc_torch.metrics``; host numpy and scipy.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from tvc_torch.metrics import DetectionEvaluator, bootstrap_ci


@dataclasses.dataclass
class ExperimentConfig:
    """(reference :33-73)"""

    n_folds: int = 5
    confidence_level: float = 0.95
    n_bootstrap: int = 1000
    significance_alpha: float = 0.05
    seed: int = 42
    generate_plots: bool = False
    output_dir: str = "./results/evaluation"


@dataclasses.dataclass
class ExperimentResult:
    """(reference :74-108)"""

    metrics: Dict[str, float]
    fold_metrics: List[Dict[str, float]]
    confidence_intervals: Dict[str, tuple]
    significance: Optional[Dict[str, Any]] = None
    artifacts: List[str] = dataclasses.field(default_factory=list)


class ExperimentEvaluator:
    def __init__(self, config: Optional[ExperimentConfig] = None):
        self.config = config or ExperimentConfig()

    def cross_validate(
        self, labels: np.ndarray, scores: np.ndarray
    ) -> ExperimentResult:
        """k-fold metric stability over a fixed score set (reference :136+:
        detection is training-free, so folds resample the eval set)."""
        cfg = self.config
        labels = np.asarray(labels)
        scores = np.asarray(scores)
        rng = np.random.default_rng(cfg.seed)
        idx = rng.permutation(len(labels))
        folds = np.array_split(idx, cfg.n_folds)
        fold_metrics = []
        for f in folds:
            if len(np.unique(labels[f])) < 2:
                continue
            m = DetectionEvaluator.evaluate(labels[f], scores[f])
            fold_metrics.append(
                {"auroc": m.auroc, "f1": m.f1, "accuracy": m.accuracy}
            )
        overall = DetectionEvaluator.evaluate(labels, scores)
        cis = {}
        for key in ("auroc", "f1", "accuracy"):
            vals = [fm[key] for fm in fold_metrics]
            cis[key] = bootstrap_ci(
                vals, n_bootstrap=cfg.n_bootstrap, confidence=cfg.confidence_level,
                seed=cfg.seed,
            )
        artifacts: List[str] = []
        if cfg.generate_plots:
            artifacts = self._plots(labels, scores)
        return ExperimentResult(
            metrics={
                "auroc": overall.auroc,
                "f1": overall.f1,
                "accuracy": overall.accuracy,
                "fpr_at_95_tpr": overall.fpr_at_95_tpr,
            },
            fold_metrics=fold_metrics,
            confidence_intervals=cis,
            artifacts=artifacts,
        )

    def _plots(self, labels: np.ndarray, scores: np.ndarray) -> List[str]:
        """ROC + score-distribution PNGs into output_dir (reference
        ExperimentConfig plots, :68-71)."""
        from tvc_torch.utils.visualization import VisualizationManager

        paths: List[str] = []
        try:
            viz = VisualizationManager(output_dir=self.config.output_dir)
            paths.append(viz.plot_roc_curve(labels, scores))
            if np.any(labels == 1) and np.any(labels == 0):
                paths.append(
                    viz.plot_score_distribution(
                        scores[labels == 0], scores[labels == 1]
                    )
                )
        except Exception:  # matplotlib backend issues must not fail evaluation
            pass
        return paths

    def compare_methods(
        self,
        labels: np.ndarray,
        scores_a: np.ndarray,
        scores_b: np.ndarray,
        name_a: str = "method_a",
        name_b: str = "method_b",
    ) -> Dict[str, Any]:
        """Paired significance test over per-fold AUROC (reference :50-51:
        Wilcoxon signed-rank; falls back to t-test for tiny fold counts)."""
        ra = self.cross_validate(labels, scores_a)
        rb = self.cross_validate(labels, scores_b)
        a = np.asarray([m["auroc"] for m in ra.fold_metrics])
        b = np.asarray([m["auroc"] for m in rb.fold_metrics])
        n = min(len(a), len(b))
        a, b = a[:n], b[:n]
        from scipy import stats as sps

        if n >= 6 and not np.allclose(a, b):
            stat, pvalue = sps.wilcoxon(a, b)
            test = "wilcoxon"
        elif n >= 2 and not np.allclose(a, b):
            stat, pvalue = sps.ttest_rel(a, b)
            test = "paired_t"
        else:
            stat, pvalue, test = 0.0, 1.0, "degenerate"
        return {
            name_a: ra.metrics,
            name_b: rb.metrics,
            "test": test,
            "statistic": float(stat),
            "p_value": float(pvalue),
            "significant": bool(pvalue < self.config.significance_alpha),
            "auroc_delta": float(ra.metrics["auroc"] - rb.metrics["auroc"]),
        }

    def evaluate_pipeline(
        self,
        pipeline,
        images,
        texts: Sequence[str],
        labels: Sequence[int],
    ) -> ExperimentResult:
        """Run the pipeline then cross-validate its scores (reference :136)."""
        res = pipeline.process_batch(images, list(texts))
        return self.cross_validate(np.asarray(labels), res.scores)
