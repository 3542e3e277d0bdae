"""Result visualization: ROC/PR curves, score distributions, embedding
projections, confusion matrices.

Port of ``tvc/utils/visualization.py`` (reference src/utils/visualization.py:
:31 ROC, :179 PR, :283 distribution, :432 t-SNE, :591 confusion, :828
VisualizationManager). matplotlib (Agg backend, PNG out) and scikit-learn
(t-SNE, PCA) are imported inside the methods that draw, so the module imports
where neither is installed; a method then raises ``ImportError``. ROC and PR
curves come from the port's own metrics, not scikit-learn.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np


def _pyplot():
    """matplotlib's pyplot on the Agg backend, imported at first use."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


class VisualizationManager:
    """(reference src/utils/visualization.py:828)"""

    def __init__(self, output_dir: str = "./results/figures", dpi: int = 150):
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.dpi = dpi

    def _save(self, fig, name: str) -> str:
        path = self.output_dir / f"{name}.png"
        fig.savefig(path, dpi=self.dpi, bbox_inches="tight")
        _pyplot().close(fig)
        return str(path)

    def plot_roc_curve(
        self, labels: np.ndarray, scores: np.ndarray, name: str = "roc_curve"
    ) -> str:
        """(reference :31-178)"""
        from tvc_torch.metrics import DetectionEvaluator

        plt = _pyplot()
        fpr, tpr, _ = DetectionEvaluator.roc_curve(labels, scores)
        fig, ax = plt.subplots(figsize=(6, 5))
        ax.plot(fpr, tpr, label=f"AUC = {DetectionEvaluator.auroc(labels, scores):.4f}")
        ax.plot([0, 1], [0, 1], "--", color="gray", alpha=0.5)
        ax.set_xlabel("False positive rate")
        ax.set_ylabel("True positive rate")
        ax.set_title("ROC curve")
        ax.legend()
        return self._save(fig, name)

    def plot_pr_curve(
        self, labels: np.ndarray, scores: np.ndarray, name: str = "pr_curve"
    ) -> str:
        """(reference :179-282)"""
        from tvc_torch.metrics import DetectionEvaluator, _binary_clf_curve

        plt = _pyplot()
        fps, tps, _ = _binary_clf_curve(labels, scores)
        prec = np.r_[(tps / (tps + fps))[::-1], 1.0]
        rec = np.r_[(tps / tps[-1])[::-1], 0.0]
        fig, ax = plt.subplots(figsize=(6, 5))
        ap = DetectionEvaluator.average_precision(labels, scores)
        ax.plot(rec, prec, label=f"AP = {ap:.4f}")
        ax.set_xlabel("Recall")
        ax.set_ylabel("Precision")
        ax.set_title("Precision-recall curve")
        ax.legend()
        return self._save(fig, name)

    def plot_score_distribution(
        self,
        clean_scores: np.ndarray,
        adv_scores: np.ndarray,
        threshold: Optional[float] = None,
        name: str = "score_distribution",
    ) -> str:
        """(reference :283-431)"""
        plt = _pyplot()
        fig, ax = plt.subplots(figsize=(6, 4))
        bins = np.linspace(
            min(clean_scores.min(), adv_scores.min()),
            max(clean_scores.max(), adv_scores.max()),
            40,
        )
        ax.hist(clean_scores, bins=bins, alpha=0.6, label="clean", density=True)
        ax.hist(adv_scores, bins=bins, alpha=0.6, label="adversarial", density=True)
        if threshold is not None:
            ax.axvline(threshold, color="red", linestyle="--", label=f"threshold {threshold:.3f}")
        ax.set_xlabel("Detection score")
        ax.set_ylabel("Density")
        ax.legend()
        return self._save(fig, name)

    def plot_embeddings(
        self,
        embeddings: np.ndarray,
        labels: Sequence[int],
        name: str = "embeddings",
        method: str = "pca",
    ) -> str:
        """2D projection of embeddings (reference :432-590; PCA default —
        t-SNE and UMAP available; UMAP is the first-party implementation
        in umap_lite.py, since umap-learn is not a dependency)."""
        plt = _pyplot()
        if method == "tsne":
            from sklearn.manifold import TSNE

            xy = TSNE(n_components=2, random_state=0).fit_transform(embeddings)
        elif method == "umap":
            from tvc_torch.utils.umap_lite import umap_embed

            xy = umap_embed(np.asarray(embeddings), n_components=2, seed=0)
        else:
            from sklearn.decomposition import PCA

            xy = PCA(n_components=2, random_state=0).fit_transform(embeddings)
        labels = np.asarray(labels)
        fig, ax = plt.subplots(figsize=(6, 5))
        for lab in np.unique(labels):
            m = labels == lab
            ax.scatter(xy[m, 0], xy[m, 1], s=8, alpha=0.7, label=str(lab))
        ax.legend()
        ax.set_title(f"Embedding projection ({method})")
        return self._save(fig, name)

    def plot_roc_family(
        self,
        curves: Dict[str, Dict[str, Sequence[float]]],
        name: str = "roc_family",
        title: str = "ROC curves",
    ) -> str:
        """Overlayed ROC curves from precomputed points — e.g. one curve
        per ε of the four-scenarios epsilon sweep (``curves[label] =
        {"fpr": [...], "tpr": [...]}``)."""
        plt = _pyplot()
        fig, ax = plt.subplots(figsize=(6, 5))
        for label, c in curves.items():
            ax.plot(c["fpr"], c["tpr"], marker=".", ms=3, label=label)
        ax.plot([0, 1], [0, 1], "--", color="gray", alpha=0.5)
        ax.set_xlabel("False positive rate")
        ax.set_ylabel("True positive rate")
        ax.set_title(title)
        ax.legend(fontsize=8)
        return self._save(fig, name)

    def plot_lines(
        self,
        x: Sequence[float],
        series: Dict[str, Sequence[float]],
        name: str = "lines",
        xlabel: str = "",
        ylabel: str = "",
        title: str = "",
        logx: bool = False,
    ) -> str:
        """Simple multi-series line chart (e.g. detection metrics vs the
        adaptive attacker's penalty weight λ)."""
        plt = _pyplot()
        fig, ax = plt.subplots(figsize=(6, 4))
        for label, ys in series.items():
            ax.plot(x, ys, marker="o", ms=4, label=label)
        if logx:
            ax.set_xscale("symlog", linthresh=min([v for v in x if v > 0] or [1]))
        ax.set_xlabel(xlabel)
        ax.set_ylabel(ylabel)
        if title:
            ax.set_title(title)
        ax.legend(fontsize=8)
        return self._save(fig, name)

    def plot_confusion_matrix(
        self, matrix: np.ndarray, name: str = "confusion_matrix"
    ) -> str:
        """(reference :591-717)"""
        plt = _pyplot()
        fig, ax = plt.subplots(figsize=(4, 4))
        im = ax.imshow(matrix, cmap="Blues")
        for i in range(matrix.shape[0]):
            for j in range(matrix.shape[1]):
                ax.text(j, i, str(int(matrix[i, j])), ha="center", va="center")
        ax.set_xticks([0, 1], ["clean", "adv"])
        ax.set_yticks([0, 1], ["clean", "adv"])
        ax.set_xlabel("Predicted")
        ax.set_ylabel("Actual")
        fig.colorbar(im, shrink=0.8)
        return self._save(fig, name)

    def plot_metric_bars(
        self, metrics: Dict[str, float], name: str = "metrics"
    ) -> str:
        """(reference :718-827)"""
        plt = _pyplot()
        fig, ax = plt.subplots(figsize=(max(4, len(metrics)), 4))
        keys = list(metrics)
        vals = [metrics[k] for k in keys]
        ax.bar(keys, vals)
        ax.set_ylim(0, max(1.0, max(vals) * 1.1))
        for i, v in enumerate(vals):
            ax.text(i, v, f"{v:.3f}", ha="center", va="bottom", fontsize=8)
        plt.xticks(rotation=30, ha="right")
        return self._save(fig, name)

    def plot_grouped_bars(
        self,
        groups: Dict[str, Dict[str, float]],
        name: str = "grouped",
        ylabel: str = "",
    ) -> str:
        """Grouped bar chart: ``groups[series][category] = value``
        (reference generate_charts.py baseline/ablation charts)."""
        plt = _pyplot()
        series = list(groups)
        cats = sorted({c for g in groups.values() for c in g})
        n_s, n_c = len(series), len(cats)
        width = 0.8 / max(n_s, 1)
        fig, ax = plt.subplots(figsize=(max(5, 1.2 * n_c), 4))
        x = np.arange(n_c)
        for i, s in enumerate(series):
            vals = [groups[s].get(c, 0.0) for c in cats]
            ax.bar(x + (i - (n_s - 1) / 2) * width, vals, width, label=s)
        ax.set_xticks(x, cats, rotation=30, ha="right")
        if ylabel:
            ax.set_ylabel(ylabel)
        ax.legend(fontsize=8)
        return self._save(fig, name)

    def plot_dashboard(
        self, panels: Dict[str, Dict[str, float]], name: str = "dashboard"
    ) -> str:
        """Summary dashboard: one bar-panel per experiment family
        (reference generate_charts.py:535-558 generate_summary_dashboard)."""
        plt = _pyplot()
        n = max(len(panels), 1)
        ncols = min(n, 3)
        nrows = (n + ncols - 1) // ncols
        fig, axes = plt.subplots(
            nrows, ncols, figsize=(4.5 * ncols, 3.5 * nrows), squeeze=False
        )
        for ax in axes.ravel():
            ax.set_visible(False)
        for ax, (title, metrics) in zip(axes.ravel(), panels.items()):
            ax.set_visible(True)
            keys = list(metrics)
            vals = [metrics[k] for k in keys]
            ax.bar(keys, vals)
            ax.set_title(title, fontsize=10)
            ax.set_ylim(0, max(1.0, max(vals) * 1.1) if vals else 1.0)
            ax.tick_params(axis="x", rotation=30, labelsize=7)
            for i, v in enumerate(vals):
                ax.text(i, v, f"{v:.2f}", ha="center", va="bottom", fontsize=6)
        fig.tight_layout()
        return self._save(fig, name)


# reference alias (experiments side)
ExperimentVisualizer = VisualizationManager
