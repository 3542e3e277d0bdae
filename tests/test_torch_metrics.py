"""tvc_torch's metrics (``tvc_torch/metrics.py``, numpy only) against the JAX
package's ``tvc/metrics.py`` (scikit-learn for the detection metrics) on
seeded scores with ties: every detection metric equal within float
rounding, the ROC curve point for point; the retrieval metrics, bootstrap
intervals and the aggregator equal."""

import dataclasses

import numpy as np
import pytest

from tvc import metrics as jm
from tvc_torch import metrics as tm


def _scores(seed, n=200, tied=True):
    rng = np.random.default_rng(seed)
    labels = (rng.random(n) < 0.4).astype(int)
    scores = rng.normal(labels * 0.8, 1.0)
    if tied:
        scores = np.round(scores, 1)  # many equal scores across both classes
    return labels, scores


@pytest.mark.parametrize("seed,tied", [(0, True), (1, False), (2, True), (3, False)])
def test_detection_metrics_equal_sklearn_backed_jax(seed, tied):
    labels, scores = _scores(seed, tied=tied)
    for got, want in zip(tm.DetectionEvaluator.roc_curve(labels, scores),
                         jm.DetectionEvaluator.roc_curve(labels, scores)):
        np.testing.assert_array_equal(got, want)
    g, w = tm.DetectionEvaluator.evaluate(labels, scores), jm.DetectionEvaluator.evaluate(labels, scores)
    for k in ("auroc", "accuracy", "precision", "recall", "f1", "fpr_at_95_tpr", "optimal_threshold", "aupr"):
        assert getattr(g, k) == pytest.approx(getattr(w, k), abs=1e-12), k
    np.testing.assert_array_equal(g.confusion_matrix, w.confusion_matrix)
    fixed = tm.DetectionEvaluator.evaluate(labels, scores, threshold=0.3)
    want = jm.DetectionEvaluator.evaluate(labels, scores, threshold=0.3)
    assert (fixed.precision, fixed.recall, fixed.f1) == pytest.approx((want.precision, want.recall, want.f1), abs=1e-12)


def test_detection_metrics_edge_cases_equal_jax():
    one_class = tm.DetectionEvaluator.evaluate([1, 1, 1], [0.2, 0.7, 0.9])
    want = jm.DetectionEvaluator.evaluate([1, 1, 1], [0.2, 0.7, 0.9])
    assert np.isnan(one_class.auroc) and one_class.accuracy == want.accuracy
    np.testing.assert_array_equal(one_class.confusion_matrix, want.confusion_matrix)
    # a threshold above every score: no positive prediction, zero-division
    # precision and f1 are 0
    none = tm.DetectionEvaluator.evaluate([0, 1, 0, 1], [0.1, 0.4, 0.35, 0.8], threshold=2.0)
    assert (none.precision, none.recall, none.f1) == (0.0, 0.0, 0.0)
    perfect = tm.DetectionEvaluator.evaluate([0, 0, 1, 1], [0.1, 0.2, 0.8, 0.9])
    assert perfect.auroc == 1.0 and perfect.aupr == 1.0 and perfect.fpr_at_95_tpr == 0.0


def test_retrieval_bootstrap_and_aggregator_equal_jax():
    rng = np.random.default_rng(4)
    ranked = np.argsort(rng.random((30, 60)), axis=1)
    relevant = [set(rng.choice(60, size=int(rng.integers(0, 4)), replace=False).tolist()) for _ in range(30)]
    g = tm.RetrievalEvaluator.evaluate_from_ranks(ranked, relevant)
    w = jm.RetrievalEvaluator.evaluate_from_ranks(ranked, relevant)
    assert dataclasses.asdict(g) == dataclasses.asdict(w)
    vals = rng.random(40)
    assert tm.bootstrap_ci(vals, 200, seed=3) == jm.bootstrap_ci(vals, 200, seed=3)
    ga, wa = tm.MetricsAggregator(), jm.MetricsAggregator()
    for r in ({"a": 1.0, "b": float("nan")}, {"a": 3.0, "b": 2.0}):
        ga.add(r)
        wa.add(r)
    assert ga.summary() == wa.summary()
