"""tvc_torch's evaluation layer (``tvc_torch/evaluation``) against the JAX
package's ``tvc/evaluation`` on shared inputs: cross-validation, the paired
significance tests and the dataset validator (flat pixels and the tiny_coco
CLIP on the same weights)."""

import sys

import jax
import numpy as np
import pytest
import matplotlib.pyplot  # noqa: F401  (imported at collection, as scikit-learn: seconds each)
import sklearn.metrics  # noqa: F401

from tvc.evaluation import (
    DataValidationConfig as JDataValidationConfig,
    DataValidator as JDataValidator,
    ExperimentConfig as JExperimentConfig,
    ExperimentEvaluator as JExperimentEvaluator,
)
from tvc.models.clip import CLIPConfig as JClipConfig, CLIPModel as JClip
from tvc_torch.evaluation import (
    DataValidationConfig,
    DataValidator,
    ExperimentConfig,
    ExperimentEvaluator,
    ExperimentResult,
    ValidationResult,
)
from tvc_torch.models.clip import CLIPConfig, CLIPModel, params_from_jax


def _labels_scores(n=60, seed=0, sep=1.0):
    rng = np.random.default_rng(seed)
    labels = np.r_[np.zeros(n // 2), np.ones(n - n // 2)]
    return labels, labels * sep + rng.standard_normal(n)


def _same_experiment_result(got, want):
    assert set(got.metrics) == set(want.metrics)
    for k, v in want.metrics.items():
        assert got.metrics[k] == pytest.approx(v, abs=1e-12), k
    assert len(got.fold_metrics) == len(want.fold_metrics)
    for g, w in zip(got.fold_metrics, want.fold_metrics):
        assert g == pytest.approx(w, abs=1e-12)
    for k, v in want.confidence_intervals.items():
        assert got.confidence_intervals[k] == pytest.approx(v, abs=1e-12), k


@pytest.mark.parametrize("n_folds,seed", [(5, 42), (3, 1), (8, 7)])
def test_cross_validate_equals_jax(n_folds, seed):
    labels, scores = _labels_scores(seed=seed)
    got = ExperimentEvaluator(ExperimentConfig(n_folds=n_folds, seed=seed)).cross_validate(labels, scores)
    want = JExperimentEvaluator(JExperimentConfig(n_folds=n_folds, seed=seed)).cross_validate(labels, scores)
    assert isinstance(got, ExperimentResult)
    _same_experiment_result(got, want)


@pytest.mark.parametrize("n_folds,sep_b,test", [(8, 0.3, "wilcoxon"), (4, 0.3, "paired_t"), (4, 1.0, "degenerate")])
def test_compare_methods_equals_jax(n_folds, sep_b, test):
    labels, a = _labels_scores(seed=1, sep=1.5)
    b = a if test == "degenerate" else _labels_scores(seed=2, sep=sep_b)[1]
    got = ExperimentEvaluator(ExperimentConfig(n_folds=n_folds)).compare_methods(labels, a, b, "a", "b")
    want = JExperimentEvaluator(JExperimentConfig(n_folds=n_folds)).compare_methods(labels, a, b, "a", "b")
    assert got["test"] == want["test"] == test
    for k in ("statistic", "p_value", "auroc_delta"):
        assert got[k] == pytest.approx(want[k], abs=1e-12), k
    assert got["significant"] == want["significant"]
    assert got["a"] == pytest.approx(want["a"], abs=1e-12) and got["b"] == pytest.approx(want["b"], abs=1e-12)


def test_plots_and_evaluate_pipeline(tmp_path):
    labels, scores = _labels_scores()
    got = ExperimentEvaluator(ExperimentConfig(generate_plots=True, output_dir=str(tmp_path / "t"))).cross_validate(
        labels, scores)
    want = JExperimentEvaluator(JExperimentConfig(generate_plots=True, output_dir=str(tmp_path / "j"))).cross_validate(
        labels, scores)
    assert [p.rsplit("/", 1)[1] for p in got.artifacts] == [p.rsplit("/", 1)[1] for p in want.artifacts] == [
        "roc_curve.png", "score_distribution.png"]

    class Pipe:
        def process_batch(self, images, texts):
            return type("R", (), {"scores": scores})()

    texts = [str(i) for i in range(len(labels))]
    _same_experiment_result(ExperimentEvaluator().evaluate_pipeline(Pipe(), None, texts, labels),
                            JExperimentEvaluator().evaluate_pipeline(Pipe(), None, texts, labels))


def _validation_inputs():
    rng = np.random.default_rng(4)
    images = rng.random((12, 8, 8, 3)).astype(np.float32)
    images[5] = images[2]  # an exact duplicate
    images[7] = 0.5  # a blank image
    train = np.concatenate([images[:2], rng.random((4, 8, 8, 3)).astype(np.float32)])
    reference = rng.random((12, 8, 8, 3)).astype(np.float32) * 0.2
    texts = [f"a photo of object number {i} on a table" for i in range(12)]
    texts[9] = texts[3]
    texts[10] = "dog"  # too short
    return images, texts, train, reference


def _same_validation(got, want, atol=2e-5):
    assert isinstance(got, ValidationResult)
    for field in ("exact_duplicate_pairs", "near_duplicate_pairs", "text_duplicate_pairs", "leakage_pairs"):
        g, w = getattr(got, field), getattr(want, field)
        assert [p[:2] for p in g] == [p[:2] for p in w], field
        np.testing.assert_allclose([p[2] for p in g], [p[2] for p in w], atol=atol, rtol=0, err_msg=field)
    assert got.invalid_captions == want.invalid_captions
    assert got.low_quality_images == want.low_quality_images
    assert got.passed == want.passed and got.num_samples == want.num_samples
    assert set(got.summary) == set(want.summary)
    for k, v in want.summary.items():
        assert got.summary[k] == v, k
    for part in ("distribution_shift", "clusters"):
        g, w = getattr(got, part), getattr(want, part)
        assert set(g) == set(w)
        for k, v in w.items():
            assert g[k] == (pytest.approx(v, abs=atol) if isinstance(v, float) else v), (part, k)


def test_validate_on_pixels_equals_jax():
    images, texts, train, reference = _validation_inputs()
    kw = dict(near_duplicate_threshold=0.95, text_duplicate_threshold=0.9, block_size=5)
    got = DataValidator(config=DataValidationConfig(**kw)).validate(
        images, texts, train_images=train, reference_images=reference, check_clusters=True)
    want = JDataValidator(config=JDataValidationConfig(**kw)).validate(
        images, texts, train_images=train, reference_images=reference, check_clusters=True)
    _same_validation(got, want, atol=1e-6)
    assert got.exact_duplicate_pairs and got.leakage_pairs and got.text_duplicate_pairs and not got.passed


class _StubClip:
    """A host encoder both validators batch through (``encode_image``)."""

    def __init__(self):
        self.w = np.random.default_rng(0).standard_normal((8 * 8 * 3, 16)).astype(np.float32)
        self.calls = []

    def encode_image(self, images):
        self.calls.append(len(images))
        f = np.asarray(images, np.float32).reshape(len(images), -1) @ self.w
        return f / np.linalg.norm(f, axis=-1, keepdims=True)


def test_validate_with_an_encoder_equals_jax():
    images, texts, train, reference = _validation_inputs()
    kw = dict(near_duplicate_threshold=0.99, batch_size=5, dbscan_eps=0.2)
    got_clip, want_clip = _StubClip(), _StubClip()
    got = DataValidator(got_clip, DataValidationConfig(**kw)).validate(
        images, texts, train_images=train, reference_images=reference, check_clusters=True)
    want = JDataValidator(want_clip, JDataValidationConfig(**kw)).validate(
        images, texts, train_images=train, reference_images=reference, check_clusters=True)
    _same_validation(got, want, atol=1e-6)
    assert got_clip.calls == want_clip.calls and max(got_clip.calls) == 5


@pytest.mark.slow
def test_validate_with_clip_features_equals_jax():
    """The tiny_coco CLIP on both sides: slow (~3.5 s here, the JAX package
    compiles the tiny tower)."""
    jclip = JClip(JClipConfig.tiny_coco(), seed=0)
    cfg = CLIPConfig.tiny_coco()
    tclip = CLIPModel(cfg, params=params_from_jax(jax.tree_util.tree_map(np.asarray, jclip.params), cfg),
                      device="cpu")
    _, texts, _, _ = _validation_inputs()
    # one batch shape (12 images) for every encode: one JAX compile
    rng = np.random.default_rng(9)
    images, train, reference = (rng.random((12, 32, 32, 3), dtype=np.float32) for _ in range(3))
    train[:2] = images[:2]
    kw = dict(near_duplicate_threshold=0.999, batch_size=12, dbscan_eps=0.01)
    got_v = DataValidator(tclip, DataValidationConfig(**kw))
    want_v = JDataValidator(jclip, JDataValidationConfig(**kw))
    np.testing.assert_allclose(got_v._image_features(images), np.asarray(want_v._image_features(images)),
                               atol=2e-5, rtol=0)
    got = got_v.validate(images, texts, train_images=train, reference_images=reference, check_clusters=True)
    want = want_v.validate(images, texts, train_images=train, reference_images=reference, check_clusters=True)
    _same_validation(got, want)
    assert [p[:2] for p in got.leakage_pairs][:2] == [(0, 0), (1, 1)]


def test_validator_without_sklearn_raises_import_error(monkeypatch):
    """TF-IDF and DBSCAN need scikit-learn, as in the JAX module: where it
    is missing they raise ImportError; the rest of the validator runs."""
    for name in [m for m in sys.modules if m == "sklearn" or m.startswith("sklearn.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    images, texts, _, reference = _validation_inputs()
    v = DataValidator()
    with pytest.raises(ImportError):
        v._text_features(texts)
    with pytest.raises(ImportError):
        v.cluster_check(images)
    assert v.check_distribution_shift(images, reference)["ks_dims_tested"] == 64
