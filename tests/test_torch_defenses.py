"""tvc_torch.defenses (the alt stack: ConsistencyChecker and
MultiModalDefenseDetector) against tvc.defenses on the tiny CLIP, the
cases of tests/test_defenses_eval.py with both packages on the same
inputs: overall scores, thresholds, confidences and the consistency
metrics within 2e-5, flags exact, the checker's history and stats equal."""

import jax
import numpy as np
import pytest

from test_torch_native_ready import jax_native_ready
from tvc.defenses import (
    ConsistencyChecker as JChecker,
    DetectionConfig as JDetectionConfig,
    MultiModalDefenseDetector as JDetector,
)
from tvc.models import CLIPConfig as JConfig, CLIPModel as JModel
from tvc_torch.defenses import ConsistencyChecker, DetectionConfig, MultiModalDefenseDetector
from tvc_torch.models.clip import CLIPConfig, CLIPModel, params_from_jax

TOL = 2e-5


@pytest.fixture(scope="module")
def clips():
    jm = JModel(JConfig.tiny(), seed=0)
    tm = CLIPModel(CLIPConfig.tiny(), params=params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params),
                                                             CLIPConfig.tiny()), device="cpu")
    return jm, tm


@pytest.fixture(scope="module")
def batch(clips):
    rng = np.random.default_rng(0)
    s = clips[1].config.image_size
    images = rng.random((6, s, s, 3)).astype(np.float32)
    texts = [f"a scene with object number {i}" for i in range(6)]
    for clip in clips:  # compile the JAX encoders at these shapes once
        clip.encode_image(images)
        clip.encode_text(texts)
    return images, texts


def make_alt_detector(clip, det_cls, cfg_cls, **kw):
    """tests/test_defenses_eval.py's detector: variants by template,
    references = the text embedding plus seeded noise, normalized (the same
    draws in both packages: one generator per detector, seed 1)."""
    rng = np.random.default_rng(1)
    D = clip.config.embed_dim

    def variants(text, n):
        return [f"variant {i} of {text}" for i in range(n)]

    def refs(texts, n):
        t = np.asarray(clip.encode_text(list(texts)))
        r = t[:, None, :] + 0.1 * rng.normal(size=(len(texts), n, D))
        return r / np.linalg.norm(r, axis=-1, keepdims=True)

    return det_cls(
        clip,
        cfg_cls(**kw),
        text_variant_generator=variants,
        retrieval_generator=refs,
        generative_generator=refs,
    )


def _pair(clips, **kw):
    jm, tm = clips
    return (make_alt_detector(jm, JDetector, JDetectionConfig, **kw),
            make_alt_detector(tm, MultiModalDefenseDetector, DetectionConfig, **kw))


def _same(got, want):
    np.testing.assert_array_equal(got["is_adversarial"], np.asarray(want["is_adversarial"]))
    for k in ("overall_score", "threshold", "confidence"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=TOL, rtol=0, err_msg=k)
    assert set(got["consistency_scores"]) == set(want["consistency_scores"])
    for k, v in want["consistency_scores"].items():
        np.testing.assert_allclose(got["consistency_scores"][k], np.asarray(v), atol=TOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("kw", [{}, dict(voting_strategy="simple", adaptive_threshold=False),
                                dict(voting_strategy="adaptive", num_text_variants=2)])
def test_alt_detector_batched_matches_jax(clips, batch, kw):
    images, texts = batch
    jd, td = _pair(clips, **kw)
    want, got = jd.detect(images, texts, return_details=True), td.detect(images, texts, return_details=True)
    assert got["is_adversarial"].shape == (6,) and got["overall_score"].shape == (6,)
    _same(got, want)
    assert got["details"]["voting_strategy"] == want["details"]["voting_strategy"]
    for k in ("stacked_scores", "stds", "cross_modal_variance"):
        np.testing.assert_allclose(got["details"][k], np.asarray(want["details"][k]), atol=TOL, rtol=0)


def test_alt_detector_single_and_decision_direction(clips, batch):
    images, texts = batch
    jax_native_ready()  # detect_single passes a list: both sides resize natively
    for thr, flag in ((0.99, True), (-1.0, False)):
        jd, td = _pair(clips, adaptive_threshold=False, threshold=thr)
        want, got = jd.detect_single(images[0], texts[0]), td.detect_single(images[0], texts[0])
        # threshold ~0.99 flags almost everything (score < thr), -1 nothing
        assert got["is_adversarial"] is flag and want["is_adversarial"] is flag
        assert abs(got["overall_score"] - want["overall_score"]) <= TOL
        assert got["threshold"] == pytest.approx(want["threshold"], abs=1e-7)
        assert set(got["consistency_scores"]) == set(want["consistency_scores"])
        for k, v in want["consistency_scores"].items():
            assert abs(got["consistency_scores"][k] - v) <= TOL, k


def test_checker_history_and_stats(clips, batch):
    """Two batches of six: the second passes ten thresholds of history, so
    the adaptive threshold is smoothed toward their mean on both sides."""
    images, texts = batch
    jd, td = _pair(clips)
    for _ in range(2):
        _same(td.detect(images, texts), jd.detect(images, texts))
    stats, want = td.get_stats(), jd.get_stats()
    assert stats["detections"] == want["detections"] == 12
    assert stats["checker"]["total_decisions"] == want["checker"]["total_decisions"] == 12
    assert stats["checker"]["adversarial_detected"] == want["checker"]["adversarial_detected"]
    assert stats["checker"]["mean_threshold"] == pytest.approx(want["checker"]["mean_threshold"], abs=TOL)


def test_checker_calibration():
    clean = np.asarray([0.8, 0.75, 0.9, 0.85])
    adv = np.asarray([0.2, 0.3, 0.25, 0.15])
    got = ConsistencyChecker(threshold=0.5, adaptive_threshold=False).calibrate_threshold(clean, adv)
    want = JChecker(threshold=0.5, adaptive_threshold=False).calibrate_threshold(clean, adv)
    assert got == want and 0.3 <= got <= 0.75  # separates the groups


def test_dedup_references(clips):
    jd, td = _pair(clips, dedup_similarity=0.99)
    refs = np.ones((1, 3, 32), np.float32)
    refs[0, 2] = np.arange(32)
    out = td._deduplicate_references(refs)
    # identical rows: only the first survives; the distinct row stays
    assert np.any(out[0, 0] != 0) and np.all(out[0, 1] == 0) and np.any(out[0, 2] != 0)
    np.testing.assert_array_equal(out, jd._deduplicate_references(refs))


def test_no_generators_and_custom_weights(clips, batch):
    """No injected sources: variant consistency falls back to the original
    similarity, empty reference sets score 0; custom checker weights."""
    images, texts = batch
    jm, tm = clips
    w = {"original_similarity": 0.7, "retrieval_consistency": 0.1}
    want = JDetector(jm, JDetectionConfig(), checker=JChecker(weights=w, voting_strategy="weighted")).detect(
        images, texts)
    got = MultiModalDefenseDetector(tm, DetectionConfig(), checker=ConsistencyChecker(
        weights=w, voting_strategy="weighted")).detect(images, texts)
    _same(got, want)
    np.testing.assert_array_equal(got["consistency_scores"]["retrieval_consistency"], 0.0)
