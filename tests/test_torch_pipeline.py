"""tvc_torch's full-TVC pipeline (``tvc_torch/pipeline.py``) against the JAX
package's ``tvc/pipeline.py``: tiny_coco CLIP on the same weights
(``params_from_jax``), a tiny int8 weight-only Qwen2 paraphrasing greedily
through ``ParaphraseAdapter(temperature=0.0)`` (token for token on both
sides), the same bank and captions. Variants and retrieved items equal,
scores within 2e-5, flags exact; ``process_stream`` equals
``process_batch``; ``evaluate_pipeline``'s metrics equal."""

import jax
import numpy as np
import pytest

import chip_smoke
import tvc_torch.models.qwen as tq
from tvc.augment import TextAugmentConfig as JAugConfig, TextAugmenter as JAugmenter
from tvc.models import qwen as jq
from tvc.models.clip import CLIPConfig as JClipConfig, CLIPModel as JClip
from tvc.pipeline import MultiModalDetectionPipeline as JPipeline, PipelineConfig as JPipeConfig
from tvc.retrieval import MultiModalRetriever as JRetriever
from tvc_torch.augment import TextAugmentConfig, TextAugmenter
from tvc_torch.models.clip import CLIPConfig, CLIPModel, params_from_jax
from tvc_torch.pipeline import (
    DefensePipeline,
    MultiModalDetectionPipeline,
    PipelineConfig,
    PipelineProfiler,
    create_detection_pipeline,
)
from tvc_torch.retrieval import MultiModalRetriever

B = 12
CAPTIONS = chip_smoke.coco_captions(2 * B)
ITEMS = [f"bank_image_{i:03d}.jpg" for i in range(48)]
# templates off, so the paraphrase strategy fills variant slots
AUG = dict(enable_template=False, max_variants=4)
PIPE = dict(num_text_variants=4, retrieval_top_k=5, num_reference_images=3, batch_size=B)


@pytest.fixture(scope="module")
def models():
    jclip = JClip(JClipConfig.tiny_coco(), seed=0)
    cfg = CLIPConfig.tiny_coco()
    tclip = CLIPModel(cfg, params=params_from_jax(jax.tree_util.tree_map(np.asarray, jclip.params), cfg),
                      device="cpu")
    jqwen = jq.QwenModel(jq.QwenConfig.tiny(), seed=0, max_new_tokens=8)
    jqwen.quantize_weights_int8()  # the default quant_gemm="w8"
    tqwen = tq.QwenModel(tq.QwenConfig.tiny(), device="cpu", max_new_tokens=8,
                         params=tq.qwen_params_from_jax(jax.tree_util.tree_map(np.asarray, jqwen.params),
                                                        tq.QwenConfig.tiny()))
    rng = np.random.default_rng(5)
    bank = rng.standard_normal((len(ITEMS), cfg.embed_dim)).astype(np.float32)
    images = rng.random((2 * B, 32, 32, 3)).astype(np.float32)
    return jclip, tclip, jqwen, tqwen, bank, images


def _pipelines(models, threshold=None):
    jclip, tclip, jqwen, tqwen, bank, _ = models
    jr, tr = JRetriever(jclip), MultiModalRetriever(tclip)
    jr.build_image_index(embeddings=bank, items=ITEMS)
    tr.build_image_index(embeddings=bank, items=ITEMS)
    jp = JPipeline(jclip, JPipeConfig(**PIPE), retriever=jr,
                   text_augmenter=JAugmenter(JAugConfig(**AUG), paraphrase_generator=jq.ParaphraseAdapter(jqwen, 0.0)))
    tp = MultiModalDetectionPipeline(
        tclip, PipelineConfig(**PIPE), retriever=tr, device="cpu",
        text_augmenter=TextAugmenter(TextAugmentConfig(**AUG), paraphrase_generator=tq.ParaphraseAdapter(tqwen, 0.0)),
    )
    if threshold is not None:
        jp.detector.threshold_manager.update(threshold)
        tp.detector.threshold_manager.update(threshold)
    return jp, tp


def _safe_threshold(scores):
    """A threshold between two scores far apart, near the median."""
    s = np.sort(np.asarray(scores, np.float64))
    gaps = [(abs(i / len(s) - 0.5), (s[i] + s[i + 1]) / 2) for i in range(len(s) - 1) if s[i + 1] - s[i] > 2e-4]
    return float(min(gaps)[1])


def _same_result(got, want):
    assert got.variants == want.variants
    assert got.retrieved == want.retrieved
    np.testing.assert_array_equal(got.is_adversarial, np.asarray(want.is_adversarial))
    np.testing.assert_allclose(got.scores, np.asarray(want.scores), atol=2e-5, rtol=0)
    for k, v in want.method_scores.items():
        np.testing.assert_allclose(got.method_scores[k], np.asarray(v), atol=2e-5, rtol=0)


@pytest.fixture(scope="module")
def threshold(models):
    _, tp = _pipelines(models)
    return _safe_threshold(tp.process_batch(models[5][:B], CAPTIONS[:B]).scores)


def test_process_batch_matches_jax(models, threshold):
    jp, tp = _pipelines(models, threshold)
    images = models[5][:B]
    want = jp.process_batch(images, CAPTIONS[:B])
    got = tp.process_batch(images, CAPTIONS[:B])
    _same_result(got, want)
    assert got.is_adversarial.any() and not got.is_adversarial.all()
    # the paraphrases reached the variants, and the fused top-k the items
    paras = tq.ParaphraseAdapter(models[3], 0.0).batch(CAPTIONS[:B], 4)
    assert any(v in p for vl, p in zip(got.variants, paras) for v in vl)
    assert all(len(r) == 5 and set(r) <= set(ITEMS) for r in got.retrieved)
    assert set(got.timings) == {"text_augment", "detection", "retrieval"} and not got.errors
    assert tp.get_stats()["queries"] == B and tp.get_stats()["profiler"]["detection"]["count"] == 1


def test_process_stream_equals_process_batch(models, threshold):
    images = models[5]
    batches = [(images[:B], CAPTIONS[:B]), (images[B:], CAPTIONS[B:])]
    tp = _pipelines(models, threshold)[1]
    stream = tp.process_stream(iter(batches))
    # a fresh augmenter: an empty cache and the synonym draws from the seed
    fresh = _pipelines(models, threshold)[1]
    one_by_one = [fresh.process_batch(im, tx) for im, tx in batches]
    assert len(stream) == 2
    for got, single in zip(stream, one_by_one):
        assert got.variants == single.variants and got.retrieved == single.retrieved
        np.testing.assert_array_equal(got.is_adversarial, single.is_adversarial)
        np.testing.assert_array_equal(got.scores, single.scores)
    assert tp.process_stream(iter([])) == []


def test_evaluate_pipeline_and_report_match_jax(models, threshold, tmp_path):
    images = models[5]
    labels = np.tile([0, 1], B)
    jp, tp = _pipelines(models, threshold)
    want = jp.evaluate_pipeline(images, CAPTIONS, labels)
    got = tp.evaluate_pipeline(images, CAPTIONS, labels)
    for k in ("auroc", "accuracy", "precision", "recall", "f1", "fpr_at_95_tpr", "aupr"):
        assert getattr(got["metrics"], k) == pytest.approx(getattr(want["metrics"], k), abs=1e-12), k
    assert got["metrics"].optimal_threshold == pytest.approx(want["metrics"].optimal_threshold, abs=2e-5)
    np.testing.assert_array_equal(got["metrics"].confusion_matrix, want["metrics"].confusion_matrix)
    for k in ("detection_rate", "false_positive_rate", "n_queries"):
        assert got[k] == want[k]
    report = tp.generate_report(got, str(tmp_path / "report.json"))
    assert (tmp_path / "report.json").exists() and report["summary"]["n_queries"] == 2 * B
    assert report["pipeline_stats"]["batches"] == 2 and set(report["profiler"]) >= {"text_augment", "detection"}


def test_process_single_and_the_retrieval_fallback(models):
    """process_single is the B = 1 wrapper; without the fused step's top-k
    (a staged detector) the items come from retrieve_images_by_text, whose
    indices equal the JAX retriever's."""
    jclip, tclip, _, _, bank, images = models
    jr, tr = JRetriever(jclip), MultiModalRetriever(tclip)
    jr.build_image_index(embeddings=bank, items=ITEMS)
    tr.build_image_index(embeddings=bank, items=ITEMS)
    want, got = jr.retrieve_images_by_text(CAPTIONS[:B], top_k=5), tr.retrieve_images_by_text(CAPTIONS[:B], top_k=5)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.scores, want.scores, atol=2e-5, rtol=0)
    assert got.items == want.items
    assert tr.retrieve_images_by_text(CAPTIONS[0], top_k=3) is tr.retrieve_images_by_text(CAPTIONS[0], top_k=3)
    assert tr.get_stats()["cache_hits"] == 1

    from tvc_torch.detector import AdversarialDetector, DetectorConfig

    det = AdversarialDetector(tclip, DetectorConfig(use_fused_step=False, score_aggregation="mean",
                                                    num_text_variants=4), retriever=tr, device="cpu")
    p = create_detection_pipeline(tclip, PipelineConfig(**PIPE), retriever=tr, detector=det,
                                  text_augmenter=TextAugmenter(TextAugmentConfig(**AUG)))
    # a list of images, as process_single passes its one image: lists go
    # through preprocess_images (the native resize, uint8 pixels) in both
    # packages, arrays straight to the tower
    res = p.process_batch(list(images[:B]), CAPTIONS[:B])
    assert res.retrieved == got.items
    single = p.process_single(images[0], CAPTIONS[0])
    assert single["retrieved"] == got.items[0] and single["variants"] == res.variants[0]
    assert single["score"] == pytest.approx(float(res.scores[0]), abs=2e-5)
    assert DefensePipeline is MultiModalDetectionPipeline


def test_profiler_and_steps():
    prof = PipelineProfiler()
    prof.start_step("a")
    prof.end_step("a")
    prof.end_step("never started")
    assert set(prof.get_stats()) == {"a"} and prof.get_stats()["a"]["count"] == 1
    off = PipelineProfiler(enabled=False)
    off.start_step("a")
    off.end_step("a")
    assert off.get_stats() == {}
