"""The detector's single-query and calibration API against tvc.detector at
tiny: detect_adversarial (scores 2e-5, flags and ref_idx exact), its LRU
result cache with deep copies and the per-call ``methods`` override,
compute_optimal_threshold, save_model / load_model across both packages,
EnsembleDetector (mean and majority), create_detector; and
make_defense_step against the JAX package's at tiny_coco."""

import dataclasses
import gzip
import json
from pathlib import Path

import jax
import numpy as np
import pytest
from PIL import Image

from test_torch_native_ready import jax_native_ready
from tvc.detector import AdversarialDetector as JDetector, DetectorConfig as JDetConfig
from tvc.detector import EnsembleDetector as JEnsemble
from tvc.models.clip import CLIPConfig as JConfig, CLIPModel as JModel
from tvc.parallel.steps import make_defense_step as j_make_defense_step
from tvc.retrieval import MultiModalRetriever as JRetriever
from tvc_torch.detector import DetectorConfig, EnsembleDetector, create_detector
from tvc_torch.models.clip import CLIPConfig, CLIPModel, params_from_jax
from tvc_torch.parallel.steps import make_defense_step
from tvc_torch.retrieval import MultiModalRetriever

TOL = 2e-5
ASSETS = Path(__file__).resolve().parent.parent / "tvc" / "assets"
TEXTS = ["a dog runs on the beach", "two cats on a red couch", "a man riding a wave", "pizza on a table"]


@pytest.fixture(scope="module")
def pair():
    jm = JModel(JConfig.tiny(), seed=0)
    tm = CLIPModel(
        CLIPConfig.tiny(), params=params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params), CLIPConfig.tiny()),
        device="cpu",
    )
    rng = np.random.default_rng(4)
    embs = rng.standard_normal((40, 32)).astype(np.float32)
    jr, tr = JRetriever(jm), MultiModalRetriever(tm)
    jr.build_image_index(embeddings=embs)
    tr.build_image_index(embeddings=embs)
    images = rng.random((len(TEXTS), 32, 32, 3)).astype(np.float32)
    return jm, tm, jr, tr, images


def _detectors(pair, **cfg):
    jm, tm, jr, tr, _ = pair
    kw = {**dict(num_text_variants=3, num_reference_images=2, retrieval_top_k=4), **cfg}
    return (
        JDetector(jm, JDetConfig(**kw), retriever=jr),
        create_detector(tm, DetectorConfig(**kw), retriever=tr, device="cpu"),
    )


def _same_single(got, want):
    assert got["is_adversarial"] == want["is_adversarial"]
    assert abs(got["aggregated_score"] - want["aggregated_score"]) <= TOL
    assert set(got["scores"]) == set(want["scores"])
    for k, v in want["scores"].items():
        assert abs(got["scores"][k] - v) <= TOL, k
    assert got["threshold"] == pytest.approx(want["threshold"], abs=1e-7)
    assert set(got["details"]) == set(want["details"])
    for k, v in want["details"].items():
        if isinstance(v, float):
            assert abs(got["details"][k] - v) <= TOL, k
        else:
            assert got["details"][k] == v, k


def test_detect_adversarial_matches_jax(pair):
    images = pair[4]
    jd, td = _detectors(pair)
    first = jd.detect_adversarial(images[0], TEXTS[0])
    thr = first["aggregated_score"] - 0.01  # flags True, 1e-2 away from the score
    for d in (jd, td):
        d.threshold_manager.update(thr)
    for i in (0, 1):
        want, got = jd.detect_adversarial(images[i], TEXTS[i]), td.detect_adversarial(images[i], TEXTS[i])
        _same_single(got, want)
        assert got["details"]["fused"] and isinstance(got["details"]["ref_idx"], list)
    assert td.get_stats()["cache_hits"] == 0
    # the methods override: the same call on both sides, config restored
    methods = ("text_variants", "consistency")
    _same_single(td.detect_adversarial(images[2], TEXTS[2], methods=methods),
                 jd.detect_adversarial(images[2], TEXTS[2], methods=methods))
    assert td.config.methods == ("text_variants", "sd_reference", "consistency")
    # a PIL photo of another size: resized as the JAX package resizes it
    jax_native_ready()
    photo = Image.fromarray((np.random.default_rng(1).random((45, 61, 3)) * 255).astype(np.uint8))
    _same_single(td.detect_adversarial(photo, TEXTS[3]), jd.detect_adversarial(photo, TEXTS[3]))


def test_detect_adversarial_lru_cache_and_deep_copies(pair):
    images = pair[4]
    _, td = _detectors(pair, cache_size=2)
    a = td.detect_adversarial(images[0], TEXTS[0])
    a["scores"]["text_variants"] = 123.0  # a caller's edit never reaches the cache
    a2 = td.detect_adversarial(images[0], TEXTS[0])
    assert td.stats["cache_hits"] == 1 and a2["scores"]["text_variants"] != 123.0
    a2["details"]["ref_idx"].append(-5)
    td.detect_adversarial(images[1], TEXTS[1])
    td.detect_adversarial(images[0], TEXTS[0])  # hit: image 0 becomes the most recent
    assert td.stats["cache_hits"] == 2 and -5 not in td.detect_adversarial(images[0], TEXTS[0])["details"]["ref_idx"]
    td.detect_adversarial(images[2], TEXTS[2])  # evicts image 1, the least recent
    hits = td.stats["cache_hits"]
    td.detect_adversarial(images[0], TEXTS[0])
    assert td.stats["cache_hits"] == hits + 1
    td.detect_adversarial(images[1], TEXTS[1])
    assert td.stats["cache_hits"] == hits + 1 and len(td._cache) == 2
    # a new threshold is another key; the switch turns the cache off
    td.threshold_manager.update(0.123)
    td.detect_adversarial(images[0], TEXTS[0])
    assert td.stats["cache_hits"] == hits + 1
    off = create_detector(td.model, DetectorConfig(cache_enabled=False), retriever=td.retriever, device="cpu")
    off.detect_adversarial(images[0], TEXTS[0])
    off.detect_adversarial(images[0], TEXTS[0])
    assert off.stats["cache_hits"] == 0 and not off._cache
    assert DetectorConfig().cache_size == JDetConfig().cache_size and DetectorConfig().cache_enabled


def test_compute_optimal_threshold_matches_jax(pair):
    jd, td = _detectors(pair)
    rng = np.random.default_rng(6)
    clean, adv = rng.normal(0.3, 0.1, 60), rng.normal(0.6, 0.15, 40)
    want = jd.compute_optimal_threshold(clean, adv)
    assert td.compute_optimal_threshold(clean, adv) == want
    assert td.threshold_manager.get_threshold() == want and td.threshold_manager.history


def test_save_model_is_read_by_both_packages(pair, tmp_path):
    jd, td = _detectors(pair, two_sided=True, lower_threshold=0.1, text_bucket=16)
    td.threshold_manager.update(0.37)
    td.stats["detections"] = 9
    td.save_model(str(tmp_path / "t" / "det.json"))
    jd.save_model(str(tmp_path / "j" / "det.json"))
    saved_t = json.loads((tmp_path / "t" / "det.json").read_text())
    saved_j = json.loads((tmp_path / "j" / "det.json").read_text())
    assert set(saved_t) == set(saved_j) and set(saved_t["config"]) == set(saved_j["config"])
    j2, t2 = _detectors(pair)
    j2.load_model(str(tmp_path / "t" / "det.json"))  # the JAX package reads the port's file
    t2.load_model(str(tmp_path / "j" / "det.json"))  # and the port the JAX package's
    assert j2.threshold_manager.get_threshold() == 0.37 and j2.stats["detections"] == 9
    assert j2.config.two_sided and j2.config.lower_threshold == 0.1 and j2.config.weights == td.config.weights
    assert dataclasses.asdict(t2.config) == {k: v for k, v in dataclasses.asdict(jd.config).items() if k != "use_pallas"}
    t2.load_model(str(tmp_path / "t" / "det.json"))
    assert t2.config == td.config and t2.threshold_manager.get_threshold() == 0.37


@pytest.mark.parametrize("strategy", ["mean", "majority"])
def test_ensemble_matches_jax(pair, strategy):
    images = pair[4]
    (ja, ta), (jb, tb) = _detectors(pair), _detectors(pair, num_reference_images=1, retrieval_top_k=3)
    agg = np.asarray(ja.detect_batch(images, TEXTS).aggregated_score)
    for (j, t), thr in (((ja, ta), float(np.median(agg)) + 1e-3), ((jb, tb), float(agg.min()) - 1e-3)):
        j.threshold_manager.update(thr)
        t.threshold_manager.update(thr)
    want = JEnsemble([ja, jb], strategy=strategy, weights=[0.7, 0.3]).detect_batch(images, TEXTS)
    got = EnsembleDetector([ta, tb], strategy=strategy, weights=[0.7, 0.3]).detect_batch(images, TEXTS)
    np.testing.assert_array_equal(got.is_adversarial, np.asarray(want.is_adversarial))
    np.testing.assert_allclose(got.aggregated_score, np.asarray(want.aggregated_score), atol=TOL, rtol=0)
    assert got.details == want.details
    with pytest.raises(ValueError):
        EnsembleDetector([])
    with pytest.raises(ValueError):
        EnsembleDetector([ta], weights=[0.5, 0.5])


@pytest.fixture(scope="module")
def coco_pair():
    jm = JModel(JConfig.tiny_coco(), seed=0)
    cfg = CLIPConfig.tiny_coco()
    tm = CLIPModel(cfg, params=params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params), cfg), device="cpu")
    with gzip.open(ASSETS / "coco_captions_val2017.json.gz", "rt") as f:
        caps = [c for _, c in json.load(f)[:64]]
    rng = np.random.default_rng(8)
    B, V = 16, 3
    tokens = np.asarray(tm.tokenize(caps[:B]))
    vtok = np.asarray(tm.tokenize(caps[B : B * (V + 1)])).reshape(B, V, -1)
    bank = rng.standard_normal((48, cfg.embed_dim)).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=1, keepdims=True)
    pixels = rng.random((B, 32, 32, 3)).astype(np.float32)
    return jm, tm, (pixels, tokens, vtok, bank)


def test_make_defense_step_matches_jax(coco_pair):
    jm, tm, args = coco_pair
    probe = np.asarray(j_make_defense_step(jm, None, 0, top_k=5)(jm.params, *args)[1], np.float64)
    s = np.sort(probe)
    gaps = [(s[i] + s[i + 1]) / 2 for i in range(len(s) - 1) if s[i + 1] - s[i] > 2e-4]
    thr = float(gaps[len(gaps) // 2])
    want = j_make_defense_step(jm, None, 0, top_k=5, threshold=thr)(jm.params, *args)
    got = make_defense_step(tm, None, 0, top_k=5, threshold=thr, device="cpu")(tm.params, *args)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=TOL, rtol=0)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[0].any() and not got[0].all()
    vmask = np.ones((16, 3), bool)
    vmask[::3, 2] = False
    want_m = j_make_defense_step(jm, None, 0, top_k=5, threshold=thr)(jm.params, *args, variant_mask=vmask)
    got_m = make_defense_step(tm, None, 0, top_k=5, threshold=thr, device="cpu")(tm.params, *args, variant_mask=vmask)
    np.testing.assert_allclose(got_m[1].numpy(), np.asarray(want_m[1]), atol=TOL, rtol=0)


def test_make_defense_step_raises_for_a_mesh(coco_pair, tmp_path):
    """A mesh no longer raises: over a one-rank mesh the compat step gives
    the single-device step's outputs (multi-rank: test_torch_mesh_steps.py)."""
    from tvc_torch.parallel.launch import one_rank
    from tvc_torch.parallel.mesh import create_mesh

    _, tm, _ = coco_pair
    rng = np.random.default_rng(3)
    px = rng.random((4, 32, 32, 3)).astype(np.float32)
    tok = np.asarray(tm.tokenize(["a dog", "a cat on a mat", "two birds", "a red car"]))
    vtok = np.stack([tok[::-1], tok], 1)
    bank = rng.standard_normal((21, tm.config.embed_dim)).astype(np.float32)
    want = make_defense_step(tm, None, 0, top_k=3, device="cpu")(tm.params, px, tok, vtok, bank)
    with one_rank(device="cpu", run_dir=str(tmp_path)):
        got = make_defense_step(tm, create_mesh(device="cpu"), 64, top_k=3, device="cpu")(tm.params, px, tok, vtok, bank)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
