"""The port's int8 (W8A8) serving path against the JAX package's:
``quantize_clip_params`` (int8 weights equal exactly), the int8 towers,
``make_serving_step`` with ``qparams`` at tiny_coco (two-bucket text
program on real COCO captions), the detector's qparams cache and
``ServingConfig(int8_serving=True)``. f32 compute dtype; flags and ref_idx
exact."""

import dataclasses
import gzip
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvc.models import clip as jclip
from tvc.parallel.steps import make_serving_step as j_make_step
from tvc_torch.core.kernels import launch_counts
from tvc_torch.detector import AdversarialDetector, DetectorConfig
from tvc_torch.models import clip as tclip
from tvc_torch.models.clip import CLIPConfig, CLIPModel, params_from_jax
from tvc_torch.parallel.steps import make_serving_step
from tvc_torch.retrieval import MultiModalRetriever
from tvc_torch.serving import ServingConfig, ServingRuntime, serve_args

ASSETS = Path(__file__).resolve().parent.parent / "tvc" / "assets"
B, V, K, R = 128, 3, 5, 3  # B*(V+1) = 512 text rows: the bucketed plan engages
KEYS = ("is_adversarial", "aggregated", "tv_score", "sd_score", "consistency_score",
        "orig_similarity", "variant_mean", "variant_std", "ref_idx", "img")
# The int8 towers quantize activations per row at three points a layer. The
# port and the JAX package compute the same f32 values up to the order of
# a LayerNorm or softmax sum (half of the LayerNorm outputs differ by an
# ulp or two), so where a value sits within ~1e-5 of a .5 quantum one int8
# activation flips by one. That moves its row's GEMM output by row_scale *
# col_scale * |w_q| (~absmax / 127 * max|w|, ~2e-3 here), and the row's
# features and scores by up to ~3e-3 (observed 3.4e-3 in img, 6.7e-4 in
# aggregated, on 5 to 8 of 128 rows). Rows without a flip hold the f32
# tolerance of the float path, 2e-5; at most 10 % of rows may carry a
# flip, held to 5e-3. A wrong index, scale or rounding point is O(1e-1).
TOL, FLIP_TOL, MAX_FLIPPED_ROWS = 2e-5, 5e-3, 0.10


def _assert_close_up_to_flips(got, want, name):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).reshape(len(want), -1).max(-1)
    assert d.max() <= FLIP_TOL, (name, d.max())
    assert (d > TOL).mean() <= MAX_FLIPPED_ROWS, (name, int((d > TOL).sum()))


def _int8(cfg):
    return dataclasses.replace(cfg, fused_attention=True, int8_serving=True)


def _pair(jcfg, tcfg, seed=0):
    jm = jclip.CLIPModel(_int8(jcfg), seed=seed)
    tm = CLIPModel(
        _int8(tcfg), params=params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params), tcfg),
        device="cpu",
    )
    return jm, tm


@pytest.fixture(scope="module")
def tiny():
    """The tiny int8 pair, JAX's int8 weights (``CLIPModel.qparams``, its
    jitted ``quantize_clip_params``) and its int8 tower features."""
    jm, tm = _pair(jclip.CLIPConfig.tiny(), CLIPConfig.tiny())
    rng = np.random.default_rng(5)
    px = rng.random((4, 32, 32, 3)).astype(np.float32)
    tokens = np.asarray(tm.tokenize(["a dog on a bench", "two cats", "a red car parked", "boat"]))
    jq = jm.qparams()
    want_img = np.asarray(jm._encode_image(jm.params, jclip.normalize_pixels(jnp.asarray(px)), jq))
    want_txt = np.asarray(jm._encode_text(jm.params, jnp.asarray(tokens), jq))
    return jm, tm, jq, (px, tokens, want_img, want_txt)


def test_quantize_clip_params_equals_jax(tiny):
    """int8 weights equal exactly. The scales are max|w| / 127 on both
    sides; under jit XLA rewrites the division by the constant 127 as a
    product with its reciprocal, so the served JAX scales may differ from
    the IEEE quotient by one ulp (the eager quotient is bit-identical:
    tests/test_torch_quantized_layer.py)."""
    _, tm, want, _ = tiny
    got = tclip.quantize_clip_params(tm.params, tm.config)
    assert set(got) == set(want) == {"visual", "text"}
    for tower in ("visual", "text"):
        assert set(got[tower]) == set(want[tower])
        for blk, names in want[tower].items():
            assert set(got[tower][blk]) == {"qkv", "out", "fc", "proj"}
            for name, (jw, js) in names.items():
                tw, ts = got[tower][blk][name]
                assert tw.dtype == torch.int8
                np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
                np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=2 ** -23, atol=0)
    np.testing.assert_array_equal(
        tm.qparams()["text"]["block_1"]["fc"][0].numpy(), np.asarray(want["text"]["block_1"]["fc"][0])
    )


def test_int8_towers_match_jax(tiny):
    _, tm, _, (px, tokens, want_img, want_txt) = tiny
    tq = tm.qparams()
    cp = tm._compute_params(tm.params)
    px_n = tclip.normalize_pixels(torch.as_tensor(px))
    got_img = tclip.vision_features_fused_i8(cp, tq, tm.config, px_n)
    got_txt = tclip.text_features_fused_i8(cp, tq, tm.config, torch.as_tensor(tokens, dtype=torch.long))
    _assert_close_up_to_flips(got_img.numpy(), want_img, "img")
    _assert_close_up_to_flips(got_txt.numpy(), want_txt, "txt")
    # CLIPModel entry points: int8 towers, quantizing in the call or not
    np.testing.assert_array_equal(tm.infer_image_features(tm.params, px_n).numpy(), got_img.numpy())
    np.testing.assert_array_equal(
        tm.infer_image_features(tm.params, px_n, qparams=tq).numpy(), got_img.numpy()
    )
    assert not np.allclose(
        tclip.vision_features_fused(cp, tm.config, px_n).numpy(), got_img.numpy(), atol=1e-6
    )


def _safe_threshold(agg, q):
    """A threshold near quantile q, at least 2e-3 from every score: a
    flipped quantum moves a score by less, so the flags stay exact."""
    s = np.sort(np.asarray(agg, np.float64))
    gaps = [(abs(i / len(s) - q), (s[i] + s[i + 1]) / 2) for i in range(len(s) - 1) if s[i + 1] - s[i] > 4e-3]
    return np.float32(min(gaps)[1])


@pytest.fixture(scope="module")
def coco():
    jm, tm = _pair(jclip.CLIPConfig.tiny_coco(), CLIPConfig.tiny_coco())
    with gzip.open(ASSETS / "coco_captions_val2017.json.gz", "rt") as f:
        caps = [c for _, c in json.load(f)[: B * (V + 1)]]
    rng = np.random.default_rng(11)
    tokens = np.asarray(tm.tokenize(caps[:B]))
    vtok = np.asarray(tm.tokenize(caps[B:])).reshape(B, V, -1)
    vtok[::4, 1] = vtok[::4, 0]  # duplicate rows: dedup engages
    vmask = rng.random((B, V)) > 0.15
    vmask[0] = False
    bank = rng.standard_normal((61, 32)).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=1, keepdims=True)
    bank = np.concatenate([bank, np.zeros((3, 32), np.float32)])  # 3 pad rows
    d = dict(
        pixels=rng.random((B, 32, 32, 3)).astype(np.float32), tokens=tokens, vtok=vtok, vmask=vmask,
        bank=bank, valid=np.arange(64) < 61, weights=np.asarray([0.4, 0.4, 0.2], np.float32),
    )
    j_step = j_make_step(jm, top_k=K, num_refs=R, qparams=jm.qparams())
    probe = _call(j_step, jm.params, d, np.float32(-np.inf), np.float32(0.5))
    lower, upper = _safe_threshold(probe["aggregated"], 0.2), _safe_threshold(probe["aggregated"], 0.6)
    want = _call(j_step, jm.params, d, lower, upper)
    return jm, tm, d, lower, upper, want


def _call(step, params, d, lower, upper):
    return step(params, d["pixels"], d["tokens"], d["vtok"], d["vmask"], d["bank"], d["valid"],
                d["weights"], lower, upper)


def test_int8_serving_step_matches_jax(coco):
    _, tm, d, lower, upper, want = coco
    step = make_serving_step(tm, top_k=K, num_refs=R, qparams=tm.qparams(), device="cpu")
    got = _call(step, tm.params, d, lower, upper)
    assert step.bucketed_calls == 1
    assert set(got) == set(KEYS) == set(want)
    for k in KEYS:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape, k
        if k in ("is_adversarial", "ref_idx"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            _assert_close_up_to_flips(g, w, k)
    assert bool(got["is_adversarial"].any()) and not bool(got["is_adversarial"].all())


def test_int8_step_quantizing_in_the_call_gives_the_same_output(coco):
    _, tm, d, lower, upper, _ = coco
    a = _call(make_serving_step(tm, top_k=K, num_refs=R, qparams=tm.qparams(), device="cpu"),
              tm.params, d, lower, upper)
    b = _call(make_serving_step(tm, top_k=K, num_refs=R, device="cpu"), tm.params, d, lower, upper)
    for k in KEYS:
        np.testing.assert_array_equal(a[k].numpy(), b[k].numpy(), err_msg=k)


TEXTS = [f"photo number {i} of a {w} in the park" for i, w in enumerate(
    ["dog", "cat", "bike", "tree", "kite", "bench", "boy", "ball"])]
VARIANTS = [[f"a picture of a {t.split()[-4]}", t.upper(), f"{t} today"] for t in TEXTS]


def _detector(model, embs):
    r = MultiModalRetriever(model)
    r.build_image_index(embeddings=embs)
    cfg = DetectorConfig(num_text_variants=3, num_reference_images=2, retrieval_top_k=4, text_bucket=16)
    return AdversarialDetector(model, cfg, retriever=r, device="cpu")


def test_detector_rederives_qparams_when_params_change(tiny):
    tm = tiny[1]
    model = CLIPModel(tm.config, params=tm.params, device="cpu")
    rng = np.random.default_rng(9)
    embs = rng.standard_normal((40, 32)).astype(np.float32)
    images = rng.random((8, 32, 32, 3)).astype(np.float32)
    det = _detector(model, embs)
    before = det.detect_batch(images, TEXTS, VARIANTS)
    assert before.details["fused"]
    step = det._serving[1]
    det.detect_batch(images, TEXTS, VARIANTS)
    assert det._serving[1] is step  # same tree: the cached step and its int8 weights
    model.params = tclip.init_params(model.config, seed=1)
    after = det.detect_batch(images, TEXTS, VARIANTS)
    assert det._serving[1] is not step
    assert np.abs(after.aggregated_score - before.aggregated_score).max() > 1e-3
    fresh = _detector(CLIPModel(tm.config, params=tclip.init_params(tm.config, seed=1), device="cpu"), embs)
    want = fresh.detect_batch(images, TEXTS, VARIANTS)
    np.testing.assert_array_equal(after.aggregated_score, want.aggregated_score)
    np.testing.assert_array_equal(after.is_adversarial, want.is_adversarial)


def test_serving_runtime_int8_submit_returns_detector_scores():
    rt = ServingRuntime(ServingConfig(clip_model="tiny", int8_serving=True, batch_max_size=4, drift_window=0),
                        device="cpu")
    det = rt.detector
    assert det.model.config.int8_serving and det.model.config.fused_attention
    rng = np.random.default_rng(4)
    images = rng.random((3, 32, 32, 3)).astype(np.float32)
    texts = ["a dog", "a red kite", "two boys"]
    before = launch_counts()
    rt.start(http=False)
    try:
        res = rt.submit(images, texts, timeout=60)
    finally:
        rt.stop()
    assert launch_counts() == before  # CPU tensors: the plain versions, no kernel
    direct = det.detect_batch(np.concatenate([images, np.zeros_like(images[:1])]), texts + ["pad"])
    np.testing.assert_allclose(res["scores"], direct.aggregated_score[:3], atol=1e-6, rtol=0)
    assert res["is_adversarial"] == direct.is_adversarial[:3].tolist()


def test_serve_main_parser_accepts_int8():
    cfg, device, warmup = serve_args(["--int8", "--clip-model", "ViT-B/32", "--device", "cpu", "--no-warmup"])
    assert cfg.int8_serving and cfg.clip_model == "ViT-B/32" and device == "cpu" and not warmup
    assert not serve_args([])[0].int8_serving
