"""tvc_torch CLIP against the JAX package: parameters carried over with
``params_from_jax`` (the tiny random tree and the trained tiny_coco
fixture), features of the module path and of the fused path (its layer
wrappers take their plain versions on the CPU). f32, tolerance 2e-5."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from tvc.models.clip import CLIPConfig as JConfig, CLIPModel as JModel
from tvc.models.clip import normalize_pixels as j_normalize
from tvc_torch.models.clip import (
    CLIPConfig,
    CLIPModel,
    init_params,
    normalize_pixels,
    params_from_jax,
    text_features_fused,
    vision_features_fused,
)

ASSETS = Path(__file__).resolve().parent.parent / "tvc" / "assets"
TOL = 2e-5
CAPTIONS = [
    "a dog runs on the beach",
    "two cats sleeping on a red couch next to a window",
    "A man riding a wave on top of a surfboard.",
    "pizza",
    "a group of people standing around a kitchen preparing food together",
]


def _models(name):
    jcfg = getattr(JConfig, name)()
    if name == "tiny":
        jm = JModel(jcfg, seed=0)
        tree = jax.tree_util.tree_map(np.asarray, jm.params)
    else:  # the trained tiny_coco fixture, as flax stored it
        tree = serialization.msgpack_restore((ASSETS / "clip_tiny_coco.msgpack").read_bytes())
        jm = JModel(jcfg, params=jax.tree_util.tree_map(jnp.asarray, tree), seed=0)
    cfg = getattr(CLIPConfig, name)()
    return jm, CLIPModel(cfg, params=params_from_jax(tree, cfg), device="cpu")


@pytest.fixture(scope="module", params=["tiny", "tiny_coco"])
def models(request):
    jm, tm = _models(request.param)
    rng = np.random.default_rng(3)
    size = tm.config.image_size
    pixels = rng.random((4, size, size, 3)).astype(np.float32)
    tokens = np.asarray(jm.tokenize(CAPTIONS))
    want_img = np.asarray(jax.jit(jm.image_features)(jm.params, j_normalize(jnp.asarray(pixels))))
    want_txt = np.asarray(jax.jit(jm.text_features)(jm.params, jnp.asarray(tokens)))
    return jm, tm, pixels, tokens, want_img, want_txt


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), want, atol=TOL, rtol=0)


def test_params_from_jax_carries_every_leaf(models):
    jm, tm = models[0], models[1]
    flat_j = {
        ".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(jm.params)[0]
    }
    flat_t = dict(tm.module.named_parameters())
    assert set(flat_j) == set(flat_t)
    for name, v in flat_j.items():
        np.testing.assert_array_equal(flat_t[name].detach().numpy(), v)


def test_image_features_module_path(models):
    jm, tm, pixels, _, want_img, _ = models
    got = tm.image_features(tm.params, normalize_pixels(torch.as_tensor(pixels)))
    _close(got.detach().numpy(), want_img)


def test_text_features_module_path(models):
    jm, tm, _, tokens, _, want_txt = models
    got = tm.text_features(tm.params, torch.as_tensor(tokens, dtype=torch.long))
    _close(got.detach().numpy(), want_txt)


def test_image_features_fused_path(models):
    jm, tm, pixels, _, want_img, _ = models
    got = vision_features_fused(tm.params, tm.config, normalize_pixels(torch.as_tensor(pixels)))
    _close(got.numpy(), want_img)


def test_text_features_fused_path(models):
    jm, tm, _, tokens, _, want_txt = models
    got = text_features_fused(tm.params, tm.config, torch.as_tensor(tokens, dtype=torch.long))
    _close(got.numpy(), want_txt)


def test_encode_entry_points_match_jax(models):
    """encode_image on raw [0, 1] pixels and encode_text on strings (with
    their host-side sequence trimming) against the JAX wrappers."""
    jm, tm, pixels, *_ = models
    _close(tm.encode_image(pixels).numpy(), np.asarray(jm.encode_image(pixels)))
    _close(tm.encode_text(CAPTIONS).numpy(), np.asarray(jm.encode_text(CAPTIONS)))


def test_init_params_seeded_at_flax_scales():
    cfg = CLIPConfig.tiny()
    a, b = init_params(cfg, seed=0), init_params(cfg, seed=0)
    k = a["visual"]["transformer"]["block_0"]["attn"]["qkv"]["kernel"]
    assert torch.equal(k, b["visual"]["transformer"]["block_0"]["attn"]["qkv"]["kernel"])
    assert abs(float(k.std()) - cfg.vision_width ** -0.5) < 0.2 * cfg.vision_width ** -0.5
    assert torch.all(a["visual"]["ln_pre"]["scale"] == 1)
    assert not torch.equal(k, init_params(cfg, seed=1)["visual"]["transformer"]["block_0"]["attn"]["qkv"]["kernel"])


def test_params_from_jax_rejects_mismatched_tree():
    tree = jax.tree_util.tree_map(np.asarray, JModel(JConfig.tiny(), seed=0).params)
    with pytest.raises(ValueError):
        params_from_jax(tree, CLIPConfig.tiny_coco())
