"""The multi-head attention kernel's plain version and the module tower that
runs it, against the JAX package: ``mha_reference`` (the CPU route of
``fused_mha``) vs the Pallas ``fused_mha`` in interpret mode at the shapes
of tests/test_pallas_attention.py (f32 2e-5, one bf16 case to 1e-2 of
max(1, |y|)), and ``CLIPModel.inference_module.encode_image`` with
``fused_attention`` vs the JAX inference module on the same weights."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvc.core.pallas.attention_kernel import fused_mha as j_fused_mha
from tvc.models.clip import CLIPConfig as JConfig, CLIPModel as JModel, CLIPModule as JModule
from tvc.models.clip import normalize_pixels as j_normalize
from tvc_torch.core.kernels import fused_mha, launch_counts, mha_reference
from tvc_torch.models.clip import CLIPConfig, CLIPModel, normalize_pixels, params_from_jax

TOL = 2e-5


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("B,T,H,D,causal", [
    (4, 50, 12, 64, False), (2, 16, 4, 64, False), (3, 77, 8, 64, False), (2, 16, 4, 64, True),
    (3, 17, 2, 32, True),
])
def test_mha_reference_matches_pallas(B, T, H, D, causal):
    q, k, v = _qkv(B * T + H, (B, T, H, D))
    want = np.asarray(j_fused_mha(*map(jnp.asarray, (q, k, v)), causal=causal))
    got = fused_mha(*map(torch.as_tensor, (q, k, v)), causal=causal)  # CPU route: the plain version
    assert got.shape == (B, T, H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    np.testing.assert_array_equal(mha_reference(*map(torch.as_tensor, (q, k, v)), causal=causal).numpy(),
                                  got.numpy())


def test_mha_reference_bf16_matches_pallas():
    """bf16 operands: both round the f32 softmax weights and the output to
    bf16; a weight one f32 ulp apart can round to the neighbouring bf16
    value, so the outputs agree to one bf16 ulp (1e-2 of max(1, |y|))."""
    q, k, v = _qkv(7, (2, 50, 4, 64))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(j_fused_mha(jq, jk, jv).astype(jnp.float32))
    tq, tk, tv = (torch.as_tensor(a).bfloat16() for a in (q, k, v))
    got = fused_mha(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= 1e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_reference_matches_pallas_long_sequence(dtype):
    """T = 577 (ViT-L/14 at 336 px), which the tensor-core kernel takes
    with no cap on T: f32 to 2e-5, bf16 to 1e-2 of max(1, |y|) (one bf16
    ulp of a weight or of the output, as above)."""
    q, k, v = _qkv(577, (1, 577, 2, 64))
    want = np.asarray(j_fused_mha(*(jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v))).astype(jnp.float32))
    got = fused_mha(*(torch.as_tensor(a).to(getattr(torch, dtype)) for a in (q, k, v))).float().numpy()
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= (TOL if dtype == "float32" else 1e-2)


def test_mha_reference_matches_pallas_long_causal_f32():
    """f32 at T = 300 with the causal mask, which the CUDA route's f32
    kernel now takes (it used to stop at T = 257): 2e-5."""
    q, k, v = _qkv(300, (1, 300, 2, 32))
    want = np.asarray(j_fused_mha(*map(jnp.asarray, (q, k, v)), causal=True))
    got = fused_mha(*map(torch.as_tensor, (q, k, v)), causal=True)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.fixture(scope="module")
def fused_models():
    jcfg = dataclasses.replace(JConfig.tiny_coco(), fused_attention=True)
    jm = JModel(jcfg, seed=0)
    tree = jax.tree_util.tree_map(np.asarray, jm.params)
    cfg = dataclasses.replace(CLIPConfig.tiny_coco(), fused_attention=True)
    return jm, CLIPModel(cfg, params=params_from_jax(tree, cfg), device="cpu")


def test_inference_module_encode_image_matches_jax(fused_models):
    """T = 17, D = 32: every vision layer through fused_mha on both sides."""
    jm, tm = fused_models
    pixels = np.random.default_rng(3).random((4, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jm.inference_module.apply(
        {"params": jm.params}, j_normalize(jnp.asarray(pixels)), method=JModule.encode_image))
    before = launch_counts()
    with torch.no_grad():
        got = tm.inference_module.encode_image(normalize_pixels(torch.as_tensor(pixels)))
    assert launch_counts() == before  # CPU tensors: the plain version, no kernel
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    # and the einsum module on the same parameters
    with torch.no_grad():
        np.testing.assert_allclose(tm.module.encode_image(normalize_pixels(torch.as_tensor(pixels))).numpy(),
                                   want, atol=TOL, rtol=0)


def test_inference_module_routes_vision_attention_through_fused_mha(fused_models, monkeypatch):
    """The vision tower of the inference module calls fused_mha once a
    layer; the text tower (causal mask) and the einsum module never do."""
    import tvc_torch.models.clip as clip_mod

    _, tm = fused_models
    calls = []
    monkeypatch.setattr(clip_mod, "fused_mha", lambda *a, **kw: calls.append(1) or mha_reference(*a, **kw))
    px = normalize_pixels(torch.rand(2, 32, 32, 3))
    tok = torch.as_tensor(tm.tokenize(["a dog", "two cats"]), dtype=torch.long)
    with torch.no_grad():
        tm.inference_module.encode_image(px)
        assert len(calls) == tm.config.vision_layers
        tm.inference_module.encode_text(tok)
        tm.module.encode_image(px)
    assert len(calls) == tm.config.vision_layers


def test_inference_module_shares_parameters(fused_models):
    _, tm = fused_models
    named = dict(tm.module.named_parameters())
    for name, p in tm.inference_module.named_parameters():
        assert p is named[name]
    fresh = CLIPModel(tm.config, seed=1, device="cpu")
    old = tm.params
    try:
        tm.params = fresh.params
        k = tm.inference_module.visual.transformer.block_0.attn.qkv.kernel
        assert torch.equal(k, fresh.params["visual"]["transformer"]["block_0"]["attn"]["qkv"]["kernel"])
        assert k.data_ptr() == tm.module.visual.transformer.block_0.attn.qkv.kernel.data_ptr()
    finally:
        tm.params = old
    assert not tm.module.visual.transformer.block_0.attn.fused
    assert tm.inference_module.visual.transformer.block_0.attn.fused
    assert not tm.inference_module.text.transformer.block_0.attn.fused
