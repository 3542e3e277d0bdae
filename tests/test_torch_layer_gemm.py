"""The bf16 layer GEMM's tiling (``bf16_plan``) and the tiny
configurations' fused towers (f32, head width 32) against the JAX package.

``bf16_plan`` is pure Python: every pick is a tile the CUDA kernel has,
its grid covers the output, its splits cover K, and it is cached. The
towers run the port's layer wrappers, which take their plain versions on
the CPU, against the JAX package's fused towers through the Pallas layer
kernels in interpret mode, f32 to 2e-5 (as ``test_torch_clip.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvc.models import clip as jclip
from tvc_torch.core.kernels import attention_layer_kernel as alk
from tvc_torch.models import clip as tclip

# the layer GEMMs' (M, N, K): vision B=64 T=50 W=768, text B=448 at T=16 and
# T=32 W=512, ViT-L/14 B=8 T=257 W=1024, T=300 B=4 W=768, and ragged shapes
# of the CUDA tests (W = 72, Wh = 136 / 200, M = 130, one-token sequences)
LAYER_SHAPES = [
    (3200, 2304, 768), (3200, 768, 768), (3200, 3072, 768), (3200, 768, 3072),
    (7168, 1536, 512), (7168, 512, 512), (7168, 2048, 512), (7168, 512, 2048),
    (14336, 1536, 512), (14336, 512, 512), (14336, 2048, 512), (14336, 512, 2048),
    (2056, 3072, 1024), (2056, 1024, 1024), (1200, 2304, 768), (1200, 768, 768),
    (21, 200, 64), (21, 64, 200), (130, 136, 72), (130, 72, 136), (7, 192, 64), (1, 8, 8),
]


@pytest.mark.parametrize("M,N,K", LAYER_SHAPES)
def test_bf16_plan_covers_the_product(M, N, K):
    bm, bn, splits, per = alk.bf16_plan(M, N, K)
    assert (bm, bn) in alk.BF16_TILES
    nk = -(-K // alk.BF16_BK)
    assert per >= 1 and 1 <= splits <= alk.BF16_MAX_SPLITS
    assert (splits - 1) * per < nk <= splits * per  # every range holds a k-tile; together they cover K
    assert -(-M // bm) * bm >= M and -(-N // bn) * bn >= N
    assert (bm, bn, splits, per) == min(alk.bf16_costed_plans(M, N, K))[1]


def test_bf16_plan_is_cached_and_pure():
    alk.bf16_plan.cache_clear()
    first = [alk.bf16_plan(*s) for s in LAYER_SHAPES]
    hits = alk.bf16_plan.cache_info().hits
    assert [alk.bf16_plan(*s) for s in LAYER_SHAPES] == first
    assert alk.bf16_plan.cache_info().hits == hits + len(LAYER_SHAPES)


def test_bf16_plan_costs_every_tile_and_split():
    """Each tile is weighed whole and split, and a split's workspace makes
    it dearer than the same blocks unsplit would be."""
    plans = [p for _, p in alk.bf16_costed_plans(3200, 768, 3072)]
    assert {p[:2] for p in plans} == set(alk.BF16_TILES)
    assert all(any(p[:2] == t and p[2] > 1 for p in plans) for t in alk.BF16_TILES)
    assert len(set(plans)) == len(plans)


@pytest.fixture(scope="module")
def tiny():
    """The tiny pair (f32, W = 64, two heads: head width 32) on the same
    random parameters."""
    jcfg = jclip.CLIPConfig.tiny()
    jm = jclip.CLIPModel(jcfg, seed=0)
    tree = jax.tree_util.tree_map(np.asarray, jm.params)
    cfg = tclip.CLIPConfig.tiny()
    tm = tclip.CLIPModel(cfg, params=tclip.params_from_jax(tree, cfg), device="cpu")
    assert cfg.vision_width // cfg.vision_heads == 32 and cfg.dtype == torch.float32
    return jm, jcfg, tm


def test_tiny_fused_vision_tower_matches_jax_pallas_layers(tiny):
    jm, jcfg, tm = tiny
    px = np.random.default_rng(9).random((3, tm.config.image_size, tm.config.image_size, 3)).astype(np.float32)
    want = np.asarray(jclip.vision_features_fused(jm.params, jcfg, jclip.normalize_pixels(jnp.asarray(px))))
    got = tclip.vision_features_fused(tm.params, tm.config, tclip.normalize_pixels(torch.as_tensor(px)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def test_tiny_fused_text_tower_matches_jax_pallas_layers(tiny):
    jm, jcfg, tm = tiny
    tokens = np.asarray(jm.tokenize(["a dog runs on the beach", "two cats on a red couch", "pizza"]))
    want = np.asarray(jclip.text_features_fused(jm.params, jcfg, jnp.asarray(tokens)))
    got = tclip.text_features_fused(tm.params, tm.config, torch.as_tensor(tokens, dtype=torch.long))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
