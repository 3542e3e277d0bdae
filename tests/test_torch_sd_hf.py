"""The diffusers-layout SD mirror (tvc_torch/models/sd_hf.py) against the
JAX package's flax mirror (tvc/models/sd_hf.py) on the same trees.

Each case builds a diffusers-layout state dict with numpy (the published
key names, torch-layout shapes, as tests/test_sd_hf.py does), converts it
with the JAX converter, runs the flax module on it, and runs the port's
module on the same flax tree through ``module_tree_from_jax``. f32
throughout; tolerance 2e-5 (the same f32 function summed in another
order), 3e-5 where the JAX package's own test of the block allows that.
The whole UNet, the whole VAE and the sampler with the HF modules are
``slow``, as the JAX package's tests of them are; the fast tier holds the
blocks.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from test_sd_hf import _SD, synthetic_unet_sd, synthetic_vae_sd
from tvc.models import loaders as jl
from tvc.models import sd_hf as J
from tvc_torch.models import loaders as pl
from tvc_torch.models import sd_hf as P
from tvc_torch.models.sd import Conv, load_params, module_tree_from_jax

TOL = 2e-5


def _port(module, tree):
    """The port module with the flax tree loaded (layouts converted)."""
    load_params(module, module_tree_from_jax(module, tree))
    return module


def _japply(module, tree, *args):
    """The flax module under jit (one compile; eager flax dispatches and
    compiles op by op, several times slower on the CPU)."""
    return np.asarray(jax.jit(module.apply)({"params": tree}, *args))


def _np(x) -> np.ndarray:
    return np.asarray(x.detach() if torch.is_tensor(x) else x, dtype=np.float32)


def _rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_timestep_embedding_matches_jax():
    """[cos | sin] at t = 0, 1, 500, 999; tolerance 2e-5."""
    t = np.asarray([0.0, 1.0, 500.0, 999.0], np.float32)
    want = np.asarray(J.hf_timestep_embedding(jnp.asarray(t), 32))
    got = _np(P.hf_timestep_embedding(torch.tensor(t), 32))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_array_equal(got[0, :16], 1.0)
    np.testing.assert_array_equal(got[0, 16:], 0.0)


@pytest.mark.parametrize("in_ch,out_ch,temb_dim", [(32, 64, 128), (64, 64, None)])
def test_resnet_block_matches_jax(in_ch, out_ch, temb_dim):
    """ResnetBlock2D with and without the time projection and the 1x1
    shortcut; tolerance 2e-5."""
    sd = _SD(np.random.default_rng(0))
    sd.resnet("r", in_ch, out_ch, temb_dim)
    tree = jl._sd_convert(sd.d)["r"]
    x = _rand(1, 2, 8, 8, in_ch)
    temb = _rand(2, 2, temb_dim) if temb_dim else None
    want = _japply(J.HFResnetBlock(out_ch, 1e-5, jnp.float32, with_temb=temb_dim is not None), tree,
                   jnp.asarray(x), None if temb is None else jnp.asarray(temb))
    port = _port(P.HFResnetBlock(in_ch, out_ch, 1e-5, torch.float32, temb_dim, device="cpu"), tree)
    with torch.no_grad():
        got = port(torch.tensor(x), None if temb is None else torch.tensor(temb))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL, rtol=0)


def test_transformer2d_matches_jax():
    """Transformer2DModel: GN (eps 1e-6), proj_in, self / cross attention,
    the GEGLU feed-forward (tanh GELU, the gate in f32), proj_out, the
    pre-norm residual; tolerance 3e-5 as the JAX package's own block test."""
    ch, ctx_dim, heads = 32, 16, 2
    sd = _SD(np.random.default_rng(3))
    sd.attention_block("a", ch, ctx_dim)
    tree = jl._sd_convert(sd.d)["a"]
    x, ctx = _rand(4, 2, 4, 4, ch), _rand(5, 2, 6, ctx_dim)
    want = _japply(J.HFTransformer2D(heads, 1e-5, jnp.float32), tree, jnp.asarray(x), jnp.asarray(ctx))
    port = _port(P.HFTransformer2D(ch, heads, 1e-5, torch.float32, ctx_dim, device="cpu"), tree)
    with torch.no_grad():
        got = port(torch.tensor(x), torch.tensor(ctx))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=3e-5, rtol=0)


def test_cross_attention_and_block_match_jax():
    """HFCrossAttention (self and cross) and HFBasicTransformerBlock on
    their own; tolerance 2e-5."""
    C, ctx_dim, heads = 32, 16, 4
    sd = _SD(np.random.default_rng(6))
    sd.attention_block("a", C, ctx_dim)
    blk = jl._sd_convert(sd.d)["a"]["transformer_blocks_0"]
    x, ctx = _rand(7, 2, 10, C), _rand(8, 2, 5, ctx_dim)
    want_self = _japply(J.HFCrossAttention(heads, jnp.float32), blk["attn1"], jnp.asarray(x))
    want_cross = _japply(J.HFCrossAttention(heads, jnp.float32), blk["attn2"], jnp.asarray(x), jnp.asarray(ctx))
    want_blk = _japply(J.HFBasicTransformerBlock(heads, jnp.float32), blk, jnp.asarray(x), jnp.asarray(ctx))
    a1 = _port(P.HFCrossAttention(C, heads, torch.float32, None, "cpu"), blk["attn1"])
    a2 = _port(P.HFCrossAttention(C, heads, torch.float32, ctx_dim, "cpu"), blk["attn2"])
    b = _port(P.HFBasicTransformerBlock(C, heads, torch.float32, ctx_dim, "cpu"), blk)
    with torch.no_grad():
        got = (a1(torch.tensor(x)), a2(torch.tensor(x), torch.tensor(ctx)), b(torch.tensor(x), torch.tensor(ctx)))
    for g, w in zip(got, (want_self, want_cross, want_blk)):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=TOL, rtol=0)


def test_vae_attention_matches_jax():
    """The VAE mid attention: single head over H x W, every projection
    biased; tolerance 2e-5."""
    C = 64
    d = {}
    rng = np.random.default_rng(9)
    for nm in ("to_q", "to_k", "to_v", "to_out.0"):
        d[f"m.{nm}.weight"] = rng.normal(0, 0.05, (C, C)).astype(np.float32)
        d[f"m.{nm}.bias"] = rng.normal(0, 0.05, (C,)).astype(np.float32)
    d["m.group_norm.weight"] = rng.normal(1, 0.05, (C,)).astype(np.float32)
    d["m.group_norm.bias"] = rng.normal(0, 0.05, (C,)).astype(np.float32)
    tree = jl._sd_convert(d)["m"]
    x = _rand(10, 2, 4, 4, C)
    want = _japply(J.HFVAEAttention(1e-6, jnp.float32), tree, jnp.asarray(x))
    port = _port(P.HFVAEAttention(C, 1e-6, torch.float32, "cpu"), tree)
    with torch.no_grad():
        got = port(torch.tensor(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("size", [8, 9])
def test_vae_downsample_pads_asymmetrically(size):
    """The VAE encoder's Downsample2D: a (0, 1, 0, 1) pad then a VALID
    stride-2 convolution, against the JAX mirror's jnp.pad + nn.Conv
    VALID; and the UNet's SAME stride-2 convolution against flax's SAME,
    at an even and an odd size; tolerance 2e-5."""
    C = 8
    kernel, bias = _rand(11, 3, 3, C, C) * 0.2, _rand(12, C)
    x = _rand(13, 2, size, size, C)
    tree = {"kernel": kernel, "bias": bias}
    for padding in ("VALID", "SAME"):
        conv = fnn.Conv(C, (3, 3), strides=(2, 2), padding=padding, dtype=jnp.float32)
        xj = jnp.pad(jnp.asarray(x), ((0, 0), (0, 1), (0, 1), (0, 0))) if padding == "VALID" else jnp.asarray(x)
        want = _japply(conv, tree, xj)
        port = _port(Conv(C, C, 3, 2, torch.float32, "cpu", padding=padding), tree)
        xt = torch.tensor(x)
        with torch.no_grad():
            got = port(torch.nn.functional.pad(xt, (0, 0, 0, 1, 0, 1)) if padding == "VALID" else xt)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL, rtol=0)


def test_unet_converter_tree_equals_jax_and_rejects_wrong_layout():
    """The port's UNet converter gives the JAX converter's tree bit for bit
    (names, shapes, values) and raises as it does on a missing or an extra
    key."""
    cfg_j, cfg_p = J.HFUNetConfig.tiny(), P.HFUNetConfig.tiny()
    sd = synthetic_unet_sd(cfg_j)
    want = jl._sd_convert(sd)
    got = pl.convert_sd_unet_state_dict(sd, cfg_p)
    _assert_trees_equal(got, want)
    short = dict(sd)
    short.pop("conv_in.weight")
    with pytest.raises(ValueError, match="missing"):
        pl.convert_sd_unet_state_dict(short, cfg_p)
    extra = dict(sd, **{"bogus.block.weight": np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError, match="extra"):
        pl.convert_sd_unet_state_dict(extra, cfg_p)
    bad = dict(sd, **{"conv_in.weight": np.zeros((32, 4, 1, 1), np.float32)})
    with pytest.raises(ValueError, match="shape"):
        pl.convert_sd_unet_state_dict(bad, cfg_p)


def test_vae_converter_trees_equal_jax():
    """Encoder and decoder trees (quant_conv / post_quant_conv routed) bit
    for bit, and a missing key raises."""
    cfg_j, cfg_p = J.HFVAEConfig.tiny(), P.HFVAEConfig.tiny()
    sd = synthetic_vae_sd(cfg_j)
    want_enc, want_dec = jl.convert_sd_vae_state_dict(sd, cfg_j, validate=False)
    got_enc, got_dec = pl.convert_sd_vae_state_dict(sd, cfg_p)
    _assert_trees_equal(got_enc, want_enc)
    _assert_trees_equal(got_dec, want_dec)
    short = dict(sd)
    short.pop("post_quant_conv.bias")
    with pytest.raises(ValueError, match="missing"):
        pl.convert_sd_vae_state_dict(short, cfg_p)


def _assert_trees_equal(got, want, path=""):
    assert set(got) == set(want), (path, sorted(set(got) ^ set(want)))
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=f"{path}/{k}")
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype


def test_seeded_init_fits_the_hf_modules():
    """The sampler's seeded init and compute-dtype cast cover every HF
    parameter: kernels drawn, biases 0, norm scales 1; a bias-free Dense
    has no bias."""
    from tvc_torch.models.sd import compute_params, init_params

    unet = P.HFUNet(P.HFUNetConfig.tiny(), device="cpu")
    init_params(unet, torch.Generator().manual_seed(0))
    named = dict(unet.named_parameters())
    assert "down_blocks_0_attentions_0.transformer_blocks_0.attn1.to_q.bias" not in named
    assert float(named["conv_in.kernel"].std()) > 0
    assert float(named["conv_in.bias"].abs().max()) == 0
    assert bool((named["conv_norm_out.scale"] == 1).all())
    assert set(compute_params(unet)) == set(named)


@pytest.mark.slow
def test_unet_matches_jax():
    """The tiny HFUNet on the converted tree against the flax HFUNet;
    tolerance 2e-5 relative to the output's scale."""
    cfg_j, cfg_p = J.HFUNetConfig.tiny(), P.HFUNetConfig.tiny()
    tree = jl.convert_sd_unet_state_dict(synthetic_unet_sd(cfg_j), cfg_j)
    lat, ctx = _rand(1, 2, 8, 8, 4), _rand(2, 2, 6, cfg_j.cross_attention_dim)
    t = np.asarray([1.0, 500.0], np.float32)
    want = _japply(J.HFUNet(cfg_j), tree, jnp.asarray(lat), jnp.asarray(t), jnp.asarray(ctx))
    port = _port(P.HFUNet(cfg_p, device="cpu"), tree)
    with torch.no_grad():
        got = _np(port(torch.tensor(lat), torch.tensor(t), torch.tensor(ctx)))
    np.testing.assert_allclose(got, want, atol=TOL * max(1.0, float(np.abs(want).max())), rtol=0)


@pytest.mark.slow
def test_vae_matches_jax():
    """The tiny HF VAE encoder (mean, logvar) and decoder against flax;
    tolerance 2e-5 relative to each output's scale."""
    cfg_j, cfg_p = J.HFVAEConfig.tiny(), P.HFVAEConfig.tiny()
    enc_t, dec_t = jl.convert_sd_vae_state_dict(synthetic_vae_sd(cfg_j), cfg_j)
    img = np.random.default_rng(0).random((2, 16, 16, 3)).astype(np.float32)
    mean_j, logvar_j = jax.jit(J.HFVAEEncoder(cfg_j).apply)({"params": enc_t}, jnp.asarray(img))
    dec_j = _japply(J.HFVAEDecoder(cfg_j), dec_t, mean_j)
    enc = _port(P.HFVAEEncoder(cfg_p, device="cpu"), enc_t)
    dec = _port(P.HFVAEDecoder(cfg_p, device="cpu"), dec_t)
    with torch.no_grad():
        mean_p, logvar_p = enc(torch.tensor(img))
        dec_p = dec(torch.tensor(np.asarray(mean_j)))
    for g, w in ((mean_p, mean_j), (logvar_p, logvar_j), (dec_p, dec_j)):
        w = np.asarray(w)
        np.testing.assert_allclose(_np(g), w, atol=TOL * max(1.0, float(np.abs(w).max())), rtol=0)


@pytest.mark.slow
def test_sd_model_with_hf_modules_matches_jax():
    """StableDiffusionModel with the HF overrides (the load_sd_weights
    route) runs the same DDIM + CFG loop as the JAX model: the sampler fed
    JAX's latents and text states gives JAX's uint8 images, up to one level
    on at most 1 % of the pixels (an f32 sum in another order that crosses
    a rounding boundary)."""
    from tvc.models.sd import SDConfig as JSDConfig, StableDiffusionModel as JSD
    from tvc_torch.models.sd import SDConfig, StableDiffusionModel

    ucfg_j, vcfg_j = J.HFUNetConfig.tiny(), J.HFVAEConfig.tiny()
    unet_t = jl.convert_sd_unet_state_dict(synthetic_unet_sd(ucfg_j), ucfg_j)
    enc_t, dec_t = jl.convert_sd_vae_state_dict(synthetic_vae_sd(vcfg_j), vcfg_j)
    over = dict(image_size=16, vae_mults=(1, 2), context_dim=ucfg_j.cross_attention_dim, context_len=8,
                num_inference_steps=2)
    jsd = JSD(dataclasses.replace(JSDConfig.tiny(), **over),
              params={"unet": unet_t, "vae_enc": enc_t, "vae_dec": dec_t},
              unet=J.HFUNet(ucfg_j), vae_enc=J.HFVAEEncoder(vcfg_j), vae_dec=J.HFVAEDecoder(vcfg_j))
    mods = {"unet": P.HFUNet(P.HFUNetConfig.tiny(), device="cpu"),
            "vae_enc": P.HFVAEEncoder(P.HFVAEConfig.tiny(), device="cpu"),
            "vae_dec": P.HFVAEDecoder(P.HFVAEConfig.tiny(), device="cpu")}
    trees = {"unet": unet_t, "vae_enc": enc_t, "vae_dec": dec_t}
    psd = StableDiffusionModel(dataclasses.replace(SDConfig.tiny(), **over),
                               params={k: module_tree_from_jax(m, trees[k]) for k, m in mods.items()},
                               device="cpu", **mods)
    ctx = _rand(3, 2, 8, ucfg_j.cross_attention_dim)
    unc = _rand(4, 2, 8, ucfg_j.cross_attention_dim)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jsd._build_sampler(2, 2, 7.5)(jsd.params, jnp.asarray(ctx), jnp.asarray(unc), key))
    lat = torch.tensor(np.asarray(jax.random.normal(key, (2, 8, 8, 4))))  # the draw the JAX sampler makes
    got = psd.sampler(2, 7.5)(torch.tensor(ctx), torch.tensor(unc), lat).numpy()
    assert got.shape == want.shape == (2, 16, 16, 3)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01, (diff.max(), (diff > 0).mean())


@pytest.mark.parametrize("which", ["unet", "vae"])
def test_state_dict_shapes_are_the_diffusers_layout(which):
    """The port's diffusers key and shape lists (what chip_smoke.py writes
    its SD-1.5 checkout from) equal the JAX package's test builders' at
    the tiny configs, and at SD-1.5 convert strictly into the HF modules
    (860 M UNet parameters, 84 M VAE parameters)."""
    if which == "unet":
        want = {k: v.shape for k, v in synthetic_unet_sd(J.HFUNetConfig.tiny()).items()}
        got = pl.sd_unet_state_dict_shapes(P.HFUNetConfig.tiny())
        full = pl.sd_unet_state_dict_shapes()
        modules = {"": P.HFUNet(P.HFUNetConfig(), device="meta")}
    else:
        want = {k: v.shape for k, v in synthetic_vae_sd(J.HFVAEConfig.tiny()).items()}
        got = pl.sd_vae_state_dict_shapes(P.HFVAEConfig.tiny())
        full = pl.sd_vae_state_dict_shapes()
        modules = {"encoder.": P.HFVAEEncoder(P.HFVAEConfig(), device="meta"),
                   "decoder.": P.HFVAEDecoder(P.HFVAEConfig(), device="meta")}
    assert got == want
    # SD-1.5: each key's converted path and shape (no arrays) against the
    # modules' flax templates
    routed = {"quant_conv.": "encoder.", "post_quant_conv.": "decoder."}
    for prefix, module in modules.items():
        want_leaves = pl._leaf_shapes(pl._flax_template(module))
        got_leaves = {}
        for key, shape in full.items():
            owner = next((v for k, v in routed.items() if key.startswith(k)), None)
            if owner is not None and owner != prefix or owner is None and not key.startswith(prefix):
                continue
            key = key if owner else key[len(prefix):]
            dotted, _, leaf = key.rpartition(".")
            name = "bias" if leaf == "bias" else ("kernel" if len(shape) in (2, 4) else "scale")
            shape = (shape[2], shape[3], shape[1], shape[0]) if len(shape) == 4 else shape[::-1]
            got_leaves["/".join(pl._sd_flax_path(dotted) + [name])] = tuple(shape)
        assert got_leaves == want_leaves, prefix
    assert sum(int(np.prod(v)) for v in full.values()) == (859520964 if which == "unet" else 83653863)
