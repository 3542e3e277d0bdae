"""tvc_torch.models.sd against tvc.models.sd at ``SDConfig.tiny()`` (f32):
the blocks (and, in bf16, the f32 GroupNorm statistics and attention
logits on inputs where bf16 ones would show), the stride-2 SAME padding at even and odd sizes, the UNet, the
VAE both ways, the DDIM schedule and a two-step sampler fed JAX's initial
latents, with the JAX modules' parameters carried over by
``sd_params_from_jax``; the port's seeded init and its determinism.

The JAX parameter trees come from ``jax.eval_shape`` of each flax module's
``init`` (flax's own names and shapes, no compile) filled with seeded
numpy draws, so the tests pay no JAX initialization. f32 outputs within
2e-5 of max(1, |y|) (sums in another order), uint8 pixels within one
quantum on at most 1 % of the pixels."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import tvc.models.sd as jsd
import tvc_torch.models.sd as tsd

TOL = 2e-5
JC, TC = jsd.SDConfig.tiny(), tsd.SDConfig.tiny()


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(1.0, float(np.abs(want).max()))


def _t(x):
    return torch.as_tensor(np.array(x))


def _fill(shapes, seed: int):
    """Seeded values for a flax parameter tree of these shapes: kernels at
    the lecun scale, biases and norm offsets small and non-zero, scales
    near 1 (every leaf's layout shows in the output)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        shape = s.shape
        if name == "kernel":
            return (rng.standard_normal(shape) * np.sqrt(1.0 / np.prod(shape[:-1]))).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (0.05 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _flax_params(module, *args, seed=0):
    return _fill(jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)["params"], seed)


def _port(module, tree):
    """The port module loaded with the flax block's ``tree``."""
    tsd.load_params(module, tsd.module_tree_from_jax(module, tree))
    return module


@pytest.mark.parametrize("cin,cout,temb", [(32, 32, True), (32, 64, True), (48, 16, False)])
def test_resblock_matches_jax(cin, cout, temb):
    """With and without the time embedding, with the 1x1 skip, and 48
    channels: _gn falls to one group."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 8, cin)).astype(np.float32)
    te = rng.standard_normal((2, 128)).astype(np.float32) if temb else None
    jmod = jsd.ResBlock(cout, jnp.float32)
    params = _flax_params(jmod, x, te)
    want = jax.jit(lambda p, *a: jmod.apply({"params": p}, *a))(params, x, te)
    tmod = _port(tsd.ResBlock(cin, cout, torch.float32, 128 if temb else None), params)
    _close(tmod(_t(x), None if te is None else _t(te)), want)


@pytest.mark.parametrize("context", [True, False])
def test_attnblock_matches_jax(context):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 4, 6, 32)).astype(np.float32)
    ctx = rng.standard_normal((2, 5, 24)).astype(np.float32) if context else None
    jmod = jsd.AttnBlock(2, jnp.float32)
    params = _flax_params(jmod, x, ctx)
    want = jax.jit(lambda p, *a: jmod.apply({"params": p}, *a))(params, x, ctx)
    tmod = _port(tsd.AttnBlock(32, 2, torch.float32, 24 if context else None), params)
    _close(tmod(_t(x), None if ctx is None else _t(ctx)), want)


def _bf16_close(got, want):
    """bf16 outputs within one bf16 quantum (2^-7) of max(1, |y|), element
    by element."""
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape
    assert (np.abs(got - want) / np.maximum(1.0, np.abs(want))).max() <= 2.0**-7


def test_bf16_groupnorm_takes_f32_statistics():
    """A bf16 GroupNorm over values offset by 64: flax takes the statistics
    in f32; statistics taken in bf16 (E[x^2] rounded at a spacing of 32)
    move the output by O(100)."""
    rng = np.random.default_rng(4)
    x = (64.0 + rng.standard_normal((2, 8, 8, 32))).astype(np.float32)
    params = {"scale": (1.0 + 0.1 * rng.standard_normal(32)).astype(np.float32),
              "bias": (0.05 * rng.standard_normal(32)).astype(np.float32)}
    want = fnn.GroupNorm(jsd._gn(32), dtype=jnp.bfloat16).apply({"params": params}, jnp.asarray(x, jnp.bfloat16))
    tmod = _port(tsd.GroupNorm(32, torch.bfloat16), params)
    _bf16_close(tmod(_t(x).to(torch.bfloat16)), want)


def test_bf16_attention_takes_f32_logits():
    """A bf16 AttnBlock whose cross-attention logits are 128 + {0, 5, 10,
    15} / 16, exact in f32: the GroupNorm gives every query (1, 1, 0, ...),
    the context rows carry (512, d_j) and a one-hot value each, every
    projection is the identity or zero, so the output holds the softmax
    weights. Logits rounded to bf16 (a spacing of 1 at 128) move those
    weights by ~0.09."""
    C = 16
    x = np.zeros((1, 2, 2, C), np.float32)
    ctx = np.zeros((1, 4, C), np.float32)
    ctx[0, :, 0] = 512.0
    ctx[0, :, 1] = [0.0, 1.25, 2.5, 3.75]
    ctx[0, np.arange(4), 2 + np.arange(4)] = 1.0
    jmod = jsd.AttnBlock(1, jnp.bfloat16)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x, ctx)["params"]

    def leaf(path, s):
        name, module = path[-1].key, path[-2].key
        if name == "kernel" and (module.startswith("cross_") or module == "ctx_proj"):
            return np.eye(C, dtype=np.float32)
        if name == "bias" and module == "norm":
            return (np.arange(C) < 2).astype(np.float32)
        return np.zeros(s.shape, np.float32)

    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    want = jax.jit(lambda p, *a: jmod.apply({"params": p}, *a))(
        params, jnp.asarray(x, jnp.bfloat16), jnp.asarray(ctx, jnp.bfloat16))
    tmod = _port(tsd.AttnBlock(C, 1, torch.bfloat16, C), params)
    _bf16_close(tmod(_t(x).to(torch.bfloat16), _t(ctx).to(torch.bfloat16)), want)


@pytest.mark.parametrize("size", [(8, 8), (7, 9), (5, 6)])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv_same_padding_matches_flax(size, stride):
    """flax SAME: at stride 2 an even size pads (0, 1), an odd one (1, 1)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, *size, 5)).astype(np.float32)
    jmod = fnn.Conv(7, (3, 3), strides=(stride, stride), dtype=jnp.float32)
    params = _flax_params(jmod, x)
    want = jmod.apply({"params": params}, x)
    tmod = _port(tsd.Conv(5, 7, 3, stride), params)
    _close(tmod(_t(x)), want)
    for n in size:
        assert tsd.same_pads(n, 3, 2) == ((0, 1) if n % 2 == 0 else (1, 1))


def test_timestep_embedding_schedule_and_upsample():
    t = np.array([0.0, 1.0, 37.0, 999.0], np.float32)
    _close(tsd.timestep_embedding(_t(t), 32), jsd.timestep_embedding(jnp.asarray(t), 32))
    for cfg_steps in (4, 20, 50):
        want = jsd.ddim_schedule(dataclasses.replace(JC, num_inference_steps=cfg_steps))
        got = tsd.ddim_schedule(dataclasses.replace(TC, num_inference_steps=cfg_steps))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    x = np.random.default_rng(4).standard_normal((2, 3, 5, 4)).astype(np.float32)
    np.testing.assert_array_equal(tsd.upsample2x(_t(x)).numpy(),
                                  np.asarray(jax.image.resize(x, (2, 6, 10, 4), "nearest")))
    assert [tsd._gn(c) for c in (32, 64, 48, 16, 3)] == [jsd._gn(c) for c in (32, 64, 48, 16, 3)]


@pytest.fixture(scope="module")
def trees():
    """The flax trees of the tiny UNet and VAE, and the port's modules
    loaded from them through sd_params_from_jax."""
    ls = 32 // 2
    lat = jnp.zeros((1, ls, ls, 4))
    img = jnp.zeros((1, 32, 32, 3))
    jtree = {
        "unet": _flax_params(jsd.UNet(JC), lat, jnp.zeros((1,)), jnp.zeros((1, 16, 64)), seed=10),
        "vae_enc": _flax_params(jsd.VAEEncoder(JC), img, seed=11),
        "vae_dec": _flax_params(jsd.VAEDecoder(JC), lat, seed=12),
    }
    ported = tsd.sd_params_from_jax(jax.tree_util.tree_map(np.asarray, jtree), TC)
    return jtree, ported


def test_sd_params_from_jax_layouts_and_checks(trees):
    jtree, ported = trees
    k = np.asarray(jtree["unet"]["conv_in"]["kernel"])  # HWIO
    np.testing.assert_array_equal(ported["unet"]["conv_in"]["kernel"].numpy(), k.transpose(3, 2, 0, 1))
    d = np.asarray(jtree["unet"]["temb1"]["kernel"])  # [in, out]
    np.testing.assert_array_equal(ported["unet"]["temb1"]["kernel"].numpy(), d.T)
    np.testing.assert_array_equal(ported["vae_dec"]["norm_out"]["scale"].numpy(),
                                  np.asarray(jtree["vae_dec"]["norm_out"]["scale"]))
    bad = jax.tree_util.tree_map(np.asarray, jtree["vae_enc"])
    bad["conv_in"]["kernel"] = bad["conv_in"]["kernel"][:, :, :, :8]
    with pytest.raises(ValueError, match="shape"):
        tsd.sd_params_from_jax({"vae_enc": bad}, TC)
    del bad["conv_out"]
    with pytest.raises(ValueError, match="missing"):
        tsd.sd_params_from_jax({"vae_enc": bad}, TC)


@pytest.fixture(scope="module")
def models(trees):
    jtree, ported = trees

    def encoder(texts):  # a fixed text encoder for both sides: states seeded by the text's length
        return np.stack([np.random.default_rng(len(t)).standard_normal((16, 64)).astype(np.float32) for t in texts])

    jm = jsd.StableDiffusionModel(JC, params=jtree, text_encoder=lambda texts: jnp.asarray(encoder(texts)))
    tm = tsd.StableDiffusionModel(TC, params=ported, text_encoder=lambda texts: _t(encoder(texts)), device="cpu")
    return jm, tm


def test_unet_matches_jax(models):
    jm, tm = models
    rng = np.random.default_rng(5)
    lat = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 16, 64)).astype(np.float32)
    t = np.array([3.0, 951.0], np.float32)
    want = jax.jit(lambda p, *a: jm.unet.apply({"params": p}, *a))(jm.params["unet"], lat, t, ctx)
    got = tm._apply("unet", _t(lat), _t(t), _t(ctx))
    assert got.dtype == torch.float32
    _close(got, want)


def test_vae_matches_jax(models):
    jm, tm = models
    rng = np.random.default_rng(6)
    img = rng.random((2, 32, 32, 3)).astype(np.float32)
    noise = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    mean, logvar = jax.jit(lambda p, x: jm.vae_enc.apply({"params": p}, x))(jm.params["vae_enc"], img * 2 - 1)
    want = (mean + jnp.exp(0.5 * logvar) * noise) * JC.vae_scale  # encode_image with this draw
    _close(tm.encode_image(img, noise=_t(noise)), want)
    lat = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    _close(tm.decode_latents(_t(lat)), jax.jit(jm.decode_latents)(lat))


def test_two_step_sampler_fed_jax_latents(models):
    """The DDIM + CFG loop (the last step's t_prev = -1 case included) and
    the uint8 output, from JAX's initial latents."""
    jm, tm = models
    prompts = ["a red car", "two dogs"]
    B = 2
    ctx, uncond = jm._text_encoder(prompts), jm._text_encoder([""] * B)
    key = jax.random.fold_in(jax.random.PRNGKey(0), B)
    want = np.asarray(jm._build_sampler(B, 2, 7.5)(jm.params, ctx, uncond, key))
    lat0 = _t(jax.random.normal(key, (B, 16, 16, 4)))  # the draw the JAX sampler makes
    got = tm.sampler(2, 7.5)(_t(ctx), _t(uncond), lat0).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape == (B, 32, 32, 3)
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and np.mean(d > 0) <= 0.01
    # generate_images_batch returns those pixels / 255 as f32
    imgs = tm.generate_images_batch(prompts, 1, num_inference_steps=2, latents=lat0)
    np.testing.assert_array_equal(np.stack([i[0] for i in imgs]), got.astype(np.float32) / 255.0)


def test_generation_deterministic_per_seed_and_range():
    sd = tsd.StableDiffusionModel(TC, seed=0, device="cpu")
    a = sd.generate_images_batch(["a cat", "a boat"], num_images=2, seed=3, num_inference_steps=2)
    b = sd.generate_images_batch(["a cat", "a boat"], num_images=2, seed=3, num_inference_steps=2)
    c = sd.generate_images_batch(["a cat", "a boat"], num_images=2, seed=4, num_inference_steps=2)
    a, b, c = (np.stack([np.stack(p) for p in x]) for x in (a, b, c))
    assert a.shape == (2, 2, 32, 32, 3) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.min() >= 0.0 and a.max() <= 1.0
    np.testing.assert_array_equal(a * 255.0, np.round(a * 255.0))  # multiples of 1/255
    assert sd.get_stats() == {"images_generated": 12, "batches": 3}
    one = sd.generate_image("a cat", num_images=1, seed=3, num_inference_steps=2)
    assert len(one) == 1 and one[0].shape == (32, 32, 3)


def test_seeded_init_draws_flax_distributions():
    """Kernels: flax's lecun_normal (truncated at 2 std of the underlying
    normal, std sqrt(1 / fan_in)); biases 0; scales 1; per seed."""
    a = tsd.StableDiffusionModel(TC, seed=0, device="cpu")
    b = tsd.StableDiffusionModel(TC, seed=0, device="cpu")
    c = tsd.StableDiffusionModel(TC, seed=1, device="cpu")
    fa, fb, fc = (tsd._flatten(m.params) for m in (a, b, c))
    assert all(torch.equal(fa[k], fb[k]) for k in fa)
    assert not torch.equal(fa["unet.conv_in.kernel"], fc["unet.conv_in.kernel"])
    k = fa["unet.up_0_res_0.conv1.kernel"]  # OIHW, fan_in = I * 3 * 3
    std = np.sqrt(1.0 / k[0].numel())
    assert abs(float(k.std()) / std - 1.0) < 0.05
    assert float(k.abs().max()) <= 2 * std / tsd.TRUNC_STD + 1e-6
    assert all(float(v.abs().max()) == 0 for n, v in fa.items() if n.endswith("bias"))
    assert all(bool((v == 1).all()) for n, v in fa.items() if n.endswith("scale"))
    te = tsd.TextEncoder(TC, seed=17, device="cpu")
    p = tsd._flatten(te.params)
    assert abs(float(p["pos"].std()) - 0.01) < 0.002
    assert abs(float(p["tok.embedding"].std()) * np.sqrt(64) - 1.0) < 0.05
    out = te(["a cat", ""])
    assert out.shape == (2, 16, 64) and torch.isfinite(out).all()


class _SeqTower(fnn.Module):
    """The JAX default text encoder's module, as ``tvc/models/sd.py``
    writes it inside ``_default_text_encoder``."""

    cfg: object

    @fnn.compact
    def __call__(self, tokens):
        from tvc.models.clip import Transformer

        cc = self.cfg
        emb = fnn.Embed(cc.vocab_size, cc.text_width, name="tok")(tokens)
        pos = self.param("pos", fnn.initializers.normal(0.01), (cc.context_length, cc.text_width))
        x = emb + pos[None, : tokens.shape[1]]
        T = tokens.shape[1]
        mask = jnp.where(jnp.tril(jnp.ones((T, T), bool)), 0.0, -jnp.inf)[None, None]
        x = Transformer(cc.text_width, cc.text_layers, cc.text_heads, cc.dtype, name="tr")(x, mask)
        return fnn.LayerNorm(name="ln")(x)


def test_text_encoder_matches_jax():
    from tvc.models.clip import CLIPConfig as JClipConfig
    from tvc.models.tokenizer import HashTokenizer

    jcfg = JClipConfig(vocab_size=4096, context_length=16, text_width=64, text_layers=2, text_heads=1, embed_dim=64,
                       dtype=jnp.float32)
    tower = _SeqTower(jcfg)
    tokens = jnp.asarray(HashTokenizer(4096, 16)(["a cat on a mat", ""]))
    params = _fill(jax.eval_shape(tower.init, jax.random.PRNGKey(0), tokens)["params"], 14)
    want = jax.jit(lambda p, t: tower.apply({"params": p}, t))(params, tokens)
    te = tsd.TextEncoder(TC, params=tsd.sd_params_from_jax({"text_encoder": jax.tree_util.tree_map(
        np.asarray, params)}, TC)["text_encoder"], device="cpu")
    _close(te(["a cat on a mat", ""]), want)


@pytest.mark.slow
def test_default_text_encoder_matches_jax():
    """The JAX package's own default encoder (its tower initialized by
    flax, ~5 s): its parameters through sd_params_from_jax give the same
    states."""
    jenc = jsd.StableDiffusionModel._default_text_encoder(types.SimpleNamespace(config=JC), 0)
    cells = dict(zip(jenc.__code__.co_freevars, (c.cell_contents for c in jenc.__closure__)))
    tree = jax.tree_util.tree_map(np.asarray, cells["params"])
    te = tsd.TextEncoder(TC, params=tsd.sd_params_from_jax({"text_encoder": tree}, TC)["text_encoder"],
                         device="cpu")
    texts = ["a dog on a red couch", "x"]
    _close(te(texts), jenc(texts))


def test_mesh_raises_and_module_overrides_are_kept(tmp_path):
    """A mesh no longer raises: over a one-rank mesh the sharded sampler
    draws the single-device images (two ranks: tests/test_torch_tp.py)."""
    from tvc_torch.parallel.launch import one_rank
    from tvc_torch.parallel.mesh import create_mesh

    with one_rank(device="cpu", run_dir=str(tmp_path)):
        mesh_sd = tsd.StableDiffusionModel(TC, mesh=create_mesh(device="cpu"), device="cpu")
        got = mesh_sd.generate_images_batch(["a cat"], 2, seed=5, num_inference_steps=1)
    want = tsd.StableDiffusionModel(TC, device="cpu").generate_images_batch(["a cat"], 2, seed=5, num_inference_steps=1)
    np.testing.assert_array_equal(np.stack(got[0]), np.stack(want[0]))
    unet = tsd.UNet(TC, device="cpu")
    sd = tsd.StableDiffusionModel(TC, unet=unet, device="cpu")
    assert sd.unet is unet and set(sd.params) == {"unet", "vae_enc", "vae_dec"}
    assert sd.latent_size == 16
