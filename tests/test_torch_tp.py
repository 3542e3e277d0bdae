"""Tensor-parallel Qwen2 and the sharded Stable Diffusion sampler on two
gloo ranks (spawned once for the file) against the JAX package.

* ``qwen_param_specs`` leaf for leaf against ``tvc.parallel.tp``'s
  PartitionSpecs (f32 and int8 trees; in process).
* ``shard_qwen_params`` / ``shard_stacked_qwen_layers``: each rank's shard
  shapes against the JAX shardings' shard shapes on a 1 x 2 mesh, the int8
  stacked leaves included.
* ``make_tp_forward`` against the JAX module forward (atol 2e-4, rtol
  1e-4, as tests/test_tp.py), at tiny (heads 4, kv heads 2: two ways).
* ``QwenModel(mesh=...)``: greedy decodes (plain and prefix-shared
  paraphrases) and a sampled decode token for token equal to the
  single-device port's (which tests/test_torch_qwen.py holds to JAX); in
  int8 (``init_int8``) the greedy decode equal and, in bf16, the
  teacher-forced logits against the single-device module path
  (``QwenLM.apply``) to the card's Qwen limits,
  ``quantize_weights_int8`` under TP equal to quantizing whole, then
  cutting.
* ``StableDiffusionModel(mesh=...)`` at data = 2, three prompts (padded to
  four), fed JAX's latents, against JAX's single-device sampler: uint8
  pixels within one quantum on at most 1 % of the pixels
  (tests/test_torch_sd.py's rule).

The ranks import neither JAX nor ``tvc``.
"""

import dataclasses

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from tvc_torch.parallel.launch import run_ranks

WORLD = 2
PROMPTS = ["a cat sat on the mat", "two dogs run"]
SD_PROMPTS = ["a red car", "two dogs", "a boat at sea"]
N_FORCED = 4


def _shapes(tree):
    from tvc_torch.models.qwen import _flatten

    out = {}
    for n, v in _flatten(tree).items():
        for k, t in (v.items() if isinstance(v, dict) else [(None, v)]):
            out[n if k is None else f"{n}.{k}"] = tuple(t.shape)
    return out


def _rank_job(rank, world, p):
    from tvc_torch.models import qwen as tq
    from tvc_torch.models import sd as tsd
    from tvc_torch.parallel.mesh import MeshConfig, create_mesh
    from tvc_torch.parallel.tp import make_tp_forward, shard_qwen_params, shard_stacked_qwen_layers

    out = {}
    out["jax or tvc"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "tvc"))
    mesh = create_mesh(MeshConfig(axes=("model",)), device="cpu")
    cfg = tq.QwenConfig.tiny()
    params = tq.qwen_params_from_jax(p["params"], cfg)
    params8 = tq.qwen_params_from_jax(p["params8"], cfg)
    out["shard shapes"] = _shapes(shard_qwen_params(params, mesh))
    out["shard shapes int8"] = _shapes(shard_qwen_params(params8, mesh))
    out["stacked shapes"] = _shapes(shard_stacked_qwen_layers(p["stacked8"], mesh))

    single = tq.QwenModel(cfg, params=params, max_new_tokens=6, device="cpu")
    out["forward"] = make_tp_forward(single, mesh)(shard_qwen_params(params, mesh), p["tokens"]).numpy()
    tp = tq.QwenModel(cfg, params=params, max_new_tokens=6, mesh=mesh)
    for name, m in (("single", single), ("tp", tp)):
        out[("greedy", name)] = m.generate(PROMPTS, temperature=0.0)
        out[("paraphrase", name)] = m.generate_paraphrases_batch(PROMPTS, 2, temperature=0.0)
        out[("sampled", name)] = m.generate(PROMPTS, temperature=0.8, seed=3, n_samples=2)

    s8 = tq.QwenModel(cfg, seed=0, max_new_tokens=6, device="cpu", init_int8=True)
    t8 = tq.QwenModel(cfg, seed=0, max_new_tokens=6, mesh=mesh, init_int8=True)
    want, got = _leaves(shard_qwen_params(s8.params, mesh)), _leaves(t8.params)
    out["int8 init equal"] = set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    out[("greedy8", "single")] = s8.generate(PROMPTS, temperature=0.0)
    out[("greedy8", "tp")] = t8.generate(PROMPTS, temperature=0.0)
    # teacher forcing in bf16 (the dtype of the card's Qwen2-7B, where the
    # decode's take-then-dequantize embedding equals the module's): prompts
    # of 8 real tokens (no pad), N_FORCED steps
    cfg16 = dataclasses.replace(cfg, dtype=torch.bfloat16)
    s8 = tq.QwenModel(cfg16, seed=0, max_new_tokens=N_FORCED, device="cpu", init_int8=True)
    t8 = tq.QwenModel(cfg16, seed=0, max_new_tokens=N_FORCED, mesh=mesh, init_int8=True)
    ids = torch.as_tensor(p["forced_prompt"])
    inp = tq.DecodeInputs(prefix=torch.zeros(0, dtype=torch.long), tokens=ids,
                          lengths=torch.full((ids.shape[0],), ids.shape[1]), plen=ids.shape[1], n_samples=1,
                          allowed=None, n_real=0)
    forced = torch.as_tensor(p["forced"])
    seen = []
    t8.decode(inp, temperature=0.0, forced=forced, on_logits=lambda i, lg: seen.append(lg.clone()))
    out["forced logits tp"] = torch.stack(seen).numpy()
    seq = torch.cat([ids, forced.T[:, :-1]], dim=1)
    T = seq.shape[1]
    causal = torch.zeros(1, 1, T, T).masked_fill(~torch.ones(T, T, dtype=torch.bool).tril(), float("-inf"))
    logits, _ = s8.module.apply(s8.params, seq, torch.arange(T)[None].expand_as(seq), causal)
    out["forced logits module"] = logits[:, ids.shape[1] - 1 :].transpose(0, 1).numpy()

    q_tp = tq.QwenModel(cfg, params=params, max_new_tokens=2, mesh=mesh)
    q_tp.quantize_weights_int8()
    q_single = tq.QwenModel(cfg, params=params, max_new_tokens=2, device="cpu")
    q_single.quantize_weights_int8()
    want, got = _leaves(shard_qwen_params(q_single.params, mesh)), _leaves(q_tp.params)
    out["quantize under tp"] = set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)

    # the sampler's batch over data = 2 (a data mesh on the same ranks)
    dmesh = create_mesh(device="cpu")
    states = p["sd_states"]
    sd = tsd.StableDiffusionModel(tsd.SDConfig.tiny(), params=tsd.sd_params_from_jax(p["sd_tree"], tsd.SDConfig.tiny()),
                                  text_encoder=lambda texts: torch.as_tensor(np.stack([states[t] for t in texts])),
                                  mesh=dmesh)
    imgs = sd.generate_images_batch(SD_PROMPTS, 1, num_inference_steps=2, guidance_scale=7.5,
                                    latents=torch.as_tensor(p["sd_latents"]))
    out["sd"] = np.stack([i[0] for i in imgs])
    return out


def _leaves(tree):
    """Dotted name -> tensor, int8 leaves split into ``.int8`` / ``.scale``."""
    from tvc_torch.models.qwen import _flatten

    out = {}
    for n, v in _flatten(tree).items():
        for k, t in (v.items() if isinstance(v, dict) else [(None, v)]):
            out[n if k is None else f"{n}.{k}"] = t
    return out


@pytest.fixture(scope="module")
def jax_side():
    import jax
    import jax.numpy as jnp

    import tvc.models.sd as jsd
    from test_torch_sd import _flax_params
    from tvc.models import qwen as jq

    jm = jq.QwenModel(jq.QwenConfig.tiny(), seed=0, max_new_tokens=6)
    params = jax.tree_util.tree_map(np.asarray, jm.params)
    j8 = jq.QwenModel(jq.QwenConfig.tiny(), seed=0, max_new_tokens=6)
    j8.quantize_weights_int8()
    params8 = jax.tree_util.tree_map(np.asarray, j8.params)
    stacked8 = jax.tree_util.tree_map(lambda *xs: np.stack(xs), params8["layer_0"], params8["layer_1"])
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, jm.config.vocab_size - 4, size=(2, 6)).astype(np.int32)
    T = tokens.shape[1]
    positions = jnp.broadcast_to(jnp.arange(T), tokens.shape)
    mask = jnp.where(jnp.tril(jnp.ones((T, T), bool)), 0.0, -jnp.inf)[None, None]
    forward, _ = jax.jit(jm.module.apply)({"params": jm.params}, jnp.asarray(tokens), positions, mask)

    # the sampler: flax trees from eval_shape (no init compile), JAX's latents
    ls, img = 16, jnp.zeros((1, 32, 32, 3))
    lat = jnp.zeros((1, ls, ls, 4))
    cfg = jsd.SDConfig.tiny()
    sd_tree = {
        "unet": _flax_params(jsd.UNet(cfg), lat, jnp.zeros((1,)), jnp.zeros((1, 16, 64)), seed=10),
        "vae_enc": _flax_params(jsd.VAEEncoder(cfg), img, seed=11),
        "vae_dec": _flax_params(jsd.VAEDecoder(cfg), lat, seed=12),
    }
    states = {t: np.random.default_rng(len(t) + 100 * i).standard_normal((16, 64)).astype(np.float32)
              for i, t in enumerate(SD_PROMPTS + [""])}
    jsdm = jsd.StableDiffusionModel(cfg, params=sd_tree,
                                    text_encoder=lambda texts: jnp.asarray(np.stack([states[t] for t in texts])))
    B = len(SD_PROMPTS)
    ctx, uncond = jsdm._text_encoder(SD_PROMPTS), jsdm._text_encoder([""] * B)
    key = jax.random.fold_in(jax.random.PRNGKey(0), B)
    sd_want = np.asarray(jsdm._build_sampler(B, 2, 7.5)(jsdm.params, ctx, uncond, key))
    sd_latents = np.asarray(jax.random.normal(key, (B, ls, ls, 4)))  # the draw the JAX sampler makes

    payload = dict(params=params, params8=params8, stacked8=stacked8, tokens=tokens,
                   forced_prompt=rng.integers(1, 500, size=(2, 8)), forced=rng.integers(1, 500, size=(N_FORCED, 2)),
                   sd_tree=jax.tree_util.tree_map(np.asarray, sd_tree), sd_states=states, sd_latents=sd_latents)
    return dict(jm=jm, j8=j8, stacked8=stacked8, forward=np.asarray(forward), sd=sd_want), payload


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    run_dir = str(tmp_path_factory.mktemp("tp_ranks"))
    return run_ranks(_rank_job, WORLD, jax_side[1], device="cpu", threads=1, timeout=120, run_dir=run_dir)


def _jax_specs(tree):
    import jax

    from tvc.parallel.tp import qwen_param_specs

    flat = jax.tree_util.tree_flatten_with_path(qwen_param_specs(tree))[0]
    return {".".join(getattr(k, "key", str(k)) for k in path): tuple(spec) for path, spec in flat}


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_qwen_param_specs_match_jax_leaf_for_leaf(jax_side, kind):
    from tvc_torch.models import qwen as tq
    from tvc_torch.parallel.tp import qwen_param_specs

    jm = jax_side[0]["jm" if kind == "f32" else "j8"]
    port = tq.qwen_params_from_jax(jax_side[1]["params" if kind == "f32" else "params8"], tq.QwenConfig.tiny())
    want = _jax_specs(jm.params)
    got = _leaves(qwen_param_specs(port))
    assert set(got) == set(want)
    for n, spec in want.items():
        assert got[n] == spec, n
    assert got["layer_0.attn.q.kernel" + (".int8" if kind == "int8" else "")] == (None, "model")
    assert got["embed.embedding" + (".int8" if kind == "int8" else "")] == ("model", None)


def _jax_shard_shapes(tree, fn):
    import jax
    from jax.sharding import Mesh

    from tvc.parallel.mesh import DATA_AXIS, MODEL_AXIS

    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2), (DATA_AXIS, MODEL_AXIS))
    flat = jax.tree_util.tree_flatten_with_path(fn(tree, mesh))[0]
    return {".".join(getattr(k, "key", str(k)) for k in path): tuple(leaf.addressable_shards[0].data.shape)
            for path, leaf in flat}


@pytest.mark.parametrize("which", ["shard shapes", "shard shapes int8", "stacked shapes"])
def test_shard_shapes_match_jax(jax_side, ranks, which):
    from tvc.parallel.tp import shard_qwen_params, shard_stacked_qwen_layers

    tree = {"shard shapes": jax_side[1]["params"], "shard shapes int8": jax_side[1]["params8"],
            "stacked shapes": jax_side[0]["stacked8"]}[which]
    fn = shard_stacked_qwen_layers if which == "stacked shapes" else shard_qwen_params
    want = _jax_shard_shapes(tree, fn)
    for out in ranks:
        assert out[which] == want
    if which == "stacked shapes":  # int8 sharded with its kernel, the column scale with it
        assert want["mlp.gate.kernel.int8"] == (2, 64, 64) and want["mlp.gate.kernel.scale"] == (2, 64)
        assert want["attn.o.kernel.int8"] == (2, 32, 64) and want["attn.o.kernel.scale"] == (2, 64)


def test_tp_forward_matches_the_jax_module_forward(jax_side, ranks):
    for out in ranks:
        np.testing.assert_allclose(out["forward"], jax_side[0]["forward"], atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("what", ["greedy", "paraphrase", "sampled", "greedy8"])
def test_tp_decode_equals_the_single_device_decode(ranks, what):
    for out in ranks:
        assert out[(what, "tp")] == out[(what, "single")]
    assert ranks[0][(what, "tp")] == ranks[1][(what, "tp")]


def test_tp_int8_weights_and_teacher_forced_logits(ranks):
    """bf16: the row-parallel partial sums round to bf16 before the
    reduction, so the logits part by bf16 quanta; held to the card's Qwen
    limits (PERF.md section 2: median |d| <= 2e-2 RMS, max <= 0.5 RMS,
    top-1 >= 90 %)."""
    for out in ranks:
        assert out["int8 init equal"] and out["quantize under tp"]
        got, want = out["forced logits tp"], out["forced logits module"]
        assert got.shape == want.shape == (N_FORCED, 2, 512)
        d, rms = np.abs(got - want), float(np.sqrt(np.mean(want ** 2)))
        assert np.median(d) <= 2e-2 * rms and d.max() <= 0.5 * rms, (np.median(d), d.max(), rms)
        assert np.mean(got.argmax(-1) == want.argmax(-1)) >= 0.9


def test_sharded_sampler_matches_the_jax_sampler(jax_side, ranks):
    want = jax_side[0]["sd"].astype(int)
    for out in ranks:
        got = out["sd"]
        assert got.shape == (len(SD_PROMPTS), 32, 32, 3)
        np.testing.assert_array_equal(got * 255.0, np.round(got * 255.0))
        d = np.abs(np.round(got * 255.0).astype(int) - want)
        assert d.max() <= 1 and np.mean(d > 0) <= 0.01
    np.testing.assert_array_equal(ranks[0]["sd"], ranks[1]["sd"])


def test_ranks_import_neither_jax_nor_tvc(ranks):
    """Beyond what a bare interpreter here preloads."""
    code = "import json, sys; print(json.dumps(sorted(sys.modules)))"
    bare = set(json.loads(subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                                         timeout=120, check=True).stdout))
    for out in ranks:
        assert set(out["jax or tvc"]) <= bare, out["jax or tvc"]
