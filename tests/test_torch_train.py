"""The CLIP training step (tvc_torch/parallel/steps.py make_train_step),
its optimizer (tvc_torch/optim.py) and the fixtures' training half
(tvc_torch/fixtures.py) against the JAX package.

Both steps start from one tree (the port's seeded init, handed to the JAX
model as its parameters),
see the same batch and run the same schedule. The JAX package's own test
of its training step is ``slow`` (each jitted step takes seconds to
compile on the CPU), so the comparisons that compile the JAX model (the
loss, whole steps) are ``slow`` here too; the fast tier holds the pieces
that need no JAX model: the optimizer against optax on the same
gradients, the schedule, the regularizer, resumption, the fixture loop's
draws. Tolerances:

* the loss of each step: 1e-5 relative (the same f32 function, its sums
  in another order);
* the parameters after n steps: Adam moves an element by at most about
  its learning rate a step (|m_hat| / sqrt(v_hat) <= 1 on a steady
  gradient, plus the decay term), and where a gradient is ~0 the two
  sides' rounding can flip its sign and with it the update, so every
  element within 2 x the sum of the learning rates used; and the bulk,
  99.9 % of elements, within 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tvc.fixtures import geometry_regularizer as jax_geometry
from tvc.models.clip import CLIPConfig as JC, CLIPModel as JM
from tvc_torch.fixtures import geometry_regularizer
from tvc_torch.models.clip import CLIPConfig, CLIPModel, _flatten
from tvc_torch.optim import adamw, apply_updates, warmup_cosine_decay_schedule
from tvc_torch.parallel.steps import make_train_step

B = 16
LR, WARMUP, DECAY = 1e-3, 2, 10
#: tiny_coco with one layer a tower: the JAX side's compile is most of each case
ONE_LAYER = {"vision_layers": 1, "text_layers": 1}


def _jax_step(jm, schedule, extra_loss=None):
    from jax.sharding import Mesh

    from tvc.parallel.mesh import DATA_AXIS, MODEL_AXIS
    from tvc.parallel.steps import make_train_step as jax_make_train_step

    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), (DATA_AXIS, MODEL_AXIS))
    return jax_make_train_step(jm, mesh, optax.adamw(schedule), extra_loss=extra_loss)


@pytest.fixture(scope="module")
def pair():
    """One tree on both sides: the port's seeded init, as JAX arrays for
    the JAX model (which then skips its own init)."""
    pm = CLIPModel(dataclasses.replace(CLIPConfig.tiny_coco(), **ONE_LAYER), seed=0, device="cpu")
    tree = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), pm.params)
    jm = JM(dataclasses.replace(JC.tiny_coco(), **ONE_LAYER), params=tree)
    rng = np.random.default_rng(0)
    px = rng.random((B, 32, 32, 3), dtype=np.float32)
    tok = pm.tokenize([f"a photo of {w} number {i}" for i, w in enumerate(["dog", "cat", "car", "tree"] * 4)])
    return jm, pm, px, tok


def _param_gap(jp, pp):
    want = {".".join(str(k.key) for k in path): np.asarray(v) for path, v in jax.tree_util.tree_leaves_with_path(jp)}
    got = _flatten(pp)
    d = np.concatenate([np.abs(got[k].numpy() - w).ravel() for k, w in want.items()])
    return float(d.max()), float(np.quantile(d, 0.999))


def _jax_loss(jm, params, px, tok, extra_loss=None):
    """The JAX step's loss_fn (tvc/parallel/steps.py), jitted."""
    from tvc.models.clip import normalize_pixels

    def loss_fn(params, pixels, tokens):
        img, txt, logits = jm.module.apply({"params": params}, normalize_pixels(pixels), tokens)
        labels = jnp.arange(logits.shape[0])
        li = optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()
        lt = optax.softmax_cross_entropy_with_integer_labels(logits.T, labels).mean()
        loss = 0.5 * (li + lt)
        return loss + extra_loss(img, txt) if extra_loss is not None else loss

    return float(jax.jit(loss_fn)(params, jnp.asarray(px), jnp.asarray(tok)))


@pytest.mark.slow
def test_loss_matches_jax(pair):
    """Symmetric InfoNCE plus the geometry regularizer at the input
    parameters (the loss the step returns), against the JAX step's loss
    function on the same tree and batch: 1e-5 relative (the slow
    comparisons run it without the regularizer, the default)."""
    jm, pm, px, tok = pair
    step, state = make_train_step(pm, None, 1e-3, extra_loss=geometry_regularizer, device="cpu")
    got = float(step(pm.params, state, px, tok)[2])
    want = _jax_loss(jm, jm.params, px, tok, jax_geometry)
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def test_adamw_update_matches_optax():
    """Three updates of ``adamw(schedule)`` against
    ``optax.adamw(schedule)`` on the same gradients and parameters (weight
    decay 1e-4, eps outside the root, bias corrections at the incremented
    count, the schedule at the count before): 1e-6 relative to the
    update's scale (f32 rounding of the same operations)."""
    rng = np.random.default_rng(7)
    params = {"a": {"kernel": rng.standard_normal((5, 4)).astype(np.float32)},
              "b": rng.standard_normal(3).astype(np.float32)}
    sched_j = optax.warmup_cosine_decay_schedule(1e-4, LR, warmup_steps=1, decay_steps=5)
    sched_p = warmup_cosine_decay_schedule(1e-4, LR, warmup_steps=1, decay_steps=5)
    tx, opt = optax.adamw(sched_j), adamw(sched_p)
    js, ps = tx.init(params), opt.init(jax.tree_util.tree_map(torch.tensor, params))
    jp, pp = params, jax.tree_util.tree_map(torch.tensor, params)
    for i in range(3):
        g = jax.tree_util.tree_map(lambda x: rng.standard_normal(x.shape).astype(np.float32) * 10.0 ** -i, params)
        ju, js = tx.update(g, js, jp)
        jp = optax.apply_updates(jp, ju)
        pu, ps = opt.update(jax.tree_util.tree_map(torch.tensor, g), ps, pp)
        pp = apply_updates(pp, pu)
        for (path, w), (_, v) in zip(jax.tree_util.tree_leaves_with_path(ju),
                                     jax.tree_util.tree_leaves_with_path(pu)):
            np.testing.assert_allclose(v.numpy(), np.asarray(w), rtol=0, atol=1e-6 * LR, err_msg=str(path))
    assert ps["count"] == int(js[0].count) == 3


@pytest.mark.slow
def test_three_steps_match_jax(pair):
    """Three steps of tiny_coco with the geometry regularizer and a warmup
    + cosine schedule: losses to 1e-5 relative, parameters to the Adam
    bound; the input tree is left as it was."""
    jm, pm, px, tok = pair
    sched_j = optax.warmup_cosine_decay_schedule(0.0, LR, warmup_steps=WARMUP, decay_steps=DECAY)
    sched_p = warmup_cosine_decay_schedule(0.0, LR, warmup_steps=WARMUP, decay_steps=DECAY)
    sj, oj = _jax_step(jm, sched_j, jax_geometry)
    sp, op = make_train_step(pm, None, sched_p, extra_loss=geometry_regularizer, device="cpu")
    # the JAX step donates its inputs: it trains a copy
    jp, pp = jax.tree_util.tree_map(jnp.copy, jm.params), pm.params
    before = {k: v.clone() for k, v in _flatten(pp).items()}
    rates = 0.0
    for i in range(3):
        jp, oj, lj = sj(jp, oj, jnp.asarray(px), jnp.asarray(tok))
        pp, op, lp = sp(pp, op, px, tok)
        rates += sched_p(i)
        assert abs(float(lp) - float(lj)) <= 1e-5 * abs(float(lj)), (i, float(lp), float(lj))
        worst, bulk = _param_gap(jp, pp)
        assert worst <= 2 * rates + 1e-6 and bulk <= 1e-5, (i, worst, bulk)
    assert op["count"] == 3
    for k, v in _flatten(pm.params).items():
        assert torch.equal(v, before[k]), k


def test_warmup_first_update_is_zero_and_schedule_is_optax():
    """The schedule is read at the count before the update: a warmup from
    0 leaves the parameters of the first step unchanged (bar the decay
    term, which the learning rate scales too); values against optax."""
    sched_j = optax.warmup_cosine_decay_schedule(0.0, LR, warmup_steps=3, decay_steps=12, end_value=1e-5)
    sched_p = warmup_cosine_decay_schedule(0.0, LR, warmup_steps=3, decay_steps=12, end_value=1e-5)
    for c in range(16):
        assert sched_p(c) == pytest.approx(float(sched_j(c)), rel=1e-6, abs=1e-12), c
    model = CLIPModel(CLIPConfig.tiny(), device="cpu")
    step, state = make_train_step(model, None, warmup_cosine_decay_schedule(0.0, LR, 2, 10), device="cpu")
    rng = np.random.default_rng(1)
    px, tok = rng.random((4, 32, 32, 3), dtype=np.float32), model.tokenize(["a", "b c", "d e f", "g"])
    p1, state, _ = step(model.params, state, px, tok)
    for k, v in _flatten(p1).items():
        assert torch.equal(v, _flatten(model.params)[k]), k
    p2, state, _ = step(p1, state, px, tok)
    assert any(not torch.equal(v, _flatten(p1)[k]) for k, v in _flatten(p2).items())


@pytest.mark.slow
def test_default_optimizer_is_optax_adamw_1e5(pair):
    """``make_train_step(model)``'s default against ``optax.adamw(1e-5)``
    (weight decay 1e-4, eps outside the root) for one step: the Adam bound
    at lr 1e-5; a float learning rate means adamw(lr)."""
    jm, pm, px, tok = pair
    sj, oj = _jax_step(jm, 1e-5)
    jp, _, lj = sj(jax.tree_util.tree_map(jnp.copy, jm.params), oj, jnp.asarray(px), jnp.asarray(tok))
    sp, op = make_train_step(pm, device="cpu")
    pp, _, lp = sp(pm.params, op, px, tok)
    assert abs(float(lp) - float(lj)) <= 1e-5 * abs(float(lj))
    worst, bulk = _param_gap(jp, pp)
    assert worst <= 2e-5 and bulk <= 1e-7, (worst, bulk)
    sp2, _ = make_train_step(pm, None, 1e-5, device="cpu")
    pp2, _, _ = sp2(pm.params, op, px, tok)
    for k, v in _flatten(pp2).items():
        assert torch.equal(v, _flatten(pp)[k])


def test_default_optimizer_is_adamw_1e5():
    """No optimizer means adamw(1e-5) with optax's weight decay 1e-4 (not
    torch's 1e-2); a float means adamw(that rate): one step of each,
    bit-equal."""
    model = CLIPModel(CLIPConfig.tiny(), device="cpu")
    rng = np.random.default_rng(8)
    px, tok = rng.random((4, 32, 32, 3), dtype=np.float32), model.tokenize(["a", "b c", "d", "e f"])
    outs = []
    for opt in ((), (None, adamw(1e-5, weight_decay=1e-4)), (None, 1e-5)):
        step, state = make_train_step(model, *opt, device="cpu")
        outs.append(_flatten(step(model.params, state, px, tok)[0]))
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]) and torch.equal(outs[0][k], outs[2][k]), k
    assert adamw(1e-5) == adamw(1e-5, 0.9, 0.999, 1e-8, 1e-4)


def test_geometry_regularizer_matches_jax():
    """The three hinges on L2-normed features, each active in one case;
    tolerance 1e-6 relative."""
    rng = np.random.default_rng(2)
    for shift in (0.0, 2.0, -2.0):
        img = rng.standard_normal((8, 16)).astype(np.float32) + shift
        txt = rng.standard_normal((8, 16)).astype(np.float32) + abs(shift)
        img /= np.linalg.norm(img, axis=-1, keepdims=True)
        txt /= np.linalg.norm(txt, axis=-1, keepdims=True)
        want = float(jax_geometry(jnp.asarray(img), jnp.asarray(txt)))
        got = float(geometry_regularizer(torch.tensor(img), torch.tensor(txt)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-7), shift


def test_installed_params_reach_the_fused_and_int8_paths():
    """``model.params = new`` changes what the fused (layer kernels' plain
    versions on the CPU) and the int8 towers compute: each equals a fresh
    model built on the new tree, and differs from the old output."""
    for kw in ({"fused_attention": True}, {"fused_attention": True, "int8_serving": True}):
        cfg = CLIPConfig.from_name("tiny", **kw)
        model = CLIPModel(cfg, device="cpu")
        step, state = make_train_step(model, None, 1e-2, device="cpu")
        rng = np.random.default_rng(3)
        px = rng.random((4, 32, 32, 3), dtype=np.float32)
        tok = model.tokenize(["a red car", "a dog", "two cats", "a tree"])
        old = (model.encode_image(px).clone(), model.encode_text(tok).clone())
        new, state, _ = step(model.params, state, px, tok)
        model.params = new
        fresh = CLIPModel(cfg, params=new, device="cpu")
        got = (model.encode_image(px), model.encode_text(tok))
        want = (fresh.encode_image(px), fresh.encode_text(tok))
        for g, w, o in zip(got, want, old):
            assert torch.equal(g, w), kw
            assert not torch.allclose(g, o, atol=1e-4), kw


def test_resumed_run_equals_straight_run(tmp_path):
    """3 steps, a CheckpointManager save, a restore into a fresh template,
    2 more steps: parameters, optimizer state and losses bit-equal to 5
    straight steps."""
    from tvc_torch.utils import CheckpointManager

    model = CLIPModel(CLIPConfig.tiny(), device="cpu")
    sched = warmup_cosine_decay_schedule(0.0, 1e-2, 2, 10)
    step, state0 = make_train_step(model, None, sched, extra_loss=geometry_regularizer, device="cpu")
    rng = np.random.default_rng(4)
    batches = [(rng.random((6, 32, 32, 3), dtype=np.float32),
                model.tokenize([f"word{i} thing{j}" for j in range(6)])) for i in range(5)]
    p, s = model.params, state0
    straight = []
    for px, tok in batches:
        p, s, loss = step(p, s, px, tok)
        straight.append(float(loss))
    p3, s3 = model.params, state0
    for px, tok in batches[:3]:
        p3, s3, _ = step(p3, s3, px, tok)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    mgr.save(3, {"params": p3, "opt_state": s3}, metadata={"step": 3})
    restored = mgr.restore({"params": model.params, "opt_state": state0})
    assert mgr.metadata()["step"] == 3
    pr, sr = restored["params"], restored["opt_state"]
    assert sr["count"] == 3 and isinstance(sr["count"], int)
    resumed = []
    for px, tok in batches[3:]:
        pr, sr, loss = step(pr, sr, px, tok)
        resumed.append(float(loss))
    assert resumed == straight[3:]
    for a, b in ((pr, p), (sr["mu"], s["mu"]), (sr["nu"], s["nu"])):
        fa, fb = _flatten(a), _flatten(b)
        assert set(fa) == set(fb)
        for k in fb:
            assert torch.equal(fa[k], fb[k]), k
    assert sr["count"] == s["count"] == 5


def test_mesh_raises_and_model_device_is_checked():
    model = CLIPModel(CLIPConfig.tiny(), device="cpu")
    with pytest.raises(NotImplementedError, match="D11"):
        make_train_step(model, mesh=object(), device="cpu")


def test_training_corpus_matches_jax():
    """The synthetic corpus: rendered images bit-equal, caption pools
    equal, in the JAX package's order."""
    from tvc.fixtures import _training_corpus as jax_corpus
    from tvc_torch.fixtures import _training_corpus

    ji, jc = jax_corpus(32)
    pi, pc = _training_corpus(32)
    np.testing.assert_array_equal(pi, ji)
    assert pc == jc


def test_train_clip_fixture_draws_jax_batches(monkeypatch):
    """A 3-step train_clip_fixture on each side with the step and the
    evaluation replaced by recorders: the pixels and tokens each step is
    given are equal, index for index."""
    import tvc.fixtures as jf
    import tvc.parallel.steps as jsteps
    import tvc_torch.fixtures as pf
    import tvc_torch.parallel.steps as psteps

    seen = {"jax": [], "port": []}

    def recorder(side):
        def make(model, mesh=None, optimizer=None, extra_loss=None, **kw):
            def step(params, opt_state, pixels, tokens):
                seen[side].append((np.asarray(pixels), np.asarray(tokens)))
                return params, opt_state, 0.0

            return step, None

        return make

    metrics = {"retrieval_accuracy": 0.0, "variant_similarity": 0.0}
    monkeypatch.setattr(jsteps, "make_train_step", recorder("jax"))
    monkeypatch.setattr(psteps, "make_train_step", recorder("port"))
    monkeypatch.setattr(jf, "evaluate_fixture", lambda m: dict(metrics))
    monkeypatch.setattr(pf, "evaluate_fixture", lambda m: dict(metrics))
    jf.train_clip_fixture(steps=3, batch_size=8, seed=5, eval_every=2)
    _, final = pf.train_clip_fixture(steps=3, batch_size=8, seed=5, eval_every=2, device="cpu")
    assert len(seen["jax"]) == len(seen["port"]) == 3
    for (jp, jt), (pp, pt) in zip(seen["jax"], seen["port"]):
        np.testing.assert_array_equal(pp, jp)
        np.testing.assert_array_equal(pt, jt)
    assert [h["step"] for h in final["history"]] == [2, 3]


def test_missing_fixture_trains_and_saves(monkeypatch, tmp_path):
    """With no asset and no earlier port-trained fixture,
    ``train_if_missing=True`` trains (the training function stubbed to a
    two-step run), saves the msgpack and its .json under TRAINED_DIR, and a
    second load reads that file bit for bit; ``train_if_missing=False``
    raises."""
    import tvc_torch.fixtures as pf

    monkeypatch.setattr(pf, "FIXTURE_PATH", tmp_path / "assets" / "clip_tiny_synthetic.msgpack")
    monkeypatch.setattr(pf, "TRAINED_DIR", tmp_path / "trained")
    with pytest.raises(FileNotFoundError):
        pf.load_trained_tiny(train_if_missing=False, device="cpu")
    real = pf.train_clip_fixture
    monkeypatch.setattr(pf, "train_clip_fixture",
                        lambda device=None: real(steps=2, batch_size=8, eval_every=2, device=device))
    model = pf.load_trained_tiny(device="cpu")
    saved = tmp_path / "trained" / "clip_tiny_synthetic.msgpack"
    assert saved.exists() and saved.with_suffix(".json").exists()
    again = pf.load_trained_tiny(train_if_missing=False, device="cpu")
    for k, v in _flatten(again.params).items():
        assert torch.equal(v, _flatten(model.params)[k]), k
