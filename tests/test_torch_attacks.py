"""tvc_torch.attacks against tvc.attacks on the tiny CLIP, parameters
carried over with ``params_from_jax``, the same text features and the
same random draws (the JAX draws, fed to the port's ``_*_run``).

What is held, and why: ``sign(g)`` turns a 1e-7 difference in a gradient
into a full step, so a multi-step attack is not bit-equal across the two
packages. Held instead:

* the gradient at step 0 within 1e-4 of max |g| (the two encoders agree
  to ~1e-6; a wrong term is O(1));
* one FGSM / PGD step equal on >= 99.9 % of the pixels;
* the ε-ball within one f32 rounding of orig + δ (1e-7) and the [0, 1]
  clamp exactly, everywhere;
* after the full run, the objective past its clean value;
* the final similarities within FINAL_TOL per row (measured below 1e-3 on
  these inputs; 1e-2 leaves room for a few flipped signs).

``jpeg_approx`` and ``hubness_score`` are deterministic: 2e-5.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tvc.attacks as ja
import tvc_torch.attacks as ta
from tvc.attacks import common as jc, cw as jcw, fgsm as jfg, fsta as jfs, hubness as jhub, pgd as jpgd, sma as jsma
from tvc.models.clip import CLIPConfig as JConfig, CLIPModel as JModel
from tvc_torch.attacks import common as tc, cw as tcw, fgsm as tfg, fsta as tfs, hubness as thub, pgd as tpgd
from tvc_torch.attacks import sma as tsma
from tvc_torch.models.clip import CLIPConfig, CLIPModel, params_from_jax

GRAD_TOL = 1e-4
FINAL_TOL = 1e-2
TEXTS = ["a red car on the street", "a cat", "two dogs running"]


@pytest.fixture(scope="module")
def pair():
    jm = JModel(JConfig.tiny(), seed=0)
    cfg = CLIPConfig.tiny()
    tm = CLIPModel(cfg, params=params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params), cfg), device="cpu")
    images = np.random.default_rng(0).random((3, 32, 32, 3)).astype(np.float32)
    jt = jm.encode_text(TEXTS)
    return jm, tm, images, jt, torch.as_tensor(np.array(jt))


def _t(x):
    return torch.as_tensor(np.array(x))


def _in_ball(adv, pixels, eps):
    adv = np.asarray(adv)
    assert adv.min() >= 0.0 and adv.max() <= 1.0
    assert np.abs(adv - pixels).max() <= eps + 1e-7


def _grad_close(jg, tg):
    jg, tg = np.asarray(jg), tg.numpy()
    assert np.abs(jg).max() > 0
    assert np.abs(jg - tg).max() <= GRAD_TOL * np.abs(jg).max()


def _clean_objective_sims(tm, images, feats):
    enc = tc.make_encoder(tm)
    return torch.sum(enc(tm.params, torch.as_tensor(np.asarray(images))) * feats, -1).numpy()


@pytest.mark.parametrize("targeted", [False, True])
def test_pgd_gradient_at_step_0_equals_jax(pair, targeted):
    jm, tm, images, jt, tt = pair
    obj = jt[::-1] if targeted else jt
    direction = 1.0 if targeted else -1.0
    jenc, tenc = jc.make_encoder(jm), tc.make_encoder(tm)
    jg = jax.jit(jax.grad(lambda a: direction * jnp.mean(jnp.sum(jenc(jm.params, a) * obj, -1))))(jnp.asarray(images))
    tobj = _t(obj)
    tg = tc.grad_of(lambda a: direction * torch.mean(torch.sum(tenc(tm.params, a) * tobj, -1)), _t(images))
    _grad_close(jg, tg)


def test_one_pgd_step_and_fgsm_equal_jax(pair):
    jm, tm, images, jt, tt = pair
    cfg = ja.PGDAttackConfig(num_steps=1)  # one step: no random start
    jadv, _ = jax.jit(functools.partial(jpgd._pgd_run, jc.make_encoder(jm), cfg))(
        jm.params, jnp.asarray(images), jt, jt, jax.random.PRNGKey(0))
    tadv, _ = tpgd._pgd_run(tc.make_encoder(tm), ta.PGDAttackConfig(num_steps=1), tm.params, _t(images), tt, tt,
                            None)
    assert np.mean(np.asarray(jadv) == tadv.numpy()) >= 0.999
    fcfg = ja.FGSMAttackConfig(epsilon=4 / 255)
    jadv, jsim = jax.jit(functools.partial(jfg._fgsm_run, jc.make_encoder(jm), fcfg))(jm.params, jnp.asarray(images),
                                                                                     jt, jt)
    tadv, tsim = tfg._fgsm_run(tc.make_encoder(tm), ta.FGSMAttackConfig(epsilon=4 / 255), tm.params, _t(images), tt,
                               tt)
    assert np.mean(np.asarray(jadv) == tadv.numpy()) >= 0.999
    _in_ball(tadv, images, 4 / 255)
    np.testing.assert_allclose(tsim.numpy(), np.asarray(jsim), atol=FINAL_TOL, rtol=0)


@pytest.mark.parametrize("kw", [dict(num_steps=5), dict(num_steps=5, use_momentum=True),
                                dict(num_steps=4, targeted=True, random_init=False)])
def test_pgd_run_equals_jax_with_the_same_random_start(pair, kw):
    jm, tm, images, jt, tt = pair
    jcfg, tcfg = ja.PGDAttackConfig(**kw), ta.PGDAttackConfig(**kw)
    key = jax.random.PRNGKey(3)
    target = jt[::-1]
    jadv, jsims = jax.jit(functools.partial(jpgd._pgd_run, jc.make_encoder(jm), jcfg))(
        jm.params, jnp.asarray(images), jt, target, key)
    noise = None
    if jcfg.random_init and jcfg.num_steps > 1:  # the draw _pgd_run makes from its key
        noise = _t(jax.random.uniform(key, images.shape, minval=-jcfg.epsilon, maxval=jcfg.epsilon))
    tadv, tsims = tpgd._pgd_run(tc.make_encoder(tm), tcfg, tm.params, _t(images), tt, _t(target), noise)
    _in_ball(tadv, images, tcfg.epsilon)
    np.testing.assert_allclose(tsims.numpy(), np.asarray(jsims), atol=FINAL_TOL, rtol=0)
    objective = _t(target) if tcfg.targeted else tt
    clean, final = (_clean_objective_sims(tm, x, objective) for x in (images, tadv))
    assert (final.mean() > clean.mean()) if tcfg.targeted else (final.mean() < clean.mean())


def test_pgd_attacker_draws_its_start_from_its_seed(pair):
    jm, tm, images, jt, tt = pair
    a = ta.PGDAttacker(tm, ta.PGDAttackConfig(num_steps=3, seed=5))
    px = _t(images)
    n1, n2 = a.draw_noise(px), a.draw_noise(px)
    assert torch.equal(n1, n2) and n1.abs().max() <= a.config.epsilon and n1.abs().max() > 0.9 * a.config.epsilon
    res = a.attack(images, TEXTS)
    assert res.adv_images.shape == images.shape and res.success.dtype == bool
    _in_ball(res.adv_images, images, a.config.epsilon)
    assert a.get_stats()["total_attacks"] == 3
    assert ta.PGDAttacker(tm, ta.PGDAttackConfig(num_steps=1)).draw_noise(px) is None
    with pytest.raises(ValueError, match="target_texts"):
        ta.PGDAttacker(tm, ta.PGDAttackConfig(targeted=True)).attack(images, TEXTS)


@pytest.mark.parametrize("objective", ["mean_sim", "win_hinge"])
def test_hubness_run_equals_jax_with_the_same_queries(pair, objective):
    jm, tm, images, jt, tt = pair
    pool = tm.encode_text(TEXTS + ["a blue bird", "a tree in a park", "an old man"]).numpy()
    idx = np.stack([np.random.default_rng(i).permutation(len(pool))[:4] for i in range(3)])
    queries = pool[idx]  # [B, Q, E]
    gal = tm.encode_image(np.random.default_rng(9).random((5, 32, 32, 3)).astype(np.float32)).numpy()
    gal_best = None
    if objective == "win_hinge":
        gal_best = np.einsum("bqe,ne->bqn", queries / np.linalg.norm(queries, axis=-1, keepdims=True),
                             gal / np.linalg.norm(gal, axis=-1, keepdims=True)).max(-1)
    kw = dict(num_iterations=4, objective=objective)
    jadv, jmean = jax.jit(functools.partial(jhub._hubness_run, jc.make_encoder(jm), ja.HubnessAttackConfig(**kw)))(
        jm.params, jnp.asarray(images), jnp.asarray(queries), None if gal_best is None else jnp.asarray(gal_best))
    tadv, tmean = thub._hubness_run(tc.make_encoder(tm), ta.HubnessAttackConfig(**kw), tm.params, _t(images),
                                    _t(queries), None if gal_best is None else _t(gal_best))
    _in_ball(tadv, images, 16 / 255)
    np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), atol=FINAL_TOL, rtol=0)
    clean = np.einsum("be,bqe->bq", tc.make_encoder(tm)(tm.params, _t(images)).numpy(),
                      queries / np.linalg.norm(queries, axis=-1, keepdims=True)).mean(-1)
    assert tmean.numpy().mean() > clean.mean()


def test_hubness_attacker_subsets_and_gallery(pair):
    jm, tm, images, jt, tt = pair
    a = ta.HubnessAttack(tm, ta.HubnessAttackConfig(num_iterations=2, num_target_queries=3))
    idx = a.draw_query_indices(4, 6, 3)
    assert idx.shape == (4, 3) and all(len(set(r.tolist())) == 3 for r in idx)
    assert torch.equal(idx, a.draw_query_indices(4, 6, 3))
    with pytest.raises(ValueError, match="no query texts"):
        a.attack(images)
    gallery = np.random.default_rng(2).random((4, 32, 32, 3)).astype(np.float32)
    a.build_reference_database(images=gallery, texts=TEXTS + ["a boat", "a bus"])
    res = a.attack(images)
    assert res.info["num_queries"] == 3 and res.info["hubness_scores"].shape == (3,)
    _in_ball(res.adv_images, images, 16 / 255)
    h = a.compute_hubness(res.adv_images, tt)
    assert h.shape == (3,) and ((0 <= h) & (h <= 1)).all()
    with pytest.raises(ValueError, match="win_hinge"):
        ta.HubnessAttack(tm, ta.HubnessAttackConfig(objective="win_hinge", num_iterations=1)).attack(images, TEXTS)
    assert ta.HubnessAttacker is ta.HubnessAttack


def test_hubness_score_equals_jax():
    rng = np.random.default_rng(1)
    adv, q, g = rng.standard_normal((4, 16)), rng.standard_normal((4, 7, 16)), rng.standard_normal((9, 16))
    adv[0] = q[0].mean(0) * 5  # a hub that wins its queries
    want = np.asarray(ja.hubness_score(*(jnp.asarray(x, jnp.float32) for x in (adv, q, g))))
    got = ta.hubness_score(*(torch.as_tensor(x, dtype=torch.float32) for x in (adv, q, g))).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    assert got[0] > 0


def test_cw_optimizers_equal_optax():
    """optax.adam's and optax.sgd's updates, step for step."""
    rng = np.random.default_rng(3)
    w0 = rng.standard_normal((2, 5)).astype(np.float32)
    for name, jopt, topt in (("adam", optax.adam(0.01), tcw._Adam), ("sgd", optax.sgd(0.01), tcw._SGD)):
        jw, state, tw = jnp.asarray(w0), jopt.init(jnp.asarray(w0)), torch.as_tensor(w0)
        top = topt(0.01, tw)
        for _ in range(6):
            g = rng.standard_normal(w0.shape).astype(np.float32)
            upd, state = jopt.update(jnp.asarray(g), state, jw)
            jw = optax.apply_updates(jw, upd)
            tw = top.step(tw, torch.as_tensor(g))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-7, err_msg=name)


def test_cw_gradient_and_run_equal_jax(pair):
    jm, tm, images, jt, tt = pair
    # the gradient of the total loss near the start (at the start itself the
    # L2 term's gradient is the direction of a ~1e-7 roundoff residue)
    const = 10.0 * np.ones(3, np.float32)
    w = np.arctanh((images * 2 - 1) * 0.999999) + 0.05 * np.random.default_rng(5).standard_normal(images.shape)
    w = w.astype(np.float32)
    jenc, tenc = jc.make_encoder(jm), tc.make_encoder(tm)

    def jloss(w):
        adv = (jnp.tanh(w) + 1) / 2
        fval = jnp.maximum(jnp.sum(jenc(jm.params, adv) * jt, -1).mean(), 0.0)
        return jnp.linalg.norm((adv - images).reshape(3, -1), axis=-1).mean() + const.mean() * fval

    def tloss(w):
        adv = (torch.tanh(w) + 1) / 2
        fval = torch.clamp(torch.sum(tenc(tm.params, adv) * tt, -1).mean(), min=0.0)
        l2 = torch.linalg.vector_norm((adv - _t(images)).reshape(3, -1), dim=-1)
        return l2.mean() + float(const.mean()) * fval

    _grad_close(jax.jit(jax.grad(jloss))(jnp.asarray(w)), tc.grad_of(tloss, _t(w)))
    # the run: 2 binary-search steps of 4 Adam steps, from the same start
    kw = dict(max_iterations=4, binary_search_steps=2, initial_const=10.0)
    jadv, jsims, jl2 = jax.jit(functools.partial(jcw._cw_run, jc.make_encoder(jm), ja.CWAttackConfig(**kw)))(
        jm.params, jnp.asarray(images), jt, jt)
    tadv, tsims, tl2 = tcw._cw_run(tc.make_encoder(tm), ta.CWAttackConfig(**kw), tm.params, _t(images), tt, tt)
    assert tadv.min() >= 0 and tadv.max() <= 1
    np.testing.assert_allclose(tsims.numpy(), np.asarray(jsims), atol=FINAL_TOL, rtol=0)
    # Adam's first step is lr g / (|g| + 1e-8): a sign step for all but the
    # tiniest gradients, so the L2 parts as PGD's pixels do (measured 2.6 %)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), rtol=5e-2, atol=0)


def test_cw_attacker_reports_best_l2(pair):
    jm, tm, images, jt, tt = pair
    res = ta.CWAttacker(tm, ta.CWAttackConfig(max_iterations=3, binary_search_steps=2, loss_type="mse",
                                              optimizer_type="sgd")).attack(images, TEXTS)
    assert res.info["best_l2"].shape == (3,) and res.adv_images.shape == images.shape


@pytest.mark.parametrize("kw", [dict(num_iter=4), dict(num_iter=3, feature_distance_metric="euclidean",
                                                       adaptive_step_size=True, norm_type="l2", epsilon=1.0)])
def test_fsta_run_equals_jax_with_the_same_targets(pair, kw):
    jm, tm, images, jt, tt = pair
    rand = jax.random.normal(jax.random.PRNGKey(0), jt.shape)  # the attacker's default targets
    jtarget = jc.l2_normalize(rand - jnp.sum(rand * jt, -1, keepdims=True) * jt)
    ttarget = tfs.orthogonal_targets(tt, _t(rand))
    np.testing.assert_allclose(ttarget.numpy(), np.asarray(jtarget), atol=2e-6, rtol=0)
    jadv, jsims = jax.jit(functools.partial(jfs._fsta_run, jc.make_encoder(jm), ja.FSTAAttackConfig(**kw)))(
        jm.params, jnp.asarray(images), jt, jtarget)
    tadv, tsims = tfs._fsta_run(tc.make_encoder(tm), ta.FSTAAttackConfig(**kw), tm.params, _t(images), tt, ttarget)
    assert tadv.min() >= 0 and tadv.max() <= 1
    if kw.get("norm_type", "inf") == "inf":
        _in_ball(tadv, images, kw.get("epsilon", 8 / 255))
    np.testing.assert_allclose(tsims.numpy(), np.asarray(jsims), atol=FINAL_TOL, rtol=0)


def test_fsta_attacker_targets_are_orthogonal(pair):
    jm, tm, images, jt, tt = pair
    a = ta.FSTAAttacker(tm, ta.FSTAAttackConfig(num_iter=2))
    res = a.attack(images, TEXTS)
    assert res.adv_images.shape == images.shape
    _in_ball(res.adv_images, images, 8 / 255)


@pytest.mark.parametrize("selection", ["semantic", "random", "adversarial"])
def test_sma_targets_equal_jax(pair, selection):
    jm, tm, images, jt, tt = pair
    rand = jax.random.normal(jax.random.PRNGKey(0), jt.shape)
    want = ja.SMAAttacker(jm, ja.SMAAttackConfig(target_selection=selection))._make_targets(jt)
    got = tsma.make_targets(selection, tt, _t(rand))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=0)


@pytest.mark.parametrize("kw", [dict(num_iter=3), dict(num_iter=2, jpeg_robust=True, jpeg_quality=50)])
def test_sma_run_equals_jax_with_the_same_targets(pair, kw):
    jm, tm, images, jt, tt = pair
    target = -jt[::-1]
    jadv, jsims = jax.jit(functools.partial(jsma._sma_run, jc.make_encoder(jm), ja.SMAAttackConfig(**kw)))(
        jm.params, jnp.asarray(images), jt, target)
    tadv, tsims = tsma._sma_run(tc.make_encoder(tm), ta.SMAAttackConfig(**kw), tm.params, _t(images), tt, _t(target))
    _in_ball(tadv, images, 8 / 255)
    np.testing.assert_allclose(tsims.numpy(), np.asarray(jsims), atol=FINAL_TOL, rtol=0)
    res = ta.SMAAttacker(tm, ta.SMAAttackConfig(**kw)).attack(images, TEXTS)
    _in_ball(res.adv_images, images, 8 / 255)


@pytest.mark.parametrize("shape,quality", [((2, 16, 16, 3), 75), ((1, 13, 21, 3), 10), ((1, 8, 8, 1), 100)])
def test_jpeg_approx_equals_jax(shape, quality):
    x = np.random.default_rng(sum(shape)).random(shape).astype(np.float32)
    want = np.asarray(jax.jit(ja.jpeg_approx, static_argnums=1)(jnp.asarray(x), quality))
    got = ta.jpeg_approx(torch.as_tensor(x), quality).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    # straight-through: the gradient passes the rounding
    jg = jax.jit(jax.grad(lambda a: jnp.sum(ja.jpeg_approx(a, quality) * jnp.arange(a.size).reshape(a.shape)
                                            / a.size)))(jnp.asarray(x))
    w = torch.arange(x.size, dtype=torch.float32).reshape(shape) / x.size
    tg = tc.grad_of(lambda a: torch.sum(ta.jpeg_approx(a, quality) * w), torch.as_tensor(x))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=2e-5, rtol=0)
    np.testing.assert_array_equal(tsma._dct_matrix(8), jsma._dct_matrix(8))


def test_projections_and_norms_equal_jax():
    rng = np.random.default_rng(4)
    orig = rng.random((3, 4, 4, 3)).astype(np.float32)
    adv = (orig + rng.normal(0, 0.2, orig.shape)).astype(np.float32)
    for jf, tf_, eps in ((ja.linf_project, ta.linf_project, 0.05), (ja.l2_project, ta.l2_project, 0.3)):
        np.testing.assert_allclose(tf_(_t(adv), _t(orig), eps).numpy(), np.asarray(jf(adv, orig, eps)),
                                   atol=1e-7, rtol=0)
    for a, b in zip(tc.perturbation_norms(_t(adv), _t(orig)), jc.perturbation_norms(adv, orig)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)
    sims = np.array([0.1, 0.4, 0.6], np.float32)
    for targeted in (False, True):
        np.testing.assert_array_equal(tc.check_success(_t(sims), targeted).numpy(),
                                      np.asarray(jc.check_success(sims, targeted)))


class _FixedBatchJaxModel:
    """The JAX model for the JAX TextAttacker, its text encodes padded to
    one batch of 8 rows (rows are independent): one compiled program
    instead of one per candidate count."""

    def __init__(self, jm):
        self.jm, self.config = jm, jm.config

    def encode_image(self, images):
        return self.jm.encode_image(images)

    def encode_text(self, texts):
        texts = list(texts)
        return np.asarray(self.jm.encode_text(texts + [texts[-1]] * (8 - len(texts))))[:len(texts)]


@pytest.fixture(scope="module")
def lexicon():
    """Both lexicons probe for nltk's WordNet once, at their first lookup
    (seconds when nltk is installed): done here, not in the test."""
    ja.get_synonyms("car"), ta.get_synonyms("car")


def test_text_attack_equals_jax(pair, lexicon):
    jm, tm, images, jt, tt = pair
    cfg = dict(min_text_similarity=0.0)
    text = "a red car on the street"
    jres = ja.TextAttacker(_FixedBatchJaxModel(jm), ja.TextAttackConfig(**cfg)).attack([images[0]], [text])
    tres = ta.TextAttacker(tm, ta.TextAttackConfig(**cfg)).attack([images[0]], [text])
    assert tres.adv_texts == jres.adv_texts and tres.original_texts == [text]
    np.testing.assert_array_equal(tres.num_words_changed, jres.num_words_changed)
    np.testing.assert_allclose(tres.final_similarity, jres.final_similarity, atol=2e-5, rtol=0)
    np.testing.assert_array_equal(tres.success, jres.success)
    stop = ta.create_text_attacker(tm, ta.TextAttackConfig(**cfg)).attack([images[1]], ["the cat is on the table"])
    assert [w for w in stop.adv_texts[0].split() if w in {"the", "is", "on"}] == ["the", "is", "on", "the"]


def test_presets_and_from_dict_equal_jax():
    for name in ("PGD", "FGSM", "CW", "Hubness", "FSTA", "SMA"):
        jp, tp = getattr(ja, f"{name}AttackPresets"), getattr(ta, f"{name}AttackPresets")
        presets = [m for m in vars(jp) if not m.startswith("_")]
        assert presets == [m for m in vars(tp) if not m.startswith("_")]
        for p in presets:
            assert dataclasses.asdict(getattr(tp, p)()) == dataclasses.asdict(getattr(jp, p)()), (name, p)
    for name in ("PGD", "FGSM", "CW", "Hubness", "FSTA", "SMA", "Text"):
        jcfg, tcfg = getattr(ja, f"{name}AttackConfig"), getattr(ta, f"{name}AttackConfig")
        assert dataclasses.asdict(tcfg()) == dataclasses.asdict(jcfg()), name
    d = {"epsilon": 0.1, "num_iterations": 7, "objective": "win_hinge", "unknown": 1}
    assert ta.HubnessAttackConfig.from_dict(d) == ta.HubnessAttackConfig(epsilon=0.1, num_iterations=7,
                                                                          objective="win_hinge")
    assert dataclasses.asdict(ta.HubnessAttackConfig.from_dict(d)) == \
        dataclasses.asdict(ja.HubnessAttackConfig.from_dict(d))
    assert (ta.TARGETED_SUCCESS_SIM, ta.UNTARGETED_SUCCESS_SIM) == (ja.TARGETED_SUCCESS_SIM, ja.UNTARGETED_SUCCESS_SIM)


def test_exports_are_the_jax_packages_but_the_adaptive_ones():
    adaptive = {"AdaptiveAttackConfig", "AdaptiveAttacker", "DEFAULT_PENALTY_SWEEP", "create_adaptive_attacker",
                "run_adaptive_evaluation"}
    want = {n for n in vars(ja) if not n.startswith("_") and n not in adaptive and not
            isinstance(getattr(ja, n), type(ja))}
    missing = {n for n in want if not hasattr(ta, n)}
    assert not missing, missing
    for n in ("create_pgd_attacker", "create_fgsm_attacker", "create_cw_attacker", "create_fsta_attacker",
              "create_sma_attacker", "create_hubness_attacker"):
        assert callable(getattr(ta, n))


def test_encode_image_tensor_and_text_image_similarity(pair):
    """``tests/test_clip.py``'s uses of the two CLIPModel entry points."""
    jm, tm, images, jt, tt = pair
    px = _t(images[:2])
    feats = tm.encode_image_tensor(tc.normalize_pixels(px))
    want = np.asarray(jax.jit(lambda p: jm.encode_image_tensor(jc.normalize_pixels(p)))(jnp.asarray(images[:2])))
    np.testing.assert_allclose(feats.numpy(), want, atol=2e-5, rtol=0)
    g = tc.grad_of(lambda p: torch.mean(torch.sum(tm.encode_image_tensor(tc.normalize_pixels(p)) * tt[:2], -1)), px)
    assert g.shape == px.shape and float(g.abs().max()) > 0
    img = np.random.default_rng(2).random((32, 32, 3)).astype(np.float32)
    sim = tm.get_text_image_similarity("hello world", img)
    assert sim.shape == (1,) and -1.0 <= float(sim[0]) <= 1.0
    np.testing.assert_allclose(sim.numpy(), np.asarray(jm.get_text_image_similarity("hello world", img)),
                               atol=2e-5, rtol=0)
