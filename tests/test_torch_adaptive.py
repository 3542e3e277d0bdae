"""tvc_torch.attacks.adaptive against tvc.attacks.adaptive on the tiny CLIP
(parameters carried over with ``params_from_jax``, the same text features,
variants, references and, where a run draws, the JAX draws fed to the
port's ``_adaptive_run``).

Held, as for the other attacks (tests/test_torch_attacks.py says why a
multi-step sign attack is not bit-equal across the packages):

* ``aggregated_score_fn`` (one variant draw and an EOT axis) within 2e-5;
* the objective's gradient at step 0 (band penalty and probe penalty
  active, pgd and hubness bases) within 1e-4 of max |g|;
* one momentum step equal on >= 99.9 % of the pixels;
* the ε-ball within one f32 rounding (1e-7) and [0, 1] exactly, for every
  λ; the final similarities and aggregates within FINAL_TOL of JAX's;
* λ = 0 without momentum is the port's PGD, bit for bit;
* ``run_adaptive_evaluation``'s artifact has the JAX artifact's keys.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tvc.attacks.adaptive as jad
import tvc_torch.attacks.adaptive as tad
from tvc.attacks import common as jc
from tvc.models.clip import CLIPConfig as JConfig, CLIPModel as JModel
from tvc_torch.attacks import common as tc, pgd as tpgd
from tvc_torch.attacks.pgd import PGDAttackConfig
from tvc_torch.models.clip import CLIPConfig, CLIPModel, params_from_jax

AGG_TOL = 2e-5
GRAD_TOL = 1e-4
FINAL_TOL = 1e-2
B = 4
TEXTS = [f"a photo of object number {i}" for i in range(B)]
VARIANTS = [[f"an image of object number {i}", f"object number {i} pictured"] for i in range(B)]
WEIGHTS = (0.4, 0.4, 0.2)


@pytest.fixture(scope="module")
def pair():
    jm = JModel(JConfig.tiny(), seed=0)
    cfg = CLIPConfig.tiny()
    tm = CLIPModel(cfg, params=params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params), cfg), device="cpu")
    rng = np.random.default_rng(0)
    S, D = cfg.image_size, cfg.embed_dim
    images = rng.uniform(size=(B, S, S, 3)).astype(np.float32)
    refs = rng.normal(size=(B, 3, D)).astype(np.float32)
    refs /= np.linalg.norm(refs, axis=-1, keepdims=True)
    refs[0, 2] = 0.0  # one empty reference slot: masked on both sides
    txt = np.asarray(jm.encode_text(TEXTS))
    vemb = np.asarray(jm.encode_text([v for vl in VARIANTS for v in vl])).reshape(B, 2, D)
    vmask = np.ones((B, 2), bool)
    vmask[1, 1] = False
    rmask = np.any(refs != 0, axis=-1)
    return jm, tm, images, txt, vemb, vmask, refs, rmask


def _t(x):
    return torch.as_tensor(np.array(x))


def _agg_fns(pair, vemb, vmask):
    jm, tm, images, txt, _, _, refs, rmask = pair
    jf = jad.aggregated_score_fn(jc.make_encoder(jm), jm.params, jnp.asarray(txt), jnp.asarray(vemb),
                                 jnp.asarray(vmask), jnp.asarray(refs), jnp.asarray(rmask), jnp.asarray(WEIGHTS))
    tf = tad.aggregated_score_fn(tc.make_encoder(tm), tm.params, _t(txt), _t(vemb), _t(vmask), _t(refs), _t(rmask),
                                 torch.tensor(WEIGHTS))
    return jf, tf


def test_aggregated_score_fn_matches_jax(pair):
    jm, tm, images, txt, vemb, vmask, refs, rmask = pair
    jf, tf = _agg_fns(pair, vemb, vmask)
    want = np.asarray(jax.jit(jf)(jnp.asarray(images)))
    got = tf(_t(images)).numpy()
    assert got.shape == (B,)
    np.testing.assert_allclose(got, want, atol=AGG_TOL, rtol=0)


def test_aggregated_score_fn_eot_matches_jax(pair):
    """M = 3 defender draws folded into one detect call: [M, B]."""
    jm, tm, images, txt, vemb, vmask, refs, rmask = pair
    rng = np.random.default_rng(1)
    v3 = np.stack([vemb, vemb[::-1], vemb + 0.05 * rng.normal(size=vemb.shape).astype(np.float32)], axis=1)
    m3 = np.stack([vmask, np.ones_like(vmask), vmask[::-1]], axis=1)
    jf, tf = _agg_fns(pair, v3, m3)
    want = np.asarray(jax.jit(jf)(jnp.asarray(images)))
    got = tf(_t(images)).numpy()
    assert got.shape == (3, B)
    np.testing.assert_allclose(got, want, atol=AGG_TOL, rtol=0)


def _band(pair):
    """A band around the clean aggregates narrower than their spread: the
    hinge is active on both sides for some rows."""
    jm, tm, images, txt, vemb, vmask, refs, rmask = pair
    s = _agg_fns(pair, vemb, vmask)[1](_t(images)).numpy()
    lo, hi = np.quantile(s, [0.4, 0.6])
    return float(lo), float(hi)


def _jax_objective(pair, cfg, lam, queries, probe=None, probe_thr=None):
    """The JAX objective of ``_adaptive_run`` as a function of the pixels,
    rebuilt from its pieces."""
    jm, tm, images, txt, vemb, vmask, refs, rmask = pair
    jf, _ = _agg_fns(pair, vemb, vmask)
    jenc = jc.make_encoder(jm)

    def jobj(adv):
        img = jenc(jm.params, adv)
        if cfg.base == "hubness":
            atk = jnp.mean(jnp.einsum("bd,bqd->bq", img, jnp.asarray(queries)))
        else:
            atk = -jnp.mean(jnp.sum(img * jnp.asarray(txt), -1))
        agg = jf(adv)
        pen = jnp.maximum(agg - cfg.band_upper, 0.0) + jnp.maximum(cfg.band_lower - agg, 0.0)
        obj = atk - lam * jnp.mean(pen)
        if probe is not None:
            top, _ = jax.lax.top_k(img @ jnp.asarray(probe).T, cfg.probe_top_m)
            obj = obj - cfg.probe_weight * jnp.mean(jnp.maximum(jnp.mean(top, -1) - probe_thr, 0.0))
        return obj

    return jobj


@pytest.mark.parametrize("base", ["pgd", "hubness"])
def test_gradient_at_step_0_matches_jax(pair, base):
    """The gradient of the whole objective (base term, band penalty at
    λ = 5, probe penalty) at the clean pixels: computed by the port inside
    ``_adaptive_run``'s objective, by JAX with ``jax.grad``."""
    jm, tm, images, txt, vemb, vmask, refs, rmask = pair
    lo, hi = _band(pair)
    D = txt.shape[-1]
    rng = np.random.default_rng(2)
    queries = rng.normal(size=(B, 5, D)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=-1, keepdims=True)
    probe = rng.normal(size=(6, D)).astype(np.float32)
    probe /= np.linalg.norm(probe, axis=-1, keepdims=True)
    cfg = tad.AdaptiveAttackConfig(base=base, band_lower=lo, band_upper=hi, probe_weight=2.0, probe_top_m=3,
                                   num_steps=1, use_momentum=False, alpha=1e-6)
    jobj = _jax_objective(pair, cfg, 5.0, queries, probe, -1.0)
    jg = np.asarray(jax.jit(jax.grad(jobj))(jnp.asarray(images)))
    # one step of size alpha with no momentum moves each pixel by
    # alpha * sign(g): read the port's sign(g) off the step
    adv, *_ = tad._adaptive_run(tc.make_encoder(tm), cfg, tm.params, _t(images), _t(txt), _t(vemb), _t(vmask),
                                _t(refs), _t(rmask), _t(queries), 5.0, None, _t(probe), -1.0)
    step_sign = np.sign(adv.numpy() - images)
    inside = (images > 1e-5) & (images < 1 - 1e-5)  # the clamp leaves these steps whole
    big = np.abs(jg) > GRAD_TOL * np.abs(jg).max()
    assert np.mean((step_sign == np.sign(jg))[inside & big]) >= 0.999
    # and the gradient itself, through the same functions the run uses
    tobj_pieces = tad.aggregated_score_fn(tc.make_encoder(tm), tm.params, _t(txt), _t(vemb), _t(vmask), _t(refs),
                                          _t(rmask), torch.tensor(WEIGHTS))
    enc = tc.make_encoder(tm)
    tq, tp = _t(queries), _t(probe)

    def tobj(adv):
        img = enc(tm.params, adv)
        atk = torch.mean(torch.einsum("bd,bqd->bq", img, tq)) if base == "hubness" else \
            -torch.mean(torch.sum(img * _t(txt), -1))
        agg = tobj_pieces(adv)
        zero = torch.zeros_like(agg)
        pen = torch.maximum(agg - hi, zero) + torch.maximum(lo - agg, zero)
        top = torch.topk(img @ tp.T, 3, dim=-1).values.mean(-1)
        return atk - 5.0 * pen.mean() - 2.0 * torch.maximum(top + 1.0, torch.zeros_like(top)).mean()

    tg = tc.grad_of(tobj, _t(images)).numpy()
    assert np.abs(jg).max() > 0
    assert np.abs(jg - tg).max() <= GRAD_TOL * np.abs(jg).max()


def test_one_momentum_step_equals_jax(pair):
    jm, tm, images, txt, vemb, vmask, refs, rmask = pair
    lo, hi = _band(pair)
    kw = dict(num_steps=1, band_lower=lo, band_upper=hi)  # one step: no random start
    jcfg, tcfg = jad.AdaptiveAttackConfig(**kw), tad.AdaptiveAttackConfig(**kw)
    D = txt.shape[-1]
    q = np.zeros((B, 1, D), np.float32)
    jadv, jsims, _, jagg = jax.jit(functools.partial(jad._adaptive_run, jc.make_encoder(jm), jcfg))(
        jm.params, jnp.asarray(images), jnp.asarray(txt), jnp.asarray(vemb), jnp.asarray(vmask), jnp.asarray(refs),
        jnp.asarray(rmask), jnp.asarray(q), jnp.float32(3.0), jax.random.PRNGKey(0))
    tadv, tsims, _, tagg = tad._adaptive_run(tc.make_encoder(tm), tcfg, tm.params, _t(images), _t(txt), _t(vemb),
                                             _t(vmask), _t(refs), _t(rmask), _t(q), 3.0, None)
    assert np.mean(np.asarray(jadv) == tadv.numpy()) >= 0.999
    np.testing.assert_allclose(tagg.numpy(), np.asarray(jagg), atol=FINAL_TOL, rtol=0)


@functools.lru_cache(maxsize=None)
def _jax_run(jm, cfg):
    """The jitted JAX attack program of one config (λ is an operand, so the
    λ cases share it)."""
    return jax.jit(functools.partial(jad._adaptive_run, jc.make_encoder(jm), cfg))


def _in_ball(adv, pixels, eps):
    adv = np.asarray(adv)
    assert adv.min() >= 0.0 and adv.max() <= 1.0
    assert np.abs(adv - pixels).max() <= eps + 1e-7


@pytest.mark.parametrize("lam", [0.0, 5.0])
def test_run_with_the_jax_draw_matches_jax(pair, lam):
    """Four momentum steps from JAX's random start: the constraints, and
    the final similarities and aggregates within FINAL_TOL."""
    jm, tm, images, txt, vemb, vmask, refs, rmask = pair
    lo, hi = _band(pair)
    kw = dict(num_steps=4, epsilon=8 / 255, alpha=2 / 255, band_lower=lo, band_upper=hi)
    jcfg, tcfg = jad.AdaptiveAttackConfig(**kw), tad.AdaptiveAttackConfig(**kw)
    D = txt.shape[-1]
    q = np.zeros((B, 1, D), np.float32)
    key = jax.random.PRNGKey(3)
    jadv, jsims, _, jagg = _jax_run(jm, jcfg)(
        jm.params, jnp.asarray(images), jnp.asarray(txt), jnp.asarray(vemb), jnp.asarray(vmask), jnp.asarray(refs),
        jnp.asarray(rmask), jnp.asarray(q), jnp.float32(lam), key)
    # the draw _adaptive_run makes from its key
    noise = _t(jax.random.uniform(key, images.shape, minval=-jcfg.epsilon, maxval=jcfg.epsilon))
    tadv, tsims, _, tagg = tad._adaptive_run(tc.make_encoder(tm), tcfg, tm.params, _t(images), _t(txt), _t(vemb),
                                             _t(vmask), _t(refs), _t(rmask), _t(q), lam, noise)
    _in_ball(tadv, images, tcfg.epsilon)
    np.testing.assert_allclose(tsims.numpy(), np.asarray(jsims), atol=FINAL_TOL, rtol=0)
    np.testing.assert_allclose(tagg.numpy(), np.asarray(jagg), atol=FINAL_TOL, rtol=0)


def test_lambda_zero_is_pgd(pair):
    """λ = 0 and no momentum: the band penalty adds nothing and the update
    is PGD's, so the run equals the port's ``_pgd_run`` on the same random
    start, bit for bit, and lowers the similarity."""
    jm, tm, images, txt, vemb, vmask, refs, rmask = pair
    eps, alpha, steps = 16 / 255, 2 / 255, 6
    acfg = tad.AdaptiveAttackConfig(epsilon=eps, alpha=alpha, num_steps=steps, use_momentum=False)
    pcfg = PGDAttackConfig(epsilon=eps, alpha=alpha, num_steps=steps)
    attacker = tad.AdaptiveAttacker(tm, acfg)
    noise = attacker.draw_noise(_t(images))
    D = txt.shape[-1]
    adv, sims, _, _ = tad._adaptive_run(tc.make_encoder(tm), acfg, tm.params, _t(images), _t(txt), _t(vemb),
                                        _t(vmask), _t(refs), _t(rmask), torch.zeros(B, 1, D), 0.0, noise)
    padv, psims = tpgd._pgd_run(tc.make_encoder(tm), pcfg, tm.params, _t(images), _t(txt), _t(txt), noise)
    assert torch.equal(adv, padv) and torch.equal(sims, psims)
    res = attacker.attack(images, TEXTS, VARIANTS, refs, penalty_weight=0.0)
    np.testing.assert_array_equal(res.adv_images, adv.numpy())
    clean = np.sum(tm.encode_image(images).numpy() * txt, -1)
    assert res.final_similarity.mean() < clean.mean() - 0.05


@pytest.mark.parametrize("lam", [0.0, 2.0, 25.0])
def test_attack_constraints_for_every_lambda(pair, lam):
    jm, tm, images, txt, vemb, vmask, refs, rmask = pair
    lo, hi = _band(pair)
    cfg = tad.AdaptiveAttackConfig(epsilon=8 / 255, alpha=2 / 255, num_steps=5, band_lower=lo, band_upper=hi)
    res = tad.AdaptiveAttacker(tm, cfg).attack(images, TEXTS, VARIANTS, refs, penalty_weight=lam)
    _in_ball(res.adv_images, images, cfg.epsilon)
    assert np.all(res.perturbation_linf <= cfg.epsilon + 1e-7)
    info = res.info
    assert info["penalty_weight"] == lam and info["final_aggregated"].shape == (B,)
    np.testing.assert_array_equal(info["inside_band"], (info["final_aggregated"] >= lo)
                                  & (info["final_aggregated"] <= hi))
    np.testing.assert_array_equal(res.success, info["final_objective"] < 0.3)


def test_hubness_base_eot_and_probe(pair):
    """The hubness base with a gallery (success by the hubness score), EOT
    over three variant draws, and the counter-adaptive probe penalty."""
    jm, tm, images, txt, vemb, vmask, refs, rmask = pair
    cfg = tad.AdaptiveAttackConfig(base="hubness", epsilon=8 / 255, alpha=2 / 255, num_steps=3, band_lower=0.3,
                                   band_upper=0.7, probe_weight=1.0, probe_top_m=2)
    samples = [[[f"draw {m} version {j} of object {i}" for j in range(2)] for i in range(B)] for m in range(3)]
    gallery = tm.encode_image(np.random.default_rng(4).uniform(size=images.shape).astype(np.float32))
    res = tad.AdaptiveAttacker(tm, cfg).attack(
        images, TEXTS, VARIANTS, refs, query_pool=[f"query caption {i}" for i in range(12)], penalty_weight=1.0,
        gallery_feats=gallery, variant_samples=samples, probe_feats=tm.encode_text(["a probe", "another probe"]),
        probe_threshold=0.1)
    _in_ball(res.adv_images, images, cfg.epsilon)
    hs = res.info["hubness_scores"]
    assert hs.shape == (B,) and np.all((hs >= 0) & (hs <= 1))
    np.testing.assert_array_equal(res.success, hs > 0.5)
    assert res.info["final_aggregated"].shape == (B,)  # the mean over the three draws
    with pytest.raises(ValueError, match="query_pool"):
        tad.AdaptiveAttacker(tm, cfg).attack(images, TEXTS, VARIANTS, refs)


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return None


#: the artifact of tvc.attacks.adaptive.run_adaptive_evaluation with the
#: hub probe armed and a strong pass: its keys, read off the JAX source
#: (held against a JAX run by the slow test below)
ROW_KEYS = {"mean_hub_probe_score", "detection_rate_with_hub_probe", "evasion_with_hub_probe",
            "attack_success_rate", "detection_rate", "auroc_band", "evasion_success_rate", "mean_final_similarity",
            "mean_aggregated", "inside_band_rate_selfscored"}
STRONG_KEYS = {"penalty_weight", "num_steps", "eot_samples"} | ROW_KEYS


def _evaluate(det, mod, images, refs, sampler, clean, **kw):
    score = functools.partial(lambda d, adv: d.detect_batch(adv, TEXTS, variants=VARIANTS).aggregated_score, det)
    probe_feats = np.asarray(det.model.encode_text(["a probe caption", "another"]))
    return mod.run_adaptive_evaluation(
        det.model, det, images, TEXTS, VARIANTS, refs, clean,
        attack_config=mod.AdaptiveAttackConfig(num_steps=1, epsilon=8 / 255, alpha=2 / 255, probe_top_m=2),
        score_batch=score, variant_sampler=sampler, probe_score_batch=lambda adv: np.full(len(adv), 0.1),
        attacker_probe_feats=probe_feats, base="pgd", strong_steps=2, eot_samples=2, probe_threshold=0.2,
        probe_weight=1.0, **kw)


def _sampler():
    draws = iter(range(100))

    def sampler():
        m = next(draws)
        return [[f"draw {m} of object {i}"] for i in range(B)]

    return sampler


def _check_artifact(got, clean, sweep):
    assert set(got) == {"band", "base", "epsilon", "num_steps", "sweep", "strong", "strong_vs_probe"}
    assert set(got["sweep"]) == {str(lam) for lam in sweep}
    assert all(set(row) == ROW_KEYS for row in got["sweep"].values())
    assert set(got["strong"]) == STRONG_KEYS and set(got["strong_vs_probe"]) == STRONG_KEYS | {"probe_weight"}
    np.testing.assert_allclose(got["band"], np.quantile(clean, [0.005, 0.995]), atol=0)
    assert got["strong"]["eot_samples"] == 2 and got["strong"]["num_steps"] == 2
    for row in [*got["sweep"].values(), got["strong"], got["strong_vs_probe"]]:
        for k in ("attack_success_rate", "detection_rate", "auroc_band", "evasion_success_rate",
                  "detection_rate_with_hub_probe"):
            assert 0.0 <= row[k] <= 1.0, k


def test_run_adaptive_evaluation_artifact(pair):
    """The port's evaluation on a staged detector: a one-step sweep, then a
    two-step strong pass over two EOT draws with the hub probe armed; the
    artifact has the JAX artifact's keys, the band is the clean scores'
    quantiles, and every rate is in [0, 1]."""
    from tvc_torch.detector import AdversarialDetector, DetectorConfig

    jm, tm, images, txt, vemb, vmask, refs, rmask = pair
    det = AdversarialDetector(tm, DetectorConfig(use_fused_step=False), device="cpu")
    clean = det.detect_batch(images, TEXTS, variants=VARIANTS).aggregated_score
    _check_artifact(_evaluate(det, tad, images, refs, _sampler(), clean, sweep=(0.0, 2.0)), clean, (0.0, 2.0))


@pytest.mark.slow
def test_run_adaptive_evaluation_artifact_keys_match_jax(pair):
    """Both packages' evaluations on staged detectors (the same variants),
    one-step sweeps and a two-step strong pass over three EOT draws with
    the hub probe armed: the artifacts have the same keys, the band is the
    clean scores' quantiles, and every rate is in [0, 1]."""
    from tvc.detector import AdversarialDetector as JDetector, DetectorConfig as JDetConfig
    from tvc_torch.detector import AdversarialDetector, DetectorConfig

    jm, tm, images, txt, vemb, vmask, refs, rmask = pair
    jdet = JDetector(jm, JDetConfig(use_fused_step=False))
    tdet = AdversarialDetector(tm, DetectorConfig(use_fused_step=False), device="cpu")
    outs = []
    for det, mod in ((jdet, jad), (tdet, tad)):
        clean = det.detect_batch(images, TEXTS, variants=VARIANTS).aggregated_score
        outs.append((clean, _evaluate(det, mod, images, refs, _sampler(), clean, sweep=(0.0, 2.0))))
    (jclean, want), (tclean, got) = outs
    np.testing.assert_allclose(tclean, jclean, atol=AGG_TOL, rtol=0)
    assert _keys(got) == _keys(want)
    _check_artifact(got, tclean, (0.0, 2.0))


def test_text_attacker_keeps_the_band_api(pair):
    """AdaptiveTextAttacker with a white-box score replica: per-query
    results, the band flag consistent with the final aggregate."""
    jm, tm, images, *_ = pair

    def score_fn(image, cands):
        img = tm.encode_image(np.asarray(image)[None])
        return (tm.encode_text(list(cands)) @ img[0]).numpy()

    att = tad.AdaptiveTextAttacker(tm, score_fn, penalty_weight=2.0, band=(-0.1, 0.1))
    res = att.attack(images[:2], ["a big dog running across the green field", "a small cat"])
    assert len(res.adv_texts) == 2 and res.final_similarity.shape == (2,)
    assert res.info["penalty_weight"] == 2.0 and res.info["inside_band"].shape == (2,)
    assert all(n >= 0 for n in res.num_words_changed)


def test_exports():
    import tvc_torch.attacks as ta

    for name in ("AdaptiveAttackConfig", "AdaptiveAttacker", "DEFAULT_PENALTY_SWEEP", "create_adaptive_attacker",
                 "run_adaptive_evaluation"):
        assert getattr(ta, name) is getattr(tad, name)
    assert tad.DEFAULT_PENALTY_SWEEP == jad.DEFAULT_PENALTY_SWEEP
    assert dataclasses.asdict(tad.AdaptiveAttackConfig()) == dataclasses.asdict(jad.AdaptiveAttackConfig())
    assert isinstance(tad.create_adaptive_attacker(CLIPModel(CLIPConfig.tiny(), device="cpu")), tad.AdaptiveAttacker)
