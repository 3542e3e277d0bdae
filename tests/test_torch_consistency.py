"""tvc_torch consistency math and scoring against the JAX package.

The same numpy inputs (seeded) go through ``tvc.core`` / the Pallas kernel
(interpret mode) and through the port; f32 tolerance 2e-5, flags exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvc.core import consistency as JC
from tvc.core import similarity as JS
from tvc.core.pallas.consistency_kernel import (
    consistency_scores_reference as j_reference,
    fused_consistency_scores as j_fused,
)
from tvc_torch.core import consistency as TC
from tvc_torch.core import similarity as TS
from tvc_torch.core.kernels.consistency_kernel import (
    consistency_scores_reference as t_reference,
    fused_consistency_scores as t_fused,
)

TOL = 2e-5
B, V, R, D = 24, 5, 3, 64


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), atol=tol, rtol=0)


def _safe_threshold(agg, q=0.5):
    """A threshold at least 1e-4 from every value of ``agg``, near quantile q."""
    s = np.sort(np.asarray(agg, np.float64))
    gaps = [(abs(i / len(s) - q), (s[i] + s[i + 1]) / 2) for i in range(len(s) - 1) if s[i + 1] - s[i] > 2e-4]
    return np.float32(min(gaps)[1])


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    img = rng.standard_normal((B, D)).astype(np.float32)
    txt = (img + rng.standard_normal((B, D))).astype(np.float32)
    var = rng.standard_normal((B, V, D)).astype(np.float32)
    refs = rng.standard_normal((B, R, D)).astype(np.float32)
    vmask = rng.random((B, V)) > 0.3
    rmask = rng.random((B, R)) > 0.2
    vmask[0] = False  # no variants
    rmask[1] = False  # no references
    vmask[2] = rmask[2] = False  # neither
    sims = {
        "orig": rng.uniform(-1, 1, B).astype(np.float32),
        "var": rng.uniform(-1, 1, (B, V)).astype(np.float32),
        "ret": rng.uniform(-1, 1, (B, R)).astype(np.float32),
        "gen": rng.uniform(-1, 1, (B, 2)).astype(np.float32),
        "gmask": rng.random((B, 2)) > 0.5,
    }
    return dict(img=img, txt=txt, var=var, refs=refs, vmask=vmask, rmask=rmask, sims=sims)


T = torch.as_tensor
J = jnp.asarray


@pytest.mark.parametrize("name", ["l2_normalize", "cosine_similarity", "pairwise_cosine", "batched_set_cosine"])
def test_similarity_functions(data, name):
    a, b = data["img"], data["txt"]
    args = {
        "l2_normalize": (a,),
        "cosine_similarity": (a, b),
        "pairwise_cosine": (a, b),
        "batched_set_cosine": (a, data["var"]),
    }[name]
    got = getattr(TS, name)(*(T(x) for x in args)).numpy()
    want = np.asarray(getattr(JS, name)(*(J(x) for x in args)))
    _close(got, want)


@pytest.mark.parametrize("name", ["masked_mean", "masked_std", "masked_mean_std", "masked_max"])
@pytest.mark.parametrize("with_mask", [True, False])
def test_masked_statistics(data, name, with_mask):
    x, m = data["sims"]["var"], data["vmask"]
    got = getattr(TS, name)(T(x), T(m) if with_mask else None)
    want = getattr(JS, name)(J(x), J(m) if with_mask else None)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("method", ["mean", "max", "min", "weighted_mean"])
def test_primary_stack_detect(data, method):
    s = data["sims"]
    w = np.asarray([0.5, 0.3, 0.2], np.float32)
    j_flags, j_agg, j_per = JC.detect(
        J(s["orig"]), J(s["var"]), J(s["ret"]), J(data["vmask"]), J(data["rmask"]),
        method=method, weights=J(w), threshold=0.3,
    )
    thr = _safe_threshold(j_agg)
    j_flags, j_agg, j_per = JC.detect(
        J(s["orig"]), J(s["var"]), J(s["ret"]), J(data["vmask"]), J(data["rmask"]),
        method=method, weights=J(w), threshold=thr,
    )
    t_flags, t_agg, t_per = TC.detect(
        T(s["orig"]), T(s["var"]), T(s["ret"]), T(data["vmask"]), T(data["rmask"]),
        method=method, weights=T(w), threshold=thr,
    )
    _close(t_agg.numpy(), np.asarray(j_agg))
    _close(t_per.numpy(), np.asarray(j_per))
    np.testing.assert_array_equal(t_flags.numpy(), np.asarray(j_flags))


@pytest.mark.parametrize("strategy", ["simple", "weighted", "adaptive"])
@pytest.mark.parametrize("history", [None, 0.45])
def test_alt_stack(data, strategy, history):
    s = data["sims"]
    args = (s["orig"], s["var"], s["ret"], s["gen"], data["vmask"], data["rmask"], s["gmask"])
    jm = JC.compute_consistency_metrics(*(J(a) for a in args))
    tm = TC.compute_consistency_metrics(*(T(a) for a in args))
    for f in ("original_similarity", "text_variant_consistency", "text_variant_std",
              "retrieval_consistency", "retrieval_std", "generative_consistency",
              "generative_std", "cross_modal_variance"):
        _close(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)))
    j_over = JC.overall_score(jm, strategy)
    t_over = TC.overall_score(tm, strategy)
    _close(t_over.numpy(), np.asarray(j_over))
    hist_j = None if history is None else J(np.float32(history))
    hist_t = None if history is None else T(np.float32(history))
    j_thr = JC.adaptive_threshold(jm, 0.5, hist_j)
    t_thr = TC.adaptive_threshold(tm, 0.5, hist_t)
    _close(t_thr.numpy(), np.asarray(j_thr))
    _close(
        TC.decision_confidence(t_over, t_thr, tm.cross_modal_variance).numpy(),
        np.asarray(JC.decision_confidence(j_over, j_thr, jm.cross_modal_variance)),
    )
    np.testing.assert_array_equal(
        TC.alt_is_adversarial(t_over, t_thr).numpy()[np.abs(np.asarray(j_over - j_thr)) > 1e-4],
        np.asarray(JC.alt_is_adversarial(j_over, j_thr))[np.abs(np.asarray(j_over - j_thr)) > 1e-4],
    )


@pytest.fixture(scope="module")
def jax_scores(data):
    """JAX oracle and Pallas kernel (interpret mode) at a threshold 1e-4
    away from every aggregated score."""
    d = data
    args = (J(d["img"]), J(d["txt"]), J(d["var"]), J(d["refs"]))
    kw = dict(variant_mask=J(d["vmask"]), ref_mask=J(d["rmask"]), weights=(0.4, 0.4, 0.2))
    thr = _safe_threshold(j_reference(*args, **kw, threshold=0.5)["aggregated"])
    return thr, {
        "reference": j_reference(*args, **kw, threshold=thr),
        "pallas": j_fused(*args, **kw, threshold=thr, block_b=8, interpret=True),
    }


@pytest.mark.parametrize("port_fn", ["consistency_scores_reference", "fused_consistency_scores"])
@pytest.mark.parametrize("jax_fn", ["reference", "pallas"])
def test_consistency_scores_match_jax(data, jax_scores, port_fn, jax_fn):
    """Port plain version (and the wrapper, which takes it for CPU
    tensors) against the JAX oracle and the Pallas kernel, including rows
    with no variants, no references and neither."""
    thr, outs = jax_scores
    fn = {"consistency_scores_reference": t_reference, "fused_consistency_scores": t_fused}[port_fn]
    d = data
    got = fn(
        T(d["img"]), T(d["txt"]), T(d["var"]), T(d["refs"]),
        variant_mask=T(d["vmask"]), ref_mask=T(d["rmask"]),
        weights=(0.4, 0.4, 0.2), threshold=float(thr),
    )
    want = outs[jax_fn]
    assert set(got) == set(want)
    for k in want:
        if k == "is_adversarial":
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        else:
            _close(got[k].numpy(), np.asarray(want[k]))
    assert not got["is_adversarial"][2] or got["aggregated"][2] > thr


def test_consistency_wrapper_runtime_weights_and_default_masks(data):
    """Tensor weights / threshold and absent masks (all slots real)."""
    d = data
    args = (J(d["img"]), J(d["txt"]), J(d["var"]), J(d["refs"]))
    want = j_reference(*args, weights=(0.2, 0.5, 0.3), threshold=0.1)
    got = t_fused(
        T(d["img"]), T(d["txt"]), T(d["var"]), T(d["refs"]),
        weights=torch.tensor([0.2, 0.5, 0.3]), threshold=torch.tensor(0.1),
    )
    for k in ("aggregated", "tv_score", "sd_score", "variant_std"):
        _close(got[k].numpy(), np.asarray(want[k]))


def test_consistency_wrapper_rejects_bad_shapes(data):
    d = data
    with pytest.raises(ValueError):
        t_fused(T(d["img"]), T(d["txt"][:-1]), T(d["var"]), T(d["refs"]))
    with pytest.raises(ValueError):
        t_fused(T(d["img"]).to("meta"), T(d["txt"]).to("meta"), T(d["var"]).to("meta"), T(d["refs"]).to("meta"))
