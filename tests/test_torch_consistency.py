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
    operands_needing_copy,
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


# The dtypes, widths, masks and layouts the JAX function takes: it casts
# every embedding and mask to f32 and computes in f32. The port's CPU route
# casts the embeddings to f32 as well (masks: non-zero is valid), so the
# same values in bf16 / f16 give JAX's f32 results, not a bf16 computation.
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}


def _to_jax(t):
    """The same values as a JAX array of the same dtype."""
    if t.dtype in JAX_DTYPES:
        return J(t.float().numpy()).astype(JAX_DTYPES[t.dtype])
    return J(t.numpy())


def _held_to_jax(img, txt, var, refs, vmask=None, rmask=None, weights=(0.4, 0.4, 0.2), threshold=None):
    """The port's fused_consistency_scores on these CPU tensors against the
    Pallas kernel (interpret mode) on the same values: 2e-5, f32 outputs,
    flags exact. ``threshold`` None: a Python number 1e-4 away from every
    aggregated score; a callable: given that number, it returns what the
    port is handed (a tensor, say)."""
    jargs = [_to_jax(t) for t in (img, txt, var, refs)]
    jkw = dict(variant_mask=None if vmask is None else _to_jax(vmask),
               ref_mask=None if rmask is None else _to_jax(rmask),
               weights=tuple(float(w) for w in (weights.tolist() if isinstance(weights, torch.Tensor) else weights)))
    thr = _safe_threshold(j_reference(*(a.astype(jnp.float32) for a in jargs), **{
        **jkw, "variant_mask": None if vmask is None else J(vmask.numpy() != 0),
        "ref_mask": None if rmask is None else J(rmask.numpy() != 0)}, threshold=0.5)["aggregated"])
    want = j_fused(*jargs, **jkw, threshold=float(thr), block_b=8, interpret=True)
    got = t_fused(img, txt, var, refs, vmask, rmask, weights=weights,
                  threshold=float(thr) if threshold is None else threshold(float(thr)))
    assert set(got) == set(want)
    for k in want:
        if k == "is_adversarial":
            assert got[k].dtype == torch.bool
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
        else:
            assert got[k].dtype == torch.float32, (k, got[k].dtype)
            _close(got[k].numpy(), np.asarray(want[k]))
    return got


def _embeddings(D=D, seed=1):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((B, D)).astype(np.float32)
    txt = (img + rng.standard_normal((B, D))).astype(np.float32)
    var = (txt[:, None] + 0.5 * rng.standard_normal((B, V, D))).astype(np.float32)
    refs = rng.standard_normal((B, R, D)).astype(np.float32)
    return [T(a) for a in (img, txt, var, refs)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_consistency_takes_half_embeddings(data, dtype):
    """bf16 / f16 embeddings: JAX casts them to f32 first, so the port must
    too (computing in bf16 moves the scores by ~5e-3 and flips flags)."""
    args = [t.to(dtype) for t in _embeddings()]
    _held_to_jax(*args, T(data["vmask"]), T(data["rmask"]))


def test_consistency_takes_mixed_dtypes(data):
    """f32 img and txt with bf16 references (gathered straight from a bf16
    bank) and f16 variants."""
    img, txt, var, refs = _embeddings()
    _held_to_jax(img, txt, var.half(), refs.bfloat16(), T(data["vmask"]), T(data["rmask"]))


def test_consistency_takes_any_width(data):
    """D = 30: no multiple of 4, 8 or 128 (JAX pads nothing along D)."""
    _held_to_jax(*_embeddings(D=30), T(data["vmask"]), T(data["rmask"]))


@pytest.mark.parametrize("mask_dtype", [torch.int32, torch.int64, torch.uint8, torch.float32, torch.float16])
def test_consistency_takes_integer_and_float_masks(data, mask_dtype):
    """0 / 1 masks of any dtype (JAX casts them to f32): non-zero is valid,
    including the rows with no variants, no references and neither."""
    got = _held_to_jax(*_embeddings(), T(data["vmask"]).to(mask_dtype), T(data["rmask"]).to(mask_dtype))
    assert float(got["tv_score"][0]) == 0.0 and float(got["sd_score"][1]) == 0.0


def test_consistency_takes_non_contiguous_operands(data):
    """Variants as a strided slice, refs transposed from [R, B, D], masks as
    column slices: the same values as contiguous copies."""
    img, txt, var, refs = _embeddings()
    wide = torch.cat([var, torch.full_like(var, 7.0)], dim=-1)[..., :D]
    refs_t = refs.transpose(0, 1).contiguous().transpose(0, 1)
    vmask = torch.cat([T(data["vmask"]), T(data["vmask"])], dim=1)[:, ::2]
    assert not (wide.is_contiguous() or refs_t.is_contiguous() or vmask.is_contiguous())
    _held_to_jax(img, txt, wide, refs_t, vmask, T(data["rmask"]))


@pytest.mark.parametrize("as_tensor", [False, True])
def test_consistency_takes_weights_as_numbers_or_tensors(data, as_tensor):
    w = (0.2, 0.5, 0.3)
    weights = torch.tensor(w) if as_tensor else w
    threshold = (lambda t: torch.tensor(t)) if as_tensor else None
    _held_to_jax(*_embeddings(), T(data["vmask"]), T(data["rmask"]), weights=weights, threshold=threshold)


def test_consistency_refuses_other_dtypes(data):
    img, txt, var, refs = _embeddings()
    with pytest.raises(ValueError):  # integer embeddings
        t_fused(img.to(torch.int32), txt, var, refs)
    with pytest.raises(ValueError):  # float64 embeddings
        t_fused(img, txt, var.double(), refs)
    with pytest.raises(ValueError):  # complex mask
        t_fused(img, txt, var, refs, variant_mask=torch.ones((B, V), dtype=torch.complex64))


def test_copy_rule_names_the_operands_the_card_would_copy(data):
    img, txt, var, refs = _embeddings()
    assert operands_needing_copy(img, txt, var, refs, T(data["vmask"]), T(data["rmask"])) == []
    strided = torch.cat([var, var], dim=-1)[..., :D]
    misaligned = torch.zeros(B * D + 1)[1:].reshape(B, D)  # 4 bytes past an aligned base
    assert operands_needing_copy(misaligned, txt, strided, refs, T(data["vmask"])[:, ::1]) == ["img", "variants"]
    assert operands_needing_copy(img, txt, var, refs, weights=torch.tensor([0.4, 0.4, 0.2], dtype=torch.float64),
                                 threshold=torch.tensor(0.5)) == ["weights"]


def _emulated_entry_point():
    """tvc_consistency_scores as a ctypes function of the C signature that
    reads its operands from the raw pointers by the dtype and mask codes and
    writes the [7, B] stats and [B] flags: what the kernel computes, by the
    plain version on the decoded values."""
    import ctypes

    from tvc_torch.core.kernels import _build, consistency_kernel as ck

    def raw(ptr, ctype, n):
        return np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctype)), (n,))

    def emb(ptr, code, n):
        if code == 0:
            return raw(ptr, ctypes.c_float, n).copy()
        bits = raw(ptr, ctypes.c_uint16, n)
        if code == 1:  # bf16: the upper half of an f32
            return (bits.astype(np.uint32) << 16).view(np.float32)
        return bits.view(np.float16).astype(np.float32)

    def mask(ptr, code, n):
        if code == 0:  # no mask: every slot valid, as the plain version takes None
            return None
        size = code & 15
        bits = raw(ptr, {1: ctypes.c_uint8, 2: ctypes.c_uint16, 4: ctypes.c_uint32, 8: ctypes.c_uint64}[size], n)
        bits = bits.astype(np.uint64)
        if code & ck.MASK_FLOAT:
            bits &= np.uint64((1 << (8 * size - 1)) - 1)
        return bits != 0

    def entry(img, txt, var, ref, vm, rm, wp, tp, w_tv, w_sd, w_cons, thr, stats, flags, B, V, R, D, dtypes,
              vcode, rcode, stream):
        code = [(dtypes >> (2 * i)) & 3 for i in range(4)]
        x, t = (emb(p, c, B * D).reshape(B, D) for p, c in ((img, code[0]), (txt, code[1])))
        v = emb(var, code[2], B * V * D).reshape(B, V, D) if V else np.zeros((B, 0, D), np.float32)
        r = emb(ref, code[3], B * R * D).reshape(B, R, D) if R else np.zeros((B, 0, D), np.float32)
        w = raw(wp, ctypes.c_float, 3).copy() if wp else (w_tv, w_sd, w_cons)
        thr = float(raw(tp, ctypes.c_float, 1)[0]) if tp else thr
        masks = [None if m is None else torch.as_tensor(m.reshape(B, -1))
                 for m in (mask(vm, vcode, B * V), mask(rm, rcode, B * R))]
        out = ck.consistency_scores_reference(*(torch.as_tensor(a) for a in (x, t, v, r)), *masks,
                                              weights=tuple(float(a) for a in w), threshold=thr)
        st = raw(stats, ctypes.c_float, 7 * B).reshape(7, B)
        for i, k in enumerate(ck.STAT_KEYS):
            st[i] = out[k].numpy()
        raw(flags, ctypes.c_uint8, B)[:] = out["is_adversarial"].numpy()
        return 0

    sig = _build.SIGNATURES["consistency"]["tvc_consistency_scores"]
    return ctypes.CFUNCTYPE(ctypes.c_int, *sig)(entry)


@pytest.mark.parametrize("dtypes", ["f32", "bf16", "f16", "mixed"])
@pytest.mark.parametrize("masks", ["bool", "int32", "float16", "float64", "absent"])
@pytest.mark.parametrize("scalars", ["numbers", "tensors"])
def test_consistency_kernel_arguments_match_the_c_signature(data, dtypes, masks, scalars):
    """The arguments the CUDA route hands the C entry point (pointers,
    dtype and mask codes, weights by value or by pointer, the outputs'
    layout) go through ctypes with the entry point's signature into an
    emulation that decodes them, and come back as the CPU route's results;
    a strided variants view is copied and counted."""
    from tvc_torch.core.kernels import consistency_kernel as ck

    dt = {"f32": [torch.float32] * 4, "bf16": [torch.bfloat16] * 4, "f16": [torch.float16] * 4,
          "mixed": [torch.float32, torch.float32, torch.float16, torch.bfloat16]}[dtypes]
    img, txt, var, refs = (a.to(d) for a, d in zip(_embeddings(D=30), dt))
    var = torch.cat([var, var], dim=-1)[..., :30]
    vm, rm = (None, None) if masks == "absent" else (T(data["vmask"]).to(getattr(torch, masks)),
                                                     T(data["rmask"]).to(getattr(torch, masks)))
    w, thr = ((0.3, 0.5, 0.2), 0.4) if scalars == "numbers" else (torch.tensor([0.3, 0.5, 0.2]), torch.tensor(0.4))
    copies = ck.fused_consistency_scores.copies
    args, got, _ = ck.kernel_call(img, txt, var, refs, vm, rm, w, thr)
    assert ck.fused_consistency_scores.copies == copies + 1
    assert _emulated_entry_point()(*args, None) == 0
    want = t_fused(img, txt, var, refs, vm, rm, w, thr)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == (B,), k
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-6, rtol=0, err_msg=k)
