"""Shapes the JAX kernels take that the port's CUDA kernels used to refuse:
head widths other than 32 / 64 (``fused_mha`` and the four layer
kernels), layer widths off a multiple of 8 / 16, the decode attention at
R > 8 and at head widths off {16, 32, 64, 128} (above 128 too),
``bank_topk`` at D % 8 != 0 and k > 128, and the int8 GEMMs at K, N off a
multiple of 16.

On the CPU each wrapper computes its plain version, held here to the JAX
function at the same shape (the Pallas kernels in interpret mode): f32 to
2e-5 of max(1, |y|), top-k indices exactly, the int8 layers to 1e-4 as in
``test_torch_quantized_layer.py`` and the W8A8 GEMM to 1e-6 (one rounding
of the same f32 dequantization, as ``test_torch_qwen_kernels.py``). On the card
(marked ``cuda``, skipped here) the kernel is held to its plain version at
the same shapes; ``tests/test_torch_cuda_kernels.py`` holds more of them.
"""

import importlib
import math

import numpy as np
import pytest
import torch

from tvc_torch.core import kernels as tk
from tvc_torch.core.kernels._pad import padded, round_up


class _Lazy:
    """A module imported at its first attribute access: the CPU tests read
    the JAX package; the card's machine, which runs the ``cuda`` cases at
    the end, has no JAX."""

    def __init__(self, name):
        self._name = name

    def __getattr__(self, attr):
        return getattr(importlib.import_module(self._name), attr)


jnp = _Lazy("jax.numpy")
jak, jalk, jdk, jqk, jtk, jwk = (_Lazy(f"tvc.core.pallas.{m}") for m in (
    "attention_kernel", "attention_layer_kernel", "decode_attention_kernel", "quantized_layer_kernel", "topk_kernel",
    "w8_matmul_kernel"))

TOL = 2e-5


def _err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float((np.abs(got - want) / np.maximum(1.0, np.abs(want))).max())


def _layer(rng, W, Wh):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(
        ln=(1 + 0.1 * f(W), 0.1 * f(W)),
        attn=(f(W, 3 * W) / math.sqrt(W), 0.02 * f(3 * W), f(W, W) / math.sqrt(W), 0.02 * f(W)),
        mlp=(f(W, Wh) / math.sqrt(W), 0.02 * f(Wh), f(Wh, W) / math.sqrt(Wh), 0.02 * f(W)),
    )


T_ = lambda *a: [torch.as_tensor(np.array(x)) for x in a]
J_ = lambda *a: [jnp.asarray(x) for x in a]


@pytest.mark.parametrize("B,T,H,D,causal", [(2, 7, 3, 48, False), (2, 9, 2, 96, True), (1, 5, 1, 300, False),
                                            (3, 6, 4, 16, True)])
def test_fused_mha_any_head_width(B, T, H, D, causal):
    rng = np.random.default_rng(D)
    q, k, v = (rng.standard_normal((B, T, H, D)).astype(np.float32) for _ in range(3))
    want = jak.fused_mha(*J_(q, k, v), causal=causal, interpret=True)
    got = tk.fused_mha(*T_(q, k, v), causal=causal)
    assert _err(got, want) <= TOL


@pytest.mark.parametrize("W,H,causal", [(36, 3, False), (36, 3, True), (35, 5, False), (96, 2, True)])
def test_attention_layer_any_width(W, H, causal):
    rng = np.random.default_rng(W)
    p = _layer(rng, W, 2 * W)
    x = rng.standard_normal((2, 5, W)).astype(np.float32)
    want = jalk.fused_attention_layer(*J_(x, *p["ln"], *p["attn"]), heads=H, causal=causal, interpret=True)
    got = tk.fused_attention_layer(*T_(x, *p["ln"], *p["attn"]), heads=H, causal=causal)
    assert _err(got, want) <= TOL


@pytest.mark.parametrize("W,Wh", [(36, 60), (35, 70), (40, 24)])
def test_mlp_layer_any_width(W, Wh):
    rng = np.random.default_rng(W + Wh)
    p = _layer(rng, W, Wh)
    x = rng.standard_normal((2, 5, W)).astype(np.float32)
    want = jalk.fused_mlp_layer(*J_(x, *p["ln"], *p["mlp"]), interpret=True)
    got = tk.fused_mlp_layer(*T_(x, *p["ln"], *p["mlp"]))
    assert _err(got, want) <= TOL


def _i8(weights):
    w1, b1, w2, b2 = weights
    (q1, s1), (q2, s2) = jqk.quantize_linear(jnp.asarray(w1)), jqk.quantize_linear(jnp.asarray(w2))
    return [np.asarray(a) for a in (q1, s1, b1, q2, s2, b2)]


@pytest.mark.parametrize("kind", ["attention", "mlp"])
@pytest.mark.parametrize("W,H,Wh", [(40, 2, 24), (36, 3, 60)])
def test_int8_layers_any_width(kind, W, H, Wh):
    rng = np.random.default_rng(W * H)
    p = _layer(rng, W, Wh)
    x = rng.standard_normal((2, 5, W)).astype(np.float32)
    if kind == "attention":
        a = _i8(p["attn"])
        want = jqk.fused_attention_layer_i8(*J_(x, *p["ln"], *a), heads=H, interpret=True)
        got = tk.fused_attention_layer_i8(*T_(x, *p["ln"], *a), heads=H)
    else:
        m = _i8(p["mlp"])
        want = jqk.fused_mlp_layer_i8(*J_(x, *p["ln"], *m), interpret=True)
        got = tk.fused_mlp_layer_i8(*T_(x, *p["ln"], *m))
    assert _err(got, want) <= 1e-4


@pytest.mark.parametrize("B,KV,R,S,D", [(2, 2, 9, 20, 48), (1, 2, 20, 33, 40), (2, 1, 3, 17, 200)])
def test_decode_attention_any_head_width_and_r(B, KV, R, S, D):
    rng = np.random.default_rng(R * D)
    q = rng.standard_normal((B, KV, R, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, KV, S, D)).astype(np.float32) for _ in range(2))
    mask = np.where(rng.random((B, S)) < 0.3, -np.inf, 0.0).astype(np.float32)
    mask[:, 0] = 0.0
    want = jdk.decode_gqa_attention(*J_(q, k, v, mask), block_b=8, interpret=True)
    got = tk.decode_gqa_attention(*T_(q, k, v, mask))
    assert _err(got, want) <= TOL


@pytest.mark.parametrize("B,N,D,k,n_valid", [(4, 300, 12, 129, 120)])
def test_bank_topk_any_width_and_k(B, N, D, k, n_valid):
    """Small-integer operands without normalization: exact integer scores,
    ties by index, every index equal to the JAX kernel's."""
    rng = np.random.default_rng(N + k)
    q = rng.integers(-3, 4, (B, D)).astype(np.float32)
    bank = rng.integers(-3, 4, (N, D)).astype(np.float32)
    jv, ji = jtk.bank_topk(*J_(q, bank), k, n_valid=None if n_valid is None else jnp.asarray(n_valid),
                           normalize=False, interpret=True)
    tv, ti = tk.bank_topk(*T_(q, bank), k, n_valid=n_valid, normalize=False)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_bank_topk_any_width_normalized():
    rng = np.random.default_rng(7)
    q, bank = rng.standard_normal((3, 12)).astype(np.float32), rng.standard_normal((400, 12)).astype(np.float32)
    jv, ji = jtk.bank_topk(*J_(q, bank), 129, interpret=True)
    tv, ti = tk.bank_topk(*T_(q, bank), 129)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=TOL, rtol=0)


@pytest.mark.parametrize("M,K,N", [(6, 40, 24), (5, 100, 30)])
def test_int8_gemms_any_width(M, K, N):
    rng = np.random.default_rng(K + N)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w_q, s = (np.asarray(a) for a in jqk.quantize_linear(jnp.asarray(rng.standard_normal((K, N)).astype(np.float32))))
    want = jwk.w8a8_matmul(*J_(x, w_q, s), interpret=True)
    # one rounding of the same f32 dequant (as test_torch_qwen_kernels.py)
    assert _err(tk.w8a8_matmul(*T_(x, w_q, s)), want) <= 1e-6
    want = jwk.w8_matmul(*J_(x, w_q, s), interpret=True)
    assert _err(tk.w8_matmul(*T_(x, w_q, s)), want) <= TOL


def test_padded_copies_and_counts_only_when_the_shape_grows():
    class Owner:
        copies = 0

    t = torch.arange(6.0).reshape(2, 3)
    assert padded(t, (2, 3), Owner) is t and Owner.copies == 0
    p = padded(t, (4, 8), Owner)
    assert Owner.copies == 1 and p.shape == (4, 8) and p.dtype == t.dtype
    assert torch.equal(p[:2, :3], t) and p.sum() == t.sum()
    assert [round_up(n, 8) for n in (1, 8, 9, 36)] == [8, 8, 16, 40]


# -- on the card -------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mha", "attention", "mlp", "attention_i8", "mlp_i8", "decode", "topk", "w8a8"])
def test_the_card_takes_the_shapes(dev, case):
    """The kernel at each repaired shape against its plain version on the
    card: f32 2e-5, int8 layers 3e-2 (a quantum flipped by a sum in another
    order), W8A8 and top-k indices exactly."""
    rng = np.random.default_rng(0)
    c = lambda *a: [torch.as_tensor(x).to(dev) for x in a]
    if case == "mha":
        q, k, v = c(*(rng.standard_normal((2, 7, 3, 48)).astype(np.float32) for _ in range(3)))
        assert _err(tk.fused_mha(q, k, v).cpu(), tk.mha_reference(q, k, v).cpu()) <= TOL
    elif case in ("attention", "mlp", "attention_i8", "mlp_i8"):
        p = _layer(rng, 36, 60)
        x = c(rng.standard_normal((2, 5, 36)).astype(np.float32))[0]
        kernel, plain, w, kw = {
            "attention": (tk.fused_attention_layer, tk.attention_layer_reference, p["attn"], dict(heads=3)),
            "mlp": (tk.fused_mlp_layer, tk.mlp_layer_reference, p["mlp"], {}),
            "attention_i8": (tk.fused_attention_layer_i8, tk.attention_layer_i8_reference, p["attn"],
                             dict(heads=3)),
            "mlp_i8": (tk.fused_mlp_layer_i8, tk.mlp_layer_i8_reference, p["mlp"], {}),
        }[case]
        w = c(*w)
        if case.endswith("_i8"):
            w = (*tk.quantize_linear(w[0]), w[1], *tk.quantize_linear(w[2]), w[3])
        args = (x, *c(*p["ln"]), *w)
        tol = 3e-2 if case.endswith("_i8") else TOL
        assert _err(kernel(*args, **kw).cpu(), plain(*args, **kw).cpu()) <= tol
    elif case == "decode":
        for D in (48, 200):
            q = c(rng.standard_normal((2, 2, 9, D)).astype(np.float32))[0]
            k, v = c(*(rng.standard_normal((2, 2, 20, D)).astype(np.float32) for _ in range(2)))
            mask = torch.zeros((2, 20), device=dev)
            got, want = tk.decode_gqa_attention(q, k, v, mask), tk.decode_gqa_reference(q, k, v, mask)
            assert _err(got.cpu(), want.cpu()) <= TOL
    elif case == "topk":
        q, bank = c(rng.integers(-3, 4, (3, 12)).astype(np.float32), rng.integers(-3, 4, (500, 12)).astype(np.float32))
        (gv, gi), (wv, wi) = tk.bank_topk(q, bank, 130, normalize=False), tk.bank_topk_reference(q, bank, 130,
                                                                                                   normalize=False)
        assert torch.equal(gi, wi) and torch.equal(gv, wv)
    else:
        x = c(rng.standard_normal((6, 40)).astype(np.float32))[0]
        w_q, s = tk.quantize_linear(c(rng.standard_normal((40, 24)).astype(np.float32))[0])
        assert torch.equal(tk.w8a8_matmul(x, w_q, s), tk.w8a8_matmul_reference(x, w_q, s))
