"""tvc_torch int8 (W8A8) layer functions against the JAX Pallas int8 layer
kernels (interpret mode), at B=6, T=10, W=64, H=2, f32 compute dtype; the
weight and row quantizers bit-identical to the JAX package's.

On the CPU the port's wrappers compute their plain versions, so this holds
the plain math (quantization points, rounding, dequant order) to the TPU
kernel's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvc.core.pallas.quantized_layer_kernel import (
    _quant_rows as j_quant_rows,
    fused_attention_layer_i8 as j_attn,
    fused_mlp_layer_i8 as j_mlp,
    quantize_linear as j_quantize,
)
from tvc_torch.core.kernels.quantized_layer_kernel import (
    _quant_rows,
    attention_layer_i8_reference,
    fused_attention_layer_i8 as t_attn,
    fused_mlp_layer_i8 as t_mlp,
    mlp_layer_i8_reference,
    quantize_linear,
)

B, T, W, H = 6, 10, 64, 2


def _with_ties(rng, rows, cols):
    """Random f32 values plus a column / row at exact .5 quanta (scale 1:
    the absmax is 127) and an all-zero column / row (the 1e-12 clamp)."""
    a = (0.05 * rng.standard_normal((rows, cols))).astype(np.float32)
    ties = np.asarray([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 3.5], np.float32)
    a[: len(ties), 0] = ties
    a[0, : len(ties)] = ties
    a[:, 1] = 0.0
    a[1, :] = 0.0
    return a


@pytest.mark.parametrize("shape", [(64, 192), (256, 64), (10, 10)])
def test_quantize_linear_bit_identical(shape):
    w = _with_ties(np.random.default_rng(shape[0]), *shape)
    jq, js = j_quantize(jnp.asarray(w))
    tq, ts = quantize_linear(torch.as_tensor(w))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # half to even at the exact .5 quanta of column 0: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2
    np.testing.assert_array_equal(tq.numpy()[:10, 0], [127, 0, 2, 2, 0, -2, -2, 126, -126, 4])
    assert not tq.numpy()[:, 1].any()


@pytest.mark.parametrize("shape", [(60, 64), (12, 256)])
def test_quant_rows_bit_identical(shape):
    h = _with_ties(np.random.default_rng(shape[1]), *shape)
    jq, js = j_quant_rows(jnp.asarray(h))
    tq, ts = _quant_rows(torch.as_tensor(h))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tq.numpy()[0, :10], [127, 0, 2, 2, 0, -2, -2, 126, -126, 4])
    assert not tq.numpy()[1].any()


@pytest.fixture(scope="module")
def layer():
    rng = np.random.default_rng(3)
    f = lambda *shape, scale=1.0: (scale * rng.standard_normal(shape)).astype(np.float32)
    p = dict(
        x=f(B, T, W),
        ln_s=1.0 + f(W, scale=0.1), ln_b=f(W, scale=0.1),
        bqkv=f(3 * W, scale=0.02), bout=f(W, scale=0.02),
        bfc=f(4 * W, scale=0.02), bproj=f(W, scale=0.02),
    )
    for name, shape in (("wqkv", (W, 3 * W)), ("wout", (W, W)), ("wfc", (W, 4 * W)), ("wproj", (4 * W, W))):
        wq, s = j_quantize(jnp.asarray(f(*shape, scale=0.05)))
        p[name + "_q"], p["s" + name[1:]] = np.array(wq), np.array(s)
    return p


ATTN = ("x", "ln_s", "ln_b", "wqkv_q", "sqkv", "bqkv", "wout_q", "sout", "bout")
MLP = ("x", "ln_s", "ln_b", "wfc_q", "sfc", "bfc", "wproj_q", "sproj", "bproj")


def _args(p, names, lib):
    conv = jnp.asarray if lib == "jax" else torch.as_tensor
    return [conv(p[n]) for n in names]


def _scaled_err(got, want):
    return float(np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want))))


# Tolerance: 1e-4 of max(1, |y|). Kernel and port quantize the same f32
# values where both compute them identically; a LayerNorm statistic or a
# softmax sum taken in another order can move one activation across a .5
# quantum and flip its int8 value by one, which moves an output by about
# row_scale * col_scale * |w_q| (~1e-3 of the row's absmax). No such flip
# occurs on these inputs: the observed difference is 1.2e-7 to 2.4e-7.
TOL = 1e-4


@pytest.mark.parametrize("port_fn", [t_attn, attention_layer_i8_reference], ids=["wrapper", "plain"])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_layer_i8_matches_pallas_f32(layer, port_fn, causal):
    want = np.asarray(j_attn(*_args(layer, ATTN, "jax"), heads=H, causal=causal, block_b=4, interpret=True))
    got = port_fn(*_args(layer, ATTN, "torch"), heads=H, causal=causal)
    assert got.dtype == torch.float32 and got.shape == (B, T, W)
    assert _scaled_err(got.numpy(), want) <= TOL


@pytest.mark.parametrize("port_fn", [t_mlp, mlp_layer_i8_reference], ids=["wrapper", "plain"])
def test_mlp_layer_i8_matches_pallas_f32(layer, port_fn):
    want = np.asarray(j_mlp(*_args(layer, MLP, "jax"), block_b=4, interpret=True))
    got = port_fn(*_args(layer, MLP, "torch"))
    assert _scaled_err(got.numpy(), want) <= TOL


def test_int8_layers_track_the_bf16_layers(layer):
    """The int8 layer stays close to the float layer on the dequantized
    weights (the same check the JAX package makes of its int8 kernels)."""
    from tvc_torch.core.kernels.attention_layer_kernel import attention_layer_reference

    a = _args(layer, ATTN, "torch")
    deq = lambda q, s: q.float() * s
    want = attention_layer_reference(a[0], a[1], a[2], deq(a[3], a[4]), a[5], deq(a[6], a[7]), a[8], heads=H)
    got = attention_layer_i8_reference(*a, heads=H)
    cos = torch.nn.functional.cosine_similarity(got.reshape(-1), want.reshape(-1), dim=0)
    assert float(cos) > 0.999


def test_wrappers_raise_off_cpu_without_kernel_operands(layer):
    """A non-CPU tensor goes to the kernel path, which checks its operands
    and raises; there is no fallback to the plain version."""
    args = [a.to("meta") for a in _args(layer, ATTN, "torch")]
    with pytest.raises(ValueError):
        t_attn(*args, heads=H)
    args = [a.to("meta") for a in _args(layer, MLP, "torch")]
    with pytest.raises(ValueError):
        t_mlp(*args)
