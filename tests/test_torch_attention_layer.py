"""tvc_torch attention / MLP layer functions against the JAX Pallas layer
kernels (interpret mode), at B=6, T=10, W=64, H=2.

On the CPU the port's wrappers compute their plain versions, so this holds
the plain math (and the bf16 rounding points) to the TPU kernel's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvc.core.pallas.attention_layer_kernel import (
    fused_attention_layer as j_attn,
    fused_mlp_layer as j_mlp,
)
from tvc_torch.core.kernels.attention_layer_kernel import (
    attention_layer_reference,
    fused_attention_layer as t_attn,
    fused_mlp_layer as t_mlp,
    mlp_layer_reference,
)

B, T, W, H = 6, 10, 64, 2


@pytest.fixture(scope="module")
def layer():
    rng = np.random.default_rng(1)
    f = lambda *shape, scale=1.0: (scale * rng.standard_normal(shape)).astype(np.float32)
    return dict(
        x=f(B, T, W),
        ln_s=f(W), ln_b=f(W),
        wqkv=f(W, 3 * W, scale=0.05), bqkv=f(3 * W),
        wout=f(W, W, scale=0.05), bout=f(W),
        wfc=f(W, 4 * W, scale=0.05), bfc=f(4 * W),
        wproj=f(4 * W, W, scale=0.05), bproj=f(W),
    )


def _args(p, names, dtype, lib):
    """x and weights in the compute dtype, biases / norms f32."""
    out = []
    for n in names:
        a = p[n]
        cast = dtype if n == "x" or n.startswith("w") else "float32"
        if lib == "jax":
            out.append(jnp.asarray(a).astype(getattr(jnp, cast)))
        else:
            out.append(torch.as_tensor(a).to(getattr(torch, cast)))
    return out


ATTN = ("x", "ln_s", "ln_b", "wqkv", "bqkv", "wout", "bout")
MLP = ("x", "ln_s", "ln_b", "wfc", "bfc", "wproj", "bproj")


@pytest.mark.parametrize("port_fn", [t_attn, attention_layer_reference], ids=["wrapper", "plain"])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_layer_matches_pallas_f32(layer, port_fn, causal):
    want = np.asarray(j_attn(*_args(layer, ATTN, "float32", "jax"), heads=H, causal=causal, block_b=4))
    got = port_fn(*_args(layer, ATTN, "float32", "torch"), heads=H, causal=causal).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("port_fn", [t_mlp, mlp_layer_reference], ids=["wrapper", "plain"])
def test_mlp_layer_matches_pallas_f32(layer, port_fn):
    want = np.asarray(j_mlp(*_args(layer, MLP, "float32", "jax"), block_b=4))
    got = port_fn(*_args(layer, MLP, "float32", "torch")).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def _bf16_err(got, want):
    return np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want)))


@pytest.mark.parametrize("causal", [False, True])
def test_attention_layer_bf16_rounding_points(layer, causal):
    """bf16 activations and weights: the port rounds to bf16 where the TPU
    kernel does (LN output, qkv, softmax weights, attention output, layer
    output). Both sides round the same f32 values; sums in another order
    can move a value across one bf16 rounding boundary (2^-7 relative),
    so the bound is two bf16 ulps of max(1, |y|)."""
    want = np.asarray(
        j_attn(*_args(layer, ATTN, "bfloat16", "jax"), heads=H, causal=causal, block_b=4)
    ).astype(np.float32)
    got = t_attn(*_args(layer, ATTN, "bfloat16", "torch"), heads=H, causal=causal)
    assert got.dtype == torch.bfloat16
    assert _bf16_err(got.float().numpy(), want) <= 2 ** -6


def test_mlp_layer_bf16_rounding_points(layer):
    want = np.asarray(j_mlp(*_args(layer, MLP, "bfloat16", "jax"), block_b=4)).astype(np.float32)
    got = t_mlp(*_args(layer, MLP, "bfloat16", "torch"))
    assert got.dtype == torch.bfloat16
    assert _bf16_err(got.float().numpy(), want) <= 2 ** -6


def test_wrappers_raise_off_cpu_without_kernel_operands(layer):
    """A non-CPU tensor goes to the kernel path, which checks its operands
    and raises; there is no fallback to the plain version."""
    args = [a.to("meta") for a in _args(layer, ATTN, "float32", "torch")]
    with pytest.raises(ValueError):
        t_attn(*args, heads=H)
    args = [a.to("meta") for a in _args(layer, MLP, "float32", "torch")]
    with pytest.raises(ValueError):
        t_mlp(*args)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_layer_matches_pallas_past_t_257(causal):
    """T = 300, past the old CUDA kernel's cap (the tensor-core attention
    has none, like the JAX function): the plain version against the Pallas
    layer kernel, f32 to 2e-5."""
    rng = np.random.default_rng(300)
    f = lambda *shape, scale=1.0: (scale * rng.standard_normal(shape)).astype(np.float32)
    p = dict(x=f(1, 300, 64), ln_s=f(64), ln_b=f(64), wqkv=f(64, 192, scale=0.05), bqkv=f(192),
             wout=f(64, 64, scale=0.05), bout=f(64))
    want = np.asarray(j_attn(*_args(p, ATTN, "float32", "jax"), heads=1, causal=causal, block_b=1))
    got = attention_layer_reference(*_args(p, ATTN, "float32", "torch"), heads=1, causal=causal).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
