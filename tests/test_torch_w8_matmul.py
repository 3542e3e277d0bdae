"""tvc_torch's weight-only int8 GEMM (``w8_matmul`` / ``w8_matmul_stacked``:
the plain version, as the wrappers compute it on the CPU) against the JAX
package's Pallas kernels in interpret mode, and the ported dequantize-then-
matmul oracle ``w8_matmul_reference`` against the JAX one, on the same
seeded numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvc.core.pallas.quantized_layer_kernel import quantize_linear as j_quantize
from tvc.core.pallas.w8_matmul_kernel import (
    w8_matmul as j_w8,
    w8_matmul_reference as j_w8_reference,
    w8_matmul_stacked as j_w8_stacked,
)
from tvc_torch.core.kernels import KERNELS, launch_counts, reset_launch_counts
from tvc_torch.core.kernels.w8_matmul_kernel import (
    w8_matmul,
    w8_matmul_plain,
    w8_matmul_reference,
    w8_matmul_stacked,
    w8_plan,
)


def _operands(M, K, N, L=None, seed=0):
    rng = np.random.default_rng(seed + M + K + N)
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[1] = 0.0  # an all-zero row
    ws = [j_quantize(jnp.asarray((rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)))
          for _ in range(L or 1)]
    w_q = np.stack([np.asarray(w) for w, _ in ws])
    scale = np.stack([np.asarray(s) for _, s in ws])
    return (x, w_q, scale) if L else (x, w_q[0], scale[0])


def _ulps_bf16(got: np.ndarray, want: np.ndarray) -> int:
    """The largest distance in bf16 steps (bf16 bit patterns as integers)."""
    g = torch.as_tensor(np.array(got)).to(torch.bfloat16).view(torch.int16).int()
    w = torch.as_tensor(np.array(want)).to(torch.bfloat16).view(torch.int16).int()
    return int((g - w).abs().max())


def _scaled(got, want):
    return float(np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want))))


# f32: the same exact products summed in f32 in another order, 2e-5 of
# max(1, |y|); bf16: one rounding of f32 sums that differ only in order,
# so at most one bf16 step apart.
@pytest.mark.parametrize("port_fn", [w8_matmul, w8_matmul_plain], ids=["wrapper", "plain"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", [(8, 128, 128), (15, 64, 128)])
def test_w8_matmul_matches_pallas(port_fn, dtype, M, K, N):
    x, w_q, scale = _operands(M, K, N)
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(j_w8(jx, jnp.asarray(w_q), jnp.asarray(scale), interpret=True).astype(jnp.float32))
    tx = torch.as_tensor(x).to(getattr(torch, dtype))
    got = port_fn(tx, torch.as_tensor(w_q), torch.as_tensor(scale))
    assert got.dtype == tx.dtype and got.shape == (M, N)
    got = got.float().numpy()
    if dtype == "float32":
        assert _scaled(got, want) <= 2e-5
    else:
        assert _ulps_bf16(got, want) <= 1
    assert not got[1].any()


@pytest.mark.parametrize("layer", [0, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w8_matmul_stacked_matches_pallas(layer, dtype):
    x, w_q, scale = _operands(16, 256, 384, L=3)
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(j_w8_stacked(jx, jnp.asarray(w_q), jnp.asarray(scale), layer, interpret=True)
                      .astype(jnp.float32))
    tx = torch.as_tensor(x).to(getattr(torch, dtype))
    got = w8_matmul_stacked(tx, torch.as_tensor(w_q), torch.as_tensor(scale), layer)
    assert got.dtype == tx.dtype and got.shape == (16, 384)
    if dtype == "float32":
        assert _scaled(got.numpy(), want) <= 2e-5
    else:
        assert _ulps_bf16(got.float().numpy(), want) <= 1
    flat = w8_matmul(tx, torch.as_tensor(w_q[layer]), torch.as_tensor(scale[layer]))
    assert torch.equal(got, flat)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w8_matmul_reference_matches_the_jax_oracle(dtype):
    """The dequantize-then-matmul oracle rounds each weight to x's dtype
    first: another function than the kernel's, which the bf16 case shows."""
    x, w_q, scale = _operands(15, 64, 128, seed=1)
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(j_w8_reference(jx, jnp.asarray(w_q), jnp.asarray(scale)).astype(jnp.float32))
    tx = torch.as_tensor(x).to(getattr(torch, dtype))
    got = w8_matmul_reference(tx, torch.as_tensor(w_q), torch.as_tensor(scale))
    assert got.dtype == tx.dtype and got.shape == (15, 128)
    if dtype == "float32":
        assert _scaled(got.numpy(), want) <= 2e-5
    else:
        assert _ulps_bf16(got.float().numpy(), want) <= 1
        kernel_fn = w8_matmul_plain(tx, torch.as_tensor(w_q), torch.as_tensor(scale))
        assert not torch.equal(kernel_fn, got)
    # leading batch dims, as the decode's dequant fallback passes [B, T, K]
    batched = w8_matmul_reference(tx.reshape(3, 5, 64), torch.as_tensor(w_q), torch.as_tensor(scale))
    assert torch.equal(batched.reshape(15, 128), got)


def test_w8_wrappers_refuse_off_cpu_and_bad_stacks():
    """A non-CPU tensor goes to the kernel path, which checks its operands
    and raises; there is no fallback to the plain version."""
    x, w_q, scale = (torch.as_tensor(a) for a in _operands(16, 256, 384, L=3))
    with pytest.raises(ValueError):
        w8_matmul_stacked(x, w_q, scale, 3)
    with pytest.raises(ValueError):
        w8_matmul_stacked(x, w_q[0], scale[0], 0)
    meta = lambda t: t.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):  # f32 activations: the f32 kernel's checks
        w8_matmul(meta(x), meta(w_q[0]), meta(scale[0]))
    with pytest.raises(ValueError, match="unsupported device"):
        w8_matmul(meta(x).bfloat16(), meta(w_q[0]), meta(scale[0]))


def test_w8_wrappers_count_only_kernel_launches():
    """On the CPU the wrappers compute the plain version and count nothing;
    both wrappers are in the launch table."""
    names = [k.__name__ for k in KERNELS]
    assert "w8_matmul" in names and "w8_matmul_stacked" in names
    x, w_q, scale = (torch.as_tensor(a) for a in _operands(8, 128, 128, L=2))
    reset_launch_counts()
    w8_matmul(x, w_q[0], scale[0])
    w8_matmul_stacked(x, w_q, scale, 1)
    assert launch_counts()["w8_matmul"] == 0 and launch_counts()["w8_matmul_stacked"] == 0


# Every weight-only GEMM shape of QwenConfig.qwen2_1_5b() and QwenConfig.tiny()
# (hidden, intermediate, q|k|v width): q|k|v, o, gate|up, down.
_W8_SHAPES = [(1536, 2048), (1536, 1536), (1536, 17920), (8960, 1536),
              (64, 128), (64, 64), (64, 256), (128, 64)]


@pytest.mark.parametrize("M", [1, 15, 64, 960, 1024])
@pytest.mark.parametrize("K,N", _W8_SHAPES)
def test_w8_plan_covers_every_output_once(M, K, N):
    """The bf16 kernel's plan: a tile the kernel has, output tiles that
    cover [M, N] exactly once, and K ranges of whole 64-deep k-tiles that
    cover [0, K) once, each non-empty (the last may end in K's masked
    tail); a pure function of the shape."""
    bm, bn, splits, per = w8_plan(M, N, K)
    assert (bm, bn) in ((256, 192), (256, 128), (64, 64))
    assert w8_plan(M, N, K) == (bm, bn, splits, per)
    rows = np.zeros(M, int)
    cols = np.zeros(N, int)
    for y in range(-(-M // bm)):
        rows[y * bm : (y + 1) * bm] += 1
    for x in range(-(-N // bn)):
        cols[x * bn : (x + 1) * bn] += 1
    assert (rows == 1).all() and (cols == 1).all()
    depth = np.zeros(K, int)
    for z in range(splits):
        lo, hi = z * per * 64, min(K, (z + 1) * per * 64)
        assert lo < hi
        depth[lo:hi] += 1
    assert (depth == 1).all()
    blocks = -(-M // bm) * -(-N // bn) * splits
    if M <= 64:  # the prefix prefill: two blocks an SM stream the weights, or K is split to single tiles
        assert blocks >= 264 or per == 1
