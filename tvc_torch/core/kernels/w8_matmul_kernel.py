"""The int8 GEMMs of the Qwen2 decode (port of
``tvc/core/pallas/w8_matmul_kernel.py``): the W8A8 ``w8a8_matmul`` /
``w8a8_matmul_stacked`` and the weight-only ``w8_matmul`` /
``w8_matmul_stacked``.

    w8a8_matmul(x [M, K], w_q int8 [K, N], scale f32 [N]) -> [M, N], x's dtype
        = ((q(x) . w_q) . rs) . scale

where ``q(x), rs`` is the dynamic symmetric per-row int8 quantization of
``x`` taken in f32 (``rs = max(max|x|, 1e-12) / 127``, round half to even,
clip to +-127), the int8 product is summed exactly and the dequantization
runs in f32 in that order. Weights come per output channel from
``tvc_torch.models.qwen._quantize_leaf``.

For CUDA tensors the wrapper launches the hand-written kernels of
``tvc_torch/csrc/quantized_layer.cu``: the row-quantize kernel (f32 or bf16
rows) and the int8 tensor-core GEMM with its dequantize-only epilogue, two
launches a call. For CPU tensors it computes the plain version beside it,
which sums the int8 products in float64 (exact for every int32 sum here).

    w8_matmul(x [M, K], w_q int8 [K, N], scale f32 [N]) -> [M, N], x's dtype
        = ((x . w_q) summed in f32) * scale

is the weight-only GEMM (the JAX package's default ``quant_gemm="w8"``):
the activations stay in the model dtype, the int8 weights convert exactly
to it, the products are summed in f32 and scaled per output channel in
f32, then rounded once to x's dtype. For CUDA tensors the wrapper launches
the kernel of ``tvc_torch/csrc/w8_matmul.cu`` (bf16 activations only: the
card's path; f32 activations raise); for CPU tensors it computes the plain
version :func:`w8_matmul_plain`. :func:`w8_matmul_reference` is another
function: the JAX package's dequantize-then-matmul oracle, which rounds
every dequantized weight to x's dtype first; the decode takes it for
activation blocks above the kernels' row limit, as the JAX package does.

``*_stacked(x, w_q [L, K, N], scale [L, N], layer)`` is the same function
on layer ``layer`` of the stacked weights: the TPU kernels select the layer
by scalar prefetch so that ``lax.scan`` copies no slab, and here
``w_q[layer]`` of the contiguous stack is already a zero-copy view, so each
stacked wrapper calls its flat wrapper on it. ``<flat>.launches`` therefore
counts every launch of the kernel, ``<stacked>.launches`` the stacked calls
among them.
"""

from __future__ import annotations

import torch
from torch import Tensor

from tvc_torch.core.kernels import _build
from tvc_torch.core.kernels.quantized_layer_kernel import (
    _check_widths,
    _i8_gemm,
    _mm_i32,
    _quant_rows,
    _quant_rows_cuda,
)

QEPI_DEQUANT_BF16, QEPI_DEQUANT_F32 = 3, 4


def w8a8_matmul_reference(x: Tensor, w_q: Tensor, scale: Tensor) -> Tensor:
    """Plain PyTorch version of :func:`w8a8_matmul`."""
    xq, rs = _quant_rows(x.float())
    return (_mm_i32(xq, w_q) * rs * scale.float()).to(x.dtype)


def _check_operands(x: Tensor, w_q: Tensor, scale: Tensor, dtypes=(torch.bfloat16, torch.float32)) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.ndim != 2 or x.dtype not in dtypes or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous {' or '.join(map(str, dtypes))} [M, K] tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    M, K = x.shape
    N = w_q.shape[-1] if w_q.ndim == 2 else -1
    if w_q.dtype != torch.int8 or w_q.ndim != 2 or w_q.shape[0] != K or not w_q.is_contiguous() \
            or w_q.device != x.device:
        raise ValueError(f"w_q must be a contiguous int8 [{K}, N] tensor on {x.device}, got "
                         f"{w_q.dtype} {tuple(w_q.shape)}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (N,) or not scale.is_contiguous() \
            or scale.device != x.device:
        raise ValueError(f"scale must be a contiguous float32 [{N}] tensor on {x.device}")
    _check_widths(K=K, N=N)


def w8a8_matmul(x: Tensor, w_q: Tensor, scale: Tensor) -> Tensor:
    """x [M, K] (bf16 or f32) @ (w_q int8 [K, N] * scale f32 [N]) with x
    quantized per row to int8; returns [M, N] in x's dtype."""
    if x.device.type == "cpu":
        return w8a8_matmul_reference(x, w_q, scale)
    _check_operands(x, w_q, scale)
    M, K = x.shape
    N = w_q.shape[1]
    lib = _build.load("quantized_layer")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if x.dtype == torch.bfloat16:
        xq = torch.empty((M, K), dtype=torch.int8, device=x.device)
        rs = torch.empty((M,), dtype=torch.float32, device=x.device)
        _build.check(
            lib.tvc_quant_rows_bf16(x.data_ptr(), xq.data_ptr(), rs.data_ptr(), M, K, stream),
            "tvc_quant_rows_bf16",
        )
        epilogue = QEPI_DEQUANT_BF16
    else:
        xq, rs = _quant_rows_cuda(lib, x, None, None, 0.0, stream)
        epilogue = QEPI_DEQUANT_F32
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    _i8_gemm(lib, xq, rs, w_q, scale, None, None, out, epilogue, stream)
    w8a8_matmul.launches += 1
    return out


w8a8_matmul.launches = 0


def _check_stacked(w_q: Tensor, scale: Tensor, layer: int) -> None:
    if w_q.ndim != 3 or scale.ndim != 2 or scale.shape != (w_q.shape[0], w_q.shape[2]):
        raise ValueError(f"stacked weights must be w_q [L, K, N] and scale [L, N], got "
                         f"{tuple(w_q.shape)} and {tuple(scale.shape)}")
    if not 0 <= layer < w_q.shape[0]:
        raise ValueError(f"layer {layer} out of range for {w_q.shape[0]} stacked layers")


def w8a8_matmul_stacked(x: Tensor, w_q: Tensor, scale: Tensor, layer: int) -> Tensor:
    """x [M, K] @ (w_q [L, K, N])[layer] * (scale [L, N])[layer]."""
    layer = int(layer)
    _check_stacked(w_q, scale, layer)
    if x.device.type == "cpu":
        return w8a8_matmul_reference(x, w_q[layer], scale[layer])
    out = w8a8_matmul(x, w_q[layer], scale[layer])
    w8a8_matmul_stacked.launches += 1
    return out


w8a8_matmul_stacked.launches = 0


# -- weight-only ------------------------------------------------------------------


def w8_matmul_plain(x: Tensor, w_q: Tensor, scale: Tensor) -> Tensor:
    """Plain PyTorch version of :func:`w8_matmul`: the int8 weights
    converted exactly, the products summed in f32, scaled in f32, rounded
    once to x's dtype."""
    return (torch.matmul(x.float(), w_q.float()) * scale.float()).to(x.dtype)


def w8_matmul_reference(x: Tensor, w_q: Tensor, scale: Tensor) -> Tensor:
    """The JAX package's ``w8_matmul_reference``: dequantize in x's dtype
    (``w_q * scale``, each weight rounded to that dtype), then one matmul
    summed in f32 and rounded to x's dtype. x may carry leading batch dims."""
    w = w_q.to(x.dtype) * scale.to(x.dtype)
    return torch.matmul(x, w)


def w8_matmul(x: Tensor, w_q: Tensor, scale: Tensor) -> Tensor:
    """x [M, K] @ (w_q int8 [K, N] * scale f32 [N]) with bf16 activations
    (f32 too on the CPU); returns [M, N] in x's dtype."""
    if x.device.type == "cpu":
        return w8_matmul_plain(x, w_q, scale)
    if x.dtype == torch.float32:
        raise ValueError("w8_matmul: the CUDA kernel takes bf16 activations; f32 activations are not ported")
    _check_operands(x, w_q, scale, dtypes=(torch.bfloat16,))
    if x.data_ptr() % 16 or w_q.data_ptr() % 16:
        raise ValueError("w8_matmul: x and w_q must start on 16-byte boundaries (16-byte loads)")
    M, K = x.shape
    N = w_q.shape[1]
    lib = _build.load("w8_matmul")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(
        lib.tvc_w8_matmul(x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(), M, N, K, stream),
        "tvc_w8_matmul",
    )
    w8_matmul.launches += 1
    return out


w8_matmul.launches = 0


def w8_matmul_stacked(x: Tensor, w_q: Tensor, scale: Tensor, layer: int) -> Tensor:
    """x [M, K] @ (w_q [L, K, N])[layer] * (scale [L, N])[layer], weight-only."""
    layer = int(layer)
    _check_stacked(w_q, scale, layer)
    if x.device.type == "cpu":
        return w8_matmul_plain(x, w_q[layer], scale[layer])
    out = w8_matmul(x, w_q[layer], scale[layer])
    w8_matmul_stacked.launches += 1
    return out


w8_matmul_stacked.launches = 0
