"""The routed experts of a mixture-of-experts layer as one grouped
weight-only int8 GEMM.

    moe_w8_grouped_gemm(x_sorted [M, K], w_q int8 [E, K, N], scale f32 [E, N],
                        offsets int32 [E + 1]) -> [M, N], x's dtype

multiplies expert e's rows ``offsets[e] .. offsets[e + 1]`` of the rows
sorted by expert with that expert's weights: on each expert's rows the
function of ``w8_matmul`` (the int8 weights converted exactly, the
products summed in f32, scaled per output channel in f32, rounded once to
x's dtype). For CUDA tensors (bf16 x, K a multiple of 64, N of 16) the
wrapper launches ``tvc_torch/csrc/moe_w8.cu`` once: the grid is sized
from M, which the host knows, and each block reads the offsets from device
memory, so nothing of the routing comes back to the host. For CPU tensors
it computes :func:`moe_w8_grouped_reference`, a loop over the experts.

``moe_w8_grouped_gemm.launches`` counts the calls that launched the kernel.
Inference only.
"""

from __future__ import annotations

import torch
from torch import Tensor

from tvc_torch.core.kernels import _build


def moe_w8_grouped_reference(x_sorted: Tensor, w_q: Tensor, scale: Tensor, offsets: Tensor) -> Tensor:
    """Plain PyTorch version of :func:`moe_w8_grouped_gemm`: a loop over the
    experts, each of its rows through ``w8_matmul``'s plain version; rows
    past ``offsets[E]`` are zeros."""
    E = w_q.shape[0]
    out = torch.zeros((x_sorted.shape[0], w_q.shape[2]), dtype=x_sorted.dtype, device=x_sorted.device)
    bounds = offsets.tolist()
    for e in range(E):
        lo, hi = bounds[e], bounds[e + 1]
        if hi > lo:
            out[lo:hi] = (torch.matmul(x_sorted[lo:hi].float(), w_q[e].float()) * scale[e].float()).to(x_sorted.dtype)
    return out


def _check_grouped(x: Tensor, w_q: Tensor, scale: Tensor, offsets: Tensor) -> None:
    if x.ndim != 2 or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"x_sorted must be a contiguous bf16 [M, K] tensor on the card, got {x.dtype} {tuple(x.shape)}")
    M, K = x.shape
    if w_q.dtype != torch.int8 or w_q.ndim != 3 or w_q.shape[1] != K or not w_q.is_contiguous() \
            or w_q.device != x.device:
        raise ValueError(f"w_q must be a contiguous int8 [E, {K}, N] tensor on {x.device}, got "
                         f"{w_q.dtype} {tuple(w_q.shape)}")
    E, _, N = w_q.shape
    if scale.dtype != torch.float32 or tuple(scale.shape) != (E, N) or not scale.is_contiguous() \
            or scale.device != x.device:
        raise ValueError(f"scale must be a contiguous float32 [{E}, {N}] tensor on {x.device}")
    if offsets.dtype != torch.int32 or tuple(offsets.shape) != (E + 1,) or not offsets.is_contiguous() \
            or offsets.device != x.device:
        raise ValueError(f"offsets must be a contiguous int32 [{E + 1}] tensor on {x.device}")
    if K % 64 or N % 16:
        raise ValueError(f"the grouped kernel takes K a multiple of 64 and N of 16, got K={K}, N={N}")


def moe_w8_grouped_gemm(x_sorted: Tensor, w_q: Tensor, scale: Tensor, offsets: Tensor) -> Tensor:
    """Rows of ``x_sorted`` [M, K], sorted by expert, times their expert's
    int8 weights ``w_q`` [E, K, N] scaled by ``scale`` [E, N]; expert e's
    rows are ``offsets[e] .. offsets[e + 1]`` (int32, on x's device, with
    ``offsets[E] == M``). Returns [M, N] in x's dtype."""
    if x_sorted.device.type == "cpu":
        return moe_w8_grouped_reference(x_sorted, w_q, scale, offsets)
    if x_sorted.device.type != "cuda":
        raise ValueError(f"unsupported device {x_sorted.device}")
    _check_grouped(x_sorted, w_q, scale, offsets)
    M, K = x_sorted.shape
    E, _, N = w_q.shape
    out = torch.empty((M, N), dtype=x_sorted.dtype, device=x_sorted.device)
    _build.check(
        _build.load("moe_w8").tvc_moe_w8_grouped(
            x_sorted.data_ptr(), w_q.data_ptr(), scale.data_ptr(), offsets.data_ptr(), out.data_ptr(),
            M, E, N, K, torch.cuda.current_stream(x_sorted.device).cuda_stream,
        ),
        "tvc_moe_w8_grouped",
    )
    moe_w8_grouped_gemm.launches += 1
    return out


moe_w8_grouped_gemm.launches = 0
