"""The routed experts of a mixture-of-experts layer as one grouped
weight-only int8 GEMM.

    moe_w8_grouped_gemm(x_sorted [M, K], w_q int8 [E, K, N], scale f32 [E, N],
                        offsets int32 [E + 1]) -> [M, N], x's dtype

multiplies expert e's rows ``offsets[e] .. offsets[e + 1]`` of the rows
sorted by expert with that expert's weights: on each expert's rows the
function of ``w8_matmul`` (the int8 weights converted exactly, the
products summed in f32, scaled per output channel in f32, rounded once to
x's dtype). For CUDA tensors (bf16 x, K a multiple of 64, N of 16, at most
256 experts) the wrapper launches ``tvc_torch/csrc/moe_w8.cu`` once: a
persistent grid whose blocks derive their work list (expert, row tile of
``moe_plan(M, E, N, K).rows`` rows, 256 output channels) from the offsets
in device memory, so nothing of the routing comes back to the host. For
CPU tensors it computes :func:`moe_w8_grouped_reference`, a loop over the
experts.

``moe_w8_grouped_gemm.launches`` counts the calls that launched the kernel;
each launch also counts ``moe.gemm_plan.<form><rows>`` in the program's
tracing (``moe.gemm_plan.swap32``: the weights as wgmma's A, row tiles of
32), so a run shows which tile served which call. Inference only.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from torch import Tensor

from tvc_torch.core.kernels import _build
from tvc_torch.utils import tracing

#: the row tiles the kernel takes, and the most experts
MOE_ROWS = (16, 32, 128)
MOE_MAX_EXPERTS = 256
#: output channels of a work item, depth of a k-tile
MOE_BN, MOE_BK = 256, 64
#: dynamic shared memory the kernel may use, and the most ring stages
_SMEM = 232448 - 128
_MAX_STAGES = 12


class MoePlan(NamedTuple):
    rows: int  # the row tile R: an expert's rows go in ceil(rows_e / R) items
    stages: int  # TMA ring stages (64-deep k-tiles) in flight
    counter: str  # the tracing counter a launch under this plan adds to


def _smem(rows: int, stages: int, experts: int) -> int:
    """The kernel's dynamic shared memory (``smem_bytes`` in moe_w8.cu)."""
    return 1024 + stages * (MOE_BN * MOE_BK + rows * 128 + 16) + 8 * (experts + 1)


@functools.lru_cache(maxsize=256)
def moe_plan(M: int, E: int, N: int, K: int) -> MoePlan:
    """The row tile and ring of a grouped GEMM of ``M`` rows over ``E``
    experts: the smallest tile in ``MOE_ROWS`` that holds twice the mean
    rows an expert (``M / E``), so that an expert near the mean takes one
    row tile and its weights are converted once, and as many stages as the
    shared memory then holds. Kimi-Linear's decode (3,840 rows over 256
    experts) takes 32, DeepSeek-V2-Lite's (5,760 over 64) and both
    prompts' suffix prefills 128, the shared prefix's prefill (its ~16
    tokens, under two rows an expert) 16. N and K do not move the choice:
    every tile streams the same weight boxes."""
    rows = next((r for r in MOE_ROWS if r >= 2 * M / E), MOE_ROWS[-1])
    return MoePlan(rows, moe_stages(rows), f"moe.gemm_plan.swap{rows}")


def moe_stages(rows: int) -> int:
    """The ring stages that fit beside a row tile of ``rows`` (any E)."""
    return min(_MAX_STAGES, (_SMEM - _smem(rows, 0, MOE_MAX_EXPERTS)) // (_smem(rows, 1, 0) - _smem(rows, 0, 0)))


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
    if K % 64 or N % 16 or E > MOE_MAX_EXPERTS:
        raise ValueError(f"the grouped kernel takes K a multiple of 64, N of 16 and at most {MOE_MAX_EXPERTS} "
                         f"experts, got K={K}, N={N}, E={E}")


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
    plan = moe_plan(M, E, N, K)
    out = torch.empty((M, N), dtype=x_sorted.dtype, device=x_sorted.device)
    _build.check(
        _build.load("moe_w8").tvc_moe_w8_grouped(
            x_sorted.data_ptr(), w_q.data_ptr(), scale.data_ptr(), offsets.data_ptr(), out.data_ptr(),
            M, E, N, K, plan.rows, plan.stages, torch.cuda.current_stream(x_sorted.device).cuda_stream,
        ),
        "tvc_moe_w8_grouped",
    )
    moe_w8_grouped_gemm.launches += 1
    tracing.count(plan.counter)
    return out


moe_w8_grouped_gemm.launches = 0
