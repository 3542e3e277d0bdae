"""Multi-head softmax attention for the module towers (port of
``tvc/core/pallas/attention_kernel.py``).

    fused_mha(q, k, v [B, T, H, D], causal=False) -> [B, T, H, D] in q's dtype

Numerics as the TPU kernel's: f32 logits of the operands times D^-1/2, the
optional causal mask (column <= row), an f32 softmax, the weights cast to
the operands' dtype, P.V accumulated in f32 and cast to the operands'
dtype.

For CUDA tensors the wrapper launches the hand-written kernel of
``tvc_torch/csrc/mha.cu`` (the per-head attention of ``head_attention.cuh``
on [B, T, H, D] operands, any T: at head widths 32 and 64 bf16 on the
tensor cores and f32 on the CUDA cores, since the tensor cores would mean
TF32; any other head width on the header's tail path, a warp a query row
on the CUDA cores, as the TPU kernel takes any width); for CPU tensors it
computes the plain version beside it, :func:`mha_reference`.
``fused_mha.launches`` counts the launches. Inference only: no gradient,
as the TPU kernel defines none.
"""

from __future__ import annotations

import math

import torch
from torch import Tensor

from tvc_torch.core.kernels import _build

HEAD_DIMS = (32, 64)  # head widths of the tiled kernels (tiny configs, every CLIP preset); others: the tail path


def mha_reference(q: Tensor, k: Tensor, v: Tensor, causal: bool = False) -> Tensor:
    """Plain PyTorch version of :func:`fused_mha`."""
    dt = q.dtype
    T, D = q.shape[1], q.shape[3]
    qh, kh, vh = (t.transpose(1, 2).float() for t in (q, k, v))  # [B, H, T, D]
    logits = torch.matmul(qh, kh.transpose(-1, -2)) * (1.0 / math.sqrt(D))
    if causal:
        keep = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, float("-inf"))
    w = torch.softmax(logits, dim=-1).to(dt)
    return torch.matmul(w.float(), vh).to(dt).transpose(1, 2).contiguous()


def _row_stride(ts, T: int, H: int, D: int, elem: int):
    """The common row stride of q, k, v when each is laid out [B, T, H, D]
    with strides (T * ld, ld, D, 1) and 16-byte aligned rows (e.g. views of
    one packed q | k | v projection), else None."""
    ld = ts[0].stride(1)
    for t in ts:
        if t.stride() != (T * ld, ld, D, 1) or t.data_ptr() % 16:
            return None
    return ld if (ld * elem) % 16 == 0 else None


def fused_mha(q: Tensor, k: Tensor, v: Tensor, causal: bool = False, block_heads: int = 64) -> Tensor:
    """Multi-head attention: q, k, v [B, T, H, D] -> [B, T, H, D] in q's
    dtype. ``block_heads`` is the TPU kernel's heads per grid step, kept for
    the signature; the CUDA kernels tile (b, h) themselves."""
    if q.device.type == "cpu":
        return mha_reference(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.ndim != 4 or q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q must be a bf16 or float32 [B, T, H, D] tensor, got {q.dtype} {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must be a {q.dtype} {list(q.shape)} tensor on {q.device}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    B, T, H, D = q.shape
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    ld = _row_stride((q, k, v), T, H, D, q.element_size()) if D in HEAD_DIMS else None
    if ld is None:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        ld = H * D
    lib = _build.load("mha")
    _build.check(
        lib.tvc_mha(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), ld, B, T, H, D,
            int(q.dtype == torch.bfloat16), int(causal), 1.0 / math.sqrt(D),
            torch.cuda.current_stream(q.device).cuda_stream,
        ),
        "tvc_mha",
    )
    fused_mha.launches += 1
    return out


fused_mha.launches = 0
