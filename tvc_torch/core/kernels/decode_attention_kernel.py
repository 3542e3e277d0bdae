"""One-token grouped-query attention over the KV cache (port of
``tvc/core/pallas/decode_attention_kernel.py``).

    decode_gqa_attention(q [B, KV, R, D], k, v [B, KV, S, D], mask [B, S])
        -> [B, KV, R, D] in q's dtype

with R query heads per KV head, a KV-major cache (each (b, kv) slab a
contiguous [S, D] matrix) and an additive f32 mask (0 attend, -inf masked
slot). Numerics as the TPU kernel's: f32 logits of the compute-dtype
operands scaled by D^-1/2, the mask added, an f32 softmax, the weights
rounded to q's dtype, AV accumulated in f32 and rounded to q's dtype.

For CUDA tensors the wrapper launches the hand-written kernel of
``tvc_torch/csrc/decode_attention.cu`` (bf16 products on the tensor cores,
f32 on the CUDA cores; D 16, 32, 64 or 128, R <= 8, any S); for CPU tensors
it computes the plain version beside it, which is the JAX package's oracle
``decode_gqa_reference``. Other shapes, which the TPU kernel takes too
(a head width off those four, R > 8), take ``tvc_decode_gqa_any`` of the
same source, which launches ``head_attention.cuh``'s tail kernel: a warp
a query row on the CUDA cores, any D and R, one launch, no copy.
:func:`decode_splits` cuts S across blocks when B * KV would leave the
card short of two blocks an SM and S is long, or S exceeds the 1,024
slots whose logits a block keeps in shared memory; every split then forms
the weights against the row's combined max and sum, and the partials are
added in split order, so the result does not depend on the split but for
sums taken in another order.

``decode_gqa_attention_stacked(q, k, v [L, B, KV, S, D], mask, layer)`` is
the same function over layer ``layer`` of the stacked all-layer cache: the
TPU kernel selects the layer by scalar prefetch, and here ``k[layer]`` of
the contiguous stack is already a zero-copy view, so the stacked wrapper
calls :func:`decode_gqa_attention` on it. ``decode_gqa_attention.launches``
counts every launch of the kernel, ``decode_gqa_attention_stacked.launches``
the stacked calls among them. Inference only.
"""

from __future__ import annotations

import math

import torch
from torch import Tensor

from tvc_torch.core.kernels import _build

HEAD_DIMS = (16, 32, 64, 128)  # the tiled kernel's head widths (16: QwenConfig.tiny())
MAX_R = 8  # query heads per KV head the tiled kernel takes
MAX_CHUNK = 1024  # cache slots one block takes: its R x chunk f32 logits live in shared memory
SPLIT_GRAIN = 16  # a split's slots are a multiple of 16 (the tensor-core product's M)
MIN_SPLIT = 256  # slots a split takes at least when S is cut only to fill the card


def decode_gqa_reference(q: Tensor, k: Tensor, v: Tensor, mask: Tensor) -> Tensor:
    """Plain PyTorch version of :func:`decode_gqa_attention` (the JAX
    package's ``decode_gqa_reference``)."""
    D = q.shape[-1]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(D)  # [B, KV, R, S]
    logits = logits + mask.float()[:, None, None, :]
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(w.float(), v.float()).to(q.dtype)


def _check_operands(q: Tensor, k: Tensor, v: Tensor, mask: Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.ndim != 4 or q.dtype not in (torch.bfloat16, torch.float32) or not q.is_contiguous():
        raise ValueError(f"q must be a contiguous bf16 or float32 [B, KV, R, D] tensor, got "
                         f"{q.dtype} {tuple(q.shape)}")
    B, KV, R, D = q.shape
    S = k.shape[2] if k.ndim == 4 else -1
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.ndim != 4 or tuple(t.shape) != (B, KV, S, D) or not t.is_contiguous() \
                or t.device != q.device:
            raise ValueError(f"{name} must be a contiguous {q.dtype} [{B}, {KV}, S, {D}] tensor on {q.device}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if mask.dtype != torch.float32 or tuple(mask.shape) != (B, S) or not mask.is_contiguous() \
            or mask.device != q.device:
        raise ValueError(f"mask must be a contiguous float32 [{B}, {S}] tensor on {q.device}")
    if R < 1:
        raise ValueError(f"q must hold at least one query head per KV head; got R={R}")
    if S < 1:
        raise ValueError("the cache has no slots")


def decode_splits(bkv: int, S: int, sms: int = 132):
    """(splits, chunk): S cut into ``splits`` ranges of ``chunk`` slots (a
    multiple of 16, at most 1,024). When the ``bkv`` = B * KV blocks give
    fewer than two an SM, S is cut further, up to two blocks an SM in all,
    but into no more splits than S / 256 rounded up: a cache of 256 slots
    or fewer is read faster by one launch than by the three a split
    takes."""
    splits = -(-S // MAX_CHUNK)
    if bkv < 2 * sms:
        splits = max(splits, min(2 * sms // bkv, -(-S // MIN_SPLIT)))
    chunk = -(-(-(-S // splits)) // SPLIT_GRAIN) * SPLIT_GRAIN
    return -(-S // chunk), chunk


def decode_gqa_attention(q: Tensor, k: Tensor, v: Tensor, mask: Tensor) -> Tensor:
    """Single-position GQA attention: q [B, KV, R, D], k / v [B, KV, S, D]
    (KV-major), mask [B, S] additive f32; returns [B, KV, R, D] in q's
    dtype."""
    if q.device.type == "cpu":
        return decode_gqa_reference(q, k, v, mask)
    _check_operands(q, k, v, mask)
    B, KV, R, D = q.shape
    S = k.shape[2]
    if D not in HEAD_DIMS or R > MAX_R:  # the tail path
        out = torch.empty_like(q)
        _build.check(
            _build.load("decode_attention").tvc_decode_gqa_any(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(), B, KV, R, S, D,
                int(q.dtype == torch.bfloat16), torch.cuda.current_stream(q.device).cuda_stream,
            ),
            "tvc_decode_gqa_any",
        )
        decode_gqa_attention.launches += 1
        return out
    lib = _build.load("decode_attention")
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    splits, chunk = decode_splits(B * KV, S, sms)
    out = torch.empty_like(q)
    words = lib.tvc_decode_gqa_workspace(B, KV, R, D, splits)
    ws = torch.empty(words, dtype=torch.float32, device=q.device) if words else None
    _build.check(
        lib.tvc_decode_gqa(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), B, KV, R, S, D, int(q.dtype == torch.bfloat16),
            splits, chunk, torch.cuda.current_stream(q.device).cuda_stream,
        ),
        "tvc_decode_gqa",
    )
    decode_gqa_attention.launches += 1
    return out


decode_gqa_attention.launches = 0


def decode_gqa_attention_stacked(q: Tensor, k: Tensor, v: Tensor, mask: Tensor, layer: int) -> Tensor:
    """:func:`decode_gqa_attention` over layer ``layer`` of the stacked
    cache k, v [L, B, KV, S, D]."""
    layer = int(layer)
    if k.ndim != 5 or v.ndim != 5 or not 0 <= layer < k.shape[0]:
        raise ValueError(f"k, v must be stacked [L, B, KV, S, D] caches holding layer {layer}, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if q.device.type == "cpu":
        return decode_gqa_reference(q, k[layer], v[layer], mask)
    out = decode_gqa_attention(q, k[layer], v[layer], mask)
    decode_gqa_attention_stacked.launches += 1
    return out


decode_gqa_attention_stacked.launches = 0
