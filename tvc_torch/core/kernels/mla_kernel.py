"""The latent attention (MLA) of one decode step.

    mla_decode_attention(q_lat [B, H, 512], q_pe [B, H, 64],
                         cache [L, B, S, 576], mask [B, S], layer, scale)
        -> [B, H, 512], q_lat's dtype

is one decode step of multi-head latent attention in the absorbed form
over layer ``layer`` of the latent cache (each row the normed latent c,
then the roped key k_pe shared by the heads): logits
``(q_lat . c + q_pe . k_pe) * scale + mask`` in f32, an f32 softmax over
the slots, and the weighted sum of the latents. For CUDA tensors (bf16, 16
heads as DeepSeek-V2-Lite or 32 as Kimi-Linear's latent layers, the
published widths; q_lat may be strided, as the transpose of the absorbed
product's output is) the wrapper launches
``tvc_torch/csrc/mla_decode.cu`` once (each latent row read once for all
heads, an online softmax whose weights are rounded to bf16 before the
product); for CPU tensors it computes :func:`mla_decode_reference`.

``mla_decode_attention.launches`` counts the calls that launched the
kernel. Inference only.
"""

from __future__ import annotations

import torch
from torch import Tensor

from tvc_torch.core.kernels import _build

MLA_HEADS, MLA_LATENT, MLA_ROPE = (16, 32), 512, 64  # the kernel's head counts and widths


def mla_decode_reference(q_lat: Tensor, q_pe: Tensor, cache: Tensor, mask: Tensor, layer: int,
                         scale: float) -> Tensor:
    """Plain PyTorch version of :func:`mla_decode_attention`: f32 logits,
    f32 softmax, the weighted latents summed in f32, rounded to q_lat's
    dtype."""
    rows = cache[int(layer)].float()  # [B, S, 576]
    L = q_lat.shape[-1]
    logits = (torch.einsum("bhc,bsc->bhs", q_lat.float(), rows[..., :L])
              + torch.einsum("bhr,bsr->bhs", q_pe.float(), rows[..., L:])) * scale
    p = torch.softmax(logits + mask.float()[:, None, :], dim=-1)
    return torch.einsum("bhs,bsc->bhc", p, rows[..., :L]).to(q_lat.dtype)


def _check_mla(q_lat: Tensor, q_pe: Tensor, cache: Tensor, mask: Tensor, layer: int) -> None:
    C, R = MLA_LATENT, MLA_ROPE
    B, H = tuple(q_lat.shape[:2]) if q_lat.ndim == 3 else (-1, -1)
    if H not in MLA_HEADS:
        raise ValueError(f"the latent attention kernel takes {MLA_HEADS} heads, got q_lat {tuple(q_lat.shape)}")
    for name, t, shape in (("q_lat", q_lat, (B, H, C)), ("q_pe", q_pe, (B, H, R))):
        if t.dtype != torch.bfloat16 or tuple(t.shape) != shape or t.device != cache.device:
            raise ValueError(f"{name} must be a bf16 {list(shape)} tensor on {cache.device}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if not q_pe.is_contiguous():
        raise ValueError("q_pe must be contiguous")
    if q_lat.stride(2) != 1 or q_lat.stride(0) % 8 or q_lat.stride(1) % 8 or q_lat.data_ptr() % 16:
        raise ValueError(f"q_lat's latents must be unit-stride rows 16 bytes aligned, with row and head strides a "
                         f"multiple of 8, got strides {q_lat.stride()}")
    if cache.dtype != torch.bfloat16 or cache.ndim != 4 or cache.shape[1] != B or cache.shape[3] != C + R \
            or not cache.is_contiguous() or not 0 <= layer < cache.shape[0]:
        raise ValueError(f"cache must be a contiguous bf16 [L, {B}, S, {C + R}] tensor holding layer {layer}, got "
                         f"{cache.dtype} {tuple(cache.shape)}")
    S = cache.shape[2]
    if mask.dtype != torch.float32 or tuple(mask.shape) != (B, S) or not mask.is_contiguous() \
            or mask.device != cache.device:
        raise ValueError(f"mask must be a contiguous float32 [{B}, {S}] tensor on {cache.device}")


def mla_decode_attention(q_lat: Tensor, q_pe: Tensor, cache: Tensor, mask: Tensor, layer: int,
                         scale: float) -> Tensor:
    """One decode step's latent attention over layer ``layer`` of the
    stacked latent cache ``[L, B, S, 576]``; returns ``[B, H, 512]``."""
    layer = int(layer)
    if q_lat.device.type == "cpu":
        return mla_decode_reference(q_lat, q_pe, cache, mask, layer, scale)
    if q_lat.device.type != "cuda":
        raise ValueError(f"unsupported device {q_lat.device}")
    _check_mla(q_lat, q_pe, cache, mask, layer)
    B, H, S = q_lat.shape[0], q_lat.shape[1], cache.shape[2]
    out = torch.empty((B, H, MLA_LATENT), dtype=q_lat.dtype, device=q_lat.device)
    _build.check(
        _build.load("mla_decode").tvc_mla_decode(
            q_lat.data_ptr(), q_pe.data_ptr(), cache[layer].data_ptr(), mask.data_ptr(), out.data_ptr(),
            B, H, S, q_lat.stride(0), q_lat.stride(1), float(scale),
            torch.cuda.current_stream(q_lat.device).cuda_stream,
        ),
        "tvc_mla_decode",
    )
    mla_decode_attention.launches += 1
    return out


mla_decode_attention.launches = 0
