"""Fused TVC consistency scoring (port of
``tvc/core/pallas/consistency_kernel.py``).

``fused_consistency_scores`` launches the CUDA kernel of
``tvc_torch/csrc/consistency.cu`` for CUDA tensors: one warp per query reads
img, txt, the V variant rows and the R reference rows once, and writes one
``[B, 8]`` f32 stats block. For CPU tensors it computes the same dict with
``consistency_scores_reference``, the plain PyTorch version beside it.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch
from torch import Tensor

from tvc_torch.core import consistency as C
from tvc_torch.core import similarity as S
from tvc_torch.core.kernels import _build

# output column layout of the kernel ([B, NSTATS])
ROW_TV, ROW_SD, ROW_CONS, ROW_AGG, ROW_FLAG, ROW_ORIG, ROW_VMEAN, ROW_VSTD = range(8)
NSTATS = 8

Weights = Union[Sequence[float], Tensor]


def _check_embed_shapes(img: Tensor, txt: Tensor, variants: Tensor, refs: Tensor) -> None:
    if img.ndim != 2:
        raise ValueError(f"img must be [B, D], got {tuple(img.shape)}")
    B, D = img.shape
    if tuple(txt.shape) != (B, D):
        raise ValueError(f"txt shape {tuple(txt.shape)} must match img shape {(B, D)}")
    if variants.ndim != 3 or variants.shape[0] != B or variants.shape[2] != D:
        raise ValueError(f"variants must be [B={B}, V, D={D}], got {tuple(variants.shape)}")
    if refs.ndim != 3 or refs.shape[0] != B or refs.shape[2] != D:
        raise ValueError(f"refs must be [B={B}, R, D={D}], got {tuple(refs.shape)}")


def _default_mask(mask: Optional[Tensor], like: Tensor) -> Tensor:
    if mask is None:
        return torch.ones(like.shape[:2], dtype=torch.bool, device=like.device)
    return mask


def _params_tensor(weights: Weights, threshold, device) -> Tensor:
    """[w_tv, w_sd, w_cons, threshold] as one f32 device tensor."""
    w = torch.as_tensor(weights, dtype=torch.float32, device=device).reshape(3)
    thr = torch.as_tensor(threshold, dtype=torch.float32, device=device).reshape(1)
    return torch.cat([w, thr])


def _as_dict(out: Tensor) -> Dict[str, Tensor]:
    return {
        "tv_score": out[:, ROW_TV],
        "sd_score": out[:, ROW_SD],
        "consistency_score": out[:, ROW_CONS],
        "aggregated": out[:, ROW_AGG],
        "is_adversarial": out[:, ROW_FLAG] > 0.5,
        "orig_similarity": out[:, ROW_ORIG],
        "variant_mean": out[:, ROW_VMEAN],
        "variant_std": out[:, ROW_VSTD],
    }


def fused_consistency_scores(
    img: Tensor,
    txt: Tensor,
    variants: Tensor,
    refs: Tensor,
    variant_mask: Optional[Tensor] = None,
    ref_mask: Optional[Tensor] = None,
    weights: Weights = (0.4, 0.4, 0.2),
    threshold=C.DEFAULT_THRESHOLD,
) -> Dict[str, Tensor]:
    """Fused consistency scoring for a batch of queries.

    img, txt ``[B, D]``; variants ``[B, V, D]``; refs ``[B, R, D]``;
    masks ``[B, V]`` / ``[B, R]`` bool (default all true). ``weights``
    (text_variants, sd_reference, consistency) and ``threshold`` may be
    Python numbers or tensors. Returns ``[B]`` tensors: ``tv_score``,
    ``sd_score``, ``consistency_score``, ``aggregated``, ``is_adversarial``
    (bool), ``orig_similarity``, ``variant_mean``, ``variant_std``.
    """
    _check_embed_shapes(img, txt, variants, refs)
    if img.device.type == "cpu":
        return consistency_scores_reference(
            img, txt, variants, refs, variant_mask, ref_mask, weights, threshold
        )
    if img.device.type != "cuda":
        raise ValueError(f"unsupported device {img.device}")
    variant_mask = _default_mask(variant_mask, variants)
    ref_mask = _default_mask(ref_mask, refs)
    B, D = img.shape
    V, R = variants.shape[1], refs.shape[1]
    for name, t in (("img", img), ("txt", txt), ("variants", variants), ("refs", refs)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != img.device:
            raise ValueError(f"{name} must be a contiguous float32 tensor on {img.device}")
    for name, m, shape in (("variant_mask", variant_mask, (B, V)), ("ref_mask", ref_mask, (B, R))):
        if m.dtype != torch.bool or tuple(m.shape) != shape or not m.is_contiguous() or m.device != img.device:
            raise ValueError(f"{name} must be a contiguous bool {shape} tensor on {img.device}")
    if D % 4 != 0:
        raise ValueError(f"embedding width {D} must be a multiple of 4 (float4 loads)")

    params = _params_tensor(weights, threshold, img.device)
    out = torch.empty((B, NSTATS), dtype=torch.float32, device=img.device)
    lib = _build.load("consistency")
    stream = torch.cuda.current_stream(img.device).cuda_stream
    _build.check(
        lib.tvc_consistency_scores(
            params.data_ptr(), img.data_ptr(), txt.data_ptr(), variants.data_ptr(),
            variant_mask.data_ptr(), refs.data_ptr(), ref_mask.data_ptr(),
            out.data_ptr(), B, V, R, D, stream,
        ),
        "tvc_consistency_scores",
    )
    fused_consistency_scores.launches += 1
    return _as_dict(out)


fused_consistency_scores.launches = 0


def consistency_scores_reference(
    img: Tensor,
    txt: Tensor,
    variants: Tensor,
    refs: Tensor,
    variant_mask: Optional[Tensor] = None,
    ref_mask: Optional[Tensor] = None,
    weights: Weights = (0.4, 0.4, 0.2),
    threshold=C.DEFAULT_THRESHOLD,
) -> Dict[str, Tensor]:
    """Plain PyTorch version with identical outputs (same math as the JAX
    oracle of the same name)."""
    _check_embed_shapes(img, txt, variants, refs)
    orig = S.cosine_similarity(img, txt)
    vsims = S.batched_set_cosine(img, variants)
    rsims = S.batched_set_cosine(img, refs)
    w = torch.as_tensor(weights, dtype=torch.float32, device=img.device)
    thr = torch.as_tensor(threshold, dtype=torch.float32, device=img.device)
    flags, agg, per_method = C.detect(
        orig, vsims, rsims, variant_mask=variant_mask, ref_mask=ref_mask,
        method="weighted_mean", weights=w, threshold=thr,
    )
    vmean, vstd = S.masked_mean_std(vsims, variant_mask, dim=-1)
    if variant_mask is not None:
        has = variant_mask.to(torch.int32).sum(dim=-1) > 0
        vmean = torch.where(has, vmean, torch.zeros_like(vmean))
        vstd = torch.where(has, vstd, torch.zeros_like(vstd))
    return {
        "tv_score": per_method[:, 0],
        "sd_score": per_method[:, 1],
        "consistency_score": per_method[:, 2],
        "aggregated": agg,
        "is_adversarial": flags,
        "orig_similarity": orig,
        "variant_mean": vmean,
        "variant_std": vstd,
    }
