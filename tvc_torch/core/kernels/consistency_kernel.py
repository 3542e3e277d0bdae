"""Fused TVC consistency scoring (port of
``tvc/core/pallas/consistency_kernel.py``).

``fused_consistency_scores`` computes what the JAX function computes: f32
math on f32 values of the inputs, f32 outputs (``is_adversarial`` bool).
For CUDA tensors it launches the kernel of ``tvc_torch/csrc/consistency.cu``
once and nothing else: a warp per row (img, txt, each variant, each
reference) reads the stored dtype and converts in registers, a lane per
query sums the cosines in slot order and writes a ``[7, B]`` f32 stats
block and a bool ``[B]`` flag. For CPU tensors it casts the embeddings to
f32 and computes the plain version ``consistency_scores_reference``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from tvc_torch.core import consistency as C
from tvc_torch.core import similarity as S
from tvc_torch.core.kernels import _build

#: rows of the kernel's [len(STAT_KEYS), B] stats block; the flag is a bool [B] of its own
STAT_KEYS = ("tv_score", "sd_score", "consistency_score", "aggregated",
             "orig_similarity", "variant_mean", "variant_std")
#: embedding dtypes the kernel reads, with its codes
EMBED_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MASK_FLOAT = 16  # mask code bit: a floating mask (its sign bit is ignored)
MAX_SLOTS, MAX_D = 8192, 40960  # 1 + V + R and D, as consistency.cu's kMaxSlots, kMaxD

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


def _check_operands(img, txt, variants, refs, variant_mask, ref_mask) -> None:
    """Shapes, one device, embedding and mask dtypes: what both routes take."""
    _check_embed_shapes(img, txt, variants, refs)
    B, V, R = img.shape[0], variants.shape[1], refs.shape[1]
    for name, t in (("img", img), ("txt", txt), ("variants", variants), ("refs", refs)):
        if t.dtype not in EMBED_DTYPES:
            raise ValueError(f"{name} must be float32, bfloat16 or float16, got {t.dtype}")
        if t.device != img.device:
            raise ValueError(f"{name} is on {t.device}, img on {img.device}")
    for name, m, shape in (("variant_mask", variant_mask, (B, V)), ("ref_mask", ref_mask, (B, R))):
        if m is None:
            continue
        if tuple(m.shape) != shape or m.device != img.device:
            raise ValueError(f"{name} must be a {shape} tensor on {img.device}, got {tuple(m.shape)} on {m.device}")
        if m.dtype.is_complex or m.dtype.itemsize not in (1, 2, 4, 8) or (
                m.dtype.is_floating_point and m.dtype not in (torch.float16, torch.bfloat16, torch.float32,
                                                              torch.float64)):
            raise ValueError(f"{name} must be bool, integer or floating (0 / 1), got {m.dtype}")


def _valid(mask: Optional[Tensor]) -> Optional[Tensor]:
    return mask if mask is None or mask.dtype == torch.bool else mask != 0


def _needs_copy(t: Tensor) -> bool:
    """True where the kernel could not read ``t`` as it lies: not contiguous,
    or an embedding whose base is not 16-byte aligned (vector loads)."""
    return not t.is_contiguous() or (t.dtype in EMBED_DTYPES and t.numel() > 0 and t.data_ptr() % 16 != 0)


def _scalar_needs_copy(t, device) -> bool:
    """A weights or threshold tensor on the kernel's device that it cannot
    read through its pointer (another dtype or layout)."""
    return isinstance(t, Tensor) and t.device == device and (t.dtype != torch.float32 or _needs_copy(t))


def operands_needing_copy(img, txt, variants, refs, variant_mask=None, ref_mask=None,
                          weights: Weights = (0.4, 0.4, 0.2), threshold=C.DEFAULT_THRESHOLD) -> List[str]:
    """Names of the operands ``kernel_call`` would copy (on any device, so
    that a caller's CPU test can hold its operands to none)."""
    named = [("img", img), ("txt", txt), ("variants", variants), ("refs", refs),
             ("variant_mask", variant_mask), ("ref_mask", ref_mask)]
    out = [name for name, t in named if t is not None and _needs_copy(t)]
    return out + [name for name, t in (("weights", weights), ("threshold", threshold))
                  if _scalar_needs_copy(t, img.device)]


def _mask_code(m: Optional[Tensor]) -> int:
    if m is None:
        return 0
    return m.dtype.itemsize | (MASK_FLOAT if m.dtype.is_floating_point else 0)


def _scalar_args(weights: Weights, threshold, device) -> Tuple[list, list, list]:
    """(pointers, values, tensors kept alive): a device tensor is read by the
    kernel through its pointer, anything else goes by value."""
    ptrs, vals, keep = [], [], []
    for t, n in ((weights, 3), (threshold, 1)):
        if isinstance(t, Tensor) and t.device == device:
            if t.numel() != n:
                raise ValueError(f"expected {n} value(s), got a tensor of shape {tuple(t.shape)}")
            if _scalar_needs_copy(t, device):
                t = t.to(torch.float32).contiguous()
                fused_consistency_scores.copies += 1
            ptrs.append(t.data_ptr())
            vals.extend([0.0] * n)
            keep.append(t)
        else:
            v = t.reshape(-1).tolist() if isinstance(t, Tensor) else ([t] if n == 1 else list(t))
            if len(v) != n:
                raise ValueError(f"expected {n} value(s), got {len(v)}")
            ptrs.append(None)
            vals.extend(float(x) for x in v)
    return ptrs, vals, keep


class _Launch:
    """One readied kernel call: ``launch()`` runs it on the current stream.
    Holds the operands (and any copies of them) that its pointers name."""

    def __init__(self, fn, args: tuple, device: torch.device, operands: tuple):
        self.fn, self.args, self.device, self.operands = fn, args, device, operands

    def __call__(self) -> None:
        stream = torch.cuda.current_stream(self.device).cuda_stream
        _build.check(self.fn(*self.args, stream), "tvc_consistency_scores")


def kernel_call(img, txt, variants, refs, variant_mask=None, ref_mask=None, weights: Weights = (0.4, 0.4, 0.2),
                threshold=C.DEFAULT_THRESHOLD) -> Tuple[tuple, Dict[str, Tensor], tuple]:
    """``(args, outputs, operands)``: the C entry point's arguments but the
    stream, the ``[B]`` outputs they fill, and the tensors their pointers
    name (copies included). Operands the kernel cannot read as they lie are
    copied, and each copy adds one to ``fused_consistency_scores.copies``.
    Any device: the CPU tests hold the arguments to the C signature."""
    _check_operands(img, txt, variants, refs, variant_mask, ref_mask)
    B, D = img.shape
    V, R = variants.shape[1], refs.shape[1]
    if 1 + V + R > MAX_SLOTS or D > MAX_D:
        raise ValueError(f"1 + V + R = {1 + V + R} slots and D = {D} must be <= {MAX_SLOTS} and {MAX_D}")

    def ready(t):
        if t is not None and _needs_copy(t):
            fused_consistency_scores.copies += 1
            return t.clone(memory_format=torch.contiguous_format)
        return t

    img, txt, variants, refs, variant_mask, ref_mask = map(ready, (img, txt, variants, refs, variant_mask, ref_mask))
    (w_ptr, thr_ptr), vals, keep = _scalar_args(weights, threshold, img.device)
    stats = torch.empty((len(STAT_KEYS), B), dtype=torch.float32, device=img.device)
    flags = torch.empty(B, dtype=torch.bool, device=img.device)
    dtypes = sum(EMBED_DTYPES[t.dtype] << (2 * i) for i, t in enumerate((img, txt, variants, refs)))
    ptr = lambda t: None if t is None else t.data_ptr()
    args = (ptr(img), ptr(txt), ptr(variants), ptr(refs), ptr(variant_mask), ptr(ref_mask), w_ptr, thr_ptr,
            *vals, stats.data_ptr(), flags.data_ptr(), B, V, R, D, dtypes,
            _mask_code(variant_mask), _mask_code(ref_mask))
    out = {k: stats[i] for i, k in enumerate(STAT_KEYS)}
    out["is_adversarial"] = flags
    return args, out, (img, txt, variants, refs, variant_mask, ref_mask, *keep)


def consistency_launch(
    img: Tensor,
    txt: Tensor,
    variants: Tensor,
    refs: Tensor,
    variant_mask: Optional[Tensor] = None,
    ref_mask: Optional[Tensor] = None,
    weights: Weights = (0.4, 0.4, 0.2),
    threshold=C.DEFAULT_THRESHOLD,
) -> Tuple[Callable[[], None], Dict[str, Tensor]]:
    """Ready CUDA operands for the kernel: ``(launch, outputs)``. Each
    ``launch()`` runs the kernel once on the current stream and fills the
    outputs; it counts nothing (``fused_consistency_scores`` counts its
    calls)."""
    if img.device.type != "cuda":
        raise ValueError(f"unsupported device {img.device}")
    args, out, operands = kernel_call(img, txt, variants, refs, variant_mask, ref_mask, weights, threshold)
    return _Launch(_build.load("consistency").tvc_consistency_scores, args, img.device, operands), out


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

    img, txt ``[B, D]``; variants ``[B, V, D]``; refs ``[B, R, D]``: each
    float32, bfloat16 or float16, any D >= 1, any layout (non-contiguous
    operands are copied on the card). Masks ``[B, V]`` / ``[B, R]`` (default
    all valid) of dtype bool or any integer or floating type holding 0 and
    1: a non-zero entry marks a valid slot, so other values are not weights
    in the port (the JAX function would weight the similarities by them).
    ``weights`` (text_variants, sd_reference, consistency) and ``threshold``
    may be Python numbers or tensors. Returns f32 ``[B]`` tensors:
    ``tv_score``, ``sd_score``, ``consistency_score``, ``aggregated``,
    ``orig_similarity``, ``variant_mean``, ``variant_std``, and bool
    ``is_adversarial``.
    """
    _check_operands(img, txt, variants, refs, variant_mask, ref_mask)
    if img.device.type == "cpu":
        f32 = lambda t: t if t.dtype == torch.float32 else t.float()
        return consistency_scores_reference(
            f32(img), f32(txt), f32(variants), f32(refs), _valid(variant_mask), _valid(ref_mask),
            weights, threshold,
        )
    launch, out = consistency_launch(img, txt, variants, refs, variant_mask, ref_mask, weights, threshold)
    launch()
    fused_consistency_scores.launches += 1
    return out


fused_consistency_scores.launches = 0
#: operands the CUDA route copied before a launch (non-contiguous,
#: misaligned, weights of another dtype); the serving step needs none
fused_consistency_scores.copies = 0


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
    oracle of the same name, which casts nothing: it computes in the
    embeddings' dtype)."""
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
