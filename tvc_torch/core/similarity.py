"""Batched cosine-similarity statistics (port of ``tvc/core/similarity.py``).

Variable-length variant/reference sets are padded tensors plus boolean
masks. All functions are plain PyTorch and differentiable.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

EPS = 1e-8


def l2_normalize(x: Tensor, dim: int = -1, eps: float = EPS) -> Tensor:
    """L2-normalize along ``dim`` (stable for zero vectors)."""
    norm = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def cosine_similarity(a: Tensor, b: Tensor, dim: int = -1) -> Tensor:
    """Cosine similarity along ``dim`` with broadcasting."""
    return torch.sum(l2_normalize(a, dim) * l2_normalize(b, dim), dim=dim)


def pairwise_cosine(a: Tensor, b: Tensor) -> Tensor:
    """All-pairs cosine: ``a: [M, D], b: [N, D] -> [M, N]``."""
    return l2_normalize(a) @ l2_normalize(b).T


def batched_set_cosine(query: Tensor, refs: Tensor) -> Tensor:
    """``query: [B, D], refs: [B, R, D] -> [B, R]``."""
    return torch.einsum("bd,brd->br", l2_normalize(query), l2_normalize(refs))


def masked_mean(x: Tensor, mask: Optional[Tensor], dim: int = -1) -> Tensor:
    """Mean over ``dim`` counting only ``mask``-true entries; empty sets give 0."""
    if mask is None:
        return x.mean(dim=dim)
    m = mask.to(x.dtype)
    count = m.sum(dim=dim)
    total = (x * m).sum(dim=dim)
    return torch.where(count > 0, total / torch.clamp(count, min=1.0), torch.zeros_like(total))


def masked_std(x: Tensor, mask: Optional[Tensor], dim: int = -1) -> Tensor:
    """Population std (``correction=0``) over masked entries."""
    if mask is None:
        return x.std(dim=dim, correction=0)
    m = mask.to(x.dtype)
    count = m.sum(dim=dim)
    mean = masked_mean(x, mask, dim=dim)
    sq = (torch.square(x - mean.unsqueeze(dim)) * m).sum(dim=dim)
    var = torch.where(count > 0, sq / torch.clamp(count, min=1.0), torch.zeros_like(sq))
    return torch.sqrt(torch.clamp(var, min=0.0))


def masked_mean_std(
    x: Tensor, mask: Optional[Tensor], dim: int = -1
) -> Tuple[Tensor, Tensor]:
    """Fused masked mean + population std (one pass: ``E[x^2] - mean^2``)."""
    if mask is None:
        return x.mean(dim=dim), x.std(dim=dim, correction=0)
    m = mask.to(x.dtype)
    msum = m.sum(dim=dim)
    count = torch.clamp(msum, min=1.0)
    nonempty = msum > 0
    mean = (x * m).sum(dim=dim) / count
    ex2 = (torch.square(x) * m).sum(dim=dim) / count
    var = torch.clamp(ex2 - torch.square(mean), min=0.0)
    zero = torch.zeros_like(mean)
    mean = torch.where(nonempty, mean, zero)
    # double-where sqrt keeps the var == 0 subgradient finite (the adaptive
    # attacker differentiates through this std)
    pos = var > 0
    std = torch.where(pos & nonempty, torch.sqrt(torch.where(pos, var, torch.ones_like(var))), zero)
    return mean, std


def masked_max(x: Tensor, mask: Optional[Tensor], dim: int = -1) -> Tensor:
    if mask is None:
        return x.amax(dim=dim)
    neg = torch.finfo(x.dtype).min
    return torch.where(mask, x, torch.full_like(x, neg)).amax(dim=dim)
