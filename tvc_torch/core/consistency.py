"""Text-Variant-Consistency detector math (port of ``tvc/core/consistency.py``).

* the **primary stack**: text-variant, reference-image and global
  consistency scores in [0, 1], aggregated by mean/max/min/weighted-mean;
  ``aggregated > threshold`` means adversarial.
* the **alt stack**: consistency metrics (means + stds + cross-modal
  variance) fused by simple/weighted/adaptive voting; ``overall <
  threshold`` means adversarial.

Everything consumes similarity values and returns per-query tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import Tensor

from tvc_torch.core.similarity import masked_mean, masked_mean_std

#: aggregation weights of the primary detector (text_variants, sd_reference,
#: consistency)
DEFAULT_WEIGHTS: Dict[str, float] = {
    "text_variants": 0.4,
    "sd_reference": 0.4,
    "consistency": 0.2,
}

DEFAULT_THRESHOLD: float = 0.5


def _has_any(mask: Tensor) -> Tensor:
    return mask.to(torch.int32).sum(dim=-1) > 0


def text_variant_score(
    orig_sim: Tensor, variant_sims: Tensor, variant_mask: Optional[Tensor] = None
) -> Tensor:
    """``1 - (0.7 * (1 - |orig - mean|) + 0.3 * (1 - std))``; 0 with no variants."""
    mean, std = masked_mean_std(variant_sims, variant_mask, dim=-1)
    consistency = 1.0 - torch.abs(orig_sim - mean)
    variability = 1.0 - std
    score = 1.0 - (0.7 * consistency + 0.3 * variability)
    if variant_mask is not None:
        score = torch.where(_has_any(variant_mask), score, torch.zeros_like(score))
    return score


def reference_score(ref_sims: Tensor, ref_mask: Optional[Tensor] = None) -> Tensor:
    """``1 - mean(cos(query, refs))``; 0 with no references."""
    score = 1.0 - masked_mean(ref_sims, ref_mask, dim=-1)
    if ref_mask is not None:
        score = torch.where(_has_any(ref_mask), score, torch.zeros_like(score))
    return score


def global_consistency_score(orig_sim: Tensor) -> Tensor:
    """``1 - cos(image, text)``."""
    return 1.0 - orig_sim


def aggregate_scores(
    scores: Tensor,
    present: Optional[Tensor] = None,
    method: str = "weighted_mean",
    weights: Optional[Tensor] = None,
) -> Tensor:
    """Aggregate ``scores [B, M]`` over the methods ``present [B, M]``."""
    if present is None:
        present = torch.ones_like(scores, dtype=torch.bool)
    if method == "mean":
        return masked_mean(scores, present, dim=-1)
    if method == "max":
        neg = torch.finfo(scores.dtype).min
        return torch.where(present, scores, torch.full_like(scores, neg)).amax(dim=-1)
    if method == "min":
        pos = torch.finfo(scores.dtype).max
        return torch.where(present, scores, torch.full_like(scores, pos)).amin(dim=-1)
    if method == "weighted_mean":
        if weights is None:
            weights = torch.tensor(
                [
                    DEFAULT_WEIGHTS["text_variants"],
                    DEFAULT_WEIGHTS["sd_reference"],
                    DEFAULT_WEIGHTS["consistency"],
                ],
                dtype=scores.dtype,
                device=scores.device,
            )
        w = weights.to(scores) * present.to(scores.dtype)
        total = w.sum(dim=-1)
        num = (scores * w).sum(dim=-1)
        return torch.where(
            total > 0, num / torch.clamp(total, min=1e-12), torch.zeros_like(num)
        )
    raise ValueError(f"unknown aggregation method: {method}")


def is_adversarial(aggregated: Tensor, threshold: float = DEFAULT_THRESHOLD) -> Tensor:
    return aggregated > threshold


def detect(
    orig_sim: Tensor,
    variant_sims: Tensor,
    ref_sims: Tensor,
    variant_mask: Optional[Tensor] = None,
    ref_mask: Optional[Tensor] = None,
    method: str = "weighted_mean",
    weights: Optional[Tensor] = None,
    threshold: float = DEFAULT_THRESHOLD,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Full primary-stack detection: ``(flags [B], aggregated [B],
    per_method [B, 3])`` with columns (text_variants, sd_reference,
    consistency)."""
    tv = text_variant_score(orig_sim, variant_sims, variant_mask)
    sd = reference_score(ref_sims, ref_mask)
    gc = global_consistency_score(orig_sim)
    per_method = torch.stack([tv, sd, gc], dim=-1)
    ones = torch.ones_like(orig_sim, dtype=torch.bool)
    tv_present = _has_any(variant_mask) if variant_mask is not None else ones
    sd_present = _has_any(ref_mask) if ref_mask is not None else ones
    present = torch.stack([tv_present, sd_present, ones], dim=-1)
    agg = aggregate_scores(per_method, present, method=method, weights=weights)
    return is_adversarial(agg, threshold), agg, per_method


# ---------------------------------------------------------------------------
# Alt stack — consistency metrics + voting
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ConsistencyMetrics:
    """Batched consistency statistics. All fields are [B] tensors."""

    original_similarity: Tensor
    text_variant_consistency: Tensor
    text_variant_std: Tensor
    retrieval_consistency: Tensor
    retrieval_std: Tensor
    generative_consistency: Tensor
    generative_std: Tensor
    cross_modal_variance: Tensor

    def stacked(self) -> Tensor:
        """[B, 4] column order: original, text_variant, retrieval, generative."""
        return torch.stack(
            [
                self.original_similarity,
                self.text_variant_consistency,
                self.retrieval_consistency,
                self.generative_consistency,
            ],
            dim=-1,
        )

    def stds(self) -> Tensor:
        """[B, 3] column order: text_variant, retrieval, generative."""
        return torch.stack(
            [self.text_variant_std, self.retrieval_std, self.generative_std], dim=-1
        )


def compute_consistency_metrics(
    orig_sim: Tensor,
    variant_sims: Tensor,
    retrieval_sims: Tensor,
    generative_sims: Tensor,
    variant_mask: Optional[Tensor] = None,
    retrieval_mask: Optional[Tensor] = None,
    generative_mask: Optional[Tensor] = None,
) -> ConsistencyMetrics:
    """No variants -> variant consistency falls back to ``orig_sim`` with std
    0; empty retrieval/generative sets -> 0, 0; cross-modal variance is the
    population variance of the positive consistency values, 0 if fewer than
    two are positive."""
    v_mean, v_std = masked_mean_std(variant_sims, variant_mask, dim=-1)
    if variant_mask is not None:
        v_has = _has_any(variant_mask)
        v_mean = torch.where(v_has, v_mean, orig_sim)
        v_std = torch.where(v_has, v_std, torch.zeros_like(v_std))
    r_mean, r_std = masked_mean_std(retrieval_sims, retrieval_mask, dim=-1)
    g_mean, g_std = masked_mean_std(generative_sims, generative_mask, dim=-1)

    sims = torch.stack([orig_sim, v_mean, r_mean, g_mean], dim=-1)  # [B, 4]
    pos = sims > 0
    zero = torch.zeros_like(sims)
    n_pos = pos.to(sims.dtype).sum(dim=-1)
    mean_pos = torch.where(pos, sims, zero).sum(dim=-1) / torch.clamp(n_pos, min=1.0)
    var_pos = torch.where(
        pos, torch.square(sims - mean_pos[..., None]), zero
    ).sum(dim=-1) / torch.clamp(n_pos, min=1.0)
    cross_modal = torch.where(n_pos >= 2, var_pos, torch.zeros_like(var_pos))

    return ConsistencyMetrics(
        original_similarity=orig_sim,
        text_variant_consistency=v_mean,
        text_variant_std=v_std,
        retrieval_consistency=r_mean,
        retrieval_std=r_std,
        generative_consistency=g_mean,
        generative_std=g_std,
        cross_modal_variance=cross_modal,
    )


#: alt-stack default fusion weights
ALT_DEFAULT_WEIGHTS = (0.25, 0.25, 0.25, 0.25)


def _weighted_over_positive(sims: Tensor, w: Tensor) -> Tensor:
    tw = w.sum(dim=-1)
    num = (sims * w).sum(dim=-1)
    return torch.where(tw > 0, num / torch.clamp(tw, min=1e-12), torch.zeros_like(num))


def overall_score(
    metrics: ConsistencyMetrics,
    strategy: str = "weighted",
    weights: Optional[Tensor] = None,
) -> Tensor:
    """Fuse consistency metrics: ``simple`` (mean of positive values),
    ``weighted`` (preset weights over positive values, renormalized) or
    ``adaptive`` (reliability weights 1/(1+std), original weight 1)."""
    sims = metrics.stacked()  # [B, 4]
    pos = (sims > 0).to(sims.dtype)
    if strategy == "simple":
        n = pos.sum(dim=-1)
        num = (sims * pos).sum(dim=-1)
        return torch.where(n > 0, num / torch.clamp(n, min=1.0), torch.zeros_like(num))
    if strategy == "weighted":
        if weights is None:
            weights = torch.tensor(ALT_DEFAULT_WEIGHTS, dtype=sims.dtype, device=sims.device)
        return _weighted_over_positive(sims, weights.to(sims) * pos)
    if strategy == "adaptive":
        stds = metrics.stds()  # [B, 3]
        rel = torch.cat([torch.ones_like(stds[..., :1]), 1.0 / (1.0 + stds)], dim=-1)
        rel = rel / torch.clamp(rel.sum(dim=-1, keepdim=True), min=1e-12)
        return _weighted_over_positive(sims, rel * pos)
    raise ValueError(f"unknown voting strategy: {strategy}")


def adaptive_threshold(
    metrics: ConsistencyMetrics,
    base_threshold: float = 0.5,
    history_mean: Optional[Tensor] = None,
) -> Tensor:
    """+0.1 if cross-modal variance > 0.1; +0.05 if the mean of the three
    stds > 0.2; smoothed 0.7/0.3 toward ``history_mean``; clipped to
    [0.1, 0.9]."""
    thr = torch.full_like(metrics.original_similarity, base_threshold)
    thr = thr + torch.where(metrics.cross_modal_variance > 0.1, 0.1, 0.0)
    avg_std = metrics.stds().mean(dim=-1)
    thr = thr + torch.where(avg_std > 0.2, 0.05, 0.0)
    if history_mean is not None:
        thr = 0.7 * thr + 0.3 * history_mean
    return torch.clamp(thr, 0.1, 0.9)


def alt_is_adversarial(overall: Tensor, threshold: Tensor) -> Tensor:
    """Alt-stack decision direction: LOW consistency => adversarial."""
    return overall < threshold


def decision_confidence(
    overall: Tensor, threshold: Tensor, cross_modal_variance: Tensor
) -> Tensor:
    """Distance to threshold relative to threshold, clipped to [0, 1] and
    damped by cross-modal variance."""
    dist = torch.abs(overall - threshold) / torch.clamp(threshold, min=1e-12)
    return torch.clamp(dist, 0.0, 1.0) * (1.0 / (1.0 + cross_modal_variance))
