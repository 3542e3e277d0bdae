"""FSTA — Feature-Space Targeted Attack (port of ``tvc/attacks/fsta.py``).

Behavior parity with reference src/attacks/fsta_attack.py: pushes image
features toward target text-feature centroids with the composite loss
  total = 1.0·feature + 0.1·output + 0.05·diversity        (:45-47)
where feature = −cos(img, target) + cos(img, text) (:254-268),
output = MSE(img_feat, target_feat) (:272-276), diversity = mean off-diag
cosine between batch features (:279-300); momentum-accumulated signed
descent, ε=8/255, 20 iters (:30-32), optional lr decay. The batch
diversity term is a single [B, B] matmul.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch
from torch import Tensor

from tvc_torch.attacks.common import (
    AttackResult,
    AttackStats,
    device_pixels,
    grad_of,
    l2_project,
    linf_project,
    make_encoder,
    result_from_device,
    seeded_generator,
)
from tvc_torch.core.similarity import l2_normalize
from tvc_torch.models.clip import CLIPModel


@dataclasses.dataclass(frozen=True)
class FSTAAttackConfig:
    """(reference src/attacks/fsta_attack.py:20-70)"""

    epsilon: float = 8.0 / 255.0
    learning_rate: float = 2.0 / 255.0
    num_iter: int = 20
    feature_weight: float = 1.0
    output_weight: float = 0.1
    diversity_weight: float = 0.05
    momentum: float = 0.9
    norm_type: str = "inf"  # inf | l2
    feature_distance_metric: str = "cosine"  # cosine | euclidean
    adaptive_step_size: bool = False
    decay_factor: float = 0.98
    seed: int = 0


def orthogonal_targets(text_feats: Tensor, rand: Tensor) -> Tensor:
    """``rand`` with its component along each text direction removed,
    L2-normalized (reference _generate_random_targets)."""
    proj = torch.sum(rand * text_feats, -1, keepdim=True) * text_feats
    return l2_normalize(rand - proj)


class FSTAAttacker:
    def __init__(self, model: CLIPModel, config: Optional[FSTAAttackConfig] = None):
        self.model = model
        self.config = config or FSTAAttackConfig()
        self.stats = AttackStats()
        self._encode = make_encoder(model)

    def attack(self, images, texts, target_texts=None) -> AttackResult:
        """target_texts default: per-sample random orthogonal targets
        (reference _generate_random_targets)."""
        t0 = time.time()
        pixels = device_pixels(self.model, images)
        text_feats = self.model.encode_text(texts)
        if target_texts is not None:
            target_feats = self.model.encode_text(target_texts)
        else:
            g = seeded_generator(self.model, self.config.seed)
            rand = torch.randn(text_feats.shape, generator=g, device=text_feats.device, dtype=text_feats.dtype)
            target_feats = orthogonal_targets(text_feats, rand)
        adv, sims = _fsta_run(self._encode, self.config, self.model.params, pixels, text_feats, target_feats)
        result = result_from_device(adv, pixels, sims, targeted=False)
        self.stats.update(result, time.time() - t0)
        return result

    batch_attack = attack

    def get_stats(self):
        return self.stats.get_stats()


def batch_diversity(feats: Tensor) -> Tensor:
    """Mean off-diagonal cosine of the batch's (normalized) features; 0 for
    one sample."""
    B = feats.shape[0]
    sim = feats @ feats.T
    off_diag = sim - torch.diag(torch.diag(sim))
    return torch.sum(off_diag) / max(B * (B - 1), 1) if B > 1 else torch.zeros((), device=feats.device)


@torch.no_grad()
def _fsta_run(encode, cfg: FSTAAttackConfig, params, pixels: Tensor, text_feats: Tensor, target_feats: Tensor):
    def loss_fn(adv):
        feats = encode(params, adv)  # already L2-normalized
        if cfg.feature_distance_metric == "cosine":
            feature_loss = (
                -torch.mean(torch.sum(feats * target_feats, -1)) + torch.mean(torch.sum(feats * text_feats, -1))
            )
        else:
            feature_loss = (
                torch.mean(torch.linalg.vector_norm(feats - target_feats, dim=-1))
                - torch.mean(torch.linalg.vector_norm(feats - text_feats, dim=-1))
            )
        output_loss = torch.mean(torch.square(feats - target_feats))
        return (
            cfg.feature_weight * feature_loss
            + cfg.output_weight * output_loss
            + cfg.diversity_weight * batch_diversity(feats)
        )

    project = linf_project if cfg.norm_type == "inf" else l2_project
    adv, mom = pixels, torch.zeros_like(pixels)
    lr = torch.tensor(cfg.learning_rate, dtype=torch.float32, device=pixels.device)  # decays in f32, as JAX's
    for _ in range(cfg.num_iter):
        mom = cfg.momentum * mom + grad_of(loss_fn, adv)
        adv = project(adv - lr * torch.sign(mom), pixels, cfg.epsilon)  # descend the loss
        if cfg.adaptive_step_size:
            lr = lr * cfg.decay_factor
    sims = torch.sum(encode(params, adv) * text_feats, dim=-1)
    return adv, sims


def create_fsta_attacker(model: CLIPModel, config: Optional[FSTAAttackConfig] = None) -> FSTAAttacker:
    return FSTAAttacker(model, config)


class FSTAAttackPresets:
    """(reference :409+)"""

    @staticmethod
    def fast() -> FSTAAttackConfig:
        return FSTAAttackConfig(num_iter=5)

    @staticmethod
    def standard() -> FSTAAttackConfig:
        return FSTAAttackConfig()

    @staticmethod
    def strong() -> FSTAAttackConfig:
        return FSTAAttackConfig(epsilon=16 / 255, num_iter=50)
