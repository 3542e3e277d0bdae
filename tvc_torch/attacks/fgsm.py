"""FGSM: single-step sign-gradient attack on CLIP similarity (port of
``tvc/attacks/fgsm.py``; reference src/attacks/fgsm_attack.py — same
wrapper shape as PGD with one step and no projection loop)."""

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
    make_encoder,
    result_from_device,
)
from tvc_torch.models.clip import CLIPModel


@dataclasses.dataclass(frozen=True)
class FGSMAttackConfig:
    """(reference src/attacks/fgsm_attack.py:20-58)"""

    epsilon: float = 8.0 / 255.0
    targeted: bool = False
    clip_min: float = 0.0
    clip_max: float = 1.0


class FGSMAttacker:
    def __init__(self, model: CLIPModel, config: Optional[FGSMAttackConfig] = None):
        self.model = model
        self.config = config or FGSMAttackConfig()
        self.stats = AttackStats()
        self._encode = make_encoder(model)

    def attack(self, images, texts, target_texts=None) -> AttackResult:
        t0 = time.time()
        pixels = device_pixels(self.model, images)
        text_feats = self.model.encode_text(texts)
        target_feats = (
            self.model.encode_text(target_texts)
            if (self.config.targeted and target_texts is not None)
            else text_feats
        )
        adv, sims = _fgsm_run(self._encode, self.config, self.model.params, pixels, text_feats, target_feats)
        result = result_from_device(adv, pixels, sims, self.config.targeted)
        self.stats.update(result, time.time() - t0)
        return result

    batch_attack = attack

    def get_stats(self):
        return self.stats.get_stats()


@torch.no_grad()
def _fgsm_run(encode, cfg: FGSMAttackConfig, params, pixels: Tensor, text_feats: Tensor, target_feats: Tensor):
    objective_feats = target_feats if cfg.targeted else text_feats
    direction = 1.0 if cfg.targeted else -1.0

    def objective(adv):
        return direction * torch.mean(torch.sum(encode(params, adv) * objective_feats, dim=-1))

    g = grad_of(objective, pixels)
    adv = torch.clamp(pixels + cfg.epsilon * torch.sign(g), cfg.clip_min, cfg.clip_max)
    sims = torch.sum(encode(params, adv) * text_feats, dim=-1)
    return adv, sims


def create_fgsm_attacker(model: CLIPModel, config: Optional[FGSMAttackConfig] = None) -> FGSMAttacker:
    return FGSMAttacker(model, config)


class FGSMAttackPresets:
    """(reference src/attacks/fgsm_attack.py:636+)"""

    @staticmethod
    def weak() -> FGSMAttackConfig:
        return FGSMAttackConfig(epsilon=2 / 255)

    @staticmethod
    def standard() -> FGSMAttackConfig:
        return FGSMAttackConfig()

    @staticmethod
    def strong() -> FGSMAttackConfig:
        return FGSMAttackConfig(epsilon=16 / 255)
