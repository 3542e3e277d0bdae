"""PGD attack on CLIP similarity (port of ``tvc/attacks/pgd.py``).

Behavior parity with reference src/attacks/pgd_attack.py (ε=8/255, α=2/255,
10 steps, random init inside the ε-ball, optional momentum with L1-normalized
gradient accumulation, sign step, ε-ball + [0,1] projection each step). The
JAX package runs the loop as one jitted ``lax.fori_loop``; here it is a
Python loop of forward, ``torch.autograd`` gradient, step and projection.
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
    linf_project,
    make_encoder,
    result_from_device,
    seeded_generator,
)
from tvc_torch.models.clip import CLIPModel


@dataclasses.dataclass(frozen=True)
class PGDAttackConfig:
    """(reference src/attacks/pgd_attack.py:19-58; ``num_steps`` is the
    canonical name)"""

    epsilon: float = 8.0 / 255.0
    alpha: float = 2.0 / 255.0
    num_steps: int = 10
    random_init: bool = True
    targeted: bool = False
    use_momentum: bool = False
    momentum: float = 0.9
    clip_min: float = 0.0
    clip_max: float = 1.0
    seed: int = 0


class PGDAttacker:
    """Stateful wrapper around :func:`_pgd_run`."""

    def __init__(self, model: CLIPModel, config: Optional[PGDAttackConfig] = None):
        self.model = model
        self.config = config or PGDAttackConfig()
        self.stats = AttackStats()
        self._encode = make_encoder(model)

    def draw_noise(self, pixels: Tensor) -> Optional[Tensor]:
        """The random start, uniform in [-ε, ε) (None without one)."""
        cfg = self.config
        if not (cfg.random_init and cfg.num_steps > 1):
            return None
        g = seeded_generator(self.model, cfg.seed)
        u = torch.rand(pixels.shape, generator=g, device=pixels.device, dtype=pixels.dtype)
        return u * (2 * cfg.epsilon) - cfg.epsilon

    def attack(self, images, texts, target_texts=None) -> AttackResult:
        """images: PIL list or [B,H,W,3] pixels in [0,1]; texts: list[str]."""
        t0 = time.time()
        pixels = device_pixels(self.model, images)
        text_feats = self.model.encode_text(texts)
        if self.config.targeted:
            if target_texts is None:
                raise ValueError("targeted PGD requires target_texts")
            target_feats = self.model.encode_text(target_texts)
        else:
            target_feats = text_feats
        adv, sims = _pgd_run(self._encode, self.config, self.model.params, pixels, text_feats, target_feats,
                             self.draw_noise(pixels))
        result = result_from_device(adv, pixels, sims, self.config.targeted)
        self.stats.update(result, time.time() - t0)
        return result

    batch_attack = attack

    def get_stats(self):
        return self.stats.get_stats()


@torch.no_grad()
def _pgd_run(encode, cfg: PGDAttackConfig, params, pixels: Tensor, text_feats: Tensor, target_feats: Tensor,
             noise: Optional[Tensor]):
    """The attack program. ``noise``: the random start (None: start at the
    pixels). Returns (adv_pixels, final cos-sims vs text)."""
    objective_feats = target_feats if cfg.targeted else text_feats
    # ascend similarity for targeted, descend for untargeted
    direction = 1.0 if cfg.targeted else -1.0

    def objective(adv):
        sims = torch.sum(encode(params, adv) * objective_feats, dim=-1)
        return direction * torch.mean(sims)

    adv = pixels
    if noise is not None:
        adv = torch.clamp(pixels + noise, cfg.clip_min, cfg.clip_max)
    mom = torch.zeros_like(pixels)
    for _ in range(cfg.num_steps):
        g = grad_of(objective, adv)
        if cfg.use_momentum:
            l1 = torch.sum(g.abs().reshape(g.shape[0], -1), dim=-1).reshape(-1, 1, 1, 1)
            mom = cfg.momentum * mom + g / torch.clamp(l1, min=1e-12)
            step_g = mom
        else:
            step_g = g
        adv = adv + cfg.alpha * torch.sign(step_g)  # ascend the objective
        adv = linf_project(adv, pixels, cfg.epsilon)
    final_sims = torch.sum(encode(params, adv) * text_feats, dim=-1)
    return adv, final_sims


def create_pgd_attacker(model: CLIPModel, config: Optional[PGDAttackConfig] = None) -> PGDAttacker:
    """(reference factory, src/attacks/pgd_attack.py:640+)"""
    return PGDAttacker(model, config)


class PGDAttackPresets:
    """(reference preset idiom, e.g. fgsm_attack.py:636)"""

    @staticmethod
    def weak() -> PGDAttackConfig:
        return PGDAttackConfig(epsilon=2 / 255, alpha=0.5 / 255, num_steps=5)

    @staticmethod
    def standard() -> PGDAttackConfig:
        return PGDAttackConfig()

    @staticmethod
    def strong() -> PGDAttackConfig:
        return PGDAttackConfig(epsilon=16 / 255, alpha=2 / 255, num_steps=40, use_momentum=True)
