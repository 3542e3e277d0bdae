"""SMA — Semantic Misalignment Attack (port of ``tvc/attacks/sma.py``).

Behavior parity with reference src/attacks/sma_attack.py: drives image
features toward a mismatched semantic target while keeping visual quality:
  total = 2.0·semantic + 0.5·perceptual + 0.1·diversity      (:36-38)
semantic = −cos(img, target) + cos(img, text) − shift·(cos_target −
cos_text) (:320-341); perceptual = MSE(adv, orig) (:344-352); diversity as
in FSTA (:355-373). Targets come from orthogonal / random / adversarial
(−text) strategies (:375-411). Optional JPEG robustness through a
differentiable approximation — blockwise DCT quantization with
straight-through rounding (:func:`jpeg_approx`). ε=8/255, 15 iters,
momentum signed descent.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
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
from tvc_torch.attacks.fsta import batch_diversity, orthogonal_targets
from tvc_torch.core.similarity import l2_normalize
from tvc_torch.models.clip import CLIPModel


@dataclasses.dataclass(frozen=True)
class SMAAttackConfig:
    """(reference src/attacks/sma_attack.py:21-84)"""

    epsilon: float = 8.0 / 255.0
    learning_rate: float = 2.0 / 255.0
    num_iter: int = 15
    semantic_weight: float = 2.0
    perceptual_weight: float = 0.5
    diversity_weight: float = 0.1
    semantic_shift_strength: float = 0.5
    target_selection: str = "semantic"  # semantic | random | adversarial
    momentum: float = 0.9
    norm_type: str = "inf"
    jpeg_robust: bool = False
    jpeg_quality: int = 75
    seed: int = 0


def _dct_matrix(n: int = 8) -> np.ndarray:
    k = np.arange(n)
    mat = np.sqrt(2.0 / n) * np.cos(np.pi * (2 * k[None, :] + 1) * k[:, None] / (2 * n))
    mat[0] *= 1.0 / np.sqrt(2.0)
    return mat.astype(np.float32)


def jpeg_approx(images: Tensor, quality: int) -> Tensor:
    """Differentiable JPEG approximation: 8x8 blockwise DCT, uniform
    quantization with straight-through rounding, inverse DCT. Luma-style
    single quant scale (no chroma subsampling)."""
    D = torch.as_tensor(_dct_matrix(8), device=images.device, dtype=images.dtype)
    B, H, W, C = images.shape
    pad_h, pad_w = (-H) % 8, (-W) % 8
    x = images
    if pad_h or pad_w:  # edge padding of H and W, as jnp.pad(mode="edge")
        x = torch.cat([x, x[:, -1:].expand(B, pad_h, W, C)], dim=1)
        x = torch.cat([x, x[:, :, -1:].expand(B, H + pad_h, pad_w, C)], dim=2)
    Hp, Wp = H + pad_h, W + pad_w
    x = x * 255.0 - 128.0
    x = x.reshape(B, Hp // 8, 8, Wp // 8, 8, C).permute(0, 1, 3, 5, 2, 4)
    coeffs = torch.einsum("ij,...jk,lk->...il", D, x, D)
    scale = max((100.0 - quality) / 50.0, 0.02) * 16.0
    q = coeffs / scale
    # straight-through round: forward rounds, gradient passes through
    q = q + (torch.round(q) - q).detach()
    coeffs = q * scale
    x = torch.einsum("ji,...jk,kl->...il", D, coeffs, D)
    x = x.permute(0, 1, 4, 2, 5, 3).reshape(B, Hp, Wp, C)
    return torch.clamp((x[:, :H, :W] + 128.0) / 255.0, 0.0, 1.0)


def make_targets(target_selection: str, text_feats: Tensor, rand: Tensor) -> Tensor:
    """(reference :375-411) ``rand``: a standard normal draw of
    ``text_feats``' shape (unused by "adversarial")."""
    if target_selection == "adversarial":
        return -l2_normalize(text_feats)
    if target_selection == "random":
        return l2_normalize(rand)
    # "semantic": orthogonalize against the text direction (Gram-Schmidt)
    return orthogonal_targets(l2_normalize(text_feats), rand)


class SMAAttacker:
    def __init__(self, model: CLIPModel, config: Optional[SMAAttackConfig] = None):
        self.model = model
        self.config = config or SMAAttackConfig()
        self.stats = AttackStats()
        self._encode = make_encoder(model)

    def _make_targets(self, text_feats: Tensor) -> Tensor:
        g = seeded_generator(self.model, self.config.seed)
        rand = torch.randn(text_feats.shape, generator=g, device=text_feats.device, dtype=text_feats.dtype)
        return make_targets(self.config.target_selection, text_feats, rand)

    def attack(self, images, texts, target_texts=None) -> AttackResult:
        t0 = time.time()
        pixels = device_pixels(self.model, images)
        text_feats = self.model.encode_text(texts)
        target_feats = (
            self.model.encode_text(target_texts) if target_texts is not None else self._make_targets(text_feats)
        )
        adv, sims = _sma_run(self._encode, self.config, self.model.params, pixels, text_feats, target_feats)
        result = result_from_device(adv, pixels, sims, targeted=False)
        self.stats.update(result, time.time() - t0)
        return result

    batch_attack = attack

    def get_stats(self):
        return self.stats.get_stats()


@torch.no_grad()
def _sma_run(encode, cfg: SMAAttackConfig, params, pixels: Tensor, text_feats: Tensor, target_feats: Tensor):
    tgt = l2_normalize(target_feats)
    txt = l2_normalize(text_feats)

    def loss_fn(adv):
        x = jpeg_approx(adv, cfg.jpeg_quality) if cfg.jpeg_robust else adv
        feats = encode(params, x)
        cos_t = torch.sum(feats * tgt, -1)
        cos_x = torch.sum(feats * txt, -1)
        semantic = -cos_t.mean() + cos_x.mean() - cfg.semantic_shift_strength * (cos_t - cos_x).mean()
        perceptual = torch.mean(torch.square(adv - pixels))
        return (
            cfg.semantic_weight * semantic
            + cfg.perceptual_weight * perceptual
            + cfg.diversity_weight * batch_diversity(feats)
        )

    project = linf_project if cfg.norm_type == "inf" else l2_project
    adv, mom = pixels, torch.zeros_like(pixels)
    for _ in range(cfg.num_iter):
        mom = cfg.momentum * mom + grad_of(loss_fn, adv)
        adv = project(adv - cfg.learning_rate * torch.sign(mom), pixels, cfg.epsilon)
    sims = torch.sum(encode(params, adv) * txt, dim=-1)
    return adv, sims


def create_sma_attacker(model: CLIPModel, config: Optional[SMAAttackConfig] = None) -> SMAAttacker:
    return SMAAttacker(model, config)


class SMAAttackPresets:
    """(reference :794+)"""

    @staticmethod
    def fast() -> SMAAttackConfig:
        return SMAAttackConfig(num_iter=5)

    @staticmethod
    def standard() -> SMAAttackConfig:
        return SMAAttackConfig()

    @staticmethod
    def jpeg_robust() -> SMAAttackConfig:
        return SMAAttackConfig(jpeg_robust=True, num_iter=30)
