"""Carlini-Wagner L2 attack with tanh reparameterization + binary search
(port of ``tvc/attacks/cw.py``).

Behavior parity with reference src/attacks/cw_attack.py:264-430:
  minimize ||δ||₂ + c · max(0, f(x+δ) − κ)
with f = cos(image, text) untargeted / −cos(image, target) targeted,
w = atanh((2x−1)·0.999999), Adam on w, 9 binary-search steps over c with
per-sample bound updates (success → c halves toward lower bound; failure →
lower bound rises, c ×10 until bounded), vectorized over the batch.

The optimizer is written out with optax's formulas (``optax.adam``: the
moments ``(1 - b) g^k + b m``, bias correction ``m / (1 - b^t)`` with the
step count t from 1, ``m_hat / (sqrt(v_hat) + eps)`` with eps outside the
square root, eps = 1e-8, b1 = 0.9, b2 = 0.999, then ``w + (-lr) u``;
``optax.sgd``: ``w + (-lr) g``), not ``torch.optim``, whose step order and
eps handling differ.
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
    check_success,
    device_pixels,
    grad_of,
    make_encoder,
    result_from_device,
)
from tvc_torch.models.clip import CLIPModel

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class CWAttackConfig:
    """(reference src/attacks/cw_attack.py:20-72)"""

    max_iterations: int = 1000
    binary_search_steps: int = 9
    learning_rate: float = 0.01
    initial_const: float = 1e-3
    kappa: float = 0.0
    targeted: bool = False
    loss_type: str = "cosine"  # cosine | mse
    optimizer_type: str = "adam"  # adam | sgd


class CWAttacker:
    def __init__(self, model: CLIPModel, config: Optional[CWAttackConfig] = None):
        self.model = model
        self.config = config or CWAttackConfig()
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
        adv, sims, best_l2 = _cw_run(self._encode, self.config, self.model.params, pixels, text_feats, target_feats)
        result = result_from_device(adv, pixels, sims, self.config.targeted,
                                    info={"best_l2": best_l2.cpu().numpy()})
        self.stats.update(result, time.time() - t0)
        return result

    batch_attack = attack

    def get_stats(self):
        return self.stats.get_stats()


class _Adam:
    """optax.adam(lr)'s update, state (count, mu, nu)."""

    def __init__(self, lr: float, w: Tensor):
        self.lr = lr
        self.count = 0
        self.mu = torch.zeros_like(w)
        self.nu = torch.zeros_like(w)

    def step(self, w: Tensor, g: Tensor) -> Tensor:
        self.mu = (1 - ADAM_B1) * g + ADAM_B1 * self.mu
        self.nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * self.nu
        self.count += 1
        t = torch.tensor(self.count, dtype=torch.int32, device=w.device)
        mu_hat = self.mu / (1 - torch.tensor(ADAM_B1, dtype=w.dtype, device=w.device) ** t)
        nu_hat = self.nu / (1 - torch.tensor(ADAM_B2, dtype=w.dtype, device=w.device) ** t)
        return w + (mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS)) * -self.lr


class _SGD:
    """optax.sgd(lr)'s update (no momentum)."""

    def __init__(self, lr: float, w: Tensor):
        self.lr = lr

    def step(self, w: Tensor, g: Tensor) -> Tensor:
        return w + g * -self.lr


@torch.no_grad()
def _cw_run(encode, cfg: CWAttackConfig, params, pixels: Tensor, text_feats: Tensor, target_feats: Tensor):
    B = pixels.shape[0]
    objective_feats = target_feats if cfg.targeted else text_feats
    w0 = torch.atanh((pixels * 2.0 - 1.0) * 0.999999)
    optimizer = _Adam if cfg.optimizer_type == "adam" else _SGD

    def attack_fval(feats):
        """f(x+δ): >0 means attack not yet confident (reference :327-330)."""
        sims = torch.sum(feats * objective_feats, dim=-1)
        if cfg.loss_type == "cosine":
            return -sims if cfg.targeted else sims
        diff = torch.mean(torch.square(feats - objective_feats), dim=-1)
        return diff if cfg.targeted else -diff

    def total_loss(w, const):
        adv = (torch.tanh(w) + 1.0) / 2.0
        fval = torch.clamp(attack_fval(encode(params, adv)).mean() - cfg.kappa, min=0.0)
        l2 = torch.linalg.vector_norm((adv - pixels).reshape(B, -1), dim=-1)
        return l2.mean() + const.mean() * fval

    def optimize_for_const(const):
        w = w0
        opt = optimizer(cfg.learning_rate, w0)
        for _ in range(cfg.max_iterations):
            w = opt.step(w, grad_of(lambda w_: total_loss(w_, const), w))
        return (torch.tanh(w) + 1.0) / 2.0

    lower = torch.zeros(B, device=pixels.device)
    upper = torch.full((B,), 1e10, device=pixels.device)
    const = torch.full((B,), cfg.initial_const, device=pixels.device)
    best_l2 = torch.full((B,), 1e10, device=pixels.device)
    best_adv = pixels
    for _ in range(cfg.binary_search_steps):
        adv = optimize_for_const(const)
        sims = torch.sum(encode(params, adv) * text_feats, dim=-1)
        success = check_success(sims, cfg.targeted)
        l2 = torch.linalg.vector_norm((adv - pixels).reshape(B, -1), dim=-1)
        improved = success & (l2 < best_l2)
        best_l2 = torch.where(improved, l2, best_l2)
        best_adv = torch.where(improved.reshape(-1, 1, 1, 1), adv, best_adv)
        # per-sample bound updates (reference :325-334)
        upper = torch.where(success, const, upper)
        lower = torch.where(success, lower, const)
        const = torch.where(upper < 1e9, (lower + upper) / 2.0, lower * 10.0)
    final_sims = torch.sum(encode(params, best_adv) * text_feats, dim=-1)
    return best_adv, final_sims, best_l2


def create_cw_attacker(model: CLIPModel, config: Optional[CWAttackConfig] = None) -> CWAttacker:
    return CWAttacker(model, config)


class CWAttackPresets:
    """(reference :836+)"""

    @staticmethod
    def fast() -> CWAttackConfig:
        return CWAttackConfig(max_iterations=100, binary_search_steps=3)

    @staticmethod
    def standard() -> CWAttackConfig:
        return CWAttackConfig()

    @staticmethod
    def high_confidence() -> CWAttackConfig:
        return CWAttackConfig(kappa=0.2)
