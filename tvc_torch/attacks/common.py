"""Shared attack machinery (port of ``tvc/attacks/common.py``).

All attacks operate in pixel space ([0, 1], NHWC) against a CLIP encoder.
Gradients flow through ``torch.autograd`` over the einsum module
(``CLIPModel.image_features``): the CUDA kernels define no backward, and
the JAX attacks likewise differentiate the flax module, never a Pallas
kernel. A loop step is a forward, a gradient, a step and a projection,
as in the JAX package's ``lax.fori_loop`` bodies.

Untargeted attacks MINIMIZE cos(image, original text); targeted attacks
MAXIMIZE cos(image, target text) (the JAX package's documented deviation
from the reference's sign).

Randomness: each attacker draws its random starts, query subsets and
targets from a ``torch.Generator`` seeded from its config's ``seed`` at
every ``attack`` call, and hands them to its ``_*_run`` function as plain
tensors. The draws are not ``jax.random``'s bits; the attack math given
the same draws is the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from tvc_torch.core.similarity import l2_normalize
from tvc_torch.models.clip import CLIPModel, normalize_pixels

# success thresholds (reference src/attacks/pgd_attack.py:536-541)
UNTARGETED_SUCCESS_SIM = 0.3
TARGETED_SUCCESS_SIM = 0.5


@dataclasses.dataclass
class AttackResult:
    """Host-side result bundle (parity with the reference attack dicts)."""

    adv_images: np.ndarray  # [B, H, W, 3] in [0, 1]
    success: np.ndarray  # [B] bool
    final_similarity: np.ndarray  # [B] cos(adv, text)
    perturbation_linf: np.ndarray  # [B]
    perturbation_l2: np.ndarray  # [B]
    info: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def success_rate(self) -> float:
        return float(np.mean(self.success)) if self.success.size else 0.0


def make_encoder(model: CLIPModel) -> Callable[[Any, Tensor], Tensor]:
    """(params, pixels [0,1]) -> L2-normalized embeddings, differentiable
    in the pixels. CLIP normalization happens inside so attacks perturb
    raw pixels."""

    def encode(params, pixels01: Tensor) -> Tensor:
        return l2_normalize(model.image_features(params, normalize_pixels(pixels01)))

    return encode


def grad_of(fn: Callable[[Tensor], Tensor], x: Tensor) -> Tensor:
    """d fn(x) / dx for a scalar ``fn`` (``jax.grad`` of one argument)."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(fn(x), x)
    return g


def linf_project(adv: Tensor, orig: Tensor, eps: float) -> Tensor:
    """Project onto the L∞ ε-ball around orig, then into [0, 1]."""
    delta = torch.clamp(adv - orig, -eps, eps)
    return torch.clamp(orig + delta, 0.0, 1.0)


def l2_project(adv: Tensor, orig: Tensor, eps: float) -> Tensor:
    """Project onto the per-sample L2 ε-ball around orig, then into [0, 1]."""
    delta = adv - orig
    norms = torch.linalg.vector_norm(delta.reshape(delta.shape[0], -1), dim=-1)
    factor = torch.clamp(eps / torch.clamp(norms, min=1e-12), max=1.0)
    delta = delta * factor.reshape(-1, *([1] * (delta.ndim - 1)))
    return torch.clamp(orig + delta, 0.0, 1.0)


def perturbation_norms(adv: Tensor, orig: Tensor) -> Tuple[Tensor, Tensor]:
    delta = (adv - orig).reshape(adv.shape[0], -1)
    return delta.abs().amax(dim=-1), torch.linalg.vector_norm(delta, dim=-1)


def check_success(sims: Tensor, targeted: bool, threshold: Optional[float] = None) -> Tensor:
    if targeted:
        return sims > (TARGETED_SUCCESS_SIM if threshold is None else threshold)
    return sims < (UNTARGETED_SUCCESS_SIM if threshold is None else threshold)


def prepare_images(model: CLIPModel, images) -> np.ndarray:
    """PIL list / array -> [B, H, W, 3] float32 pixels in [0, 1] (NO CLIP
    normalization — attacks perturb raw pixels)."""
    if isinstance(images, np.ndarray) and images.ndim == 4:
        return images.astype(np.float32)
    if torch.is_tensor(images):
        return prepare_images(model, images.detach().float().cpu().numpy())
    if isinstance(images, (list, tuple)):
        s = model.config.image_size
        return np.stack(
            [
                np.asarray(im.convert("RGB").resize((s, s)), dtype=np.float32) / 255.0
                if hasattr(im, "convert")
                else np.asarray(im, dtype=np.float32)
                for im in images
            ]
        )
    arr = np.asarray(images, dtype=np.float32)
    if arr.ndim == 3:
        arr = arr[None]
    return arr


def device_pixels(model: CLIPModel, images) -> Tensor:
    """``prepare_images`` on the model's device (a tensor already there
    stays as it is)."""
    if torch.is_tensor(images) and images.ndim == 4 and images.device == model.device:
        return images.float()
    return torch.as_tensor(prepare_images(model, images), device=model.device)


def seeded_generator(model: CLIPModel, seed: int) -> torch.Generator:
    """A generator on the model's device, seeded anew for each attack call
    (the JAX attacks take ``PRNGKey(seed)`` each call)."""
    return torch.Generator(device=model.device).manual_seed(int(seed))


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def result_from_device(
    adv: Tensor,
    orig: Tensor,
    sims: Tensor,
    targeted: bool,
    info: Optional[Dict[str, Any]] = None,
    success_threshold: Optional[float] = None,
) -> AttackResult:
    linf, l2 = perturbation_norms(adv, orig)
    success = check_success(sims, targeted, success_threshold)
    return AttackResult(
        adv_images=_np(adv),
        success=_np(success),
        final_similarity=_np(sims),
        perturbation_linf=_np(linf),
        perturbation_l2=_np(l2),
        info=info or {},
    )


class AttackStats:
    """Running stats dict (parity with reference ``get_stats``,
    pgd_attack.py:591-627)."""

    def __init__(self):
        self.total_attacks = 0
        self.successful_attacks = 0
        self.total_time = 0.0
        self.sum_linf = 0.0

    def update(self, result: AttackResult, elapsed: float) -> None:
        n = len(result.success)
        self.total_attacks += n
        self.successful_attacks += int(result.success.sum())
        self.total_time += elapsed
        self.sum_linf += float(result.perturbation_linf.sum())

    def get_stats(self) -> Dict[str, float]:
        n = max(self.total_attacks, 1)
        return {
            "total_attacks": self.total_attacks,
            "successful_attacks": self.successful_attacks,
            "success_rate": self.successful_attacks / n,
            "average_attack_time": self.total_time / n,
            "average_perturbation": self.sum_linf / n,
        }
