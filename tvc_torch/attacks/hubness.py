"""Hubness attack (arXiv 2412.14113 reproduction; port of
``tvc/attacks/hubness.py``).

Makes one image a "hub": optimizes it to be the top-1 retrieval result for
many text queries simultaneously. Behavior parity with reference
src/attacks/hubness_attack.py: loss = -mean cos(image, query set)
(:671-674), ε=16/255 L∞, 500 signed-gradient steps (:48-49), per-sample
random query subsets (:283-304), hubness score = fraction of queries whose
top-1 among the gallery ∪ {adv} is the adv image (:482-498), success at
score > 0.84 (:55). The whole [B]-batch, each sample with its own [Q]
query set, is one einsum a step; MI-FGSM momentum is on by default.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

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
    seeded_generator,
)
from tvc_torch.core.similarity import l2_normalize
from tvc_torch.models.clip import CLIPModel


@dataclasses.dataclass(frozen=True)
class HubnessAttackConfig:
    """(reference src/attacks/hubness_attack.py:40-100)"""

    epsilon: float = 16.0 / 255.0
    alpha: float = 2.0 / 255.0  # step size
    num_iterations: int = 500
    num_target_queries: int = 100
    success_threshold: float = 0.84
    norm_type: str = "linf"  # linf | l2
    seed: int = 0
    #: ``mean_sim`` is the paper/reference objective (maximize mean cos to
    #: the query set). ``win_hinge`` is the gallery-aware white-box
    #: objective: maximize a smooth count of queries the hub actually WINS
    #: (sigmoid((cos(adv,q) - best_gallery(q) - margin)/tau)); requires
    #: build_reference_database(images=...)
    objective: str = "mean_sim"  # mean_sim | win_hinge
    win_margin: float = 0.02
    win_tau: float = 0.05
    #: MI-FGSM-style momentum (Dong et al. 2018): accumulate the
    #: L1-normalized gradient and step on the accumulator's sign. On by
    #: default: a defense evaluation must face the strongest attack.
    use_momentum: bool = True
    momentum: float = 0.9

    @classmethod
    def from_dict(cls, d: dict) -> "HubnessAttackConfig":
        """(reference :101)"""
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


class HubnessAttack:
    """Exported as ``HubnessAttacker`` too (reference attacks/__init__.py:8)."""

    def __init__(self, model: CLIPModel, config: Optional[HubnessAttackConfig] = None):
        self.model = model
        self.config = config or HubnessAttackConfig()
        self.stats = AttackStats()
        self._encode = make_encoder(model)
        self._gallery_img: Optional[Tensor] = None  # [N, E]
        self._query_texts: Optional[Tensor] = None  # [M, E]

    # -- reference database (reference :189-204) ----------------------------
    def build_reference_database(self, images=None, texts: Optional[Sequence[str]] = None):
        if images is not None:
            self._gallery_img = self.model.encode_image(device_pixels(self.model, images))
        if texts is not None:
            self._query_texts = self.model.encode_text(list(texts))

    def draw_query_indices(self, B: int, M: int, Q: int) -> Tensor:
        """Per-sample random query subsets, [B, Q] distinct indices into the
        pool (reference :283-304)."""
        g = seeded_generator(self.model, self.config.seed)
        keys = torch.rand((B, M), generator=g, device=self.model.device)
        return keys.argsort(dim=1)[:, :Q]

    # -- attack ------------------------------------------------------------
    def attack(self, images, texts: Optional[Sequence[str]] = None) -> AttackResult:
        """Optimize each image toward its own random query subset. ``texts``
        (or the prebuilt query DB) is the query pool."""
        t0 = time.time()
        pixels = device_pixels(self.model, images)
        if texts is not None:
            pool = self.model.encode_text(list(texts))
        elif self._query_texts is not None:
            pool = self._query_texts
        else:
            raise ValueError("no query texts: pass texts or build_reference_database")
        B = pixels.shape[0]
        M = pool.shape[0]
        Q = min(self.config.num_target_queries, M)
        queries = pool[self.draw_query_indices(B, M, Q)]  # [B, Q, E]
        gal_best = None
        if self.config.objective == "win_hinge":
            if self._gallery_img is None:
                raise ValueError(
                    "objective='win_hinge' needs the gallery: call build_reference_database(images=...) first"
                )
            g = l2_normalize(self._gallery_img)
            gal_best = torch.einsum("bqe,ne->bqn", l2_normalize(queries), g).amax(dim=-1)  # [B, Q]
        adv, mean_sims = _hubness_run(self._encode, self.config, self.model.params, pixels, queries, gal_best)

        hub_scores = None
        if self._gallery_img is not None:
            adv_feats = self.model.encode_image(adv)
            hub_scores = hubness_score(adv_feats, queries, self._gallery_img).cpu().numpy()
        success_metric = hub_scores if hub_scores is not None else mean_sims.cpu().numpy()
        threshold = self.config.success_threshold if hub_scores is not None else 0.5
        delta = (adv - pixels).reshape(B, -1)
        result = AttackResult(
            adv_images=adv.cpu().numpy(),
            success=np.asarray(success_metric) > threshold,
            final_similarity=mean_sims.cpu().numpy(),
            perturbation_linf=delta.abs().amax(dim=-1).cpu().numpy(),
            perturbation_l2=torch.linalg.vector_norm(delta, dim=-1).cpu().numpy(),
            info={"hubness_scores": hub_scores, "num_queries": Q},
        )
        self.stats.update(result, time.time() - t0)
        return result

    batch_attack = attack

    def compute_hubness(self, adv_images, queries, gallery=None) -> np.ndarray:
        """(reference :464-498)"""
        adv_feats = self.model.encode_image(device_pixels(self.model, adv_images))
        gal = gallery if gallery is not None else self._gallery_img
        if gal is None:
            raise ValueError("no gallery: build_reference_database(images=...) first")
        queries = torch.as_tensor(queries, device=adv_feats.device)
        gal = torch.as_tensor(gal, device=adv_feats.device)
        if queries.ndim == 2:
            queries = queries[None].expand((adv_feats.shape[0],) + tuple(queries.shape))
        return hubness_score(adv_feats, queries, gal).cpu().numpy()

    def get_stats(self):
        return self.stats.get_stats()


@torch.no_grad()
def _hubness_run(encode, cfg: HubnessAttackConfig, params, pixels: Tensor, queries: Tensor,
                 gal_best: Optional[Tensor] = None):
    """queries: [B, Q, E] per-sample target query features; ``gal_best``
    [B, Q] = each query's best gallery cosine (win_hinge objective only)."""
    q = l2_normalize(queries)

    def objective(adv):
        sims = torch.einsum("be,bqe->bq", encode(params, adv), q)  # [B, Q]
        if cfg.objective == "win_hinge" and gal_best is not None:
            # smooth hijack count: reward crossing each query's own
            # gallery bar instead of raising the unwinnable mean
            return torch.mean(torch.sigmoid((sims - gal_best - cfg.win_margin) / cfg.win_tau))
        return torch.mean(sims)  # maximize mean sim == minimize reference loss

    project = linf_project if cfg.norm_type == "linf" else l2_project
    adv = pixels
    m = torch.zeros_like(pixels)
    for _ in range(cfg.num_iterations):
        g = grad_of(objective, adv)
        if cfg.use_momentum:
            m = cfg.momentum * m + g / (torch.mean(g.abs()) + 1e-12)
            adv = project(adv + cfg.alpha * torch.sign(m), pixels, cfg.epsilon)
        else:
            adv = project(adv + cfg.alpha * torch.sign(g), pixels, cfg.epsilon)
    final = torch.einsum("be,bqe->bq", encode(params, adv), q).mean(dim=-1)
    return adv, final


def hubness_score(adv_feats: Tensor, queries: Tensor, gallery: Tensor) -> Tensor:
    """Fraction of queries whose top-1 over gallery ∪ {adv} is adv.

    adv_feats [B, E]; queries [B, Q, E]; gallery [N, E]: adv wins a query
    iff cos(query, adv) > max_n cos(query, gallery_n)."""
    a = l2_normalize(adv_feats.float())
    q = l2_normalize(queries.float())
    g = l2_normalize(gallery.float())
    adv_sim = torch.einsum("bqe,be->bq", q, a)  # [B, Q]
    gal_sim = torch.einsum("bqe,ne->bqn", q, g).amax(dim=-1)  # [B, Q]
    return torch.mean((adv_sim > gal_sim).float(), dim=-1)


# reference export alias (attacks/__init__.py:8)
HubnessAttacker = HubnessAttack


def create_hubness_attacker(model: CLIPModel, config: Optional[HubnessAttackConfig] = None) -> HubnessAttack:
    return HubnessAttack(model, config)


class HubnessAttackPresets:
    """(reference :789+)"""

    @staticmethod
    def fast() -> HubnessAttackConfig:
        return HubnessAttackConfig(num_iterations=50, num_target_queries=20)

    @staticmethod
    def standard() -> HubnessAttackConfig:
        return HubnessAttackConfig()

    @staticmethod
    def paper() -> HubnessAttackConfig:
        """arXiv 2412.14113 standard setting."""
        return HubnessAttackConfig(epsilon=16 / 255, num_iterations=500, num_target_queries=100)
