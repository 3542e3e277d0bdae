"""Adaptive (defense-aware) attacks (port of ``tvc/attacks/adaptive.py``).

A white-box adaptive attacker knows the whole detector: the text variants,
the retrieval references (fetched by the TEXT embedding, hence constant
with respect to the image), the aggregation weights and the calibrated
clean band. It optimizes

    attack_objective(adv)  -  λ · band_penalty(aggregated_score(adv))

where ``aggregated_score`` is the differentiable TVC aggregate
(``tvc_torch.core.consistency.detect``, through which ``torch.autograd``
flows) and ``band_penalty`` is the hinge distance outside the calibrated
clean band [lower, upper]. λ = 0 is the oblivious attack; sweeping λ traces
the attacker's evasion / effectiveness frontier.

Gradients flow through the einsum module (``CLIPModel.image_features``),
as in every attack of the port. The random start and the hubness query
subsets are drawn from a ``torch.Generator`` seeded from the config's
``seed`` at every ``attack`` call and handed to :func:`_adaptive_run` as
tensors; the attack math given the same draws is the JAX package's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch import Tensor

from tvc_torch.attacks.common import (
    AttackResult,
    AttackStats,
    _np,
    device_pixels,
    grad_of,
    linf_project,
    make_encoder,
    seeded_generator,
)
from tvc_torch.core import consistency as C
from tvc_torch.core.similarity import l2_normalize
from tvc_torch.models.clip import CLIPModel


@dataclasses.dataclass(frozen=True)
class AdaptiveAttackConfig:
    """Defense-aware attack parameters.

    ``base`` selects the attack objective the evasion penalty is traded
    against: ``pgd`` minimizes cos(image, paired text), ``hubness``
    maximizes the mean cos to a per-sample query set.
    ``band_lower``/``band_upper`` are the calibrated clean-band thresholds
    the attacker wants the aggregated score to stay inside
    (AdversarialDetector.calibrate_two_sided)."""

    base: str = "pgd"  # pgd | hubness
    epsilon: float = 8.0 / 255.0
    alpha: float = 1.0 / 255.0
    num_steps: int = 100
    penalty_weight: float = 1.0  # λ
    band_lower: float = 0.0
    band_upper: float = 1.0
    weights: tuple = (0.4, 0.4, 0.2)  # detector aggregation weights (known)
    random_init: bool = True
    clip_min: float = 0.0
    clip_max: float = 1.0
    seed: int = 0
    #: MI-FGSM momentum (Dong et al. 2018): plain sign ascent oscillates on
    #: the hubness-style objectives
    use_momentum: bool = True
    momentum: float = 0.9
    #: counter-adaptation against the defender's hub probe
    #: (AdversarialDetector.set_hub_probe): weight of the penalty keeping
    #: the attacker's OWN probe-pool draw's top-m mean similarity under the
    #: threshold. 0 disables (and the probe args are ignored).
    probe_weight: float = 0.0
    probe_top_m: int = 8


def aggregated_score_fn(
    encode,
    params,
    txt_feats: Tensor,
    var_feats: Tensor,
    var_mask: Tensor,
    refs: Tensor,
    ref_mask: Tensor,
    weights: Tensor,
):
    """Differentiable TVC aggregate as a function of raw pixels: what the
    serving step computes per query (orig / variant / reference cosines ->
    ``C.detect``). ``refs`` are the text-retrieved bank rows, constant with
    respect to the image.

    ``var_feats`` / ``var_mask`` may carry an EOT axis, [B, M, V, D] /
    [B, M, V]: M independent draws from the defender's variant sampling.
    The aggregate is then [M, B] (one defender hypothesis per row)."""
    eot = var_feats.ndim == 4

    def agg(adv_pixels: Tensor) -> Tensor:
        img = encode(params, adv_pixels)  # [B, D] L2-normalized
        orig = torch.sum(img * txt_feats, dim=-1)  # [B]
        rsims = torch.einsum("bd,brd->br", img, refs)
        if eot:
            B, M, V, _ = var_feats.shape
            vsims = torch.einsum("bd,bmvd->bmv", img, var_feats)
            # fold the M defender draws into the batch: one C.detect call
            _, aggregated, _ = C.detect(
                orig.repeat(M),
                vsims.permute(1, 0, 2).reshape(M * B, V),
                rsims.repeat(M, 1),
                variant_mask=var_mask.permute(1, 0, 2).reshape(M * B, V),
                ref_mask=ref_mask.repeat(M, 1),
                weights=weights,
            )
            return aggregated.reshape(M, B)
        vsims = torch.einsum("bd,bvd->bv", img, var_feats)
        _, aggregated, _ = C.detect(
            orig, vsims, rsims, variant_mask=var_mask, ref_mask=ref_mask, weights=weights
        )
        return aggregated

    return agg


@torch.no_grad()
def _adaptive_run(
    encode,
    cfg: AdaptiveAttackConfig,
    params,
    pixels: Tensor,
    txt_feats: Tensor,
    var_feats: Tensor,
    var_mask: Tensor,
    refs: Tensor,
    ref_mask: Tensor,
    queries: Tensor,
    lam: float,
    noise: Optional[Tensor],
    probe: Optional[Tensor] = None,
    probe_thr: Optional[float] = None,
):
    """The attack program. ``noise``: the random start (None: start at the
    pixels). ``probe`` [P, D] + ``probe_thr``: the attacker's own draw from
    the defender's hub-probe caption distribution (cfg.probe_weight > 0).
    Returns (adv_pixels, final sims, final objective, final aggregate)."""
    weights = torch.as_tensor(cfg.weights, dtype=torch.float32, device=pixels.device)
    agg_of = aggregated_score_fn(encode, params, txt_feats, var_feats, var_mask, refs, ref_mask, weights)

    def band_penalty(agg: Tensor) -> Tensor:
        # hinge distance outside the calibrated clean band: zero inside,
        # linear outside (torch.maximum splits a tie's gradient as
        # jnp.maximum does)
        zero = torch.zeros_like(agg)
        return torch.maximum(agg - cfg.band_upper, zero) + torch.maximum(cfg.band_lower - agg, zero)

    def objective(adv: Tensor) -> Tensor:
        img = encode(params, adv)
        if cfg.base == "hubness":
            atk = torch.mean(torch.einsum("bd,bqd->bq", img, queries))  # maximize
        else:
            atk = -torch.mean(torch.sum(img * txt_feats, dim=-1))  # minimize sim
        obj = atk - lam * torch.mean(band_penalty(agg_of(adv)))
        if cfg.probe_weight > 0.0 and probe is not None:
            top = torch.topk(img @ probe.T, cfg.probe_top_m, dim=-1).values
            probe_score = torch.mean(top, dim=-1)  # [B]
            obj = obj - cfg.probe_weight * torch.mean(
                torch.maximum(probe_score - probe_thr, torch.zeros_like(probe_score))
            )
        return obj

    adv = pixels
    if noise is not None:
        adv = torch.clamp(pixels + noise, cfg.clip_min, cfg.clip_max)
    if cfg.use_momentum:
        m = torch.zeros_like(adv)
        for _ in range(cfg.num_steps):
            g = grad_of(objective, adv)
            m = cfg.momentum * m + g / (torch.mean(torch.abs(g)) + 1e-12)
            adv = linf_project(adv + cfg.alpha * torch.sign(m), pixels, cfg.epsilon)
    else:
        for _ in range(cfg.num_steps):
            adv = adv + cfg.alpha * torch.sign(grad_of(objective, adv))  # ascend
            adv = linf_project(adv, pixels, cfg.epsilon)
    img = encode(params, adv)
    final_sims = torch.sum(img * txt_feats, dim=-1)
    # per-sample base-objective value: mean query sim (hubness), the
    # success criterion for the hub; paired-text sim otherwise
    if cfg.base == "hubness":
        final_obj = torch.einsum("bd,bqd->bq", img, queries).mean(dim=-1)
    else:
        final_obj = final_sims
    agg = agg_of(adv)
    if agg.ndim == 2:  # EOT: report the expectation over defender draws
        agg = agg.mean(dim=0)
    return adv, final_sims, final_obj, agg


def _f32(x, device) -> Tensor:
    """An array or tensor as an f32 tensor on ``device``."""
    if torch.is_tensor(x):
        return x.detach().to(device, torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


class AdaptiveAttacker:
    """The defense-aware attack on one model and config; the penalty
    weight λ is a per-call argument, so a sweep reuses the attacker."""

    def __init__(self, model: CLIPModel, config: Optional[AdaptiveAttackConfig] = None):
        self.model = model
        self.config = config or AdaptiveAttackConfig()
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

    def draw_query_indices(self, B: int, M: int, Q: int) -> Tensor:
        """Per-sample query subsets of the hubness base: [B, Q] distinct
        indices into the pool."""
        g = seeded_generator(self.model, self.config.seed)
        keys = torch.rand((B, M), generator=g, device=self.model.device)
        return keys.argsort(dim=1)[:, :Q]

    def _variant_features(self, samples, B: int, D: int):
        """[B, M, V, D] features and [B, M, V] mask of M variant draws."""
        dev = self.model.device
        M = len(samples)
        V = max(max((len(v) for s in samples for v in s), default=1), 1)
        feats = torch.zeros((B, M, V, D), dtype=torch.float32, device=dev)
        mask = torch.zeros((B, M, V), dtype=torch.bool, device=dev)
        flat = [v for s in samples for vl in s for v in vl]
        if flat:
            slots = [(b, m, j) for m, s in enumerate(samples) for b, vl in enumerate(s) for j in range(len(vl))]
            b_i, m_i, j_i = (torch.as_tensor(ix, device=dev) for ix in zip(*slots))
            feats[b_i, m_i, j_i] = self.model.encode_text(flat).float()
            mask[b_i, m_i, j_i] = True
        return feats, mask

    def attack(
        self,
        images,
        texts: Sequence[str],
        variants: Sequence[Sequence[str]],
        refs,
        query_pool: Optional[Sequence[str]] = None,
        penalty_weight: Optional[float] = None,
        gallery_feats=None,
        variant_samples: Optional[Sequence[Sequence[Sequence[str]]]] = None,
        probe_feats=None,
        probe_threshold: Optional[float] = None,
    ) -> AttackResult:
        """``variants``: the per-query variant texts the attacker knows;
        ``refs``: [B, R, D] text-retrieved reference embeddings;
        ``query_pool``: hubness-base target captions; ``gallery_feats``:
        [N, D] gallery image embeddings (with these the hubness-base success
        criterion is the hubness score > 0.5, else mean query sim > 0.5);
        ``variant_samples``: M independent draws [M][B][V] from the
        defender's variant sampling, whose band penalties the attack
        averages (expectation over transformation)."""
        cfg = self.config
        t0 = time.time()
        dev = self.model.device
        pixels = device_pixels(self.model, images)
        B = pixels.shape[0]
        txt_feats = self.model.encode_text(list(texts)).float()
        D = txt_feats.shape[-1]

        samples = [list(s) for s in variant_samples] if variant_samples is not None else [list(variants)]
        var_feats, var_mask = self._variant_features(samples, B, D)
        if len(samples) == 1:  # the single-sample program keeps [B, V, D]
            var_feats, var_mask = var_feats[:, 0], var_mask[:, 0]

        refs = _f32(refs, dev)
        ref_mask = torch.any(refs != 0, dim=-1)

        if cfg.base == "hubness":
            if query_pool is None:
                raise ValueError("hubness base requires query_pool")
            pool = self.model.encode_text(list(query_pool)).float()
            M = pool.shape[0]
            Q = min(100, M)
            queries = l2_normalize(pool[self.draw_query_indices(B, M, Q)])
        else:
            queries = torch.zeros((B, 1, D), dtype=torch.float32, device=dev)

        lam = float(cfg.penalty_weight if penalty_weight is None else penalty_weight)
        probe = l2_normalize(_f32(probe_feats, dev)) if probe_feats is not None else None
        pthr = float(probe_threshold) if probe_threshold is not None else None
        adv, sims, obj, agg = _adaptive_run(
            self._encode, cfg, self.model.params, pixels, txt_feats, var_feats, var_mask, refs, ref_mask,
            queries, lam, self.draw_noise(pixels), probe, pthr,
        )
        adv_np, obj_np, agg_np = _np(adv), _np(obj), _np(agg)
        delta = adv_np - _np(pixels)
        inside = (agg_np >= cfg.band_lower) & (agg_np <= cfg.band_upper)
        hub_scores = None
        if cfg.base == "hubness":
            if gallery_feats is not None:
                from tvc_torch.attacks.hubness import hubness_score

                adv_feats = self.model.encode_image(adv)
                hub_scores = _np(hubness_score(adv_feats, queries, _f32(gallery_feats, dev)))
            success = hub_scores > 0.5 if hub_scores is not None else obj_np > 0.5
        else:
            # paired-text sim broken below the reference bar
            # (common.UNTARGETED_SUCCESS_SIM)
            success = obj_np < 0.3
        result = AttackResult(
            adv_images=adv_np,
            success=success,
            final_similarity=_np(sims),
            perturbation_linf=np.abs(delta).reshape(B, -1).max(-1),
            perturbation_l2=np.linalg.norm(delta.reshape(B, -1), axis=-1),
            info={
                "final_aggregated": agg_np,
                "final_objective": obj_np,
                "inside_band": inside,
                "penalty_weight": lam,
                "hubness_scores": hub_scores,
            },
        )
        self.stats.update(result, time.time() - t0)
        return result

    batch_attack = attack

    def get_stats(self):
        return self.stats.get_stats()


def create_adaptive_attacker(
    model: CLIPModel, config: Optional[AdaptiveAttackConfig] = None
) -> AdaptiveAttacker:
    return AdaptiveAttacker(model, config)


class AdaptiveTextAttacker:
    """Defense-aware text attack: TextFooler-style greedy synonym
    substitution (``tvc_torch.attacks.text_attack``) whose candidate score
    is

        cos(image, candidate_text)  +  λ · band_dist(aggregated(candidate))

    The attacker minimizes image-text similarity while keeping the
    white-box TVC aggregate inside the calibrated clean band. The aggregate
    is ``score_fn(image, candidate_texts) -> scores``: the attacker's own
    replica of the full defense. Candidates per step are scored in one
    batched call."""

    def __init__(
        self,
        model: CLIPModel,
        score_fn,
        config=None,
        penalty_weight: float = 1.0,
        band: tuple = (0.0, 1.0),
    ):
        from tvc_torch.attacks.text_attack import TextAttackConfig

        self.model = model
        self.config = config or TextAttackConfig()
        self.score_fn = score_fn
        self.lam = float(penalty_weight)
        self.band_lower, self.band_upper = float(band[0]), float(band[1])

    def _band_dist(self, s: np.ndarray) -> np.ndarray:
        return np.maximum(s - self.band_upper, self.band_lower - s)

    def _text_feats(self, texts) -> np.ndarray:
        return _np(self.model.encode_text(list(texts)).float())

    def attack_single(self, image, text: str):
        from tvc_torch.attacks.text_attack import STOPWORDS, get_synonyms

        cfg = self.config
        img = np.asarray(image)
        image_feat = _np(self.model.encode_image(img[None]).float())[0]

        def sims(cands):
            return self._text_feats(cands) @ image_feat

        def combined(cands):
            s = sims(cands)
            pen = self._band_dist(np.asarray(_np(self.score_fn(img, list(cands)))))
            return s + self.lam * np.maximum(pen, 0.0), s

        words = text.split()
        idxs = [
            i
            for i, w in enumerate(words)
            if len(w) >= cfg.min_word_length and not (cfg.preserve_stopwords and w.lower() in STOPWORDS)
        ]
        cur_total, cur_sim = combined([text])
        cur_total, cur_sim = float(cur_total[0]), float(cur_sim[0])
        if not idxs:
            return text, {"similarity": cur_sim, "changed": 0}
        orig_text_feat = self._text_feats([text])[0]
        # word importance by deletion drop (plain sims: the ranking needs no
        # defense replica)
        deleted = [" ".join(words[:i] + words[i + 1:]) for i in idxs]
        importance = cur_sim - sims(deleted)
        order = [idxs[j] for j in np.argsort(-importance)]

        budget = max(1, int(len(words) * cfg.max_perturbation_ratio))
        current, changed = list(words), 0
        for i in order:
            if changed >= budget:
                break
            syns = get_synonyms(words[i].lower(), cfg.num_synonyms)
            if not syns:
                continue
            cands = []
            for s in syns:
                c = list(current)
                c[i] = s
                cands.append(" ".join(c))
            totals, cand_sims = combined(cands)
            text_sims = self._text_feats(cands) @ orig_text_feat
            totals = np.where(text_sims >= cfg.min_text_similarity, totals, np.inf)
            best = int(np.argmin(totals))
            if totals[best] < cur_total:
                current[i] = syns[best]
                cur_total, cur_sim = float(totals[best]), float(cand_sims[best])
                changed += 1
        final = " ".join(current)
        agg = float(np.asarray(_np(self.score_fn(img, [final])))[0])
        return final, {
            "similarity": cur_sim,
            "changed": changed,
            "aggregated": agg,
            "inside_band": bool(self._band_dist(np.asarray([agg]))[0] <= 0),
        }

    def attack(self, images, texts: Sequence[str]):
        from tvc_torch.attacks.text_attack import TextAttackResult

        t0 = time.time()
        adv_texts, sims, changed, inside = [], [], [], []
        for image, text in zip(list(images), texts):
            adv, info = self.attack_single(image, text)
            adv_texts.append(adv)
            sims.append(info["similarity"])
            changed.append(info["changed"])
            inside.append(info.get("inside_band", False))
        sims = np.asarray(sims)
        return TextAttackResult(
            adv_texts=adv_texts,
            original_texts=list(texts),
            success=sims < self.config.success_threshold,
            final_similarity=sims,
            num_words_changed=np.asarray(changed),
            info={
                "elapsed": time.time() - t0,
                "inside_band": np.asarray(inside),
                "penalty_weight": self.lam,
            },
        )


#: default λ sweep: 0 is the oblivious baseline; the grid is densest around
#: the knee the JAX package's sweep found (λ ∈ [1, 3])
DEFAULT_PENALTY_SWEEP = (0.0, 0.3, 1.0, 1.5, 2.0, 3.0, 10.0)


def run_adaptive_evaluation(
    model: CLIPModel,
    detector,
    images,
    texts: Sequence[str],
    variants: Sequence[Sequence[str]],
    refs,
    clean_scores: np.ndarray,
    base: str = "pgd",
    query_pool: Optional[Sequence[str]] = None,
    sweep: Sequence[float] = DEFAULT_PENALTY_SWEEP,
    attack_config: Optional[AdaptiveAttackConfig] = None,
    score_batch=None,
    gallery_feats=None,
    variant_sampler=None,
    eot_samples: int = 4,
    strong_steps: int = 500,
    probe_score_batch=None,
    probe_threshold: Optional[float] = None,
    attacker_probe_feats=None,
    probe_weight: float = 3.0,
) -> Dict[str, Any]:
    """Full adaptive-attack evaluation against a calibrated detector.

    Calibrates the clean band from ``clean_scores`` quantiles (0.5 % and
    99.5 %), then for each λ in ``sweep`` runs the defense-aware attack
    and reports:

    * ``attack_success_rate``: the base objective still succeeds (pgd: cos
      < 0.3; hubness: mean query sim > 0.5);
    * ``detection_rate``: fraction flagged outside the calibrated band by
      the production scoring path (``score_batch(adv_images) -> scores``,
      by default ``detector.detect_batch``: fresh defender variants);
    * ``auroc_band``: AUROC of the band-distance anomaly score
      max(s - hi, lo - s);
    * ``evasion_success_rate``: attack succeeded and not detected.

    After the sweep a strong pass re-attacks at the λ with the best evasion
    rate with ``strong_steps`` steps and, when ``variant_sampler`` (a
    zero-argument callable returning one fresh [B][V] variant draw) is
    given, expectation over ``eot_samples`` defender variant draws; its
    row lands in ``out["strong"]``.

    Hub-probe evaluation: ``probe_score_batch(adv_images) -> scores`` and
    ``probe_threshold`` score every row with the probe branch active;
    ``attacker_probe_feats`` arms a counter-adaptive strong pass
    (``out["strong_vs_probe"]``) that also penalizes the attacker's own draw
    from the probe caption distribution at ``probe_weight``."""
    from tvc_torch.metrics import DetectionEvaluator

    clean_scores = np.asarray(clean_scores)
    lo = float(np.quantile(clean_scores, 0.005))
    hi = float(np.quantile(clean_scores, 0.995))
    cfg = attack_config or AdaptiveAttackConfig()
    cfg = dataclasses.replace(cfg, base=base, band_lower=lo, band_upper=hi)
    attacker = AdaptiveAttacker(model, cfg)

    if score_batch is None:
        score_batch = lambda adv: detector.detect_batch(adv, list(texts)).aggregated_score  # noqa: E731

    def band_dist(s):
        return np.maximum(s - hi, lo - s)

    n = len(texts)
    labels = np.concatenate([np.zeros(n), np.ones(n)])

    def eval_attack(res) -> Dict[str, Any]:
        adv_scores = np.asarray(_np(score_batch(res.adv_images)))
        detected = band_dist(adv_scores) > 0
        auroc = DetectionEvaluator.auroc(labels, np.concatenate([band_dist(clean_scores), band_dist(adv_scores)]))
        success = res.success
        probe_cols: Dict[str, Any] = {}
        if probe_score_batch is not None and probe_threshold is not None:
            ps = np.asarray(_np(probe_score_batch(res.adv_images)))
            det_p = detected | (ps > probe_threshold)
            probe_cols = {
                "mean_hub_probe_score": float(np.mean(ps)),
                "detection_rate_with_hub_probe": float(np.mean(det_p)),
                "evasion_with_hub_probe": float(np.mean(success & ~det_p)),
            }
        return {
            **probe_cols,
            "attack_success_rate": float(np.mean(success)),
            "detection_rate": float(np.mean(detected)),
            "auroc_band": float(auroc),
            "evasion_success_rate": float(np.mean(success & ~detected)),
            "mean_final_similarity": float(np.mean(res.final_similarity)),
            "mean_aggregated": float(np.mean(adv_scores)),
            "inside_band_rate_selfscored": float(np.mean(res.info["inside_band"])),
            **(
                {"mean_hubness_score": float(np.mean(res.info["hubness_scores"]))}
                if res.info.get("hubness_scores") is not None
                else {}
            ),
        }

    out: Dict[str, Any] = {
        "band": [lo, hi],
        "base": base,
        "epsilon": cfg.epsilon,
        "num_steps": cfg.num_steps,
        "sweep": {},
    }
    for lam in sweep:
        res = attacker.attack(
            images, texts, variants, refs,
            query_pool=query_pool, penalty_weight=lam, gallery_feats=gallery_feats,
        )
        out["sweep"][str(lam)] = eval_attack(res)

    if strong_steps and strong_steps > cfg.num_steps:
        # best λ for the attacker = highest evasion, ties broken toward
        # lower band-AUROC (harder for the defense)
        rows = [(k, v) for k, v in out["sweep"].items() if float(k) > 0]
        best_lam = float(
            max(rows, key=lambda kv: (kv[1]["evasion_success_rate"], -kv[1]["auroc_band"]))[0]
        )
        eot = [variant_sampler() for _ in range(eot_samples)] if variant_sampler is not None else None
        strong_attacker = AdaptiveAttacker(model, dataclasses.replace(cfg, num_steps=int(strong_steps)))
        res = strong_attacker.attack(
            images, texts, variants, refs,
            query_pool=query_pool, penalty_weight=best_lam, gallery_feats=gallery_feats, variant_samples=eot,
        )
        out["strong"] = {
            "penalty_weight": best_lam,
            "num_steps": int(strong_steps),
            "eot_samples": len(eot) if eot else 1,
            **eval_attack(res),
        }

        if attacker_probe_feats is not None and probe_score_batch is not None and probe_threshold is not None:
            # counter-adaptive: the attacker also suppresses its own draw
            # from the probe caption distribution
            cfg_vs = dataclasses.replace(cfg, num_steps=int(strong_steps), probe_weight=float(probe_weight))
            res = AdaptiveAttacker(model, cfg_vs).attack(
                images, texts, variants, refs,
                query_pool=query_pool, penalty_weight=best_lam, gallery_feats=gallery_feats, variant_samples=eot,
                probe_feats=attacker_probe_feats, probe_threshold=probe_threshold,
            )
            out["strong_vs_probe"] = {
                "penalty_weight": best_lam,
                "probe_weight": float(probe_weight),
                "num_steps": int(strong_steps),
                "eot_samples": len(eot) if eot else 1,
                **eval_attack(res),
            }
    return out
