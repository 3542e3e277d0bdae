"""Standalone config-driven runners.

Covers reference experiments/runners/: AttackRunner (run_attack.py:32:
attack sweeps over datasets with all attack types :64-97), DetectionRunner
(run_detection.py:34: detection eval with ablation support :244),
AblationRunner (run_ablation.py:58: component on/off grid + statistical
significance :205-390). Port of ``tvc/experiments/runners.py`` over the
port's harness (``HarnessConfig.device``: the card unless ``"cpu"``).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Sequence

import numpy as np

from tvc_torch.experiments.harness import ABLATION_VARIANTS, ExperimentHarness, HarnessConfig
from tvc_torch.metrics import DetectionEvaluator


class AttackRunner:
    """Sweep every configured attack over the dataset (reference
    run_attack.py:32-200)."""

    ATTACKS = ("pgd", "fgsm", "cw", "fsta", "sma", "hubness", "text")

    def __init__(self, config: Optional[HarnessConfig] = None):
        self.harness = ExperimentHarness(config or HarnessConfig())

    def run(self, attacks: Optional[Sequence[str]] = None) -> Dict[str, Any]:
        from tvc_torch.attacks import (
            CWAttackConfig,
            CWAttacker,
            FGSMAttacker,
            FSTAAttacker,
            HubnessAttack,
            HubnessAttackConfig,
            PGDAttacker,
            SMAAttacker,
            TextAttacker,
        )

        h = self.harness
        fast = h.config.clip_model == "tiny"
        model = h.model
        images, texts = h.images, list(h.texts)
        makers = {
            "pgd": lambda: PGDAttacker(model),
            "fgsm": lambda: FGSMAttacker(model),
            "cw": lambda: CWAttacker(
                model, CWAttackConfig(max_iterations=50 if fast else 1000,
                                      binary_search_steps=3 if fast else 9)
            ),
            "fsta": lambda: FSTAAttacker(model),
            "sma": lambda: SMAAttacker(model),
            "hubness": lambda: HubnessAttack(
                model,
                HubnessAttackConfig(
                    num_iterations=50 if fast else 500,
                    num_target_queries=min(16, len(texts)),
                ),
            ),
            "text": lambda: TextAttacker(model),
        }
        out = {}
        for name in attacks or self.ATTACKS:
            if name not in makers:
                raise ValueError(f"unknown attack {name!r}")
            attacker = makers[name]()
            t0 = time.time()
            if name == "hubness":
                result = attacker.attack(images, texts=texts)
            elif name == "text":
                result = attacker.attack(list(images), texts)
            else:
                result = attacker.attack(images, texts)
            out[name] = {
                "success_rate": result.success_rate,
                "mean_final_similarity": float(np.mean(result.final_similarity)),
                "elapsed_s": time.time() - t0,
            }
            if hasattr(result, "perturbation_linf"):
                out[name]["mean_linf"] = float(np.mean(result.perturbation_linf))
        return {"attack_sweep": out, "num_samples": len(texts)}


class DetectionRunner:
    """Detection evaluation with optional component ablation (reference
    run_detection.py:34-300)."""

    def __init__(self, config: Optional[HarnessConfig] = None):
        self.harness = ExperimentHarness(config or HarnessConfig())

    def run(self, variant: str = "full") -> Dict[str, Any]:
        if variant not in ABLATION_VARIANTS:
            raise ValueError(f"unknown variant {variant!r}")
        h = self.harness
        flags = ABLATION_VARIANTS[variant]
        pipe = h.make_pipeline(**{
            "text_variants": flags["text_variants"],
            "retrieval": flags["retrieval"],
            "generative": flags["generative"],
        })
        adv = h._adv_images(h.config.attacks[0])
        clean_s = pipe.process_batch(h.images, list(h.texts)).scores
        adv_s = pipe.process_batch(adv, list(h.texts)).scores
        labels = np.concatenate([np.zeros(len(clean_s)), np.ones(len(adv_s))])
        m = DetectionEvaluator.evaluate(labels, np.concatenate([clean_s, adv_s]))
        return {
            "variant": variant,
            "auroc": m.auroc,
            "f1": m.f1,
            "accuracy": m.accuracy,
            "fpr_at_95_tpr": m.fpr_at_95_tpr,
        }


class AblationRunner:
    """Full grid + significance vs the full system (reference
    run_ablation.py:58-390)."""

    def __init__(self, config: Optional[HarnessConfig] = None):
        self.harness = ExperimentHarness(config or HarnessConfig())

    def run(self) -> Dict[str, Any]:
        from tvc_torch.evaluation import ExperimentConfig, ExperimentEvaluator

        h = self.harness
        adv = h._adv_images(h.config.attacks[0])
        labels = np.concatenate([np.zeros(len(h.texts)), np.ones(len(h.texts))])
        scores = {}
        for name, flags in ABLATION_VARIANTS.items():
            pipe = h.make_pipeline(
                text_variants=flags["text_variants"],
                retrieval=flags["retrieval"],
                generative=flags["generative"],
            )
            clean_s = pipe.process_batch(h.images, list(h.texts)).scores
            adv_s = pipe.process_batch(adv, list(h.texts)).scores
            scores[name] = np.concatenate([clean_s, adv_s])
        ev = ExperimentEvaluator(ExperimentConfig(n_folds=4, n_bootstrap=100))
        results = {}
        for name, s in scores.items():
            m = DetectionEvaluator.evaluate(labels, s)
            entry = {"auroc": m.auroc, "f1": m.f1}
            if name != "full":
                entry["vs_full"] = ev.compare_methods(
                    labels, scores["full"], s, "full", name
                )
            results[name] = entry
        return {"ablation": results}
