"""Experiment-family-aware result parsing for the analysis layer.

The reference's analysis tools are family-aware — separate parsers,
tables, charts, and LaTeX per experiment mode
(reference analysis/generate_comprehensive_report.py:100-215
``_parse_{defense_effectiveness,baseline_comparison,ablation_studies,
efficiency_analysis}``; generate_charts.py:187-533 per-family chart
methods). This module is the tvc equivalent: detect the family of a
result dict and extract a uniform ``[{column: value}]`` row table plus
headline metrics for charts/dashboards.

A "result dict" is either a standalone experiment JSON (harness output)
or one value of a comprehensive-mode JSON (which nests one result per
mode under its mode name).

Port of ``tvc/analysis/families.py``: a copy, pure Python.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

#: families with dedicated parsers, in report order
FAMILIES = (
    "four_scenarios",
    "defense_effectiveness",
    "baseline_comparison",
    "ablation_study",
    "efficiency_analysis",
    "cross_dataset",
    "retrieval_quality",
    "adaptive_attack",
    "epsilon_sweep",
)

_METRIC_KEYS = {"auroc", "accuracy", "f1", "fpr_at_95_tpr", "optimal_threshold"}


def detect_family(res: Dict[str, Any]) -> Optional[str]:
    """Family of a result dict, or None for unrecognized layouts."""
    exp = res.get("experiment") or res.get("experiment_name")
    if isinstance(exp, str):
        for fam in FAMILIES:
            if fam in exp:
                return fam
    if "scenarios" in res and isinstance(res["scenarios"], dict):
        return "four_scenarios"
    vals = [v for v in res.values() if isinstance(v, dict)]
    if vals and all(_METRIC_KEYS.issuperset(v.keys()) or _METRIC_KEYS & set(v.keys()) for v in vals):
        if any("detection_enabled" in v for v in vals):
            return "baseline_comparison"
        if any("throughput_qps" in v for v in vals):
            return "ablation_study"
        if any("per_query_ms" in v for v in vals):
            return "efficiency_analysis"
        if any("auroc" in v for v in vals):
            return "defense_effectiveness"
    return None


def split_comprehensive(res: Dict[str, Any]) -> List[Tuple[str, Dict[str, Any]]]:
    """A comprehensive-mode result nests one result per mode under the
    mode's name (harness.run_comprehensive). Returns [(family, sub)] —
    or [(family, res)] for a standalone result."""
    def _sweep_of(d: Dict[str, Any]) -> List[Tuple[str, Dict[str, Any]]]:
        sw = d.get("epsilon_sweep")
        return [("epsilon_sweep", sw)] if isinstance(sw, dict) and sw else []

    # standalone four-scenarios artifact (has "scenarios" AND a nested
    # epsilon_sweep key — the sweep must not shadow the main table)
    if isinstance(res.get("scenarios"), dict):
        return [("four_scenarios", res)] + _sweep_of(res)
    subs = [
        (fam, res[fam])
        for fam in FAMILIES
        if isinstance(res.get(fam), dict) and res[fam]
    ]
    if subs:
        extra: List[Tuple[str, Dict[str, Any]]] = []
        for fam, sub in subs:
            if fam == "four_scenarios":
                extra += _sweep_of(sub)
        return subs + extra
    fam = detect_family(res)
    return [(fam, res)] if fam else []


# -- per-family tables -------------------------------------------------------


def _fmt_rows(rows: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    return [
        {k: (round(v, 4) if isinstance(v, float) else v) for k, v in r.items()}
        for r in rows
    ]


def four_scenarios_table(res: Dict[str, Any]) -> List[Dict[str, Any]]:
    """One row per attack: ASR (scenario 1) vs detection/AUROC
    (scenario 4), plus the clean-side columns (scenarios 2-3)."""
    sc = res.get("scenarios", {})

    def scenario(n: int, suffix: str) -> Dict[str, Any]:
        # three layouts: scenarios.scenario_N (reference artifact),
        # scenario_N_<suffix> (harness), bare scenario_N (older outputs)
        return (
            sc.get(f"scenario_{n}")
            or res.get(f"scenario_{n}_{suffix}")
            or res.get(f"scenario_{n}")
            or {}
        )

    s1 = scenario(1, "no_defense_with_attack")
    s2 = scenario(2, "no_defense_no_attack")
    s3 = scenario(3, "defense_no_attack")
    s4 = scenario(4, "defense_with_attack")
    attacks = res.get("attacks") or [
        k for k in s4 if isinstance(s4.get(k), dict)
    ]
    rows = []
    for a in attacks:
        a1, a4 = s1.get(a, {}), s4.get(a, {})
        rows.append(
            {
                "attack": a,
                "asr_no_defense": a1.get("attack_success_rate"),
                "retrieval_acc_under_attack": a1.get(
                    "retrieval_accuracy_under_attack"
                ),
                "detection_rate": a4.get("detection_rate"),
                "defense_success": a4.get("defense_success_rate"),
                "auroc": a4.get("auroc"),
            }
        )
    rows.append(
        {
            "attack": "(clean)",
            "clean_retrieval_accuracy": s2.get("retrieval_accuracy"),
            "false_positive_rate": s3.get("false_positive_rate"),
            "defense_overhead": s3.get("defense_overhead"),
            "retrieval_precision_preserved": s3.get(
                "retrieval_precision_preserved"
            ),
        }
    )
    return _fmt_rows(rows)


def defense_effectiveness_table(res: Dict[str, Any]) -> List[Dict[str, Any]]:
    rows = []
    for attack, m in res.items():
        if not isinstance(m, dict) or "auroc" not in m:
            continue
        rows.append(
            {
                "attack": attack,
                "auroc": m.get("auroc"),
                "accuracy": m.get("accuracy"),
                "f1": m.get("f1"),
                "fpr@95tpr": m.get("fpr_at_95_tpr"),
                "threshold": m.get("optimal_threshold"),
            }
        )
    return _fmt_rows(rows)


def baseline_comparison_table(res: Dict[str, Any]) -> List[Dict[str, Any]]:
    rows = []
    for baseline, m in res.items():
        if not isinstance(m, dict) or "auroc" not in m:
            continue
        rows.append(
            {
                "baseline": baseline,
                "auroc": m.get("auroc"),
                "f1": m.get("f1"),
                "accuracy": m.get("accuracy"),
                "detection": bool(m.get("detection_enabled", True)),
            }
        )
    # best-first, matching the reference's ranked table
    rows.sort(key=lambda r: -(r.get("auroc") or 0.0))
    return _fmt_rows(rows)


def ablation_study_table(res: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Per-variant metrics with deltas vs the 'full' configuration
    (reference generate_comprehensive_report.py:308-350)."""
    full = res.get("full", {})
    rows = []
    for variant, m in res.items():
        if not isinstance(m, dict) or "auroc" not in m:
            continue
        row = {
            "variant": variant,
            "auroc": m.get("auroc"),
            "f1": m.get("f1"),
            "throughput_qps": m.get("throughput_qps"),
        }
        if variant != "full" and isinstance(full.get("auroc"), (int, float)):
            row["auroc_delta_vs_full"] = (m.get("auroc") or 0.0) - full["auroc"]
            if isinstance(full.get("throughput_qps"), (int, float)) and full[
                "throughput_qps"
            ]:
                row["speedup_vs_full"] = (
                    (m.get("throughput_qps") or 0.0) / full["throughput_qps"]
                )
        rows.append(row)
    return _fmt_rows(rows)


def efficiency_analysis_table(res: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Per-stage timing with share-of-total (reference
    generate_comprehensive_report.py:351-382)."""
    total = (res.get("end_to_end") or {}).get("per_query_ms")
    rows = []
    for stage, m in res.items():
        if not isinstance(m, dict) or "per_query_ms" not in m:
            continue
        row = {
            "stage": stage,
            "mean_s": m.get("mean_s"),
            "per_query_ms": m.get("per_query_ms"),
        }
        if total and stage != "end_to_end":
            row["share_of_total"] = m["per_query_ms"] / total
        rows.append(row)
    rows.sort(key=lambda r: (r["stage"] == "end_to_end", -(r["per_query_ms"] or 0)))
    return _fmt_rows(rows)


def adaptive_attack_table(res: Dict[str, Any]) -> List[Dict[str, Any]]:
    """One row per (attack base, λ): the defense-aware attacker's
    evasion/effectiveness frontier (harness mode adaptive_attack,
    tvc/attacks/adaptive.py)."""
    rows = []
    for base, r in res.items():
        if not isinstance(r, dict) or "sweep" not in r:
            continue
        for lam, m in sorted(r["sweep"].items(), key=lambda kv: float(kv[0])):
            rows.append(
                {
                    "attack": base,
                    "lambda": float(lam),
                    "attack_success": m.get("attack_success_rate"),
                    "detection_rate": m.get("detection_rate"),
                    "auroc_band": m.get("auroc_band"),
                    "evasion_success": m.get("evasion_success_rate"),
                    **(
                        {"evasion_w_hub_probe": m["evasion_with_hub_probe"]}
                        if "evasion_with_hub_probe" in m
                        else {}
                    ),
                    **(
                        {"mean_hubness_score": m["mean_hubness_score"]}
                        if "mean_hubness_score" in m
                        else {}
                    ),
                }
            )
        for key, label in (
            ("strong", "strong"),
            ("strong_vs_probe", "strong vs probe"),
        ):
            strong = r.get(key)
            if isinstance(strong, dict):
                rows.append(
                    {
                        "attack": f"{base} ({label}: {strong.get('num_steps')} "
                        f"steps, EOT={strong.get('eot_samples')})",
                        "lambda": strong.get("penalty_weight"),
                        "attack_success": strong.get("attack_success_rate"),
                        "detection_rate": strong.get("detection_rate"),
                        "auroc_band": strong.get("auroc_band"),
                        "evasion_success": strong.get("evasion_success_rate"),
                        **(
                            {
                                "evasion_w_hub_probe": strong[
                                    "evasion_with_hub_probe"
                                ]
                            }
                            if "evasion_with_hub_probe" in strong
                            else {}
                        ),
                    }
                )
    return _fmt_rows(rows)


def epsilon_sweep_table(res: Dict[str, Any]) -> List[Dict[str, Any]]:
    """One row per (attack, ε): the de-saturated detection-quality table
    (four_scenarios epsilon_sweep)."""
    rows = []
    for attack, sweeps in res.items():
        if not isinstance(sweeps, dict):
            continue
        for eps_label, m in sweeps.items():
            if not isinstance(m, dict) or "auroc" not in m:
                continue
            rows.append(
                {
                    "attack": attack,
                    "epsilon": eps_label,
                    "auroc": m.get("auroc"),
                    "detection_rate": m.get("detection_rate"),
                    "asr_similarity": m.get("attack_success_similarity"),
                    "asr_retrieval": m.get("attack_success_retrieval"),
                }
            )
    return _fmt_rows(rows)


def generic_table(res: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Fallback: one row of the scalar metrics at the top two levels."""
    row: Dict[str, Any] = {}
    for k, v in res.items():
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            row[k] = v
        elif isinstance(v, dict):
            for k2, v2 in v.items():
                if isinstance(v2, (int, float)) and not isinstance(v2, bool):
                    row[f"{k}.{k2}"] = v2
    return _fmt_rows([row]) if row else []


TABLE_BUILDERS = {
    "four_scenarios": four_scenarios_table,
    "defense_effectiveness": defense_effectiveness_table,
    "baseline_comparison": baseline_comparison_table,
    "ablation_study": ablation_study_table,
    "efficiency_analysis": efficiency_analysis_table,
    "adaptive_attack": adaptive_attack_table,
    "epsilon_sweep": epsilon_sweep_table,
}


def build_table(family: Optional[str], res: Dict[str, Any]) -> List[Dict[str, Any]]:
    return TABLE_BUILDERS.get(family or "", generic_table)(res)


def key_findings(parsed: List[Tuple[str, str, List[Dict[str, Any]]]]) -> List[str]:
    """Cross-experiment key findings (reference
    generate_comprehensive_report.py:433-446 _write_key_findings).

    ``parsed``: [(family, experiment_name, rows)].
    """
    findings: List[str] = []
    aurocs = [
        (name, r.get("attack") or r.get("baseline") or r.get("variant"), r["auroc"])
        for fam, name, rows in parsed
        for r in rows
        if isinstance(r.get("auroc"), (int, float))
    ]
    if aurocs:
        best = max(aurocs, key=lambda t: t[2])
        worst = min(aurocs, key=lambda t: t[2])
        findings.append(
            f"Best AUROC {best[2]:.3f} ({best[1]}, {best[0]}); "
            f"weakest {worst[2]:.3f} ({worst[1]}, {worst[0]})."
        )
    for fam, name, rows in parsed:
        if fam == "four_scenarios":
            for r in rows:
                if r.get("attack") == "(clean)" and r.get("false_positive_rate") is not None:
                    # clean_retrieval_accuracy is None when scenario 2 is
                    # absent (partial/failed runs) — never format None
                    acc = r.get("clean_retrieval_accuracy")
                    acc_s = f"{acc:.3f}" if isinstance(acc, (int, float)) else "n/a"
                    findings.append(
                        f"Clean FPR {r['false_positive_rate']:.3f} at retrieval "
                        f"accuracy {acc_s} ({name})."
                    )
        if fam == "ablation_study":
            deltas = [
                (r["variant"], r["auroc_delta_vs_full"])
                for r in rows
                if r.get("auroc_delta_vs_full") is not None
            ]
            if deltas:
                v, dmin = min(deltas, key=lambda t: t[1])
                findings.append(
                    f"Ablation: removing '{v.replace('no_', '')}' costs the most "
                    f"AUROC ({dmin:+.4f}) — component importance ranking ({name})."
                )
        if fam == "efficiency_analysis":
            stages = [
                (r["stage"], r["per_query_ms"])
                for r in rows
                if r.get("share_of_total") is not None
            ]
            if stages:
                s, ms = max(stages, key=lambda t: t[1])
                findings.append(
                    f"Efficiency: '{s}' dominates at {ms:.2f} ms/query ({name})."
                )
        if fam == "adaptive_attack":
            bands = [
                (r["attack"], r["lambda"], r["auroc_band"])
                for r in rows
                if isinstance(r.get("auroc_band"), (int, float))
            ]
            evas = [
                r.get("evasion_success") or 0.0
                for r in rows
                if r.get("evasion_success") is not None
            ]
            if bands:
                a, lam, worst = min(bands, key=lambda t: t[2])
                findings.append(
                    f"Adaptive attacker: band AUROC drops to {worst:.3f} "
                    f"({a}, λ={lam:g}); peak joint evasion success "
                    f"{max(evas):.3f} ({name})."
                )
        if fam == "epsilon_sweep":
            soft = [
                (r["attack"], r["epsilon"], r["auroc"])
                for r in rows
                if isinstance(r.get("auroc"), (int, float)) and r["auroc"] < 0.99
            ]
            if soft:
                a, eps, v = min(soft, key=lambda t: t[2])
                findings.append(
                    f"ε-sweep: detection de-saturates below {eps} "
                    f"(AUROC {v:.3f} for {a}) — the benchmark discriminates "
                    f"detector variants there ({name})."
                )
    return findings
