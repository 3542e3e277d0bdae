"""Post-hoc analysis: scan result JSONs -> family-aware markdown report +
charts + dashboard + LaTeX tables/document + summary index.

Covers reference analysis/ (UnifiedAnalysisRunner run_analysis.py:34-374,
generate_comprehensive_report.py — per-family parsers/tables + key
findings, generate_charts.py — per-family charts + summary dashboard,
generate_latex_tables.py — per-family booktabs tables + comprehensive
LaTeX document). Port of ``tvc/analysis/run_analysis.py``: charts go through
the port's ``VisualizationManager``, which imports matplotlib only when it
draws (``charts=False`` needs none).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from tvc_torch.analysis.families import (
    build_table,
    key_findings,
    split_comprehensive,
)

Parsed = Tuple[str, str, List[Dict[str, Any]]]  # (family, name, rows)


def _flatten(d: Dict[str, Any], prefix: str = "") -> Dict[str, float]:
    out = {}
    for k, v in d.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            out[key] = float(v)
    return out


def load_results(results_dir: str) -> List[Dict[str, Any]]:
    """Collect every experiment-result JSON under the directory."""
    out = []
    for p in sorted(Path(results_dir).rglob("*.json")):
        try:
            data = json.loads(p.read_text())
        except (json.JSONDecodeError, OSError):
            continue
        if isinstance(data, dict):
            data["_source"] = str(p)
            out.append(data)
    return out


def parse_results(results: List[Dict[str, Any]]) -> List[Parsed]:
    """Family-aware parse of every loaded result (comprehensive-mode
    results contribute one entry per nested mode)."""
    parsed: List[Parsed] = []
    for res in results:
        base = Path(res.get("_source", "result")).stem
        body = {k: v for k, v in res.items() if not k.startswith("_")}
        for fam, sub in split_comprehensive(body):
            rows = build_table(fam, sub)
            if rows:
                parsed.append((fam or "other", f"{base}", rows))
    return parsed


def _md_table(rows: List[Dict[str, Any]]) -> List[str]:
    cols: List[str] = []
    for r in rows:
        for k in r:
            if k not in cols:
                cols.append(k)
    def cell(v: Any) -> str:
        if v is None:
            return "--"
        if isinstance(v, float):
            return f"{v:.4f}"
        return str(v)
    lines = ["| " + " | ".join(cols) + " |", "|" + "---|" * len(cols)]
    lines += ["| " + " | ".join(cell(r.get(c)) for c in cols) + " |" for r in rows]
    return lines


def generate_comprehensive_report(
    results: List[Dict[str, Any]], output_path: str
) -> str:
    """Family-aware MD report with per-family tables + key findings
    (reference generate_comprehensive_report.py)."""
    parsed = parse_results(results)
    lines = ["# Comprehensive experiment report", ""]
    lines.append(f"Generated: {time.strftime('%Y-%m-%d %H:%M:%S')}")
    lines.append(f"Experiments analyzed: {len(results)}")
    lines.append("")
    findings = key_findings(parsed)
    if findings:
        lines.append("## Key findings")
        lines += [f"- {f}" for f in findings]
        lines.append("")
    for fam, name, rows in parsed:
        lines.append(f"## {fam} — {name}")
        lines += _md_table(rows)
        lines.append("")
    # unrecognized results still get their flat metrics
    for res in results:
        body = {k: v for k, v in res.items() if not k.startswith("_")}
        if split_comprehensive(body):
            continue
        flat = _flatten(body)
        if not flat:
            continue
        lines.append(f"## other — {Path(res['_source']).stem}")
        lines += [f"- {k}: {v:.4f}" for k, v in sorted(flat.items())[:40]]
        lines.append("")
    Path(output_path).parent.mkdir(parents=True, exist_ok=True)
    Path(output_path).write_text("\n".join(lines))
    return output_path


def generate_charts(results: List[Dict[str, Any]], output_dir: str) -> List[str]:
    """Per-family charts + one summary dashboard (reference
    generate_charts.py:187-558)."""
    from tvc_torch.utils.visualization import VisualizationManager

    viz = VisualizationManager(output_dir)
    parsed = parse_results(results)
    paths = []
    panels: Dict[str, Dict[str, float]] = {}
    for i, (fam, name, rows) in enumerate(parsed):
        metrics: Dict[str, float] = {}
        for r in rows:
            label = (
                r.get("attack") or r.get("baseline") or r.get("variant")
                or r.get("stage") or ""
            )
            for k in ("auroc", "detection_rate", "per_query_ms", "throughput_qps"):
                if isinstance(r.get(k), (int, float)):
                    metrics[f"{label}" if len(rows) > 1 else k] = float(r[k])
                    break
        if metrics:
            paths.append(viz.plot_metric_bars(metrics, name=f"chart_{fam}_{i}"))
            panels[f"{fam}"] = dict(list(metrics.items())[:6])
    if panels:
        paths.append(viz.plot_dashboard(panels, name="summary_dashboard"))
    return paths


_LATEX_CAPTIONS = {
    "four_scenarios": "Four-scenarios protocol results",
    "defense_effectiveness": "Defense effectiveness per attack",
    "baseline_comparison": "Baseline comparison",
    "ablation_study": "Ablation study",
    "efficiency_analysis": "Efficiency analysis (per-stage timing)",
    "adaptive_attack": "Adaptive (defense-aware) attacker sweep",
    "epsilon_sweep": "Detection quality vs perturbation budget",
}


def _latex_table(fam: str, rows: List[Dict[str, Any]]) -> List[str]:
    cols: List[str] = []
    for r in rows:
        for k in r:
            if k not in cols:
                cols.append(k)
    def esc(s: str) -> str:
        return str(s).replace("_", r"\_").replace("%", r"\%")
    def cell(v: Any) -> str:
        if v is None:
            return "--"
        if isinstance(v, float):
            return f"{v:.3f}"
        return esc(v)
    lines = [
        r"\begin{table}[t]",
        r"\centering",
        rf"\caption{{{_LATEX_CAPTIONS.get(fam, esc(fam))}}}",
        r"\begin{tabular}{l" + "c" * (len(cols) - 1) + "}",
        r"\toprule",
        " & ".join(esc(c) for c in cols) + r" \\",
        r"\midrule",
    ]
    lines += [" & ".join(cell(r.get(c)) for c in cols) + r" \\" for r in rows]
    lines += [r"\bottomrule", r"\end{tabular}", r"\end{table}"]
    return lines


def generate_latex_tables(
    results: List[Dict[str, Any]], output_path: str
) -> str:
    """Per-family booktabs tables wrapped in a compilable document
    (reference generate_latex_tables.py:168-453 + :391 comprehensive
    document)."""
    parsed = parse_results(results)
    lines = [
        r"% generated by tvc-analyze",
        r"\documentclass{article}",
        r"\usepackage{booktabs}",
        r"\begin{document}",
        "",
    ]
    for fam, name, rows in parsed:
        lines.append(rf"% {fam}: {name}")
        lines += _latex_table(fam, rows)
        lines.append("")
    lines.append(r"\end{document}")
    Path(output_path).parent.mkdir(parents=True, exist_ok=True)
    Path(output_path).write_text("\n".join(lines))
    return output_path


class UnifiedAnalysisRunner:
    """(reference analysis/run_analysis.py:34-374)"""

    def __init__(self, results_dir: str = "./results", output_dir: Optional[str] = None):
        self.results_dir = results_dir
        self.output_dir = Path(output_dir or (Path(results_dir) / "analysis"))

    def run(self, charts: bool = True) -> Dict[str, Any]:
        results = load_results(self.results_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        report = generate_comprehensive_report(
            results, str(self.output_dir / "comprehensive_report.md")
        )
        latex = generate_latex_tables(
            results, str(self.output_dir / "tables.tex")
        )
        chart_paths = (
            generate_charts(results, str(self.output_dir / "charts")) if charts else []
        )
        parsed = parse_results(results)
        index = {
            "generated": time.time(),
            "num_experiments": len(results),
            "families": sorted({fam for fam, _, _ in parsed}),
            "key_findings": key_findings(parsed),
            "report": report,
            "latex": latex,
            "charts": chart_paths,
            "sources": [r["_source"] for r in results],
        }
        (self.output_dir / "index.json").write_text(json.dumps(index, indent=2))
        return index
