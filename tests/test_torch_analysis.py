"""tvc_torch's analysis layer (``tvc_torch/analysis``), first-party UMAP and
visualization against the JAX package's on shared result JSONs: family
detection and tables, key findings, the markdown report and the LaTeX text
equal; charts with the same names; ``--no-charts`` and the module imports
where matplotlib is missing."""

import importlib
import json
import sys
import time

import matplotlib.pyplot  # noqa: F401  (imported at collection: seconds)
import numpy as np
import pytest

import tvc.analysis.families as jfam
import tvc.analysis.run_analysis as jra
import tvc.utils.umap_lite as jumap
import tvc_torch.analysis.families as fam
import tvc_torch.analysis.run_analysis as ra
import tvc_torch.utils.umap_lite as umap
from tvc_torch.analysis import (
    UnifiedAnalysisRunner,
    generate_charts,
    generate_comprehensive_report,
    generate_latex_tables,
)


def _results(seed=0):
    """One harness result per family, in the layouts the harness writes."""
    rng = np.random.default_rng(seed)
    r = lambda: float(rng.random())  # noqa: E731
    attacks = ["pgd", "hubness"]
    s1 = {a: {"attack_success_rate": r(), "retrieval_accuracy_under_attack": r()} for a in attacks}
    s4 = {a: {"detection_rate": r(), "defense_success_rate": r(), "auroc": r()} for a in attacks}
    four = {
        "experiment": "four_scenarios", "attacks": attacks, "num_samples": 8,
        "scenarios": {"scenario_1": s1, "scenario_2": {"retrieval_accuracy": r()},
                      "scenario_3": {"false_positive_rate": r(), "defense_overhead": r(),
                                     "retrieval_precision_preserved": r()},
                      "scenario_4": s4},
        "epsilon_sweep": {"pgd": {f"{e}/255": {"auroc": 0.5 + r() / 2, "detection_rate": r(),
                                               "attack_success_similarity": r(), "attack_success_retrieval": r()}
                                  for e in (2, 4, 8)}},
    }
    defense = {"defense_effectiveness": {a: {"auroc": r(), "accuracy": r(), "f1": r(), "fpr_at_95_tpr": r(),
                                             "optimal_threshold": r()} for a in attacks},
               "figures": []}
    baseline = {"baseline_comparison": {m: {"auroc": r(), "f1": r(), "accuracy": r(),
                                            "detection_enabled": m != "no_defense"}
                                        for m in ("no_defense", "random_text_variants", "tvc_full")},
                "significance_vs_tvc_full": {"no_defense": {"test": "wilcoxon", "p_value": r(),
                                                            "significant": True, "auroc_delta": r()}}}
    ablation = {"ablation_study": {v: {"auroc": r(), "f1": r(), "throughput_qps": 100 * r(),
                                       "components": {"text_variants": True}}
                                   for v in ("full", "no_text_variants", "consistency_only")}}
    efficiency = {"efficiency_analysis": {s: {"mean_s": r(), "per_query_ms": 10 * r()}
                                          for s in ("text_augment", "detection", "end_to_end")},
                  "hardware": {"platform": "gpu"}, "num_samples": 8, "profiler_trace_dir": "t"}
    adaptive = {"adaptive_attack": {
        "pgd": {"sweep": {str(lam): {"attack_success_rate": r(), "detection_rate": r(), "auroc_band": r(),
                                     "evasion_success_rate": r(), "evasion_with_hub_probe": r()}
                          for lam in (0.0, 2.0, 10.0)},
                "strong": {"num_steps": 20, "eot_samples": 4, "penalty_weight": 2.0, "attack_success_rate": r(),
                           "detection_rate": r(), "auroc_band": r(), "evasion_success_rate": r()}},
        "hub_probe": {"threshold": r(), "pool_size": 64, "top_m": 8},
        "text": {"sweep": {"0.0": {"attack_success_rate": r(), "detection_rate": r(), "evasion_success_rate": r()}}},
    }}
    cross = {"cross_dataset": {"source": "coco_captions", "target": "synthetic", "auroc": r(),
                               "detection_rate": r(), "false_positive_rate": r(), "calibrated_threshold": r()}}
    retrieval = {"retrieval_quality": {"clean": {"recall_at_k": {"1": r()}, "mAP": r(), "MRR": r()}}}
    comprehensive = {"four_scenarios": four, **defense, **ablation, **efficiency}
    other = {"some_metric": r(), "nested": {"value": r(), "flag": True}, "label": "x"}
    return {"four_scenarios_1": four, "defense_effectiveness_2": defense, "baseline_comparison_3": baseline,
            "ablation_study_4": ablation, "efficiency_analysis_5": efficiency, "adaptive_attack_6": adaptive,
            "cross_dataset_7": cross, "retrieval_quality_8": retrieval, "comprehensive_9": comprehensive,
            "other_10": other}


@pytest.fixture
def results_dir(tmp_path):
    d = tmp_path / "results"
    (d / "sub").mkdir(parents=True)
    for i, (name, res) in enumerate(_results().items()):
        (d / ("sub" if i % 2 else "") / f"{name}.json").write_text(json.dumps(res))
    (d / "broken.json").write_text("{not json")
    (d / "list.json").write_text("[1, 2]")
    return d


@pytest.mark.parametrize("name", list(_results()))
def test_families_equal_jax(name):
    res = _results()[name]
    assert fam.detect_family(res) == jfam.detect_family(res)
    got, want = fam.split_comprehensive(res), jfam.split_comprehensive(res)
    assert got == want
    for f, sub in got:
        assert fam.build_table(f, sub) == jfam.build_table(f, sub)
    assert fam.FAMILIES == jfam.FAMILIES and set(fam.TABLE_BUILDERS) == set(jfam.TABLE_BUILDERS)


def test_parse_and_key_findings_equal_jax(results_dir):
    got, want = ra.load_results(str(results_dir)), jra.load_results(str(results_dir))
    assert got == want and len(got) == 10
    parsed = ra.parse_results(got)
    assert parsed == jra.parse_results(want)
    assert fam.key_findings(parsed) == jfam.key_findings(parsed) and len(fam.key_findings(parsed)) >= 5


def test_report_and_latex_text_equal_jax(results_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(time, "strftime", lambda *a: "2026-01-01 00:00:00")
    results = ra.load_results(str(results_dir))
    for gen in ("generate_comprehensive_report", "generate_latex_tables"):
        got = getattr(ra, gen)(results, str(tmp_path / "t" / gen))
        want = getattr(jra, gen)(results, str(tmp_path / "j" / gen))
        assert open(got).read() == open(want).read(), gen
    assert "\\begin{tabular}" in (tmp_path / "t" / "generate_latex_tables").read_text()


def test_runner_and_charts_equal_jax(tmp_path):
    d = tmp_path / "results"
    d.mkdir()
    for name in ("four_scenarios_1", "ablation_study_4"):  # two families: each chart costs ~0.1 s a side
        (d / f"{name}.json").write_text(json.dumps(_results()[name]))
    got = UnifiedAnalysisRunner(str(d), str(tmp_path / "t")).run(charts=True)
    want = jra.UnifiedAnalysisRunner(str(d), str(tmp_path / "j")).run(charts=True)
    for k in ("num_experiments", "families", "key_findings", "sources"):
        assert got[k] == want[k], k
    assert [p.rsplit("/", 1)[1] for p in got["charts"]] == [p.rsplit("/", 1)[1] for p in want["charts"]]
    assert got["charts"] and all(open(p, "rb").read(4) == b"\x89PNG" for p in got["charts"])
    assert json.loads((tmp_path / "t" / "index.json").read_text())["families"] == got["families"]


def test_umap_lite_equals_jax():
    x = np.random.default_rng(0).standard_normal((60, 12)).astype(np.float32)
    got = umap.umap_embed(x, n_components=2, seed=0, n_epochs=50)
    want = jumap.umap_embed(x, n_components=2, seed=0, n_epochs=50)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_without_matplotlib_no_charts_runs_and_drawing_raises(results_dir, tmp_path, monkeypatch):
    for name in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    import tvc_torch.utils.visualization as viz

    viz = importlib.reload(viz)  # the module imports without matplotlib
    index = UnifiedAnalysisRunner(str(results_dir), str(tmp_path / "out")).run(charts=False)
    assert index["charts"] == [] and (tmp_path / "out" / "comprehensive_report.md").exists()
    with pytest.raises(ImportError):
        generate_charts(ra.load_results(str(results_dir)), str(tmp_path / "charts"))
    with pytest.raises(ImportError):
        viz.VisualizationManager(str(tmp_path / "v")).plot_metric_bars({"a": 1.0})
    assert generate_comprehensive_report and generate_latex_tables


def test_visualization_draws_every_figure(tmp_path):
    from tvc_torch.utils.visualization import ExperimentVisualizer, VisualizationManager

    assert ExperimentVisualizer is VisualizationManager
    v = VisualizationManager(str(tmp_path))
    rng = np.random.default_rng(0)
    labels = np.r_[np.zeros(20), np.ones(20)]
    scores = labels + rng.standard_normal(40)
    paths = [
        v.plot_roc_curve(labels, scores), v.plot_pr_curve(labels, scores),
        v.plot_score_distribution(scores[:20], scores[20:], threshold=0.5),
        v.plot_embeddings(rng.standard_normal((40, 8)), labels.astype(int), method="umap"),
        v.plot_roc_family({"a": {"fpr": [0, 0.5, 1], "tpr": [0, 0.8, 1]}}),
        v.plot_lines([0, 1, 2], {"s": [0.1, 0.2, 0.3]}, logx=True),
        v.plot_confusion_matrix(np.array([[5, 1], [2, 7]])),
        v.plot_metric_bars({"a": 0.5, "b": 0.9}), v.plot_grouped_bars({"x": {"a": 0.1}, "y": {"a": 0.2}}),
        v.plot_dashboard({"p": {"a": 0.3}, "q": {"b": 0.4}}),
    ]
    assert all(open(p, "rb").read(4) == b"\x89PNG" for p in paths)
