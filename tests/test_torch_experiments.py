"""tvc_torch's experiment harness (``tvc_torch/experiments``) against the JAX
package's ``tvc/experiments``: the command line and the experiment YAMLs
give equal configs, the seeded splits and the random-variant baseline are
equal draw for draw, the markdown report is equal text, and the
four-scenarios protocol on the same tiny_coco weights, bank, captions and
adversarial images (both packages' ``generate_adversarial`` return the same
numpy arrays, since the attacks' random starts differ) gives scores within
2e-5, equal flags and counts, and AUROC, rates and bootstrap CIs within 1e-6
once the score order agrees."""

import dataclasses
import zlib
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import tvc.experiments.four_scenarios as jfs
import tvc.experiments.harness as jh
from tvc.attacks.common import AttackResult as JAttackResult
from tvc.augment import TextAugmentConfig as JAugConfig, TextAugmenter as JAugmenter
from tvc.data import DataConfig as JDataConfig, DataLoaderManager as JDataLoaderManager
from tvc.experiments.four_scenarios import (
    FourScenariosConfig as JFSConfig,
    FourScenariosExperiment as JFSExperiment,
)
from tvc.models.clip import CLIPConfig as JClipConfig, CLIPModel as JClip
from tvc.pipeline import MultiModalDetectionPipeline as JPipeline, PipelineConfig as JPipeConfig
from tvc.retrieval import MultiModalRetriever as JRetriever
import tvc_torch.experiments.harness as th
from tvc_torch.attacks.common import AttackResult
from tvc_torch.augment import TextAugmentConfig, TextAugmenter
from tvc_torch.data import DataConfig, DataLoaderManager
from tvc_torch.experiments import (
    ABLATION_VARIANTS,
    BASELINE_METHODS,
    ExperimentHarness,
    FourScenariosConfig,
    FourScenariosExperiment,
    HarnessConfig,
    parse_args,
)
from tvc_torch.experiments.four_scenarios import measure_serving_overhead, serving_overhead_steps
from tvc_torch.models.clip import CLIPConfig, CLIPModel, params_from_jax
from tvc_torch.pipeline import MultiModalDetectionPipeline, PipelineConfig
from tvc_torch.retrieval import MultiModalRetriever

REPO = Path(__file__).resolve().parent.parent
EXPERIMENTS = sorted(str(p.relative_to(REPO)) for p in (REPO / "configs" / "experiments").glob("*.yaml"))


def _port_config(cfg: HarnessConfig) -> dict:
    d = dataclasses.asdict(cfg)
    assert d.pop("device") is None
    return d


def test_harness_config_has_the_jax_fields_and_device():
    want = [f.name for f in dataclasses.fields(jh.HarnessConfig)]
    assert [f.name for f in dataclasses.fields(HarnessConfig)] == want + ["device"]
    assert _port_config(HarnessConfig()) == dataclasses.asdict(jh.HarnessConfig())
    assert BASELINE_METHODS == jh.BASELINE_METHODS and ABLATION_VARIANTS == jh.ABLATION_VARIANTS
    assert sorted(ExperimentHarness.MODES) == sorted(jh.ExperimentHarness.MODES)


@pytest.mark.parametrize("path", EXPERIMENTS)
def test_experiment_yaml_gives_the_jax_config(path):
    argv = ["--config", path]
    assert _port_config(parse_args(argv)) == dataclasses.asdict(jh.parse_args(argv))


PRECEDENCE = (
    # tests/test_fixtures.py's case: explicitly passed flags win over the YAML
    ["--config", "configs/experiments/coco_pgd_full.yaml", "--dataset", "synthetic", "--clip-model", "tiny",
     "--num-samples", "8", "--bank-size", "64"],
    ["--config", "configs/experiments/coco_hubness_full.yaml", "--dataset", "synthetic", "--clip-model", "tiny",
     "--num-samples", "8", "--bank-size", "64"],
    ["--config", "configs/experiments/ablation_fixed_threshold.yaml", "--attacks", "fgsm", "cw", "--seed", "3"],
    ["--config", "configs/experiments/efficiency_profile.yaml", "--experiment-mode", "four_scenarios",
     "--batch-size", "16", "--output-dir", "elsewhere"],
    ["--experiment-mode", "cross_dataset", "--target-dataset", "synthetic", "--resume", "--checkpoint-dir", "ck"],
    ["--use-sd", "--use-qwen", "--data-dir", "d", "--attacks", "pgd"],
    [],
)


@pytest.mark.parametrize("argv", PRECEDENCE, ids=range(len(PRECEDENCE)))
def test_flag_precedence_gives_the_jax_config(argv):
    got = parse_args(argv)
    assert _port_config(got) == dataclasses.asdict(jh.parse_args(argv))
    assert parse_args(argv + ["--device", "cpu"]).device == "cpu"


def test_apply_experiment_config_equals_jax():
    loaded = {
        "dataset": "flickr30k", "experiment": {"mode": "cross_dataset", "target_dataset": "coco", "num_samples": 9},
        "data": {"base_dir": "/d"}, "experiments": {"seed": 5, "output_dir": "o"}, "batch": {"default_size": 12},
        "models": {"clip": {"default_model": "ViT-L/14"}},
        "attack": {"type": "fgsm", "epsilon": 0.1},
        "defense": {"text_variants": {"num_variants": 3}, "retrieval_reference": {"top_k": 4},
                    "generative_reference": {"num_images": 1},
                    "detector": {"detection_threshold": 0.7, "score_aggregation": "max", "weights": [0.5, 0.3, 0.2]}},
    }
    got, want = HarnessConfig(), jh.HarnessConfig()
    th.apply_experiment_config(got, loaded)
    jh.apply_experiment_config(want, loaded)
    assert _port_config(got) == dataclasses.asdict(want)


def test_random_variant_augmenter_equals_jax():
    texts = chip_smoke.coco_captions(12)
    a, b = th.RandomVariantAugmenter(seed=7), jh.RandomVariantAugmenter(seed=7)
    assert a.batch_generate_variants(texts, 5) == b.batch_generate_variants(texts, 5)
    assert a.generate_variants(texts[0], 3) == b.generate_variants(texts[0], 3)


def _bare(harness_cls, cfg, mgr):
    """A harness with only what the pool splits read (no model)."""
    h = object.__new__(harness_cls)
    h.config, h._data_mgr = cfg, mgr
    h.texts = next(mgr.load_dataset().batches(batch_size=cfg.num_samples))["texts"]
    return h


@pytest.mark.parametrize("dataset,n", [("coco_captions", 8), ("coco_captions", 20), ("synthetic", 8)])
def test_pool_splits_equal_jax(dataset, n):
    kw = dict(dataset=dataset, image_size=8, max_samples=n, batch_size=n, seed=3)
    got = _bare(ExperimentHarness, HarnessConfig(dataset=dataset, num_samples=n, seed=3),
                DataLoaderManager(DataConfig(**kw)))
    want = _bare(jh.ExperimentHarness, jh.HarnessConfig(dataset=dataset, num_samples=n, seed=3),
                 JDataLoaderManager(JDataConfig(**kw)))
    assert got.texts == want.texts
    assert got._hubness_query_pool() == want._hubness_query_pool()
    assert got._probe_caption_pools(size=16) == want._probe_caption_pools(size=16)


def test_markdown_report_equals_jax(tmp_path):
    results = {
        "four_scenarios": {"summary": {"auroc": {"pgd": 0.91234567}, "note": "x"}, "num_samples": 8},
        "significance_vs_tvc_full": {"no_defense": {"test": "wilcoxon", "p_value": 0.0123456, "significant": True,
                                                    "auroc_delta": 0.25}},
        "figures": ["a.png"], "output_path": "ignored", "flag": False,
    }
    texts = []
    for harness_cls, cfg in ((ExperimentHarness, HarnessConfig), (jh.ExperimentHarness, jh.HarnessConfig)):
        h = object.__new__(harness_cls)
        h.config = cfg(num_samples=8, attacks=("pgd", "hubness"))
        h.write_markdown_report(results, tmp_path / "r.md")
        texts.append((tmp_path / "r.md").read_text())
    assert texts[0] == texts[1]


# -- the four-scenarios protocol on shared adversarial images ------------------

B = 10
ITEMS = [f"bank_image_{i:03d}.jpg" for i in range(48)]
PIPE = dict(num_text_variants=4, retrieval_top_k=5, num_reference_images=3, batch_size=B)
AUG = dict(enable_paraphrase_generation=False, seed=0)
FS = dict(attacks=("pgd", "hubness"), num_samples=B, sweep_epsilons=(4 / 255, 8 / 255), save_results=False)
TIMES = ("baseline_time", "defense_time", "defense_overhead", "total_time", "timestamp")


def _attack_results(cls, adv, rng_seed):
    rng = np.random.default_rng(rng_seed)
    out = {}
    for name, images in adv.items():
        info = {"hubness_scores": rng.random(B)} if name == "hubness" else {}
        out[name] = cls(
            adv_images=images, success=rng.random(B) > 0.5, final_similarity=rng.random(B).astype(np.float32),
            perturbation_linf=np.full(B, 8 / 255, np.float32), perturbation_l2=rng.random(B).astype(np.float32),
            info=info,
        )
    return out


def _adv_images(images, rng):
    return {
        "pgd": np.clip(images + rng.uniform(-16 / 255, 16 / 255, images.shape), 0, 1).astype(np.float32),
        "hubness": rng.random(images.shape).astype(np.float32),
    }


def _spy(pipe, record):
    run = pipe.process_batch

    def process_batch(images, texts):
        res = run(images, texts)
        record.append((np.asarray(res.scores), np.asarray(res.is_adversarial)))
        return res

    pipe.process_batch = process_batch
    return pipe


def _run_both(make, images, texts, adv):
    """``make(tag) -> (model, pipeline, FourScenariosConfig class,
    experiment class, AttackResult class)``; both runs see the same
    adversarial results."""
    runs = {}
    for tag in ("jax", "torch"):
        model, pipe, fs_cls, exp_cls, res_cls = make(tag)
        record = []
        exp = exp_cls(model, _spy(pipe, record), fs_cls(**FS))
        shared = _attack_results(res_cls, adv, 5)
        exp.generate_adversarial = lambda images, texts, attack, shared=shared: shared[attack]
        runs[tag] = (exp.run(images, texts), record, exp)
    return runs


def _leaves(d, prefix=""):
    for k, v in d.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from _leaves(v, key)
        else:
            yield key, v


def _assert_runs_agree(runs):
    """Scores within 2e-5 and flags exact in every ``process_batch``; the
    order of the detection scores equal; then every leaf of the result:
    counts, strings and flags exact, scores, similarities and thresholds
    within 2e-5, AUROC, rates and bootstrap CIs within 1e-6 (timings and
    the device name aside)."""
    (got, got_rec, exp_g), (want, want_rec, exp_w) = runs["torch"], runs["jax"]
    assert len(got_rec) == len(want_rec) >= 6
    for (gs, gf), (ws, wf) in zip(got_rec, want_rec):
        np.testing.assert_allclose(gs, ws, atol=2e-5, rtol=0)
        np.testing.assert_array_equal(gf, wf)
    cs_g, cs_w = got_rec[0][0], want_rec[0][0]
    for (sg, _), (sw, _) in zip(got_rec, want_rec):
        order_g = np.argsort(exp_g._detection_scores(np.r_[cs_g, sg], cs_g), kind="stable")
        order_w = np.argsort(exp_w._detection_scores(np.r_[cs_w, sw], cs_w), kind="stable")
        np.testing.assert_array_equal(order_g, order_w)
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert set(g) == set(w)
    for key, wv in w.items():
        gv = g[key]
        if key.split(".")[-1] in TIMES or key == "metadata.device":
            continue
        if isinstance(wv, float):
            tol = 2e-5 if ("score" in key or "similarity" in key or "threshold" in key) else 1e-6
            assert gv == pytest.approx(wv, abs=tol), key
        elif isinstance(wv, (list, tuple)) and wv and isinstance(wv[0], float):
            np.testing.assert_allclose(gv, wv, atol=1e-6, rtol=0, err_msg=key)
        else:
            assert gv == wv, key
    for k in ("upper", "lower", "youden_vs_first_attack"):
        assert g[f"metadata.calibrated_threshold.{k}"] == pytest.approx(w[f"metadata.calibrated_threshold.{k}"],
                                                                        abs=2e-5)


class _StubModel:
    """Deterministic host encoders shared by both packages' protocol."""

    device = torch.device("cpu")

    def __init__(self):
        self.w = np.random.default_rng(0).standard_normal((8 * 8 * 3, 16)).astype(np.float32)

    @staticmethod
    def _norm(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    def encode_image(self, images):
        return self._norm(np.asarray(images, np.float32).reshape(len(images), -1) @ self.w)

    def encode_text(self, texts):
        return self._norm(np.stack([
            np.random.default_rng(zlib.crc32(t.encode())).standard_normal(16).astype(np.float32) for t in texts
        ]))


class _StubResult:
    def __init__(self, scores, flags):
        self.scores, self.is_adversarial = scores, flags


class _StubDetector:
    def __init__(self):
        self.config = SimpleNamespace(two_sided=True, lower_threshold=-np.inf)
        self.upper = 0.5
        self.threshold_manager = SimpleNamespace(get_threshold=lambda: self.upper)

    def compute_optimal_threshold(self, clean, adv):
        return float(np.median(np.r_[clean, adv]))

    def calibrate_two_sided(self, clean, quantile=0.98):
        lo, hi = float(np.quantile(clean, 1 - quantile)), float(np.quantile(clean, quantile))
        self.config.lower_threshold, self.upper = lo, hi
        return lo, hi


class _StubPipeline:
    def __init__(self, model):
        self.model, self.detector = model, _StubDetector()

    def process_batch(self, images, texts):
        scores = 1.0 - np.sum(self.model.encode_image(images) * self.model.encode_text(texts), -1)
        det = self.detector
        return _StubResult(scores, (scores > det.upper) | (scores < det.config.lower_threshold))


def test_four_scenarios_protocol_equals_jax(monkeypatch):
    """The protocol's own arithmetic on both packages' FourScenariosExperiment
    with the same host encoders and pipeline (no model compute). The JAX
    package's ROC and AUROC run through scikit-learn (~5 s to import, 7 ms
    an AUROC and 1,000 of them in the bootstrap CIs): here both sides use
    the port's numpy ones, which ``tests/test_torch_metrics.py`` holds to
    scikit-learn's; the slow case below runs the JAX package's own."""
    from tvc_torch.metrics import DetectionEvaluator

    for name in ("auroc", "roc_curve"):
        monkeypatch.setattr(jfs.DetectionEvaluator, name, staticmethod(getattr(DetectionEvaluator, name)))
    rng = np.random.default_rng(3)
    images = rng.random((B, 8, 8, 3)).astype(np.float32)
    model = _StubModel()
    classes = {"jax": (JFSConfig, JFSExperiment, JAttackResult),
               "torch": (FourScenariosConfig, FourScenariosExperiment, AttackResult)}
    runs = _run_both(lambda tag: (model, _StubPipeline(model), *classes[tag]),
                     images, chip_smoke.coco_captions(B), _adv_images(images, rng))
    _assert_runs_agree(runs)
    assert set(runs["torch"][0]["epsilon_sweep"]["pgd"]) == {"4/255", "8/255"}


@pytest.fixture(scope="module")
def four_scenarios():
    jclip = JClip(JClipConfig.tiny_coco(), seed=0)
    cfg = CLIPConfig.tiny_coco()
    tclip = CLIPModel(cfg, params=params_from_jax(jax.tree_util.tree_map(np.asarray, jclip.params), cfg),
                      device="cpu")
    rng = np.random.default_rng(11)
    bank = rng.standard_normal((len(ITEMS), cfg.embed_dim)).astype(np.float32)
    images = rng.random((B, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    jr, tr = JRetriever(jclip), MultiModalRetriever(tclip)
    jr.build_image_index(embeddings=bank, items=ITEMS)
    tr.build_image_index(embeddings=bank, items=ITEMS)

    def make(tag):
        if tag == "jax":
            pipe = JPipeline(jclip, JPipeConfig(**PIPE), retriever=jr, text_augmenter=JAugmenter(JAugConfig(**AUG)))
            return jclip, pipe, JFSConfig, JFSExperiment, JAttackResult
        pipe = MultiModalDetectionPipeline(tclip, PipelineConfig(**PIPE), retriever=tr, device="cpu",
                                           text_augmenter=TextAugmenter(TextAugmentConfig(**AUG)))
        return tclip, pipe, FourScenariosConfig, FourScenariosExperiment, AttackResult

    return _run_both(make, images, chip_smoke.coco_captions(B), _adv_images(images, rng))


@pytest.mark.slow
def test_four_scenarios_on_tiny_coco_equals_jax(four_scenarios):
    """The whole protocol through both packages' tiny_coco CLIP, pipeline and
    detector: slow (~15-25 s here: the JAX package compiles the tiny towers
    and the serving step, imports nltk for its synonyms, and computes 1,000
    scikit-learn AUROCs for the bootstrap CIs)."""
    _assert_runs_agree(four_scenarios)
    got, record, exp = four_scenarios["torch"]
    assert any(f.any() for _, f in record) and not all(f.all() for _, f in record)
    assert got["metadata"]["device"] == "cpu:1"
    # every timed window of the protocol ends on host numpy: the host clock
    # times finished device work
    assert all(isinstance(s, np.ndarray) and isinstance(f, np.ndarray) for s, f in record)
    assert isinstance(exp._retrieval_accuracy(np.zeros((2, 32, 32, 3), np.float32), ["a", "b"]), float)


SERVING_KEYS = {
    "defense_time_serving", "baseline_time_serving", "defense_overhead_serving", "serving_batch_size",
    "serving_bank_size", "serving_precision", "serving_model", "serving_chained_steps",
}


@pytest.fixture
def tiny_serving(monkeypatch):
    """The serving-overhead steps at the tiny CLIP's widths (they build
    ViT-B/32 otherwise, ~4 s on the CPU)."""
    import tvc_torch.models.clip as clip_mod

    monkeypatch.setattr(clip_mod, "CLIPConfig", CLIPConfig.tiny)


def test_measure_serving_overhead_on_the_cpu(tiny_serving):
    out = measure_serving_overhead(batch_size=4, bank_size=64, num_variants=2, top_k=3, device="cpu")
    assert set(out) == SERVING_KEYS
    assert out["serving_model"] == "tiny" and out["serving_precision"] == "int8-w8a8"
    assert out["serving_chained_steps"] == 20 and out["serving_bank_size"] == 64 and out["serving_batch_size"] == 4
    assert out["defense_time_serving"] > 0 and out["baseline_time_serving"] > 0


def test_serving_overhead_steps_score_every_query(tiny_serving, monkeypatch):
    from tvc_torch.core.kernels import consistency_scores_reference

    steps = serving_overhead_steps(batch_size=4, bank_size=64, num_variants=2, top_k=3, device="cpu")
    assert steps["model"].config.int8_serving and steps["model"].config.fused_attention
    out = steps["defended"]()
    assert out["aggregated"].shape == (4,) and torch.isfinite(out["aggregated"]).all()
    assert steps["text_passes"] == 1 and torch.isfinite(steps["baseline"]())
    # the step scores through the kernel's wrapper: on the CPU its plain version
    import tvc_torch.experiments.four_scenarios as tfs

    calls = []
    monkeypatch.setattr(tfs, "fused_consistency_scores", lambda *a, **k: calls.append(1) or
                        consistency_scores_reference(*a, **k))
    torch.testing.assert_close(steps["defended"]()["aggregated"], out["aggregated"], rtol=0, atol=0)
    assert calls == [1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serving_overhead_steps(batch_size=4, bank_size=64)


def test_harness_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ExperimentHarness(HarnessConfig(clip_model="tiny", num_samples=2, bank_size=4))
