"""tvc_torch stands alone: it imports neither JAX nor the JAX package, and
its entry points never fall back to the CPU by themselves."""

import ast
import importlib
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "tvc_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack", "safetensors", "tvc", "transformers", "diffusers",
             "yaml")
#: optional libraries the card's machine lacks: imported only inside the
#: functions that need them, never when a port module is imported
LAZY_ONLY = ("matplotlib", "sklearn", "psutil")


def _port_modules():
    return sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )


def test_importing_every_module_loads_no_jax_and_no_tvc():
    code = (
        "import importlib, json, sys\n"
        f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120, check=True
    )
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    assert "tvc_torch.serving" in loaded
    for m in ("tvc_torch.pipeline", "tvc_torch.augment.text_augment", "tvc_torch.attacks.text_attack",
              "tvc_torch.metrics", "tvc_torch.core.kernels.attention_kernel", "tvc_torch.core.kernels.topk_kernel",
              "tvc_torch.native", "tvc_torch.retrieval"):
        assert m in loaded, m
    # the lexicon probes nltk at its first lookup, never at import
    assert "nltk" not in loaded


def test_importing_every_module_loads_no_optional_library():
    """The experiment harness, the CLI and their utilities import everywhere:
    matplotlib, scikit-learn and psutil load only inside the functions that
    use them, and YAML goes through the port's own reader."""
    code = (
        "import importlib, json, sys\n"
        f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120, check=True
    )
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded if m.split(".")[0] in FORBIDDEN + LAZY_ONLY]
    assert not bad, bad
    for m in ("tvc_torch._yaml", "tvc_torch.config.loader", "tvc_torch.experiments.harness",
              "tvc_torch.experiments.four_scenarios", "tvc_torch.experiments.runners",
              "tvc_torch.evaluation.experiment_evaluator", "tvc_torch.evaluation.data_validator",
              "tvc_torch.analysis.families", "tvc_torch.analysis.run_analysis", "tvc_torch.utils.hardware",
              "tvc_torch.utils.logger", "tvc_torch.utils.profiles", "tvc_torch.utils.umap_lite",
              "tvc_torch.utils.visualization", "tvc_torch.cli"):
        assert m in loaded, m


@pytest.mark.parametrize("path", sorted(str(p.relative_to(REPO)) for p in PORT.rglob("*.py")) + ["chip_smoke.py"])
def test_no_forbidden_import_statements(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {n}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_without_device_raise_when_cuda_is_absent(no_cuda):
    from tvc_torch.bank import EmbeddingBank
    from tvc_torch.detector import AdversarialDetector
    from tvc_torch.models.clip import CLIPConfig, CLIPModel
    from tvc_torch.parallel.steps import make_serving_step
    from tvc_torch.serving import ServingConfig, ServingRuntime

    cfg = CLIPConfig.tiny()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CLIPModel(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EmbeddingBank(32)
    model = CLIPModel(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_serving_step(model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AdversarialDetector(model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingRuntime(ServingConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingRuntime(ServingConfig(), detector=AdversarialDetector(model, device="cpu"))


def test_qwen_without_device_raises_when_cuda_is_absent(no_cuda):
    from tvc_torch.models.qwen import QwenConfig, QwenModel

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        QwenModel(QwenConfig.tiny())
    m = QwenModel(QwenConfig.tiny(), device="cpu", max_new_tokens=2)
    assert m.device.type == "cpu" and len(m.generate(["a b"], temperature=0.0)) == 1


def test_pipeline_without_device_raises_when_cuda_is_absent(no_cuda):
    from tvc_torch.models.clip import CLIPConfig, CLIPModel
    from tvc_torch.pipeline import MultiModalDetectionPipeline

    model = CLIPModel(CLIPConfig.tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MultiModalDetectionPipeline(model)
    assert MultiModalDetectionPipeline(model, device="cpu").detector.device.type == "cpu"


def test_mesh_serving_raises_not_implemented(monkeypatch, tmp_path):
    import tvc_torch.fixtures as fixtures
    from tvc_torch.models.clip import CLIPConfig, CLIPModel
    from tvc_torch.parallel.steps import make_serving_step, make_train_step
    from tvc_torch.serving import ServingConfig, ServingRuntime

    from tvc_torch.parallel.launch import one_rank
    from tvc_torch.parallel.mesh import create_mesh

    model = CLIPModel(CLIPConfig.from_name("tiny", int8_serving=True, fused_attention=True), device="cpu")
    # the mesh steps are ported (item D11): they build over a mesh
    with one_rank(device="cpu", run_dir=str(tmp_path)):
        mesh = create_mesh(device="cpu")
        assert callable(make_serving_step(model, mesh=mesh, qparams=model.qparams(), device="cpu"))
        step, state = make_train_step(model, mesh=mesh, device="cpu")
        assert callable(step) and state["count"] == 0
    # the trained fixture serves from its asset; without the asset it is
    # trained (here a stub that records the call) and saved beside the port
    monkeypatch.setattr(fixtures, "FIXTURE_COCO_PATH", tmp_path / "missing.msgpack")
    monkeypatch.setattr(fixtures, "TRAINED_DIR", tmp_path / "trained")
    calls = []

    def train(device=None):
        calls.append(device)
        return CLIPModel(CLIPConfig.tiny_coco(), device=device), {"retrieval_accuracy": 1.0}

    monkeypatch.setattr(fixtures, "train_clip_fixture_coco", train)
    rt = ServingRuntime(ServingConfig(clip_model="tiny_coco_trained"), device="cpu")
    assert len(calls) == 1 and rt.detector.model.config.model_name == "tiny_coco"
    assert (tmp_path / "trained" / "missing.msgpack").exists()


def test_chip_smoke_fails_without_a_card(no_cuda):
    import chip_smoke

    assert chip_smoke.main() == 1


#: the detect-under-attack, generative-reference and model-lifecycle
#: (checkpoints in, training, checkpoints out) modules: each port file and
#: the JAX file it ports
SLICE_PAIRS = (
    # the mesh paths (item D11)
    ("tvc_torch/parallel/mesh.py", "tvc/parallel/mesh.py"),
    ("tvc_torch/parallel/tp.py", "tvc/parallel/tp.py"),
    ("tvc_torch/parallel/__init__.py", "tvc/parallel/__init__.py"),
    ("tvc_torch/attacks/adaptive.py", "tvc/attacks/adaptive.py"),
    ("tvc_torch/defenses/__init__.py", "tvc/defenses/__init__.py"),
    ("tvc_torch/defenses/consistency_checker.py", "tvc/defenses/consistency_checker.py"),
    ("tvc_torch/defenses/detector.py", "tvc/defenses/detector.py"),
    ("tvc_torch/bank/store.py", "tvc/bank/store.py"),
    ("tvc_torch/models/sd.py", "tvc/models/sd.py"),
    ("tvc_torch/sd_ref.py", "tvc/sd_ref.py"),
    ("tvc_torch/models/loaders.py", "tvc/models/loaders.py"),
    ("tvc_torch/models/sd_hf.py", "tvc/models/sd_hf.py"),
    ("tvc_torch/parallel/steps.py", "tvc/parallel/steps.py"),
    ("tvc_torch/fixtures.py", "tvc/fixtures.py"),
    ("tvc_torch/utils/seed.py", "tvc/utils/seed.py"),
    ("tvc_torch/utils/checkpoint.py", "tvc/utils/checkpoint.py"),
    # the experiment harness and the command line
    ("tvc_torch/config/__init__.py", "tvc/config/__init__.py"),
    ("tvc_torch/config/loader.py", "tvc/config/loader.py"),
    ("tvc_torch/experiments/__init__.py", "tvc/experiments/__init__.py"),
    ("tvc_torch/experiments/four_scenarios.py", "tvc/experiments/four_scenarios.py"),
    ("tvc_torch/experiments/harness.py", "tvc/experiments/harness.py"),
    ("tvc_torch/experiments/runners.py", "tvc/experiments/runners.py"),
    ("tvc_torch/evaluation/__init__.py", "tvc/evaluation/__init__.py"),
    ("tvc_torch/evaluation/experiment_evaluator.py", "tvc/evaluation/experiment_evaluator.py"),
    ("tvc_torch/evaluation/data_validator.py", "tvc/evaluation/data_validator.py"),
    ("tvc_torch/analysis/__init__.py", "tvc/analysis/__init__.py"),
    ("tvc_torch/analysis/families.py", "tvc/analysis/families.py"),
    ("tvc_torch/analysis/run_analysis.py", "tvc/analysis/run_analysis.py"),
    ("tvc_torch/utils/__init__.py", "tvc/utils/__init__.py"),
    ("tvc_torch/utils/logger.py", "tvc/utils/logger.py"),
    ("tvc_torch/utils/hardware.py", "tvc/utils/hardware.py"),
    ("tvc_torch/utils/profiles.py", "tvc/utils/profiles.py"),
    ("tvc_torch/utils/umap_lite.py", "tvc/utils/umap_lite.py"),
    ("tvc_torch/utils/visualization.py", "tvc/utils/visualization.py"),
    ("tvc_torch/cli.py", "tvc/cli.py"),
    # the package re-exports (F3)
    ("tvc_torch/__init__.py", "tvc/__init__.py"),
    ("tvc_torch/models/__init__.py", "tvc/models/__init__.py"),
    ("tvc_torch/core/__init__.py", "tvc/core/__init__.py"),
)


def _public_names(path: Path) -> set:
    """Top-level public classes, functions and constants, each public
    class's public methods (``Class.method``), and a package's re-exports."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                names |= {f"{node.name}.{f.name}" for f in node.body
                          if isinstance(f, ast.FunctionDef) and not f.name.startswith("_")}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.ImportFrom) and path.name == "__init__.py":
            names |= {a.asname or a.name for a in node.names}
    return {n for n in names if not n.split(".")[-1].startswith("_")}


@pytest.mark.parametrize("port,ref", SLICE_PAIRS)
def test_slice_modules_have_the_reference_public_names(port, ref):
    want = _public_names(REPO / ref)
    missing = want - _public_names(REPO / port)
    assert not missing, missing


def test_parallel_package_lacks_only_the_mesh_names():
    """Item D11 is ported: ``tvc_torch.parallel`` re-exports every name of
    ``tvc/parallel/__init__.py`` (the mesh helpers and the steps), and
    importing its mesh and TP modules loads neither JAX nor ``tvc``."""
    import tvc_torch.parallel as tp_pkg

    want = _public_names(REPO / "tvc/parallel/__init__.py")
    assert want == {"DATA_AXIS", "MODEL_AXIS", "MeshConfig", "create_mesh", "data_sharding", "local_mesh_for_tests",
                    "pad_to_multiple", "replicated", "shard_batch", "make_defense_step", "make_serving_step",
                    "make_train_step"}
    assert want <= _public_names(REPO / "tvc_torch/parallel/__init__.py")
    assert all(hasattr(tp_pkg, n) for n in want)
    code = (
        "import json, sys\n"
        "import tvc_torch.parallel.mesh, tvc_torch.parallel.tp, tvc_torch.parallel.launch\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
                         check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert not [m for m in loaded if m.split(".")[0] in FORBIDDEN]


def test_package_top_level_names_resolve():
    import tvc_torch

    for name, module in tvc_torch._LAZY.items():
        assert getattr(tvc_torch, name) is getattr(importlib.import_module(module), name)
    with pytest.raises(AttributeError):
        tvc_torch.not_a_name


def test_slice_modules_load_no_sklearn_at_import():
    code = (
        "import json, sys\n"
        "import tvc_torch.attacks.adaptive, tvc_torch.defenses, tvc_torch.bank.store, tvc_torch.models.sd\n"
        "import tvc_torch.sd_ref\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
                         check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded if m.split(".")[0] in FORBIDDEN + ("sklearn",)]
    assert not bad, bad


def test_sd_without_device_raises_when_cuda_is_absent(no_cuda):
    from tvc_torch.models.sd import SDConfig, StableDiffusionModel

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StableDiffusionModel(SDConfig.tiny())
    assert StableDiffusionModel(SDConfig.tiny(), device="cpu").device.type == "cpu"


def test_loaders_and_training_without_device_raise_when_cuda_is_absent(no_cuda, tmp_path):
    """A checkpoint loader given a checkout, the training step, the fixture
    trainer and derive_key run on the card unless asked for the CPU."""
    from tvc_torch.fixtures import train_clip_fixture
    from tvc_torch.models.clip import CLIPConfig, CLIPModel
    from tvc_torch.models.loaders import load_clip_weights, load_qwen_weights, load_sd_weights
    from tvc_torch.parallel.steps import make_train_step
    from tvc_torch.utils import derive_key

    for load in (load_clip_weights, load_qwen_weights):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            load(None, str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_sd_weights(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_train_step(CLIPModel(CLIPConfig.tiny(), device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_clip_fixture(steps=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        derive_key(0)
    assert derive_key(0, device="cpu").device.type == "cpu"
