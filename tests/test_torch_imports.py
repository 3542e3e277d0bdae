"""tvc_torch stands alone: it imports neither JAX nor the JAX package, and
its entry points never fall back to the CPU by themselves."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "tvc_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "tvc", "transformers")


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
    from tvc_torch.parallel.steps import make_serving_step
    from tvc_torch.serving import ServingConfig, ServingRuntime

    model = CLIPModel(CLIPConfig.from_name("tiny", int8_serving=True, fused_attention=True), device="cpu")
    with pytest.raises(NotImplementedError):
        make_serving_step(model, mesh=object(), qparams=model.qparams(), device="cpu")
    # the trained fixture serves from its asset; without the asset it would
    # have to be trained, and the training step is not ported yet
    monkeypatch.setattr(fixtures, "FIXTURE_COCO_PATH", tmp_path / "missing.msgpack")
    with pytest.raises(NotImplementedError):
        ServingRuntime(ServingConfig(clip_model="tiny_coco_trained"), device="cpu")


def test_chip_smoke_fails_without_a_card(no_cuda):
    import chip_smoke

    assert chip_smoke.main() == 1
