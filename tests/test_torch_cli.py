"""tvc_torch's command line (``python -m tvc_torch.cli``), hardware detection
and dynamic profiles: the profile tiers against the JAX package's per device
count, the written YAML read back by PyYAML and the port's reader, every
command on ``--device cpu``, and a computing command with no ``--device``
raising where CUDA is missing. No test writes into ``configs/``."""

import dataclasses
import json
from pathlib import Path

import matplotlib.pyplot  # noqa: F401  (first imports at collection, not in a test: ~2 s together)
import pytest
import torch
import torch._dynamo  # noqa: F401  (the profiler's first use imports it)
import yaml

import tvc.utils.profiles as jprofiles
from tvc.utils.hardware import DeviceInfo as JDeviceInfo, SystemInfo as JSystemInfo
from tvc_torch import _yaml, cli
from tvc_torch.utils import (
    PROFILES,
    DeviceInfo,
    DeviceMonitor,
    DynamicConfigManager,
    HardwareDetector,
    SystemInfo,
    detect_and_configure,
    device_memory_stats,
    optimize_batch_size,
    select_profile,
)
from tvc_torch.utils.hardware import probe_device_health

REPO = Path(__file__).resolve().parent.parent
AUTO_CONFIG = REPO / "configs" / "dynamic" / "auto_generated_config.yaml"
AUTO_CONFIG_BYTES = AUTO_CONFIG.read_bytes()
TIERS = {0: ("cpu", "cpu"), 1: ("gpu_single_card", "tpu_single_chip"), 2: ("gpu_multi_card", "tpu_multi_chip"),
         7: ("gpu_multi_card", "tpu_multi_chip"), 8: ("gpu_node", "tpu_pod_slice"), 16: ("gpu_node", "tpu_pod_slice")}


def _info(cls, dev_cls, platform, n, version_field):
    devices = [dev_cls(index=i, platform=platform, kind="card") for i in range(max(n, 1))]
    return cls(platform=platform, num_devices=max(n, 1), devices=devices, host_count=1, cpu_count=8,
               memory_gb=1.0, python_version="3.12", **{version_field: "x"})


@pytest.mark.parametrize("n", sorted(TIERS))
def test_select_profile_tiers_equal_jax(n):
    name, jax_name = TIERS[n]
    got = select_profile(_info(SystemInfo, DeviceInfo, "gpu" if n else "cpu", n, "torch_version"))
    want = jprofiles.select_profile(_info(JSystemInfo, JDeviceInfo, "tpu" if n else "cpu", n, "jax_version"))
    assert got.name == name and want.name == jax_name
    strip = lambda p: {k: v for k, v in dataclasses.asdict(p).items() if k not in ("name", "description")}  # noqa
    assert strip(got) == strip(want)
    assert set(PROFILES) == {"gpu_node", "gpu_multi_card", "gpu_single_card", "cpu"}


class _Detector(HardwareDetector):
    def __init__(self, info):
        super().__init__()
        self._info = info


def test_dynamic_config_written_through_the_port_yaml(tmp_path):
    mgr = DynamicConfigManager(config_dir=str(tmp_path))
    mgr.detector = _Detector(_info(SystemInfo, DeviceInfo, "gpu", 1, "torch_version"))
    cfg = mgr.auto_configure_system()
    written = (tmp_path / "dynamic" / "auto_generated_config.yaml").read_text()
    assert yaml.safe_load(written) == _yaml.load(written) == cfg
    assert cfg["profile"] == "gpu_single_card" and cfg["device"]["platform"] == "gpu"
    assert cfg["device"]["mesh"] == {"axes": ["data"], "shape": [1]} and cfg["hardware"]["torch"] == "x"
    assert mgr.auto_configure_system(write=False, profile="gpu_node")["batch"]["default_size"] == 2048
    with pytest.raises(ValueError, match="unknown profile"):
        mgr.auto_configure_system(write=False, profile="tpu_pod_slice")
    assert DynamicConfigManager().config_dir == REPO / "configs"


def test_hardware_detection_on_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    det = HardwareDetector()
    info = det.detect()
    assert info.platform == "cpu" and info.num_devices == 1 and info.torch_version == torch.__version__
    assert set(det.summary()) == {"platform", "num_devices", "device_kinds", "hosts", "torch"}
    assert not det.has_tpu() and det.get_available_devices() == info.devices
    assert detect_and_configure()["profile"]["name"] == "cpu"
    assert device_memory_stats() == {}
    with DeviceMonitor(interval_s=0.01) as mon:
        pass
    assert mon.summary() == {"samples": 0}


def test_probe_device_health(monkeypatch):
    out = probe_device_health(timeout_s=10.0, rtt_probes=2, device="cpu")
    assert out["healthy"] and out["platform"] == "cpu" and len(out["rtt_ms"]) == 2 and out["diagnosis"] == "ok"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = probe_device_health(timeout_s=1.0)
    assert not out["healthy"] and "CUDA is not available" in out["diagnosis"]


def test_optimize_batch_size_halves_on_out_of_memory():
    seen = []

    def run(n):
        seen.append(n)
        if n > 100:
            raise RuntimeError("CUDA out of memory. Tried to allocate")

    assert optimize_batch_size(run, initial=1024) == 64 and seen == [1024, 512, 256, 128, 64]
    with pytest.raises(ValueError):
        optimize_batch_size(lambda n: (_ for _ in ()).throw(ValueError("other")))


@pytest.fixture
def builtin_lexicon(monkeypatch):
    """Synonyms from the built-in lexicon, as on a machine without nltk
    (importing nltk's WordNet takes ~5 s)."""
    import tvc_torch.attacks.text_attack as ta

    monkeypatch.setattr(ta, "_WORDNET", False)
    ta._synonyms_cached.cache_clear()
    yield
    ta._synonyms_cached.cache_clear()


def _json_out(capsys):
    return json.loads(capsys.readouterr().out)


def test_cli_hardware_detect_and_config_gen(capsys):
    cli._module_main(["hardware-detect", "--probe", "--device", "cpu"])
    out = _json_out(capsys)
    assert out["health"]["healthy"] and out["health"]["device"] == "cpu" and "torch" in out
    cli._module_main(["config-gen", "--no-write"])
    out = _json_out(capsys)
    assert out["profile"] == select_profile().name and out["generated_by"].startswith("tvc_torch.")
    cli._module_main(["deploy", "--detect-only"])
    assert capsys.readouterr().out.startswith("hardware: ")
    assert AUTO_CONFIG.read_bytes() == AUTO_CONFIG_BYTES


def test_cli_deploy_config_only_writes_the_given_config_dir(tmp_path, monkeypatch, capsys):
    import tvc_torch.utils.profiles as profiles

    real = profiles.DynamicConfigManager.__init__
    monkeypatch.setattr(profiles.DynamicConfigManager, "__init__",
                        lambda self, config_dir=None: real(self, str(tmp_path)))
    cli._module_main(["deploy", "--config-only", "--profile", "gpu_multi_card"])
    assert capsys.readouterr().out.strip() == "profile: gpu_multi_card"
    assert _yaml.load((tmp_path / "dynamic" / "auto_generated_config.yaml").read_text())["profile"] == "gpu_multi_card"
    assert AUTO_CONFIG.read_bytes() == AUTO_CONFIG_BYTES


def test_cli_defense_efficiency_on_the_cpu(tmp_path, capsys, builtin_lexicon):
    cli._module_main(["defense", "--device", "cpu", "--experiment-mode", "efficiency_analysis", "--clip-model",
                      "tiny", "--dataset", "synthetic", "--num-samples", "4", "--bank-size", "8",
                      "--output-dir", str(tmp_path)])
    path = Path(_json_out(capsys)["output_path"])
    res = json.loads(path.read_text())
    assert path.with_suffix(".md").exists() and res["hardware"]["platform"] in ("cpu", "gpu")
    assert res["profiler_trace_dir"] == str(tmp_path / "profiler_trace")
    assert (tmp_path / "profiler_trace" / "trace.json.gz").exists()
    assert set(res["efficiency_analysis"]) == {"text_augment", "image_encode", "retrieval", "detection", "end_to_end"}


def test_cli_attack(tmp_path, capsys, builtin_lexicon, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the runner's harness logs under ./results
    cli._module_main(["attack", "--device", "cpu", "--num-samples", "4", "--attacks", "fgsm",
                      "--output", str(tmp_path / "attack.json")])
    out = _json_out(capsys)
    assert out["num_samples"] == 4 and set(out["attack_sweep"]) == {"fgsm"}
    assert json.loads((tmp_path / "attack.json").read_text()) == out


def test_cli_build_bank_and_analyze(tmp_path, capsys):
    cli._module_main(["build-bank", "--device", "cpu", "--max-samples", "16", "--output", str(tmp_path / "bank")])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["image_bank"] == out["text_bank"] == 16 and (tmp_path / "bank" / "retriever.json").exists()
    (tmp_path / "r").mkdir()
    (tmp_path / "r" / "ablation.json").write_text(json.dumps(
        {"ablation_study": {"full": {"auroc": 0.9, "f1": 0.8, "throughput_qps": 10.0}}}))
    cli._module_main(["analyze", "--results-dir", str(tmp_path / "r"), "--no-charts"])
    out = _json_out(capsys)
    assert out["families"] == ["ablation_study"] and out["charts"] == []


def test_cli_usage_and_commands(capsys):
    assert set(cli.COMMANDS) == {"defense", "attack", "deploy", "quick-start", "hardware-detect", "config-gen",
                                 "build-bank", "analyze", "serve"}
    with pytest.raises(SystemExit) as e:
        cli._module_main(["nope"])
    assert e.value.code == 2 and "usage: python -m tvc_torch.cli" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["defense", "--clip-model", "tiny", "--num-samples", "2", "--bank-size", "4"],
    ["attack", "--num-samples", "2"],
    ["build-bank", "--max-samples", "4"],
    ["quick-start"],
    ["deploy", "--deploy-only"],
    ["serve", "--no-warmup"],
], ids=lambda a: a[0])
def test_computing_commands_without_device_raise_when_cuda_is_absent(argv, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli._module_main(argv)


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["four_scenarios", "defense_effectiveness", "baseline_comparison", "ablation_study",
                                  "retrieval_quality", "cross_dataset", "adaptive_attack"])
def test_cli_defense_every_mode_on_the_cpu(mode, tmp_path, capsys):
    """Each harness mode through the CLI on the trained tiny_coco fixture:
    slow (7-30 s a mode here: attacks of 50-500 steps, the fixture's bank)."""
    cli._module_main(["defense", "--device", "cpu", "--experiment-mode", mode, "--num-samples", "8",
                      "--bank-size", "64", "--attacks", "pgd", "--output-dir", str(tmp_path)])
    path = Path(_json_out(capsys)["output_path"])
    assert path.exists() and path.with_suffix(".md").exists()
    assert mode in json.loads(path.read_text()) or mode == "four_scenarios"


@pytest.mark.slow
def test_cli_quick_start_and_deploy_smoke_on_the_cpu(tmp_path, capsys, monkeypatch):
    """The tiny four-scenarios demo and the deploy smoke run: slow (~10 s)."""
    monkeypatch.chdir(tmp_path)
    cli._module_main(["quick-start", "--device", "cpu"])
    assert "detection_rate" in json.loads(capsys.readouterr().out)
    cli._module_main(["deploy", "--deploy-only", "--device", "cpu"])
    assert capsys.readouterr().out.startswith("smoke: ")
    assert AUTO_CONFIG.read_bytes() == AUTO_CONFIG_BYTES
