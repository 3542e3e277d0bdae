"""Command-line entry points of the port.

Port of ``tvc/cli.py`` (reference setup.py:177-187 console scripts:
mm-defense, mm-attack, mm-deploy, mm-quick-start, mm-auto-deploy,
mm-hardware-detect, mm-config-gen, + build-bank and analyze). Run as
``python -m tvc_torch.cli <command> [args...]``. Every command that computes
takes ``--device`` and runs on the card unless it is ``cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path
from typing import Optional, Sequence

_DEVICE_HELP = "where the models run: the card by default, 'cpu' for the CPU"


def defense_main(argv: Optional[Sequence[str]] = None) -> None:
    """mm-defense: run the experiment harness (reference mm-defense ->
    run_experiments.main); ``--device`` is the harness's flag."""
    from tvc_torch.experiments.harness import main

    results = main(argv)
    print(json.dumps({"output_path": results.get("output_path")}, indent=2))


def attack_main(argv: Optional[Sequence[str]] = None) -> None:
    """mm-attack: attack sweep (reference runners/run_attack.py)."""
    p = argparse.ArgumentParser(description="tvc_torch attack sweep")
    p.add_argument("--attacks", nargs="+", default=None)
    p.add_argument("--dataset", default="synthetic")
    p.add_argument("--num-samples", type=int, default=16)
    p.add_argument("--clip-model", default="tiny")
    p.add_argument("--output", default=None)
    p.add_argument("--device", default=None, help=_DEVICE_HELP)
    args = p.parse_args(argv)
    from tvc_torch.experiments.harness import HarnessConfig
    from tvc_torch.experiments.runners import AttackRunner

    runner = AttackRunner(
        HarnessConfig(
            dataset=args.dataset,
            num_samples=args.num_samples,
            clip_model=args.clip_model,
            device=args.device,
        )
    )
    out = runner.run(args.attacks)
    text = json.dumps(out, indent=2, default=float)
    if args.output:
        Path(args.output).write_text(text)
    print(text)


def hardware_detect_main(argv: Optional[Sequence[str]] = None) -> None:
    """mm-hardware-detect (reference scripts/deploy.py hardware probe).

    --probe additionally runs a BOUNDED dispatch+readback liveness check on
    ``--device`` (exit 1 if the execution path is down): a device that
    enumerates can still fail to compute."""
    p = argparse.ArgumentParser()
    p.add_argument(
        "--probe", action="store_true",
        help="run a bounded dispatch+readback health probe",
    )
    p.add_argument("--probe-timeout", type=float, default=30.0)
    p.add_argument("--device", default=None, help=_DEVICE_HELP)
    args = p.parse_args(argv)
    from tvc_torch.utils import HardwareDetector

    summary = HardwareDetector().summary()
    if args.probe:
        from tvc_torch.utils.hardware import probe_device_health

        summary["health"] = probe_device_health(timeout_s=args.probe_timeout, device=args.device)
    print(json.dumps(summary, indent=2))
    if args.probe and not summary["health"]["healthy"]:
        # the probe's daemon thread may still be inside a device call;
        # flush and exit directly so callers see rc=1
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)


def config_gen_main(argv: Optional[Sequence[str]] = None) -> None:
    """mm-config-gen: write the hardware-derived dynamic config
    (reference dynamic_config.auto_configure_system)."""
    p = argparse.ArgumentParser()
    p.add_argument("--no-write", action="store_true")
    args = p.parse_args(argv)
    from tvc_torch.utils import DynamicConfigManager

    cfg = DynamicConfigManager().auto_configure_system(write=not args.no_write)
    print(json.dumps(cfg, indent=2))


def deploy_main(argv: Optional[Sequence[str]] = None) -> None:
    """mm-deploy / mm-auto-deploy: detect hardware, generate config, run a
    smoke experiment (reference scripts/deploy.py:315; flag surface
    mirrors its --detect-only / --config-only / --deploy-only /
    --profile / --interactive modes)."""
    p = argparse.ArgumentParser()
    p.add_argument("--skip-smoke", action="store_true")
    p.add_argument("--detect-only", action="store_true", help="hardware probe only")
    p.add_argument("--config-only", action="store_true", help="generate config only")
    p.add_argument(
        "--deploy-only", action="store_true",
        help="skip detect/config output; run the smoke deployment only",
    )
    p.add_argument(
        "--profile", default=None,
        help="force a named hardware profile (see tvc_torch.utils.profiles.PROFILES)",
    )
    p.add_argument("--interactive", action="store_true", help="menu-driven flow")
    p.add_argument("--device", default=None, help=_DEVICE_HELP)
    args = p.parse_args(argv)
    from tvc_torch.utils import DynamicConfigManager, HardwareDetector

    def detect():
        hw = HardwareDetector().summary()
        print("hardware:", json.dumps(hw))
        return hw

    def gen_config():
        cfg = DynamicConfigManager().auto_configure_system(
            write=True, profile=args.profile
        )
        print("profile:", cfg["profile"])
        return cfg

    def smoke():
        from tvc_torch.experiments.harness import ExperimentHarness, HarnessConfig

        results = ExperimentHarness(
            HarnessConfig(
                experiment_mode="efficiency_analysis", num_samples=8, clip_model="tiny",
                device=args.device,
            )
        ).run()
        print("smoke:", results.get("output_path"))

    if args.interactive:
        actions = {"1": detect, "2": gen_config, "3": smoke}
        while True:
            choice = input(
                "mm-deploy: [1] detect hardware  [2] generate config  "
                "[3] smoke run  [q] quit > "
            ).strip().lower()
            if choice in ("q", "quit", ""):
                return
            action = actions.get(choice)
            if action is None:
                print(f"unknown choice {choice!r}")
            else:
                action()
        return
    if args.detect_only:
        detect()
        return
    if args.config_only:
        gen_config()
        return
    if not args.deploy_only:
        detect()
        gen_config()
    if not args.skip_smoke:
        smoke()


def quick_start_main(argv: Optional[Sequence[str]] = None) -> None:
    """mm-quick-start: tiny end-to-end four-scenarios demo."""
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, help=_DEVICE_HELP)
    args = p.parse_args(argv)
    from tvc_torch.experiments.harness import ExperimentHarness, HarnessConfig

    results = ExperimentHarness(
        HarnessConfig(
            experiment_mode="four_scenarios",
            num_samples=8,
            attacks=("pgd",),
            clip_model="tiny",
            device=args.device,
        )
    ).run()
    print(json.dumps(results["summary"], indent=2, default=float))


def build_bank_main(argv: Optional[Sequence[str]] = None) -> None:
    """build-bank: encode a dataset and persist image/text banks
    (replaces reference scripts/build_faiss_indices.py)."""
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="synthetic")
    p.add_argument("--data-dir", default="./data")
    p.add_argument("--max-samples", type=int, default=1024)
    p.add_argument("--clip-model", default="tiny")
    p.add_argument("--output", default="./data/banks/default")
    p.add_argument("--device", default=None, help=_DEVICE_HELP)
    args = p.parse_args(argv)
    import numpy as np

    from tvc_torch.data import DataConfig, DataLoaderManager
    from tvc_torch.models import CLIPConfig, CLIPModel
    from tvc_torch.retrieval import MultiModalRetriever

    clip_cfg = CLIPConfig.tiny() if args.clip_model == "tiny" else CLIPConfig()
    model = CLIPModel(clip_cfg, seed=0, device=args.device)
    ds = DataLoaderManager(
        DataConfig(
            dataset=args.dataset,
            data_dir=args.data_dir,
            image_size=clip_cfg.image_size,
            max_samples=args.max_samples,
        )
    ).load_dataset()
    retriever = MultiModalRetriever(model)
    images, texts = [], []
    for b in ds.batches(batch_size=64):
        images.append(b["images"])
        texts.extend(b["texts"])
    imgs = np.concatenate(images)
    retriever.build_image_index(images=imgs, items=texts)
    retriever.build_text_index(texts=texts)
    retriever.save(args.output)
    print(
        json.dumps(
            {
                "output": args.output,
                "image_bank": retriever.image_bank.size,
                "text_bank": retriever.text_bank.size,
            }
        )
    )


def analyze_main(argv: Optional[Sequence[str]] = None) -> None:
    """analyze (reference analysis/run_analysis.py CLI): host only."""
    p = argparse.ArgumentParser()
    p.add_argument("--results-dir", default="./results")
    p.add_argument("--output-dir", default=None)
    p.add_argument("--no-charts", action="store_true")
    args = p.parse_args(argv)
    from tvc_torch.analysis import UnifiedAnalysisRunner

    index = UnifiedAnalysisRunner(args.results_dir, args.output_dir).run(
        charts=not args.no_charts
    )
    print(json.dumps(index, indent=2, default=str))


def _serve_main(argv: Optional[Sequence[str]] = None) -> None:
    """serve: dynamic micro-batching detection service (tvc_torch/serving.py;
    ``--device`` as the other commands)."""
    from tvc_torch.serving import serve_main

    serve_main(argv)


COMMANDS = {
    "defense": defense_main,
    "attack": attack_main,
    "deploy": deploy_main,
    "quick-start": quick_start_main,
    "hardware-detect": hardware_detect_main,
    "config-gen": config_gen_main,
    "build-bank": build_bank_main,
    "analyze": analyze_main,
    "serve": _serve_main,
}


def _module_main(argv: Optional[Sequence[str]] = None) -> None:
    """``python -m tvc_torch.cli <command>`` dispatcher."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in COMMANDS:
        print(f"usage: python -m tvc_torch.cli {{{','.join(COMMANDS)}}} [args...]")
        raise SystemExit(2)
    COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    _module_main()
