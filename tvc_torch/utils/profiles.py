"""Dynamic hardware-derived config profiles — CUDA edition.

Port of ``tvc/utils/profiles.py`` (reference src/utils/dynamic_config.py:
DynamicConfigManager :32, profiles :44-130, auto_configure_system :561,
writes configs/dynamic/auto_generated_config.yaml). The JAX package's
accelerator tiers become GPU tiers with the same fields and the same values
per device count: 8+ cards, 2-7 cards, one card, no card. The YAML goes
through the port's own writer (``tvc_torch/_yaml.py``).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, Optional

from tvc_torch import _yaml
from tvc_torch.utils.hardware import HardwareDetector, SystemInfo


@dataclasses.dataclass
class DynamicConfigProfile:
    """(reference dynamic_config.py:23-31)"""

    name: str
    description: str
    batch_size: int
    bank_shards: int
    num_text_variants: int
    sd_images_per_prompt: int
    mesh_axes: tuple
    mesh_shape: tuple
    precision: str


PROFILES: Dict[str, DynamicConfigProfile] = {
    "gpu_node": DynamicConfigProfile(
        name="gpu_node",
        description="8+ GPUs (e.g. one 8-card node): full SPMD, sharded bank",
        batch_size=2048,
        bank_shards=8,
        num_text_variants=8,
        sd_images_per_prompt=3,
        mesh_axes=("data", "model"),
        mesh_shape=(-1, 2),
        precision="bfloat16",
    ),
    "gpu_multi_card": DynamicConfigProfile(
        name="gpu_multi_card",
        description="2-7 GPUs: data-parallel, replicated bank",
        batch_size=1024,
        bank_shards=2,
        num_text_variants=6,
        sd_images_per_prompt=3,
        mesh_axes=("data",),
        mesh_shape=(-1,),
        precision="bfloat16",
    ),
    "gpu_single_card": DynamicConfigProfile(
        name="gpu_single_card",
        description="one GPU: batched single-device execution",
        batch_size=256,
        bank_shards=1,
        num_text_variants=5,
        sd_images_per_prompt=2,
        mesh_axes=("data",),
        mesh_shape=(1,),
        precision="bfloat16",
    ),
    "cpu": DynamicConfigProfile(
        name="cpu",
        description="no accelerator: reduced workload (tests/dev)",
        batch_size=32,
        bank_shards=1,
        num_text_variants=3,
        sd_images_per_prompt=1,
        mesh_axes=("data",),
        mesh_shape=(1,),
        precision="float32",
    ),
}


def select_profile(info: Optional[SystemInfo] = None) -> DynamicConfigProfile:
    """(reference dynamic_config.py:131-210 tier selection)"""
    if info is None:
        info = HardwareDetector().detect()
    if info.platform != "gpu":
        return PROFILES["cpu"]
    if info.num_devices >= 8:
        return PROFILES["gpu_node"]
    if info.num_devices >= 2:
        return PROFILES["gpu_multi_card"]
    return PROFILES["gpu_single_card"]


class DynamicConfigManager:
    """(reference dynamic_config.py:32)"""

    def __init__(self, config_dir: Optional[str] = None):
        if config_dir is None:
            config_dir = str(Path(__file__).resolve().parents[2] / "configs")
        self.config_dir = Path(config_dir)
        self.detector = HardwareDetector()

    def auto_configure_system(
        self, write: bool = True, profile: Optional[str] = None
    ) -> Dict[str, Any]:
        """(reference :561) — selects a profile (or uses the named one,
        reference deploy.py --profile) and optionally writes
        configs/dynamic/auto_generated_config.yaml."""
        info = self.detector.detect()
        if profile is not None:
            if profile not in PROFILES:
                raise ValueError(
                    f"unknown profile {profile!r}; available: {sorted(PROFILES)}"
                )
            profile = PROFILES[profile]
        else:
            profile = select_profile(info)
        config = {
            "generated_by": "tvc_torch.utils.profiles.DynamicConfigManager",
            "hardware": self.detector.summary(),
            "profile": profile.name,
            "batch": {"default_size": profile.batch_size},
            "device": {
                "platform": info.platform,
                "precision": profile.precision,
                "mesh": {
                    "axes": list(profile.mesh_axes),
                    "shape": list(profile.mesh_shape),
                },
            },
            "defense": {
                "text_variants": {"num_variants": profile.num_text_variants},
                "sd_reference": {"num_images": profile.sd_images_per_prompt},
            },
        }
        if write:
            out = self.config_dir / "dynamic" / "auto_generated_config.yaml"
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(_yaml.dump(config))
        return config
