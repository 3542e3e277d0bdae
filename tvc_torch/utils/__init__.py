"""Utilities (port of ``tvc/utils``): checkpoints, seeds, hardware
detection, experiment logging and the hardware-derived config profiles."""

from tvc_torch.utils.checkpoint import CheckpointManager, StageCheckpointer  # noqa: F401
from tvc_torch.utils.hardware import (  # noqa: F401
    DeviceInfo,
    DeviceMonitor,
    HardwareDetector,
    SystemInfo,
    detect_and_configure,
    device_memory_stats,
    optimize_batch_size,
)
from tvc_torch.utils.logger import ExperimentInfo, ExperimentLogger  # noqa: F401
from tvc_torch.utils.profiles import (  # noqa: F401
    PROFILES,
    DynamicConfigManager,
    DynamicConfigProfile,
    select_profile,
)
from tvc_torch.utils.seed import SeedContext, derive_key, set_random_seed  # noqa: F401
