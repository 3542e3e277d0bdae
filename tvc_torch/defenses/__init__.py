"""The alt defense stack (port of ``tvc/defenses``): the stateful
``ConsistencyChecker`` and the dependency-injected
``MultiModalDefenseDetector``."""

from tvc_torch.defenses.consistency_checker import ConsistencyChecker  # noqa: F401
from tvc_torch.defenses.detector import DetectionConfig, MultiModalDefenseDetector  # noqa: F401
