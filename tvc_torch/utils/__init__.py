"""Training-state utilities (port of ``tvc/utils``: checkpoints and
seeds; the hardware, logger and profile helpers are not ported yet)."""

from tvc_torch.utils.checkpoint import CheckpointManager, StageCheckpointer  # noqa: F401
from tvc_torch.utils.seed import SeedContext, derive_key, set_random_seed  # noqa: F401
