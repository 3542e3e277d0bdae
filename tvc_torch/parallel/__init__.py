"""The serving and training steps of the port (single device; the mesh
helpers of ``tvc/parallel/mesh.py`` are not ported yet)."""

from tvc_torch.parallel.steps import (  # noqa: F401
    make_defense_step,
    make_serving_step,
    make_train_step,
)
