"""The mesh helpers and the serving and training steps of the port (the
re-exports of ``tvc/parallel/__init__.py``)."""

from tvc_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    MeshConfig,
    create_mesh,
    data_sharding,
    local_mesh_for_tests,
    pad_to_multiple,
    replicated,
    shard_batch,
)
from tvc_torch.parallel.steps import (  # noqa: F401
    make_defense_step,
    make_serving_step,
    make_train_step,
)
