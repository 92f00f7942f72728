"""Training of the flagship LM: the optimizer, the step on one device or on
a mesh of data x fsdp x tensor, the mesh itself, and the fsdp and tensor
axes' operators."""

from ray_tpu_torch.parallel.mesh import (
    AXES,
    LOGICAL_RULES,
    create_mesh,
    default_mesh_axes,
    mesh_placements,
    param_layout,
    param_logical_axes,
)
from ray_tpu_torch.parallel.train import (
    AdamW,
    OptState,
    TrainStepBundle,
    make_optimizer,
    sharded_clip_by_global_norm,
)

__all__ = ["AXES", "LOGICAL_RULES", "AdamW", "OptState", "TrainStepBundle",
           "create_mesh", "default_mesh_axes", "make_optimizer",
           "mesh_placements", "param_layout", "param_logical_axes",
           "sharded_clip_by_global_norm"]
