"""Training of the flagship LM: the optimizer, the step on one device or on
the data axis of a mesh, and the mesh itself."""

from ray_tpu_torch.parallel.mesh import (
    AXES,
    LOGICAL_RULES,
    create_mesh,
    default_mesh_axes,
    mesh_placements,
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
           "mesh_placements", "param_logical_axes",
           "sharded_clip_by_global_norm"]
