"""ray_tpu_torch.train: distributed training orchestration on the port's
runtime, the port of ``ray_tpu.train`` (reference: ray.train v2).

The north-star path: ``TorchTrainer.fit()`` -> ``TrainController`` actor ->
``WorkerGroup`` gang-scheduled on a placement group (each worker's card
bound through its ``GPU`` lease) -> the ``torch.distributed`` process group
where the group asks for one -> the user's train loop with
``report(metrics, checkpoint)`` -> ``CheckpointManager`` over the port's
checkpoint plane, with the group killed and re-formed from fresh processes
resuming from the latest checkpoint on failure.

``ray_tpu_torch.train.pipeline`` is MPMD pipeline parallelism: stage actors
running a 1F1B schedule over the channel plane (``ray_tpu_torch/dag``).
"""

from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager
from ray_tpu_torch.train.config import (
    CheckpointConfig,
    FailureConfig,
    Result,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.context import (
    get_checkpoint,
    get_context,
    get_dataset_shard,
    report,
)
from ray_tpu_torch.train.trainer import (DataParallelTrainer, TorchTrainer,
                                         TrainingFailedError)

__all__ = [
    "TorchTrainer",
    "DataParallelTrainer",
    "TrainingFailedError",
    "ScalingConfig",
    "RunConfig",
    "FailureConfig",
    "CheckpointConfig",
    "Result",
    "Checkpoint",
    "CheckpointManager",
    "report",
    "get_context",
    "get_checkpoint",
    "get_dataset_shard",
]
