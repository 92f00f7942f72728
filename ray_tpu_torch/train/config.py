"""Train configuration dataclasses, the port of ``ray_tpu/train/config.py``.

Reference: python/ray/air/config.py (ScalingConfig/RunConfig/CheckpointConfig)
+ train/v2 failure policy config (v2/_internal/execution/failure_handling/).

Where the port differs: a worker's accelerator is the card (``use_gpu``,
``gpus_per_worker`` and the ``GPU`` resource for the JAX package's
``use_tpu``, ``chips_per_worker`` and ``TPU``), there is no ``topology``
(no TPU slices), and the grad-sync backends are ``torch.distributed``'s
(``gloo`` and ``nccl``, with the JAX names ``cpu`` and ``xla`` for them).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class ScalingConfig:
    num_workers: int = 1
    use_gpu: bool = False
    # resources per training worker actor
    resources_per_worker: Dict[str, float] = field(default_factory=lambda: {"CPU": 1.0})
    gpus_per_worker: float = 0  # cards each worker owns (0: none added)
    placement_strategy: str = "SPREAD"
    # form the torch.distributed default process group across the workers
    # (NCCL on the card, gloo on the CPU). Defaults on for multi-worker GPU
    # groups.
    bootstrap_distributed: Optional[bool] = None
    # elasticity (reference: scaling_policy.py:32): on worker loss, re-form
    # the group at the largest mesh-shaped size the cluster can host
    # instead of insisting on num_workers
    elastic: bool = False
    min_workers: int = 1
    # mesh-shaped sizes only: "pow2" (powers of two) or an int group
    # granularity (the group size must be a whole multiple)
    elastic_granularity: Any = "pow2"
    # bucketed grad synchronization across the group (the explicit-
    # collective tier of the overlapped train step): backend "gloo" (or
    # the JAX name "cpu") or "nccl" ("xla"); None = off. Train loops reach
    # it via train.get_context().grad_sync / make_bucket_reducer /
    # make_sharded_optimizer (cross-replica sharded update: opt state
    # 1/N per worker).
    grad_sync_backend: Optional[str] = None
    grad_sync_bucket_bytes: int = 32 << 20
    # wire compression for the bucketed grad sync (collective/quant.py):
    # None (fp32), "int8" / "fp8" (block-quantized with error feedback;
    # ~4x fewer wire bytes) or "bf16" (plain narrowing, 2x). Strictly
    # opt-in; gloo backend only at this tier, as the JAX package takes it
    # on its CPU backend only — on-device programs use
    # TrainStepBundle(compression=...).
    grad_sync_compression: Optional[str] = None
    # collective dtype of the TrainStepBundle sharded-path grad
    # reduce-scatter: "fp32" (default) or "bf16" (halves collective bytes;
    # optimizer + params stay fp32 master copies).
    grad_dtype: str = "fp32"

    def bundle(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker)
        if self.use_gpu and self.gpus_per_worker:
            res["GPU"] = float(self.gpus_per_worker)
        return res


@dataclass
class FailureConfig:
    max_failures: int = 0  # worker-group restarts allowed


@dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"


@dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None  # local path
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)


@dataclass
class Result:
    metrics: Dict[str, Any]
    checkpoint: Optional["Checkpoint"]
    error: Optional[str] = None
    path: str = ""


from ray_tpu_torch.train.checkpoint import Checkpoint  # noqa: E402  (re-export cycle)
