"""Trainers: DataParallelTrainer + TorchTrainer (the north-star API), the
port of ``ray_tpu/train/trainer.py``, where ``JaxTrainer`` stands.

Reference: train/v2/api/data_parallel_trainer.py:64 (``fit`` :152 spawns the
controller actor) and train/v2/torch/torch_trainer.py (``TorchTrainer``).

Usage::

    def train_loop(config):
        ctx = ray_tpu_torch.train.get_context()
        ... torch training; ray_tpu_torch.train.report({"loss": l},
                                                       checkpoint=ckpt)

    trainer = TorchTrainer(
        train_loop,
        train_loop_config={"steps": 100},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True,
                                     resources_per_worker={"CPU": 1,
                                                           "GPU": 1}),
        run_config=RunConfig(storage_path="/mnt/ckpts", name="run1"),
    )
    result = trainer.fit()

The loop and the datasets cross to the workers through the port's by-value
pickler (``_private/serialization.py``), where the JAX package uses
``cloudpickle``: a loop defined in ``__main__`` or inside a function
travels with its code.
"""

from __future__ import annotations

import os
import tempfile
import time
import uuid
from typing import Any, Callable, Dict, Optional

import ray_tpu_torch
from ray_tpu_torch._private.serialization import dumps
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import Result, RunConfig, ScalingConfig
from ray_tpu_torch.train.controller import TrainController


class DataParallelTrainer:
    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
    ):
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.datasets = datasets or {}

    def _run_dir(self) -> str:
        base = self.run_config.storage_path or os.path.join(
            tempfile.gettempdir(), "ray_tpu_torch", "train_runs")
        name = self.run_config.name or f"train_{time.strftime('%Y%m%d_%H%M%S')}_{uuid.uuid4().hex[:6]}"
        path = os.path.join(base, name)
        os.makedirs(path, exist_ok=True)
        return path

    def _dataset_shards(self) -> Optional[list]:
        if not self.datasets:
            return None
        n = self.scaling_config.num_workers
        per_rank: list = [dict() for _ in range(n)]
        for name, ds in self.datasets.items():
            if hasattr(ds, "split"):
                shards = ds.split(n)
            else:
                shards = [ds] * n
            for i in range(n):
                per_rank[i][name] = shards[i]
        return [dumps(d) for d in per_rank]

    def fit(self) -> Result:
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        run_dir = self._run_dir()
        from ray_tpu_torch.util.scheduling_strategies import (
            NodeAffinitySchedulingStrategy,
        )

        # pin the controller to the DRIVER's node (reference: the
        # controller runs alongside the driver): a controller placed on an
        # arbitrary worker node would die with it, taking down the very
        # failure handling that should survive node loss
        controller = TrainController.options(
            num_cpus=0.1, max_concurrency=8,
            name=f"train_controller_{uuid.uuid4().hex[:8]}",
            scheduling_strategy=NodeAffinitySchedulingStrategy(
                node_id=ray_tpu_torch.get_runtime_context().get_node_id(),
                soft=True),
        ).remote(
            dumps(self.train_loop_per_worker),
            self.train_loop_config,
            self.scaling_config,
            self.run_config,
            run_dir,
            self._dataset_shards(),
        )
        ray_tpu_torch.get(controller._set_self.remote(controller), timeout=300)
        out = ray_tpu_torch.get(controller.run.remote(), timeout=7 * 24 * 3600)
        ray_tpu_torch.kill(controller)
        ckpt = Checkpoint(out["checkpoint_path"]) if out.get("checkpoint_path") else None
        result = Result(metrics=out.get("metrics") or {}, checkpoint=ckpt,
                        error=out.get("error"), path=run_dir)
        if result.error:
            raise TrainingFailedError(result.error)
        return result


class TrainingFailedError(RuntimeError):
    pass


class TorchTrainer(DataParallelTrainer):
    """The PyTorch flavor, the counterpart of ``JaxTrainer``: multi-worker
    GPU groups default to forming the ``torch.distributed`` default process
    group (NCCL) across the workers before the loop runs, as
    ``JaxTrainer`` bootstraps ``jax.distributed`` for TPU groups
    (reference: train/v2/torch/config.py)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.scaling_config.bootstrap_distributed is None and \
                self.scaling_config.num_workers > 1:
            self.scaling_config.bootstrap_distributed = self.scaling_config.use_gpu
