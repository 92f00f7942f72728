"""Per-worker train context: rank info + report plumbing, the port of
``ray_tpu/train/context.py``.

Reference: ray.train.get_context() / ray.train.report (train/v2 api);
``report(metrics, checkpoint=...)`` ships the checkpoint to storage and
notifies the controller (checkpoint/report_handler in the reference).
The grad-sync helpers build the port's bucketed tier
(``collective/bucketed.py``) over the worker group's collective groups;
trees are flat dicts of tensors keyed by flax path.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint

_ctx = threading.local()


class TrainContext:
    def __init__(self, rank: int, world_size: int, local_rank: int,
                 node_rank: int, controller, latest_checkpoint: Optional[Checkpoint],
                 config: Optional[Dict[str, Any]] = None,
                 dataset_shards: Optional[Dict[str, Any]] = None,
                 grad_sync: Optional[Dict[str, Any]] = None):
        self.rank = rank
        self.world_size = world_size
        self.local_rank = local_rank
        self.node_rank = node_rank
        self.controller = controller
        self.latest_checkpoint = latest_checkpoint
        self.config = config or {}
        self.dataset_shards = dataset_shards or {}
        # {"group": name, "world_size": N, "backend": ..., "bucket_bytes":
        # B} when the worker group set up bucketed grad sync (the
        # collective groups are already initialized in this process)
        self.grad_sync = grad_sync

    def get_world_size(self) -> int:
        return self.world_size

    def get_world_rank(self) -> int:
        return self.rank

    def get_local_rank(self) -> int:
        return self.local_rank

    def get_node_rank(self) -> int:
        return self.node_rank

    def get_checkpoint(self) -> Optional[Checkpoint]:
        return self.latest_checkpoint

    def get_dataset_shard(self, name: str = "train"):
        shard = self.dataset_shards.get(name)
        if shard is None:
            raise KeyError(f"no dataset shard named {name!r}")
        return shard

    # -- bucketed grad sync (collective/bucketed.py) ----------------------

    def _require_grad_sync(self) -> Dict[str, Any]:
        if not self.grad_sync:
            raise RuntimeError(
                "grad sync is not configured for this worker group — set "
                "ScalingConfig.grad_sync_backend (with num_workers > 1)")
        return self.grad_sync

    def make_bucket_reducer(self, params_like: Any,
                            compression: Any = "__default__"):
        """An AsyncBucketReducer over this group's grad-sync plane, with a
        bucket plan derived from ``params_like`` (every worker must build
        it over the same tree — bucket order is the collective order).
        Rides the dedicated ``.user`` sibling group so it can never
        interleave with a sharded optimizer's internal reducer; keep at
        most ONE live reducer per worker. ``compression`` defaults to
        ``ScalingConfig.grad_sync_compression`` (pass None/int8/fp8/bf16
        to override per reducer; every rank must pick the same). The tensors
        reduced lie on the group's device: the CPU for gloo, the card for
        NCCL."""
        from ray_tpu_torch.collective.bucketed import (AsyncBucketReducer,
                                                 leaf_meta, plan_buckets)

        gs = self._require_grad_sync()
        if compression == "__default__":
            compression = gs.get("compression")
        plan = plan_buckets(leaf_meta(params_like),
                            bucket_bytes=gs["bucket_bytes"],
                            world_size=self.world_size)
        return AsyncBucketReducer(f"{gs['group']}.user", plan,
                                  compression=compression)

    def make_sharded_optimizer(self, optimizer, params, *,
                               clip_global_norm: Optional[float] = None,
                               grad_scale: float = 1.0,
                               compression: Any = "__default__"):
        """A cross-replica ShardedBucketOptimizer: this worker keeps
        optimizer state only for its ~1/world_size of the buckets and the
        update pipeline overlaps bucket collectives with bucket applies.

        ``optimizer`` must be one of the port's PER-LEAF optimizers
        (``bucketed.Adam`` or ``parallel.make_optimizer(clip=None)``): it is
        applied bucket by bucket, so a clipping optimizer is refused; pass
        ``clip_global_norm=`` instead (computed globally from shard-local
        sqnorms)."""
        from ray_tpu_torch.collective.bucketed import (ShardedBucketOptimizer,
                                                 leaf_meta, plan_buckets)

        gs = self._require_grad_sync()
        if compression == "__default__":
            compression = gs.get("compression")
        plan = plan_buckets(leaf_meta(params),
                            bucket_bytes=gs["bucket_bytes"],
                            world_size=self.world_size)
        return ShardedBucketOptimizer(
            gs["group"], plan, self.rank, optimizer, params,
            clip_global_norm=clip_global_norm, grad_scale=grad_scale,
            compression=compression)


def set_context(ctx: Optional[TrainContext]):
    _ctx.value = ctx


def get_context() -> TrainContext:
    ctx = getattr(_ctx, "value", None)
    if ctx is None:
        raise RuntimeError("not inside a train worker (ray_tpu_torch.train "
                           "loop)")
    return ctx


_savers: Dict[str, Any] = {}  # store root -> per-process async saver
_savers_lock = threading.Lock()


def _saver_for(run_dir: str):
    from ray_tpu_torch.ckpt import CheckpointSaver
    from ray_tpu_torch.train.checkpoint import checkpoint_store

    store = checkpoint_store(run_dir)
    with _savers_lock:
        saver = _savers.get(store.root)
        if saver is None:
            saver = _savers[store.root] = CheckpointSaver(store)
        return saver


def report(metrics: Dict[str, Any], checkpoint: Optional[Checkpoint] = None):
    """Report metrics (all ranks) and optionally a checkpoint (rank 0 ships
    it through the checkpoint plane; other ranks' checkpoints are ignored —
    single-writer checkpoint layout).

    The save is ASYNC: the checkpoint directory's bytes are snapshotted to
    RAM here (so the caller may delete the directory immediately), the
    chunk writes + manifest commit happen on a background thread, and only
    the manifest id rides the report RPC. A second checkpointed report
    while the previous save is still writing blocks then (backpressure),
    never mid-step."""
    import ray_tpu_torch
    from ray_tpu_torch.train.checkpoint import dir_to_tree
    from ray_tpu_torch.util import goodput

    ctx = get_context()
    if "mfu" in metrics:
        try:
            goodput.note_mfu(float(metrics["mfu"]))
        except (TypeError, ValueError):
            pass
    ckpt_ref = None
    if checkpoint is not None and ctx.rank == 0:
        run_dir = getattr(ctx, "run_dir", None)
        if run_dir:
            step = int(metrics.get("step", metrics.get(
                "training_iteration", 0)) or 0)
            tree = dir_to_tree(checkpoint.as_directory())
            ckpt_ref = _saver_for(run_dir).save(tree, step=step,
                                                metrics=metrics)
        else:
            # no shared run dir (a bare context in unit tests): hand the
            # directory itself over; the controller saves it blocking
            ckpt_ref = {"dir": checkpoint.as_directory()}
    ray_tpu_torch.get(ctx.controller._on_report.remote(ctx.rank, metrics,
                                                       ckpt_ref),
                      timeout=300)


def get_checkpoint() -> Optional[Checkpoint]:
    return get_context().get_checkpoint()


def get_dataset_shard(name: str = "train"):
    return get_context().get_dataset_shard(name)
