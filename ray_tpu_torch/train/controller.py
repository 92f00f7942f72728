"""TrainController: the actor orchestrating one training run, the port of
``ray_tpu/train/controller.py``.

Reference: train/v2/_internal/execution/controller/controller.py:100 — a
state machine that creates the worker group, polls it, applies the failure
policy (kill group -> recreate -> resume from latest checkpoint), and owns
the checkpoint manager.
"""

from __future__ import annotations

import os
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train.checkpoint import CheckpointManager
from ray_tpu_torch.train.config import RunConfig, ScalingConfig


@ray_tpu_torch.remote
class TrainController:
    """max_concurrency > 1 so _on_report lands while run() blocks."""

    def __init__(self, fn_blob: bytes, config: Optional[dict],
                 scaling: ScalingConfig, run_config: RunConfig,
                 run_dir: str, shards_per_rank: Optional[List[bytes]] = None):
        self.fn_blob = fn_blob
        self.config = config
        self.scaling = scaling
        self.run_config = run_config
        self.run_dir = run_dir
        self.shards_per_rank = shards_per_rank
        ckpt_cfg = run_config.checkpoint_config
        self.manager = CheckpointManager(
            run_dir, ckpt_cfg.num_to_keep, ckpt_cfg.checkpoint_score_attribute,
            ckpt_cfg.checkpoint_score_order)
        self._lock = threading.Lock()
        self.latest_metrics: Dict[str, Any] = {}
        self.state = "INITIALIZING"
        self._self_handle = None

    def _set_self(self, handle):
        self._self_handle = handle
        return True

    def _on_report(self, rank: int, metrics: Dict[str, Any],
                   ckpt_ref) -> bool:
        """``ckpt_ref`` is a checkpoint-plane manifest id (the worker-side
        async save path — chunks may still be committing when this lands),
        a ``{"dir": path}`` fallback for bare contexts, or None."""
        with self._lock:
            if rank == 0:
                self.latest_metrics = dict(metrics)
            if isinstance(ckpt_ref, str):
                self.manager.register_manifest(ckpt_ref, metrics)
            elif isinstance(ckpt_ref, dict) and ckpt_ref.get("dir"):
                self.manager.register(ckpt_ref["dir"], metrics)
        return True

    def status(self) -> Dict[str, Any]:
        return {"state": self.state, "metrics": dict(self.latest_metrics)}

    def _shards_for(self, size: int) -> Optional[List[bytes]]:
        """Dataset shards for a (possibly resized) group. An elastic shrink
        keeps the first ``size`` rank shards; the removed ranks' shards are
        dropped with a warning (full re-sharding needs the dataset layer)."""
        if self.shards_per_rank is None:
            return None
        if size < len(self.shards_per_rank):
            import logging

            logging.getLogger("ray_tpu_torch.train").warning(
                "elastic shrink to %d workers drops the dataset shards of "
                "ranks >= %d for this restart", size, size)
        return self.shards_per_rank[:size]

    def run(self) -> Dict[str, Any]:
        from ray_tpu_torch.train.scaling_policy import (make_scaling_policy,
                                                        sized)
        from ray_tpu_torch.train.worker_group import WorkerGroup
        from ray_tpu_torch.util import goodput

        goodput.set_job(self.run_dir.rsplit("/", 1)[-1])
        reform_started: Optional[float] = None
        failures = 0
        max_failures = self.run_config.failure_config.max_failures
        last_error = None
        policy = make_scaling_policy(self.scaling)
        size = policy.initial_size(ray_tpu_torch.available_resources())
        if size < 1:
            size = self.scaling.num_workers  # scheduler queues until ready
        while True:
            self.state = "SCHEDULING"
            scaling = sized(self.scaling, size)
            group = None
            try:
                # bounded group formation on elastic retries: if a stale
                # availability view sized too big, the PG never becomes
                # ready — fail into the retry loop (which re-sizes from a
                # fresher view) instead of hanging on it
                group = WorkerGroup(
                    scaling,
                    ready_timeout=60.0 if (failures and self.scaling.elastic)
                    else 600.0)
                bootstrap = scaling.bootstrap_distributed
                if bootstrap is None:
                    bootstrap = scaling.use_gpu and size > 1
                if bootstrap and size > 1:
                    group.bootstrap_distributed()
                if scaling.grad_sync_backend and size > 1:
                    # bucketed grad collectives for the loop (the group
                    # name carries the restart count, as the JAX one's,
                    # whose re-formed group must not collide with the dead
                    # one's store actor)
                    group.setup_grad_sync(
                        f"train.grads.{self.run_dir.rsplit('/', 1)[-1]}"
                        f".r{failures}",
                        backend=scaling.grad_sync_backend,
                        bucket_bytes=scaling.grad_sync_bucket_bytes,
                        compression=getattr(scaling,
                                            "grad_sync_compression", None))
                self.state = "RUNNING"
                if reform_started is not None:
                    # downtime window: first failure detection through the
                    # re-formed group going back to RUNNING
                    goodput.add("reform_downtime",
                                time.monotonic() - reform_started)
                    goodput.count("reforms")
                    reform_started = None
                refs = group.run(self.fn_blob, self.config, self._self_handle,
                                 self.manager.latest(), self.run_dir,
                                 self._shards_for(size))
                # wait-any, not rank-ordered get: a failure on ANY worker
                # must trigger recovery immediately — a plain get(refs)
                # blocks on rank 0 and never notices rank k>0 dying
                # (reference: the controller's worker poll, controller.py:269)
                by_idx: Dict[int, Any] = {}
                pending = {ref: i for i, ref in enumerate(refs)}
                run_deadline = time.monotonic() + 24 * 3600
                while pending:
                    remaining = run_deadline - time.monotonic()
                    if remaining <= 0:
                        # a wedged worker (no result, no error) must still
                        # fall into the failure policy, like the old
                        # bounded get did
                        raise TimeoutError(
                            f"{len(pending)} train workers produced no "
                            f"result within 24h")
                    ready, _ = ray_tpu_torch.wait(list(pending), num_returns=1,
                                            timeout=min(remaining, 3600.0))
                    for ref in ready:
                        by_idx[pending.pop(ref)] = ray_tpu_torch.get(
                            ref, timeout=300)  # raises the worker's error
                results = [by_idx[i] for i in range(len(refs))]
                self.state = "FINISHED"
                latest = self.manager.latest()
                return {
                    "metrics": self.latest_metrics or (
                        results[0].get("result") if isinstance(results[0], dict)
                        else {}),
                    "checkpoint_path": latest.path if latest else None,
                    "num_workers": size,
                    "error": None,
                }
            except Exception as e:  # worker failure, PG timeout, node loss
                last_error = str(e)
                failures += 1
                self.state = "RESTARTING"
                if reform_started is None:
                    reform_started = time.monotonic()
                if failures > max_failures:
                    latest = self.manager.latest()
                    self.state = "ERRORED"
                    return {
                        "metrics": self.latest_metrics,
                        "checkpoint_path": latest.path if latest else None,
                        "num_workers": size,
                        "error": f"train workers failed {failures}x "
                                 f"(max_failures={max_failures}): {last_error[:2000]}",
                    }
                if group is not None:  # creation itself may have raised
                    group.shutdown()  # release resources BEFORE re-sizing
                group = None
                if self.scaling.elastic:
                    # settle: size from a view taken AFTER the GCS node
                    # death-detection window (health_check timeout + slack)
                    # and stable across samples, or an elastic resize could
                    # target capacity that is about to be marked dead
                    from ray_tpu_torch._private.config import RAY_CONFIG

                    time.sleep(
                        (RAY_CONFIG.health_check_timeout_ms
                         + 3 * RAY_CONFIG.health_check_period_ms) / 1000.0)
                    avail = ray_tpu_torch.available_resources()
                    for _ in range(10):
                        time.sleep(1.5)
                        nxt = ray_tpu_torch.available_resources()
                        if nxt == avail:
                            break
                        avail = nxt
                else:
                    time.sleep(1.0)
                    avail = {}  # fixed policy ignores the view
                new_size = policy.size_after_failure(size, avail)
                if new_size is None:
                    latest = self.manager.latest()
                    self.state = "ERRORED"
                    return {
                        "metrics": self.latest_metrics,
                        "checkpoint_path": latest.path if latest else None,
                        "num_workers": size,
                        "error": ("cluster below the elastic minimum "
                                  f"({self.scaling.min_workers} workers): "
                                  f"{last_error[:1500]}"),
                    }
                size = new_size
            finally:
                if group is not None:
                    group.shutdown()
