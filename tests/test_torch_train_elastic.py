"""Elastic train on the port's runtime: a mirror of
``tests/test_train_elastic.py`` on ``TorchTrainer``. Losing a node mid-run
re-forms the worker group at the largest mesh-shaped size the shrunken
cluster can host and resumes from the latest checkpoint, in fresh
processes. The cluster's health checks run at 0.2 s with a 1 s timeout
(``RAY_TPU_HEALTH_CHECK_*`` in the environment of every process it starts),
so the node's death and the controller's settle take seconds.

Every cluster call carries its own timeout."""

import json
import os
import threading
import time

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.train import (FailureConfig, RunConfig, ScalingConfig,
                                 TorchTrainer)

HEALTH = {"RAY_TPU_HEALTH_CHECK_PERIOD_MS": "200",
          "RAY_TPU_HEALTH_CHECK_TIMEOUT_MS": "1000"}


def _elastic_loop(config):
    """Checkpoints every step; crashes the whole group when a worker dies
    (rank 1+ sleeps forever on a dead node -> the group task fails)."""
    import tempfile

    from ray_tpu_torch import train
    from ray_tpu_torch.train import Checkpoint

    ctx = train.get_context()
    start = 0
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        with open(os.path.join(ckpt.as_directory(), "state.json")) as f:
            start = json.load(f)["step"]
    marker = config["marker"]
    for step in range(start, config["steps"]):
        if step == 2 and ctx.get_world_size() == 4:
            # first incarnation: EVERY worker stalls (per-rank marker) so
            # none finishes before the driver kills node B mid-training
            open(f"{marker}.{ctx.get_world_rank()}", "w").close()
            time.sleep(600.0)
        metrics = {"step": step + 1, "world_size": ctx.get_world_size(),
                   "start": start}
        if ctx.get_world_rank() == 0:
            with tempfile.TemporaryDirectory() as d:
                with open(os.path.join(d, "state.json"), "w") as f:
                    json.dump({"step": step + 1}, f)
                train.report(metrics, checkpoint=Checkpoint.from_directory(d))
        else:
            train.report(metrics)
    return {"final_world_size": ctx.get_world_size(), "resumed_from": start}


def test_elastic_reform_after_node_loss(tmp_path):
    ray_tpu_torch.shutdown()
    saved = {k: os.environ.get(k) for k in HEALTH}
    os.environ.update(HEALTH)
    try:
        cluster = Cluster(head_node_args={"resources": {"CPU": 3.0}})
        node_b = cluster.add_node(resources={"CPU": 2.0})
        ray_tpu_torch.init(address=cluster.address)
        cluster.wait_for_nodes(2)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    marker = str(tmp_path / "stall_once")
    try:
        trainer = TorchTrainer(
            _elastic_loop,
            train_loop_config={"steps": 5, "marker": marker},
            scaling_config=ScalingConfig(
                num_workers=4, elastic=True, min_workers=1,
                elastic_granularity="pow2",
                resources_per_worker={"CPU": 1.0}),
            run_config=RunConfig(
                storage_path=str(tmp_path / "runs"), name="elastic",
                failure_config=FailureConfig(max_failures=2)),
        )
        result_box = {}

        def _fit():
            result_box["result"] = trainer.fit()

        t = threading.Thread(target=_fit, daemon=True)
        t.start()
        # wait for the first incarnation (4 workers) to all reach the stall
        deadline = time.time() + 120
        while sum(os.path.exists(f"{marker}.{r}") for r in range(4)) < 4:
            assert time.time() < deadline, "group never started training"
            time.sleep(0.5)
        time.sleep(1.0)
        cluster.remove_node(node_b)  # kills the workers living there
        t.join(timeout=300)
        assert not t.is_alive(), "training did not finish after node loss"
        result = result_box["result"]
        assert result.error is None, result.error
        # 3 CPUs remain on the head; pow2 floor of min(4, feasible)
        assert result.metrics["world_size"] == 2, result.metrics
        # the re-formed group resumed from the checkpointed step, not 0
        assert result.metrics["step"] == 5
        assert result.metrics["start"] == 2
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()
