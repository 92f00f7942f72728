"""A mirror of ``tests/test_oom_defense.py`` on the port's runtime
(``ray_tpu_torch``, on the CPU): the same scenarios and assertions.

OOM defense: a worker that allocates unboundedly is killed by the node
memory monitor (group-by-owner, newest first) — the NODE survives, other
tasks keep running, and the task's owner sees OutOfMemoryError.

Reference: src/ray/common/memory_monitor.h:52,
src/ray/raylet/worker_killing_policy_group_by_owner.cc,
python/ray/tests/test_memory_pressure.py scenarios.

Uses the deterministic budget accounting mode
(RAY_TPU_MEMORY_MONITOR_CAPACITY_BYTES): usage = worker RSS / budget, so
the test is independent of the CI host's real memory pressure.
"""

import os
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.exceptions import OutOfMemoryError


@pytest.fixture
def oom_cluster():
    ray_tpu_torch.shutdown()
    # 500 MiB worker-RSS budget; the hog allocates well past it
    os.environ["RAY_TPU_MEMORY_MONITOR_CAPACITY_BYTES"] = str(500 * 1024 * 1024)
    os.environ["RAY_TPU_MEMORY_USAGE_THRESHOLD"] = "0.9"
    try:
        ray_tpu_torch.init(num_cpus=4, device="cpu")
        yield ray_tpu_torch
    finally:
        del os.environ["RAY_TPU_MEMORY_MONITOR_CAPACITY_BYTES"]
        del os.environ["RAY_TPU_MEMORY_USAGE_THRESHOLD"]
        ray_tpu_torch.shutdown()


def test_memory_hog_killed_node_survives(oom_cluster):
    @ray_tpu_torch.remote(max_retries=0, num_cpus=1.0)
    def hog():
        blocks = []
        while True:  # allocate ~50 MiB/step until the monitor intervenes
            blocks.append(bytearray(os.urandom(50 * 1024 * 1024)))
            time.sleep(0.1)

    @ray_tpu_torch.remote(num_cpus=1.0)
    def fine(i):
        return i * 2

    ref = hog.remote()
    with pytest.raises(OutOfMemoryError):
        ray_tpu_torch.get(ref, timeout=180)
    # the node survived: fresh tasks still schedule and run
    assert ray_tpu_torch.get([fine.remote(i) for i in range(4)],
                       timeout=120) == [0, 2, 4, 6]


def test_victim_policy_group_by_owner_newest_first():
    from ray_tpu_torch._private.memory_monitor import MemoryMonitor

    workers = [
        {"pid": 1, "job": "a", "started": 10.0},
        {"pid": 2, "job": "a", "started": 30.0},
        {"pid": 3, "job": "a", "started": 20.0},
        {"pid": 4, "job": "b", "started": 40.0},
    ]
    v = MemoryMonitor.pick_victim(workers)
    # job "a" is the largest group; its newest member (pid 2) dies first
    assert v["pid"] == 2

    assert MemoryMonitor.pick_victim([]) is None
