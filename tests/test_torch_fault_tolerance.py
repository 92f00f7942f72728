"""A mirror of ``tests/test_fault_tolerance.py`` on the port's runtime
(``ray_tpu_torch``, on the CPU): the same scenarios and assertions.

Fault tolerance: task retries, actor restarts, node failure.

Reference tier: python/ray/tests/test_failure*.py + chaos tests (SURVEY.md §4)
driven through the cluster_utils harness.
"""

import os
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.exceptions import TaskError


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, device="cpu")
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_task_retry_on_worker_death(cluster):
    @ray_tpu_torch.remote(max_retries=3)
    def die_once(path):
        # first attempt kills its worker; the retry succeeds
        if not os.path.exists(path):
            open(path, "w").close()
            os._exit(1)
        return "survived"

    marker = f"/tmp/ray_tpu_die_once_{time.time()}"
    try:
        assert ray_tpu_torch.get(die_once.remote(marker), timeout=120) == "survived"
    finally:
        if os.path.exists(marker):
            os.unlink(marker)


def test_task_no_retry_exhausted(cluster):
    @ray_tpu_torch.remote(max_retries=1)
    def always_dies():
        os._exit(1)

    with pytest.raises(TaskError, match="worker died"):
        ray_tpu_torch.get(always_dies.remote(), timeout=120)


def test_actor_restart(cluster):
    @ray_tpu_torch.remote(max_restarts=2)
    class Flaky:
        def __init__(self):
            self.count = 0

        def crash(self):
            os._exit(1)

        def ping(self):
            self.count += 1
            return self.count

    a = Flaky.remote()
    assert ray_tpu_torch.get(a.ping.remote(), timeout=60) == 1
    with pytest.raises(TaskError):
        ray_tpu_torch.get(a.crash.remote(), timeout=60)  # kills the actor process
    # actor restarts (state resets) and serves again
    deadline = time.time() + 60
    value = None
    while time.time() < deadline:
        try:
            value = ray_tpu_torch.get(a.ping.remote(), timeout=30)
            break
        except TaskError:
            time.sleep(0.5)
    assert value == 1  # fresh instance after restart


def test_actor_dead_after_max_restarts(cluster):
    @ray_tpu_torch.remote(max_restarts=0)
    class Fragile:
        def go(self):
            os._exit(1)

    a = Fragile.remote()
    a.go.remote()
    time.sleep(1.0)
    with pytest.raises(TaskError, match="(?i)actor"):
        ray_tpu_torch.get(a.go.remote(), timeout=60)


def test_kill_actor(cluster):
    @ray_tpu_torch.remote
    class Victim:
        def ping(self):
            return "ok"

    a = Victim.remote()
    assert ray_tpu_torch.get(a.ping.remote(), timeout=60) == "ok"
    ray_tpu_torch.kill(a)
    time.sleep(0.5)
    with pytest.raises(TaskError, match="(?i)actor"):
        ray_tpu_torch.get(a.ping.remote(), timeout=60)
