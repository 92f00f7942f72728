"""A mirror of ``tests/test_gcs_ft.py`` on the port's runtime
(``ray_tpu_torch``, on the CPU): the same scenarios and assertions.

GCS fault tolerance: kill + restart the control plane and verify the
cluster survives (reference: GCS FT via Redis-backed store_client +
GcsInitData replay on restart, SURVEY.md §5)."""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster


@pytest.fixture
def ft_cluster():
    ray_tpu_torch.shutdown()
    cluster = Cluster(head_node_args={
        "resources": {"CPU": 4.0}, "gcs_fault_tolerance": True})
    ray_tpu_torch.init(address=cluster.address)
    yield cluster
    ray_tpu_torch.shutdown()
    cluster.shutdown()


def _kv(method, req):
    from ray_tpu_torch._private.worker import global_worker

    core = global_worker()
    return core._run(core._gcs_call(method, req))


def test_gcs_restart_preserves_cluster_state(ft_cluster):
    @ray_tpu_torch.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def incr(self):
            self.n += 1
            return self.n

    c = Counter.options(
        name="survivor", lifetime="detached", num_cpus=0.1).remote()
    assert ray_tpu_torch.get(c.incr.remote(), timeout=60) == 1
    _kv("KVPut", {"ns": "t", "key": "durable", "value": b"payload"})

    ft_cluster.kill_gcs()
    time.sleep(0.3)
    ft_cluster.restart_gcs()

    # named actor still resolvable; its in-memory state survived because the
    # worker process never died — only the control plane blinked
    h = ray_tpu_torch.get_actor("survivor")
    assert ray_tpu_torch.get(h.incr.remote(), timeout=60) == 2
    # KV table replayed from the durable store (public API)
    from ray_tpu_torch.experimental.internal_kv import _internal_kv_get

    assert _internal_kv_get(b"durable", namespace="t") == b"payload"
    # nodes replayed: new work is schedulable immediately
    @ray_tpu_torch.remote
    def probe():
        return 42

    assert ray_tpu_torch.get(probe.remote(), timeout=60) == 42
    total = ray_tpu_torch.cluster_resources()
    assert total.get("CPU") == 4.0


def test_gcs_restart_actor_restart_still_works(ft_cluster):
    """max_restarts actor killed AFTER a GCS restart is restarted by the
    replayed record (restart budget persisted)."""

    @ray_tpu_torch.remote(max_restarts=1, max_task_retries=2)
    class Phoenix:
        def pid(self):
            import os

            return os.getpid()

    p = Phoenix.options(name="phoenix", num_cpus=0.1).remote()
    pid1 = ray_tpu_torch.get(p.pid.remote(), timeout=60)

    ft_cluster.kill_gcs()
    time.sleep(0.3)
    ft_cluster.restart_gcs()

    import os
    import signal

    os.kill(pid1, signal.SIGKILL)
    deadline = time.monotonic() + 60
    pid2 = None
    while time.monotonic() < deadline:
        try:
            pid2 = ray_tpu_torch.get(p.pid.remote(), timeout=30)
            break
        except Exception:
            time.sleep(0.5)
    assert pid2 is not None and pid2 != pid1
