"""A mirror of ``tests/test_two_level_scheduler.py`` on the port's runtime
(``ray_tpu_torch``, on the CPU): the same scenarios and assertions.

Two-level scheduling: local raylet grant + peer spillback via the synced
resource view, with no per-lease GCS round trip (reference:
cluster_lease_manager.cc:196 grant, :421 spillback; ray_syncer.h:89 views).
"""

import time

import pytest

from ray_tpu_torch._private import wire
import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster


@pytest.fixture
def two_node():
    ray_tpu_torch.shutdown()
    cluster = Cluster(head_node_args={"resources": {"CPU": 2.0}})
    cluster.add_node(resources={"CPU": 2.0, "zone_b": 4.0})
    ray_tpu_torch.init(address=cluster.address)
    cluster.wait_for_nodes(2)
    yield cluster
    ray_tpu_torch.shutdown()
    cluster.shutdown()


def test_spillback_reaches_remote_resource(two_node):
    """The head raylet lacks zone_b entirely: the lease must spill to the
    peer via the raylet's cluster view (by totals), not via GCS PickNode."""
    @ray_tpu_torch.remote(resources={"zone_b": 1.0}, num_cpus=0.1)
    def where():
        import os

        return os.getpid()

    pids = set(ray_tpu_torch.get([where.remote() for _ in range(4)], timeout=120))
    assert pids  # executed somewhere — and only node_b carries zone_b


def test_spillback_on_busy_local(two_node):
    """With the local node saturated by long tasks, new tasks spill to the
    peer instead of queueing behind them."""
    @ray_tpu_torch.remote(num_cpus=1.0)
    def hold(sec):
        time.sleep(sec)
        return "held"

    @ray_tpu_torch.remote(num_cpus=1.0)
    def quick(i):
        return i

    # saturate both local CPUs for a while
    holders = [hold.remote(15.0) for _ in range(2)]
    time.sleep(2.0)  # let them occupy the local pool + heartbeat propagate
    t0 = time.monotonic()
    out = ray_tpu_torch.get([quick.remote(i) for i in range(2)], timeout=120)
    dt = time.monotonic() - t0
    assert sorted(out) == [0, 1]
    # spilled tasks must not have waited for the 15s holders
    assert dt < 12.0, f"tasks queued behind saturated local node: {dt:.1f}s"
    ray_tpu_torch.get(holders, timeout=120)


def test_raylet_view_tracks_membership(two_node):
    """A raylet's synced view includes peers and marks dead ones."""

    w = ray_tpu_torch._private.worker.global_worker()

    def view():
        return wire.loads(w._run(w.raylet.call("GetNodeStats", b"")))

    stats = view()
    assert stats.get("cluster_view_size", 0) >= 2
