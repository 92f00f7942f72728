"""A mirror of ``tests/test_refcounting.py`` on the port's runtime
(``ray_tpu_torch``, on the CPU): the same scenarios and assertions.

Ownership-based distributed refcounting + lineage reconstruction.

Reference tier: python/ray/tests/test_reference_counting*.py and
test_reconstruction*.py — owner frees objects cluster-wide when local refs,
in-flight submissions, and borrowers all reach zero
(src/ray/core_worker/reference_counter.h:44); lost task outputs are rebuilt
by re-executing the producing task from retained lineage
(object_recovery_manager.h:41, task_manager.h:183).
"""

import gc
import time

import numpy as np
import pytest

from ray_tpu_torch._private import wire
import ray_tpu_torch


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, device="cpu")
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _store_objects():
    w = ray_tpu_torch._private.worker.global_worker()
    return wire.loads(w._run(w.raylet.call("StoreStats", b"")))["num_objects"]


def _wait_store_below(n, timeout=15.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if _store_objects() <= n:
            return True
        time.sleep(0.25)
    return False


def test_put_freed_on_ref_drop(cluster):
    before = _store_objects()
    ref = ray_tpu_torch.put(np.arange(300_000))
    assert ray_tpu_torch.get(ref, timeout=60)[5] == 5
    assert _store_objects() == before + 1
    del ref
    gc.collect()
    assert _wait_store_below(before), "dropped put ref was not freed"


def test_task_return_freed_on_ref_drop(cluster):
    @ray_tpu_torch.remote
    def big():
        return np.ones(400_000)

    before = _store_objects()
    ref = big.remote()
    assert ray_tpu_torch.get(ref, timeout=60).shape == (400_000,)
    del ref
    gc.collect()
    assert _wait_store_below(before), "dropped task-return ref was not freed"


def test_ref_alive_while_held(cluster):
    ref = ray_tpu_torch.put(np.full(300_000, 3.0))
    time.sleep(2.5)  # longer than the free grace period
    assert ray_tpu_torch.get(ref, timeout=60)[0] == 3.0
    del ref
    gc.collect()


def test_borrower_keeps_object_alive(cluster):
    @ray_tpu_torch.remote
    class Holder:
        def __init__(self):
            self.box = None

        def stash(self, box):
            self.box = box  # keeps the contained ref: becomes a borrower
            return "ok"

        def read(self):
            return float(ray_tpu_torch.get(self.box[0])[0])

        def drop(self):
            self.box = None
            return "dropped"

    h = Holder.remote()
    ref = ray_tpu_torch.put(np.full(300_000, 7.0))
    assert ray_tpu_torch.get(h.stash.remote([ref]), timeout=60) == "ok"
    del ref
    gc.collect()
    time.sleep(3.0)  # owner zero + grace passed; borrow must protect it
    assert ray_tpu_torch.get(h.read.remote(), timeout=60) == 7.0


def test_borrow_release_frees_object(cluster):
    @ray_tpu_torch.remote
    class Holder2:
        def __init__(self):
            self.box = None

        def stash(self, box):
            self.box = box
            return "ok"

        def drop(self):
            self.box = None
            return "dropped"

    h = Holder2.remote()
    before = _store_objects()
    ref = ray_tpu_torch.put(np.full(300_000, 9.0))
    assert ray_tpu_torch.get(h.stash.remote([ref]), timeout=60) == "ok"
    time.sleep(1.0)  # let the borrow register
    del ref
    gc.collect()
    assert ray_tpu_torch.get(h.drop.remote(), timeout=60) == "dropped"
    assert _wait_store_below(before, timeout=20.0), (
        "object not freed after the last borrower released it")


def test_inflight_args_pinned(cluster):
    """A ref dropped right after submission must survive until the task
    consumed it (submission pins)."""

    @ray_tpu_torch.remote
    def slow_read(arr):
        time.sleep(2.0)
        return float(arr[0])

    ref = ray_tpu_torch.put(np.full(300_000, 11.0))
    out = slow_read.remote(ref)
    del ref
    gc.collect()
    assert ray_tpu_torch.get(out, timeout=60) == 11.0


def test_nested_ref_in_stored_value_pinned(cluster):
    """A large stored value containing a ref pins the inner object."""
    inner = ray_tpu_torch.put(np.full(200_000, 13.0))
    outer = ray_tpu_torch.put({"pad": np.zeros(200_000), "inner": inner})
    del inner
    gc.collect()
    time.sleep(2.5)
    got = ray_tpu_torch.get(outer, timeout=60)
    assert ray_tpu_torch.get(got["inner"], timeout=60)[0] == 13.0
    del got, outer
    gc.collect()


def test_lineage_reconstruction_after_node_death():
    """Kill the node holding the only copy of a task output; a downstream
    consumer must still complete via lineage re-execution."""
    from ray_tpu_torch.cluster_utils import Cluster

    ray_tpu_torch.shutdown()
    cluster = Cluster(head_node_args={"resources": {"CPU": 2.0}})
    node_b = cluster.add_node(resources={"CPU": 2.0, "zone_b": 2.0})
    ray_tpu_torch.init(address=cluster.address)
    try:
        cluster.wait_for_nodes(2)

        @ray_tpu_torch.remote(resources={"zone_b": 0.1}, num_cpus=0.1, max_retries=3)
        def produce(seed):
            return np.full(300_000, float(seed))

        @ray_tpu_torch.remote(num_cpus=0.1, max_retries=3)
        def consume(arr):
            return float(arr[0]) + float(arr[-1])

        ref = produce.remote(21)
        assert ray_tpu_torch.get(ref, timeout=120)[0] == 21.0
        cluster.remove_node(node_b)
        time.sleep(1.0)
        cluster.add_node(resources={"CPU": 2.0, "zone_b": 2.0})
        cluster.wait_for_nodes(2)  # head + replacement (the killed node may already be marked dead)
        assert ray_tpu_torch.get(consume.remote(ref), timeout=180) == 42.0
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()


def test_lineage_reconstruction_recursive():
    """A lost intermediate whose own args were also lost reconstructs the
    whole upstream chain."""
    from ray_tpu_torch.cluster_utils import Cluster

    ray_tpu_torch.shutdown()
    cluster = Cluster(head_node_args={"resources": {"CPU": 2.0}})
    node_b = cluster.add_node(resources={"CPU": 2.0, "zone_b": 2.0})
    ray_tpu_torch.init(address=cluster.address)
    try:
        cluster.wait_for_nodes(2)

        @ray_tpu_torch.remote(resources={"zone_b": 0.1}, num_cpus=0.1, max_retries=3)
        def stage1():
            return np.full(300_000, 5.0)

        @ray_tpu_torch.remote(resources={"zone_b": 0.1}, num_cpus=0.1, max_retries=3)
        def stage2(arr):
            return arr * 2.0

        r1 = stage1.remote()
        r2 = stage2.remote(r1)
        assert ray_tpu_torch.get(r2, timeout=120)[0] == 10.0
        cluster.remove_node(node_b)  # both copies gone
        time.sleep(1.0)
        cluster.add_node(resources={"CPU": 2.0, "zone_b": 2.0})
        cluster.wait_for_nodes(2)  # head + replacement (the killed node may already be marked dead)

        @ray_tpu_torch.remote(num_cpus=0.1)
        def consume(arr):
            return float(arr[17])

        assert ray_tpu_torch.get(consume.remote(r2), timeout=180) == 10.0
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()
