"""A mirror of ``tests/test_owner_directory.py`` on the port's runtime
(``ray_tpu_torch``, on the CPU): the same scenarios and assertions.

Owner-resident object directory (reference:
src/ray/object_manager/ownership_object_directory.cc — location reads are
served by the object's owner; the GCS keeps the durable write-through copy
as fallback)."""

import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch._private import wire
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy


@pytest.fixture
def two_nodes():
    ray_tpu_torch.shutdown()
    cluster = Cluster(initialize_head=True,
                      head_node_args={"resources": {"CPU": 2.0}})
    cluster.add_node(resources={"CPU": 2.0})
    ray_tpu_torch.init(address=cluster.address)
    from ray_tpu_torch.util.state import list_nodes

    deadline = time.time() + 60
    while time.time() < deadline:
        nodes = [n for n in list_nodes() if n["alive"]]
        if len(nodes) >= 2:
            break
        time.sleep(0.2)
    yield cluster, nodes
    ray_tpu_torch.shutdown()
    cluster.shutdown()


@ray_tpu_torch.remote(num_cpus=0.5)
def produce_big():
    return np.ones(1024 * 1024, dtype=np.uint8)


def test_owner_table_filled_and_queryable(two_nodes):
    cluster, nodes = two_nodes
    other_id = next(n["node_id"] for n in nodes if not n["is_head"])
    ref = produce_big.options(
        scheduling_strategy=NodeAffinitySchedulingStrategy(
            node_id=other_id)).remote()
    assert ray_tpu_torch.get(ref, timeout=120).sum() == 1024 * 1024

    from ray_tpu_torch._private import worker as worker_mod

    core = worker_mod.global_worker()
    # the raylet's seal announcement reaches the owner (this driver)
    deadline = time.time() + 30
    entry = None
    while time.time() < deadline:
        entry = core._obj_locations.get(ref.id.binary())
        if entry and entry["nodes"]:
            break
        time.sleep(0.2)
    assert entry and entry["nodes"], "owner never received the announcement"
    assert other_id in entry["nodes"]
    assert entry["size"] >= 1024 * 1024

    # the owner answers location queries over its worker RPC (what a
    # pulling raylet uses before falling back to the GCS)
    async def _query():
        reply = await core._worker_client(core.address).call(
            "ObjectLocQuery", wire.dumps({"oid": ref.id.binary()}),
            timeout=10.0)
        return wire.loads(reply)

    out = core._run(_query())
    assert any(loc["node_id"] == other_id for loc in out["locations"])

    # consuming on the head still pulls fine (owner-first read path)
    @ray_tpu_torch.remote(num_cpus=0.5)
    def consume(a):
        return int(a.sum())

    head_id = next(n["node_id"] for n in nodes if n["is_head"])
    assert ray_tpu_torch.get(consume.options(
        scheduling_strategy=NodeAffinitySchedulingStrategy(
            node_id=head_id)).remote(ref), timeout=120) == 1024 * 1024

    # freeing the ref clears the owner-resident entry
    del ref
    import gc

    gc.collect()
    deadline = time.time() + 30
    while time.time() < deadline:
        if not core._obj_locations:
            break
        time.sleep(0.2)
    assert not core._obj_locations, core._obj_locations


def test_owner_gone_falls_back_to_gcs(two_nodes):
    """A pull whose owner hint is unreachable must still resolve through
    the GCS directory copy."""
    cluster, nodes = two_nodes
    other_id = next(n["node_id"] for n in nodes if not n["is_head"])
    ref = produce_big.options(
        scheduling_strategy=NodeAffinitySchedulingStrategy(
            node_id=other_id)).remote()
    ray_tpu_torch.get(ref, timeout=120)

    from ray_tpu_torch._private import worker as worker_mod

    core = worker_mod.global_worker()

    # ask the HEAD raylet to pull with a bogus owner hint: the owner-first
    # leg fails fast and the GCS fallback serves the locations
    async def _pull_with_bad_owner():
        return wire.loads(await core.raylet.call("StoreGet", wire.dumps({
            "oid": ref.id.binary(), "timeout": 60.0, "pull": True,
            "owner": "127.0.0.1:1"}), timeout=70.0))

    reply = core._run(_pull_with_bad_owner())
    assert reply["status"] in ("shm", "shm_arena", "inline"), reply
