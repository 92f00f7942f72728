"""Placement groups on the port's runtime, on a multi-node cluster of one
host (``cluster_utils.Cluster``): a mirror of ``tests/test_placement_groups.py``
(PACK, STRICT_SPREAD, resources returned on remove, no leak after a lease
returns, the state API; ``slice_placement_group`` has no counterpart), and a
``num_gpus=1`` actor in a ``GPU`` bundle, which runs on its node's card and
gives it back when the group is removed. The nodes declare their cards as a
``GPU`` resource, so this runs on the CPU.

Every cluster call carries its own timeout."""

import os
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.util.placement_group import (get_placement_group_state,
                                                placement_group,
                                                remove_placement_group)
from ray_tpu_torch.util.scheduling_strategies import (
    NodeAffinitySchedulingStrategy, PlacementGroupSchedulingStrategy)

T = 60  # seconds, each cluster call


@pytest.fixture(scope="module")
def gpu_cluster():
    """Head (2 CPUs) + 2 nodes of 4 CPUs and one card each."""
    ray_tpu_torch.shutdown()
    cluster = Cluster(head_node_args={"resources": {"CPU": 2.0}})
    for name in ("node-a", "node-b"):
        cluster.add_node(resources={"CPU": 4.0, "GPU": 1.0},
                         labels={"test/node": name})
    ray_tpu_torch.init(address=cluster.address)
    cluster.wait_for_nodes(3)
    yield cluster
    ray_tpu_torch.shutdown()
    cluster.shutdown()


def test_pg_pack_and_task(gpu_cluster):
    pg = placement_group([{"CPU": 1.0}, {"CPU": 1.0}], strategy="PACK")
    assert pg.ready(timeout=T)

    @ray_tpu_torch.remote(num_cpus=1)
    def where():
        return ray_tpu_torch.get_runtime_context().get_node_id()

    strat = PlacementGroupSchedulingStrategy(pg, placement_group_bundle_index=0)
    node = ray_tpu_torch.get(where.options(scheduling_strategy=strat).remote(),
                             timeout=T)
    assert node in [n["node_id"] for n in ray_tpu_torch.nodes()]
    assert node == pg.bundle_nodes()[0]
    remove_placement_group(pg)


def test_pg_strict_spread(gpu_cluster):
    pg = placement_group([{"CPU": 1.0}] * 3, strategy="STRICT_SPREAD")
    assert pg.ready(timeout=T)
    nodes = pg.bundle_nodes()
    assert len(set(nodes)) == 3
    remove_placement_group(pg)


def _wait_resource(predicate, key="CPU", timeout=20.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        value = ray_tpu_torch.available_resources().get(key, 0)
        if predicate(value):
            return value
        time.sleep(0.3)
    return ray_tpu_torch.available_resources().get(key, 0)


def _dump_nodes():
    """Per-node availability snapshot for accounting-failure diagnostics."""
    try:
        return "; ".join(
            f"{n['node_id'][:8]}: avail={n.get('available')}"
            for n in ray_tpu_torch.nodes())
    except Exception as e:  # diagnostics must never mask the assert
        return f"(node dump failed: {e})"


def test_pg_resources_returned_on_remove(gpu_cluster):
    total = ray_tpu_torch.cluster_resources()["CPU"]  # 2 + 2*4 = 10
    before = _wait_resource(lambda v: v >= total - 0.1)  # quiesce
    assert before <= total + 0.01, (
        f"available CPU {before} exceeds cluster total {total}: a lease or "
        f"bundle release double-credited a node pool")
    pg = placement_group([{"CPU": 2.0}], strategy="PACK")
    assert pg.ready(timeout=T)
    during = _wait_resource(lambda v: v <= before - 2.0 + 0.01)
    assert during <= before - 2.0 + 0.01, _dump_nodes()
    remove_placement_group(pg)
    after = _wait_resource(lambda v: v >= before - 0.01)
    assert after >= before - 0.01, _dump_nodes()
    assert after <= total + 0.01, _dump_nodes()


def test_pg_lease_return_after_remove_no_leak(gpu_cluster):
    """A worker lease granted from a PG bundle whose group is removed before
    the idle lease returns must NOT credit the node's main pool —
    ReleasePGBundles already returned the whole reserve."""
    total = ray_tpu_torch.cluster_resources()["CPU"]
    _wait_resource(lambda v: v >= total - 0.1)
    pg = placement_group([{"CPU": 2.0}], strategy="PACK")
    assert pg.ready(timeout=T)

    @ray_tpu_torch.remote(num_cpus=1)
    def touch():
        return 1

    strat = PlacementGroupSchedulingStrategy(pg, placement_group_bundle_index=0)
    assert ray_tpu_torch.get(touch.options(scheduling_strategy=strat).remote(),
                             timeout=T) == 1
    # remove the group while the 1-CPU lease is still idle-cached
    remove_placement_group(pg)
    deadline = time.time() + 10.0
    while time.time() < deadline:
        avail = ray_tpu_torch.available_resources().get("CPU", 0.0)
        assert avail <= total + 0.01, (
            f"available CPU {avail} exceeds total {total}: dead-PG lease "
            f"return double-credited the node pool")
        time.sleep(0.25)
    assert _wait_resource(lambda v: v >= total - 0.1) >= total - 0.1


def test_pg_state_api(gpu_cluster):
    pg = placement_group([{"CPU": 1.0}], strategy="PACK", name="mypg")
    assert pg.ready(timeout=T)
    info = get_placement_group_state(pg)
    assert info["state"] == "CREATED" and info["name"] == "mypg"
    remove_placement_group(pg)
    assert get_placement_group_state(pg)["state"] == "REMOVED"


@ray_tpu_torch.remote(num_cpus=0)
class CardHolder:
    def where(self):
        return (ray_tpu_torch.get_runtime_context().get_node_id(),
                os.environ.get("CUDA_VISIBLE_DEVICES"), os.getpid())


def test_gpu_actor_in_a_gpu_bundle_gets_the_card_and_gives_it_back(
        gpu_cluster):
    """A ``num_gpus=1`` actor in a ``{"CPU": 1, "GPU": 1}`` bundle runs in a
    worker forked with ``CUDA_VISIBLE_DEVICES`` naming its node's card.
    While the group holds both cards, an actor outside it pends; removing
    the group returns the bundle and the card, and that actor then starts
    on the freed card of the same node."""
    gpus = ray_tpu_torch.cluster_resources()["GPU"]
    assert gpus == 2.0
    assert _wait_resource(lambda v: v >= gpus, "GPU") == gpus
    pg = placement_group([{"CPU": 1.0, "GPU": 1.0}] * 2, strategy="SPREAD")
    assert pg.ready(timeout=T)
    holders = [CardHolder.options(
        num_cpus=1, num_gpus=1,
        scheduling_strategy=PlacementGroupSchedulingStrategy(pg, i)).remote()
        for i in range(2)]
    seen = ray_tpu_torch.get([h.where.remote() for h in holders], timeout=T)
    assert [node for node, _, _ in seen] == pg.bundle_nodes()
    assert [card for _, card, _ in seen] == ["0", "0"]  # one card a node
    assert _wait_resource(lambda v: v <= 0.0, "GPU") == 0.0

    node = seen[0][0]
    late = CardHolder.options(
        num_gpus=1, scheduling_strategy=NodeAffinitySchedulingStrategy(
            node_id=node)).remote()
    pending = late.where.remote()
    ready, _ = ray_tpu_torch.wait([pending], timeout=3.0)
    assert ready == []  # the group holds the node's only card
    for h in holders:
        ray_tpu_torch.kill(h)
    remove_placement_group(pg)
    got_node, got_card, got_pid = ray_tpu_torch.get(pending, timeout=T)
    assert (got_node, got_card) == (node, "0")
    assert got_pid not in {pid for _, _, pid in seen}
    ray_tpu_torch.kill(late)
    assert _wait_resource(lambda v: v >= gpus, "GPU") == gpus, _dump_nodes()
