"""A mirror of ``tests/test_multinode.py`` on the port's runtime
(``ray_tpu_torch``, on the CPU): the same scenarios and assertions.

Multi-node tests via the cluster_utils harness: cross-node objects,
label scheduling, node failure (reference: python/ray/tests with
ray_start_cluster, SURVEY.md §4)."""

import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.util.scheduling_strategies import NodeLabelSchedulingStrategy


@pytest.fixture(scope="module")
def multinode():
    ray_tpu_torch.shutdown()
    cluster = Cluster(head_node_args={"resources": {"CPU": 2.0}})
    cluster.add_node(resources={"CPU": 2.0, "zone_b": 1.0},
                     labels={"zone": "b"})
    ray_tpu_torch.init(address=cluster.address)
    cluster.wait_for_nodes(2)
    yield cluster
    ray_tpu_torch.shutdown()
    cluster.shutdown()


def test_two_nodes_visible(multinode):
    nodes = [n for n in ray_tpu_torch.nodes() if n["alive"]]
    assert len(nodes) == 2
    assert ray_tpu_torch.cluster_resources()["CPU"] == 4.0


def test_custom_resource_routing(multinode):
    @ray_tpu_torch.remote(resources={"zone_b": 0.1}, num_cpus=0.1)
    def where():
        return ray_tpu_torch.get_runtime_context().get_node_id()

    node_hex = ray_tpu_torch.get(where.remote(), timeout=60)
    labeled = [n for n in ray_tpu_torch.nodes() if n["labels"].get("zone") == "b"]
    assert node_hex == labeled[0]["node_id"]


def test_label_scheduling(multinode):
    @ray_tpu_torch.remote
    def where():
        return ray_tpu_torch.get_runtime_context().get_node_id()

    strat = NodeLabelSchedulingStrategy(hard={"zone": "b"})
    node_hex = ray_tpu_torch.get(
        where.options(scheduling_strategy=strat, num_cpus=0.1).remote(), timeout=60)
    labeled = [n for n in ray_tpu_torch.nodes() if n["labels"].get("zone") == "b"]
    assert node_hex == labeled[0]["node_id"]


def test_cross_node_object_transfer(multinode):
    """A large object produced on node B is pulled chunk-wise to node A."""

    @ray_tpu_torch.remote(resources={"zone_b": 0.1}, num_cpus=0.1)
    def produce():
        return np.full((2048, 1024), 7.0)  # 16 MiB

    @ray_tpu_torch.remote(num_cpus=0.1)
    def consume(arr):
        return float(arr.mean())

    ref = produce.remote()
    # force consumption with affinity away from b is not guaranteed; just
    # validate the value flows regardless of which node consumes it
    assert ray_tpu_torch.get(consume.remote(ref), timeout=120) == 7.0
    assert ray_tpu_torch.get(ref, timeout=120).shape == (2048, 1024)


def test_node_failure_detected(multinode):
    node = multinode.add_node(resources={"CPU": 1.0, "doomed": 1.0})
    multinode.wait_for_nodes(3)
    multinode.remove_node(node)
    deadline = time.time() + 30
    while time.time() < deadline:
        alive = [n for n in ray_tpu_torch.nodes() if n["alive"]]
        if len(alive) == 2:
            return
        time.sleep(0.5)
    raise AssertionError("GCS did not detect node death")
