"""A mirror of ``tests/test_locality_scheduling.py`` on the port's runtime
(``ray_tpu_torch``, on the CPU): the same scenarios and assertions.

Data-locality lease targeting (reference:
src/ray/core_worker/task_submission/lease_policy.cc — the lease chain starts
at the raylet holding the most argument bytes; spillback tie-breaks on the
same locality map)."""

import numpy as np
import pytest

import ray_tpu_torch
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

    import time

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
def produce():
    import ray_tpu_torch.runtime_context as rc

    return np.zeros(2 * 1024 * 1024, dtype=np.uint8), \
        rc.get_runtime_context().get_node_id()


@ray_tpu_torch.remote(num_cpus=0.5)
def consume(blob_and_node):
    import ray_tpu_torch.runtime_context as rc

    blob, producer_node = blob_and_node
    return len(blob), producer_node, rc.get_runtime_context().get_node_id()


def test_consumer_schedules_onto_arg_node(two_nodes):
    cluster, nodes = two_nodes
    head_id = next(n["node_id"] for n in nodes if n["is_head"])
    other_id = next(n["node_id"] for n in nodes if not n["is_head"])
    # pin the producer (and its 2MB output) to the non-head node
    ref = produce.options(scheduling_strategy=NodeAffinitySchedulingStrategy(
        node_id=other_id)).remote()
    # resolve so the output is sealed + its location announced
    _, producer_node = ray_tpu_torch.get(ref, timeout=120)
    assert producer_node == other_id
    # the consumer has no affinity: locality must steer it to the arg node
    # (without locality the owner's local raylet — the head — would grant,
    # since it has free CPU)
    n, producer_node, consumer_node = ray_tpu_torch.get(
        consume.remote(ref), timeout=120)
    assert n == 2 * 1024 * 1024
    assert consumer_node == other_id, (
        f"consumer ran on {consumer_node[:8]}, arg lives on {other_id[:8]}")
    assert head_id != other_id
