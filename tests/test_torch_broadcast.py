"""A mirror of ``tests/test_broadcast.py`` on the port's runtime
(``ray_tpu_torch``, on the CPU): the same scenarios and assertions.

Object broadcast across nodes: completed pulls announce new locations,
so an N-node fan-out forms a tree off the origin (reference: the
1 GiB / 50-node broadcast envelope, release/benchmarks/README.md:19-20;
pull_manager.cc / push_manager.cc source selection).
"""

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster


def test_broadcast_object_to_all_nodes():
    ray_tpu_torch.shutdown()
    cluster = Cluster(head_node_args={"resources": {"CPU": 2.0}})
    for i in range(3):
        cluster.add_node(resources={"CPU": 2.0, f"node{i}": 2.0})
    ray_tpu_torch.init(address=cluster.address)
    cluster.wait_for_nodes(4)
    try:
        payload = np.arange(1_500_000, dtype=np.float64)  # ~12 MB, store path
        ref = ray_tpu_torch.put(payload)

        def make_reader(i):
            @ray_tpu_torch.remote(resources={f"node{i}": 1.0}, num_cpus=0.5)
            def read(arr):
                return float(arr.sum())
            return read

        expect = float(payload.sum())
        refs = [make_reader(i).remote(ref) for i in range(3)]
        out = ray_tpu_torch.get(refs, timeout=300)
        assert out == [expect] * 3
        # every puller announced its copy: the directory must list multiple
        # holders (the broadcast tree's fan-out substrate)
        w = ray_tpu_torch._private.worker.global_worker()
        locs = w._run(w._gcs_call("ObjectLocGet", {"oid": ref.id.binary()}))
        assert len(locs["locations"]) >= 2, locs
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()
