"""The RL library's weight broadcast on the port: a mirror of
``tests/test_weight_plane.py``'s two RL cases (``test_learner_broadcast_to_
runners`` and ``test_learner_group_delta_quantized_publish``), on a port
cluster on the CPU. ``LearnerGroup.publish_weights`` publishes from inside
the learner to a ``weights.WeightStore``; env runners pull through
``env_runner.WeightSync``, versions never regress, and a delta publish of
unchanged params ships no bytes.

The learner core and the runner actor are this module's top-level classes:
the workers import this module by name (it imports no JAX)."""

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.weights import WeightStore


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=8, device="cpu")
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


class _ToyCore:
    def __init__(self, rank, world_size, group_name):
        self.params = {"w": np.zeros(4, np.float32)}

    def update(self, batch):
        self.params["w"] = self.params["w"] + 1.0
        return {"step": float(self.params["w"][0])}

    def get_params(self):
        return self.params

    def get_state(self):
        return self.params

    def set_state(self, state):
        self.params = state


def _toy_factory(rank, world_size, group_name):
    return _ToyCore(rank, world_size, group_name)


@ray_tpu_torch.remote(num_cpus=0.2)
class _Runner:
    def __init__(self, store_name):
        from ray_tpu_torch.rl.env_runner import WeightSync

        self.sync = WeightSync(store_name, start_after=-1)
        self.seen = []

    def poll(self, timeout=0.0):
        v = self.sync.poll(timeout=timeout)
        if v is not None:
            self.seen.append(v)
        return v

    def report(self):
        return {"versions": list(self.seen),
                "w0": float(self.sync.weights["w"][0])
                if self.sync.weights is not None else None}


def test_learner_broadcast_to_runners(cluster):
    from ray_tpu_torch.rl.learner_group import LearnerGroup

    store_name = "bcast_test"
    runners = [_Runner.remote(store_name) for _ in range(8)]
    group = LearnerGroup(_toy_factory, num_learners=1,
                         num_cpus_per_learner=0.5, device="cpu")
    try:
        v1 = group.publish_weights(store_name)
        got = ray_tpu_torch.get([r.poll.remote(timeout=30.0)
                                 for r in runners], timeout=120)
        assert got == [v1] * 8
        # nothing new: poll returns None, version does not regress
        assert ray_tpu_torch.get([r.poll.remote(0.0) for r in runners],
                                 timeout=60) == [None] * 8
        group.update(np.zeros(1))
        v2 = group.publish_weights(store_name)
        assert v2 > v1
        got = ray_tpu_torch.get([r.poll.remote(timeout=30.0)
                                 for r in runners], timeout=120)
        assert got == [v2] * 8
        reports = ray_tpu_torch.get([r.report.remote() for r in runners],
                                    timeout=60)
        for rep in reports:
            assert rep["versions"] == sorted(rep["versions"]) == [v1, v2]
            assert rep["w0"] == 1.0  # post-update params reached every runner
        stats = WeightStore(store_name).stats()
        assert stats["latest"] == v2
    finally:
        group.shutdown()
        for r in runners:
            ray_tpu_torch.kill(r)


def test_learner_group_delta_quantized_publish(cluster):
    """The rl publish path: LearnerGroup.publish_weights(delta=True)
    publishes against the learner's previous version; with compression
    the env-runner-facing pull dequantizes transparently."""
    from ray_tpu_torch.rl.learner_group import LearnerGroup

    group = LearnerGroup(_toy_factory, num_learners=2, device="cpu")
    try:
        store = WeightStore("w_lg")
        v1 = group.publish_weights("w_lg", durable=True, delta=True)
        v2 = group.publish_weights("w_lg", durable=True, delta=True)
        vs = store.stats()["versions"]
        # params unchanged between publishes -> the second is all-reuse
        assert vs[str(v2)]["bytes_published"] == 0
        assert vs[str(v2)]["bytes_reused"] > 0
        t1, t2 = store.pull(v1), store.pull(v2)
        for k in t1:
            np.testing.assert_array_equal(t1[k], t2[k])
        v3 = group.publish_weights("w_lg", durable=True, delta=True,
                                   compression="int8")
        assert store.latest() == v3
    finally:
        group.shutdown()
