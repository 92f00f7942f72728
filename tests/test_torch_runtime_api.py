"""The port's core API in local mode: a mirror of ``tests/test_core_api.py``
on ``ray_tpu_torch``, with the options the port renames or refuses."""

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.exceptions import TaskError


@pytest.fixture
def port_local():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(local_mode=True)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_put_get(port_local):
    ref = ray_tpu_torch.put({"a": 1, "b": np.arange(10), "t": torch.ones(3)})
    out = ray_tpu_torch.get(ref)
    assert out["a"] == 1
    np.testing.assert_array_equal(out["b"], np.arange(10))
    assert torch.equal(out["t"], torch.ones(3))


def test_task_roundtrip(port_local):
    @ray_tpu_torch.remote
    def add(a, b):
        return a + b

    assert ray_tpu_torch.get(add.remote(1, 2)) == 3
    # ObjectRef args resolve before execution
    assert ray_tpu_torch.get(add.remote(add.remote(1, 1), 3)) == 5


def test_multiple_returns(port_local):
    @ray_tpu_torch.remote(num_returns=2)
    def two():
        return 1, 2

    a, b = two.remote()
    assert ray_tpu_torch.get(a) == 1 and ray_tpu_torch.get(b) == 2


def test_task_error_propagates(port_local):
    @ray_tpu_torch.remote
    def boom():
        raise ValueError("kaboom")

    with pytest.raises(TaskError, match="kaboom"):
        ray_tpu_torch.get(boom.remote())


def test_options_override(port_local):
    @ray_tpu_torch.remote
    def f():
        return 42

    assert ray_tpu_torch.get(
        f.options(num_cpus=2, num_gpus=0, num_returns=1).remote()) == 42
    with pytest.raises(ValueError):
        f.options(bogus=1)
    with pytest.raises(ValueError):
        f.options(num_tpus=1)  # the port's accelerator is the GPU


def test_unported_options_raise_naming_the_roadmap(port_local):
    @ray_tpu_torch.remote
    def f():
        return 1

    @ray_tpu_torch.remote
    class A:
        pass

    # DAG authoring is ported: binds build nodes; the device-mesh
    # transport of a compiled edge is not, and names its ROADMAP item
    from ray_tpu_torch.dag import ClassNode, FunctionNode

    assert isinstance(f.bind(), FunctionNode)
    node = A.bind()
    assert isinstance(node, ClassNode)
    assert node.with_tensor_transport("object") is node
    with pytest.raises(NotImplementedError,
                       match=r"ROADMAP.md queue 1 item 3"):
        node.with_tensor_transport("ici")
    # placement groups and the strategy objects are ported: the options
    # take them (a group's strategy sets its fields) and the task schedules
    from ray_tpu_torch._private.ids import PlacementGroupID
    from ray_tpu_torch.util.placement_group import PlacementGroup
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy, PlacementGroupSchedulingStrategy)

    pg = PlacementGroup(PlacementGroupID.from_random(), [{"CPU": 1.0}])
    g = f.options(scheduling_strategy=PlacementGroupSchedulingStrategy(pg, 0))
    assert (g.task_options.placement_group,
            g.task_options.placement_group_bundle_index) == (pg, 0)
    assert A.options(placement_group=pg).actor_options.placement_group is pg
    for strategy in ("SPREAD", PlacementGroupSchedulingStrategy(pg, 0),
                     NodeAffinitySchedulingStrategy(node_id="0" * 56)):
        assert ray_tpu_torch.get(f.options(scheduling_strategy=strategy)
                                 .remote()) == 1


def test_weight_store_methods_raise_naming_the_roadmap(port_local):
    """The train worker's weight-plane hand-off runs on the ported weight
    store (it raised before the store's port); the weight plane's one tier
    still to port, the XLA reshard, raises naming its ROADMAP item."""
    import numpy as np

    from ray_tpu_torch import weights
    from ray_tpu_torch.train.worker_group import TrainWorker

    worker = TrainWorker.remote(0, 1)
    m = np.arange(6, dtype=np.float32).reshape(2, 3)
    assert ray_tpu_torch.get(worker.publish_weight_shards.remote(
        "store", 1, {"opt": {"m": m}})) == 1
    out = ray_tpu_torch.get(worker.pull_weight_shards.remote("store"))
    assert out["version"] == 1
    np.testing.assert_array_equal(out["tree"]["opt"]["m"], m)
    with pytest.raises(NotImplementedError, match="queue 1 item 3"):
        weights.jax_reshard({"w": m}, {"data": 1}, {})


def test_actor_basics(port_local):
    @ray_tpu_torch.remote
    class Counter:
        def __init__(self, start=0):
            self.n = start

        def incr(self, by=1):
            self.n += by
            return self.n

    c = Counter.remote(10)
    assert ray_tpu_torch.get(c.incr.remote()) == 11
    assert ray_tpu_torch.get(c.incr.remote(5)) == 16
    with pytest.raises(AttributeError):
        c.nonexistent


def test_named_actor(port_local):
    @ray_tpu_torch.remote
    class A:
        def ping(self):
            return "pong"

    A.options(name="the_actor").remote()
    h = ray_tpu_torch.get_actor("the_actor")
    assert ray_tpu_torch.get(h.ping.remote()) == "pong"
    ray_tpu_torch.kill(h)
    with pytest.raises(ValueError):
        ray_tpu_torch.get_actor("the_actor")


def test_wait(port_local):
    refs = [ray_tpu_torch.put(i) for i in range(4)]
    ready, rest = ray_tpu_torch.wait(refs, num_returns=2)
    assert len(ready) == 2 and len(rest) == 2


def test_runtime_context(port_local):
    ctx = ray_tpu_torch.get_runtime_context()
    assert len(ctx.get_job_id()) == 8


def test_cannot_call_remote_directly(port_local):
    @ray_tpu_torch.remote
    def f():
        return 1

    with pytest.raises(TypeError):
        f()


def test_init_needs_a_card_unless_told_cpu(monkeypatch):
    """``device="cuda"`` (the default) on a host with no card raises before
    any process starts; an unknown device is refused."""
    from ray_tpu_torch.util import accelerators

    monkeypatch.setattr(accelerators, "num_gpus_on_host", lambda: 0)
    ray_tpu_torch.shutdown()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ray_tpu_torch.init(num_cpus=1)
    with pytest.raises(ValueError):
        ray_tpu_torch.init(device="tpu")
    assert not ray_tpu_torch.is_initialized()


def test_client_mode_connects_and_runs_a_task(tmp_path):
    """``init(address="ray-tpu://...")`` installs the client worker: the
    public API reaches a cluster through its proxy process."""
    from test_torch_client_mode import start_host, stop_host

    from ray_tpu_torch.util.client.client import ClientWorker

    ray_tpu_torch.shutdown()
    proc, address = start_host(tmp_path, num_cpus=2)
    try:
        worker = ray_tpu_torch.init(address=address)
        assert isinstance(worker, ClientWorker)
        assert ray_tpu_torch.is_initialized()

        @ray_tpu_torch.remote
        def pid_plus(x):
            import os

            return os.getpid() + x

        import os

        got = ray_tpu_torch.get(pid_plus.remote(1), timeout=120)
        assert got - 1 not in (os.getpid(), proc.pid)
        assert ray_tpu_torch.cluster_resources()["CPU"] == 2.0
    finally:
        ray_tpu_torch.shutdown()
        stop_host(proc)
    assert not ray_tpu_torch.is_initialized()
