"""The port's device-object transport
(``ray_tpu_torch/experimental/device_objects.py``) on a port cluster, on the
CPU: a mirror of ``tests/test_device_objects.py``. A value returned by a
``tensor_transport``-marked method stays in the producing worker, the
owner's memory store holds a ``DeviceObjectMarker``, and consumers (the
driver, other actors) pull the tensor from the holder; ``free`` releases it.
The pulled tensors equal the JAX producer's arrays on the same inputs.

Every cluster call carries its own timeout. Nothing here imports JAX at
module level: the workers import this module to reach its actor classes."""

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.experimental import device_objects
from ray_tpu_torch.experimental.device_objects import DeviceObjectMarker

T = 60  # seconds, each cluster call


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=6, device="cpu")
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote(num_cpus=0.5)
class Producer:
    def __init__(self):
        self.produced = 0

    @ray_tpu_torch.method(tensor_transport="device")
    def weights(self, scale):
        self.produced += 1
        return torch.full((64, 64), float(scale))

    def num_produced(self):
        return self.produced

    def num_held(self):
        from ray_tpu_torch._private.worker import global_worker

        return len(global_worker().device_store)


@ray_tpu_torch.remote(num_cpus=0.5)
class Consumer:
    def total(self, w):
        return float(torch.as_tensor(w).sum())

    @ray_tpu_torch.method(tensor_transport="device")
    def double(self, w):
        return torch.as_tensor(w) * 2.0


def _jax_full(scale):
    import jax.numpy as jnp

    return np.asarray(jnp.full((64, 64), float(scale)))


def _raw(ref):
    """What the owner's memory store holds for ``ref``."""
    from ray_tpu_torch._private.worker import global_worker

    return global_worker().memory_store.get(ref.id)


def test_driver_get_pulls_from_holder(cluster):
    p = Producer.remote()
    ref = p.weights.remote(3.0)
    w = ray_tpu_torch.get(ref, timeout=T)
    assert isinstance(w, torch.Tensor) and w.device.type == "cpu"
    np.testing.assert_array_equal(w.numpy(), _jax_full(3.0))
    # the driver-visible reply is a marker, not the tensor's bytes
    raw = _raw(ref)
    assert isinstance(raw, DeviceObjectMarker), type(raw)
    assert raw.transport == "device"
    assert ray_tpu_torch.get(p.num_held.remote(), timeout=T) == 1


def test_actor_to_actor_p2p(cluster):
    p = Producer.remote()
    c = Consumer.remote()
    ref = p.weights.remote(2.0)
    # the consumer receives the real tensor (pulled from the producer)
    assert ray_tpu_torch.get(c.total.remote(ref), timeout=T) == float(
        _jax_full(2.0).sum())


def test_chained_device_objects(cluster):
    p = Producer.remote()
    c = Consumer.remote()
    ref1 = p.weights.remote(1.0)
    ref2 = c.double.remote(ref1)  # the consumer holds its own device object
    assert ray_tpu_torch.get(Consumer.remote().total.remote(ref2),
                             timeout=T) == float((_jax_full(1.0) * 2.0).sum())
    np.testing.assert_array_equal(ray_tpu_torch.get(ref2, timeout=T).numpy(),
                                  _jax_full(1.0) * 2.0)


def test_free_releases_holder_memory(cluster):
    p = Producer.remote()
    ref = p.weights.remote(5.0)
    ray_tpu_torch.get(ref, timeout=T)  # ensure produced
    assert ray_tpu_torch.get(p.num_held.remote(), timeout=T) == 1
    assert device_objects.free(ref) is True
    assert device_objects.free(ref) is False
    assert ray_tpu_torch.get(p.num_held.remote(), timeout=T) == 0
    c = Consumer.remote()
    with pytest.raises(Exception):
        ray_tpu_torch.get(c.total.remote(ref), timeout=T)


def test_options_override_disables_decorator_transport(cluster):
    p = Producer.remote()
    # "object" forces the plain object-plane return for this call
    ref = p.weights.options(tensor_transport="object").remote(4.0)
    w = ray_tpu_torch.get(ref, timeout=T)
    np.testing.assert_array_equal(w.numpy(), _jax_full(4.0))
    assert not isinstance(_raw(ref), DeviceObjectMarker)
    with pytest.raises(TypeError):
        device_objects.free(ref)  # not a marker: traveled as a plain object
    assert ray_tpu_torch.get(p.num_held.remote(), timeout=T) == 0


def test_transport_via_method_options(cluster):
    @ray_tpu_torch.remote(num_cpus=0.5)
    class Plain:
        def make(self):
            return torch.ones(8)

    a = Plain.remote()
    ref = a.make.options(tensor_transport="device").remote()
    out = ray_tpu_torch.get(ref, timeout=T)
    assert float(out.sum()) == 8
    assert isinstance(_raw(ref), DeviceObjectMarker)


# keep last: tears down the module cluster
def test_local_mode_actor_calls_unaffected():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(local_mode=True)
    try:
        @ray_tpu_torch.remote
        class A:
            def f(self):
                return 7

            @ray_tpu_torch.method(tensor_transport="device")
            def g(self):
                return torch.ones(3)

        a = A.remote()
        assert ray_tpu_torch.get(a.f.remote()) == 7
        assert float(ray_tpu_torch.get(a.g.remote()).sum()) == 3.0
    finally:
        ray_tpu_torch.shutdown()
