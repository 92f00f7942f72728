"""Device object transport: tensors stay where they were produced, the port
of ``ray_tpu/experimental/device_objects.py``.

Reference: python/ray/experimental/gpu_object_manager (``@ray.method(
tensor_transport=...)``, per-actor GPUObjectStore, driver-side orchestration
of p2p pulls). The value returned by a marked actor method stays in the
producing worker (a CUDA tensor stays on that worker's card), and a small
``DeviceObjectMarker`` travels through the object plane instead. Consumers
(other actors, or the driver) pull the value directly from the holder
worker; the driver never relays tensor bytes between actors. The pull is
host-mediated, as in the JAX package: the holder serializes the value the
way the runtime sends any tensor (copied to the host), and it arrives as a
CPU tensor. The marker carries the transport tag so a device-to-device
path (CUDA IPC, NCCL) can slot in without an API change.

Usage::

    class Producer:
        @ray_tpu_torch.method(tensor_transport="device")
        def weights(self):
            return torch.ones(4096, 4096, device="cuda")

    ref = producer.weights.remote()     # returns at once; value stays put
    consumer.consume.remote(ref)        # consumer pulls from the producer
    ray_tpu_torch.get(ref)              # driver pulls from the producer
"""

from __future__ import annotations

import time

from ray_tpu_torch._private import wire


class DeviceObjectMarker:
    """Placeholder for a value held in a producer worker's device store."""

    __slots__ = ("oid", "address", "transport")

    def __init__(self, oid: bytes, address: str, transport: str = "device"):
        self.oid = oid
        self.address = address
        self.transport = transport

    def __reduce__(self):
        return (DeviceObjectMarker, (self.oid, self.address, self.transport))

    def __repr__(self):
        return (f"DeviceObjectMarker({self.oid.hex()[:12]} @ {self.address}, "
                f"{self.transport})")


def free(ref) -> bool:
    """Release the device-held value behind ``ref`` on its holder worker.
    Returns False if the value was already gone."""
    from ray_tpu_torch._private.worker import global_worker

    core = global_worker()
    # resolve the MARKER itself (core.get would pull the tensor)
    marker = core._run(core._get_one(ref, time.monotonic() + 60.0))
    if not isinstance(marker, DeviceObjectMarker):
        raise TypeError("free() expects a ref produced by a "
                        "tensor_transport-marked method")

    async def _free():
        reply = await core._worker_client(marker.address).call(
            "FreeDeviceObject", wire.dumps({"oid": marker.oid}), timeout=30.0)
        return wire.loads(reply)["freed"]

    return core._run(_free())


def pull_stats(reset: bool = False) -> dict:
    """This process's pulls from holder workers so far: ``pulls``, the
    serialized ``bytes`` received and the ``seconds`` from request to
    deserialized value; set to 0 after reading when ``reset``."""
    from ray_tpu_torch._private.worker import global_worker

    core = global_worker()
    stats = dict(getattr(core, "device_pull_stats", None)
                 or {"pulls": 0, "bytes": 0, "seconds": 0.0})
    if reset and hasattr(core, "device_pull_stats"):
        core.device_pull_stats.update(pulls=0, bytes=0, seconds=0.0)
    return stats
