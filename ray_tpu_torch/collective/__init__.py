"""Collective communication on ``torch.distributed``: the port of
``ray_tpu/collective/__init__.py``'s group API.

Each process declares itself a rank of a named group, then calls the ops by
the group's name::

    from ray_tpu_torch import collective as col
    col.init_collective_group(world_size=4, rank=rank, group_name="grads",
                              device="cpu", init_method="file:///tmp/store")
    summed = col.allreduce(grads, group_name="grads")

The backend follows the device: NCCL on the card (the default device), gloo
on the CPU; asking for the card without one raises. The ops are
``TorchGroup``'s (``collective_group.py``). The bucketed tier
(``bucketed.py``: the bucket plan, ``AsyncBucketReducer`` and
``ShardedBucketOptimizer``) runs on these groups.

A driver declares a group for a set of actors of the port's runtime with
``create_collective_group``; each actor mixes in ``CollectiveActorMixin``.
The rendezvous is explicit: the driver asks rank 0's actor for a free port
on its host and hands every rank ``init_method="tcp://<host>:<port>"``.
The JAX package's ``backend="cpu"`` is gloo here (its ``CpuStoreGroup``
over a store actor is not ported), ``"xla"`` NCCL.
"""

from __future__ import annotations

import socket
from typing import Any, List, Optional

from ray_tpu_torch.collective.bucketed import (AsyncBucketReducer, Bucket,
                                               BucketPlan,
                                               ShardedBucketOptimizer,
                                               init_sharded_optimizer_groups,
                                               leaf_meta, plan_buckets)
from ray_tpu_torch.collective.collective_group import TorchGroup
from ray_tpu_torch.collective.quant import (ErrorFeedback, QuantCodec,
                                            QuantizedTensor, dequantize,
                                            quantize,
                                            quantized_reduce_scatter_1d,
                                            resolve_codec)
from ray_tpu_torch.collective.types import Backend, GroupInfo, ReduceOp
from ray_tpu_torch.utils import DeviceLike

__all__ = [
    "init_collective_group",
    "create_collective_group",
    "CollectiveActorMixin",
    "destroy_collective_group",
    "get_rank",
    "get_collective_group_size",
    "get_group",
    "allreduce",
    "reduce",
    "broadcast",
    "allgather",
    "reducescatter",
    "alltoall",
    "send",
    "recv",
    "barrier",
    "allreduce_quantized",
    "plan_buckets",
    "leaf_meta",
    "BucketPlan",
    "Bucket",
    "AsyncBucketReducer",
    "ShardedBucketOptimizer",
    "init_sharded_optimizer_groups",
    "ReduceOp",
    "Backend",
    "GroupInfo",
    "TorchGroup",
    "QuantCodec",
    "QuantizedTensor",
    "ErrorFeedback",
    "resolve_codec",
    "quantize",
    "dequantize",
    "quantized_reduce_scatter_1d",
]


class GroupManager:
    """This process's collective groups by name."""

    def __init__(self):
        self._groups = {}

    def create(self, group_name: str, world_size: int, rank: int,
               backend: Optional[str], device: DeviceLike,
               init_method: Optional[str]) -> TorchGroup:
        if group_name in self._groups:
            raise ValueError(f"collective group {group_name!r} already "
                             "initialized")
        group = TorchGroup.create(group_name, world_size, rank, device=device,
                                  init_method=init_method, backend=backend)
        self._groups[group_name] = group
        return group

    def get(self, group_name: str) -> TorchGroup:
        group = self._groups.get(group_name)
        if group is None:
            raise ValueError(
                f"collective group {group_name!r} is not initialized in this "
                f"process; call init_collective_group first")
        return group

    def destroy(self, group_name: str) -> None:
        group = self._groups.pop(group_name, None)
        if group is not None:
            group.destroy()


_manager = GroupManager()


def init_collective_group(world_size: int, rank: int,
                          backend: Optional[str] = None,
                          group_name: str = "default",
                          device: DeviceLike = None,
                          init_method: Optional[str] = None) -> TorchGroup:
    """Declare this process ``rank`` of a collective group. ``device`` (the
    card unless given) picks the backend; ``backend``, where given, must
    agree with it (the JAX names ``xla`` and ``cpu`` stand for ``nccl`` and
    ``gloo``). ``init_method`` is the rendezvous of the first group of the
    process (``tcp://127.0.0.1:<port>``, ``file:///<path>``)."""
    return _manager.create(group_name, world_size, rank, backend, device,
                           init_method)


def _device_for(backend: str) -> str:
    """The device a backend's tensors live on: the card for NCCL, the CPU
    for gloo."""
    return "cuda" if Backend.validate(backend) == Backend.NCCL else "cpu"


def create_collective_group(actors: List[Any], world_size: int,
                            ranks: List[int], backend: str = Backend.CPU,
                            group_name: str = "default") -> None:
    """Driver-side declaration for a set of actors (reference:
    collective.py:222): rank 0's actor names a free port on its host, and
    each actor inits its side of the group through that rendezvous. The
    actors mix in ``CollectiveActorMixin``."""
    import ray_tpu_torch

    if len(actors) != len(ranks):
        raise ValueError("actors and ranks must have equal length")
    if 0 not in ranks:
        raise ValueError("no actor is rank 0 of the group")
    backend = Backend.validate(backend)
    init_method = ray_tpu_torch.get(
        actors[ranks.index(0)]._collective_rendezvous.remote(), timeout=300)
    refs = [
        actor._init_collective.remote(world_size, rank, backend, group_name,
                                      init_method)
        for actor, rank in zip(actors, ranks)
    ]
    ray_tpu_torch.get(refs, timeout=300)


def destroy_collective_group(group_name: str = "default") -> None:
    _manager.destroy(group_name)


def get_rank(group_name: str = "default") -> int:
    return _manager.get(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _manager.get(group_name).world_size


def get_group(group_name: str = "default") -> TorchGroup:
    """The group object itself (``ppermute`` and ``ring_shift`` live on
    it)."""
    return _manager.get(group_name)


def allreduce_quantized(wire: dict, codec, group_name: str = "default"
                        ) -> dict:
    """Quantized-SUM allreduce of an encoded contribution (see
    ``collective/quant.py``)."""
    return _manager.get(group_name).allreduce_quantized(wire, codec)


def allreduce(tensor, op: ReduceOp = ReduceOp.SUM,
              group_name: str = "default"):
    return _manager.get(group_name).allreduce(tensor, op)


def reduce(tensor, dst_rank: int = 0, op: ReduceOp = ReduceOp.SUM,
           group_name: str = "default"):
    return _manager.get(group_name).reduce(tensor, dst_rank, op)


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    return _manager.get(group_name).broadcast(tensor, src_rank)


def allgather(tensor, group_name: str = "default"):
    return _manager.get(group_name).allgather(tensor)


def reducescatter(tensor, op: ReduceOp = ReduceOp.SUM,
                  group_name: str = "default"):
    return _manager.get(group_name).reducescatter(tensor, op)


def alltoall(tensor, group_name: str = "default"):
    return _manager.get(group_name).alltoall(tensor)


def send(tensor, dst_rank: int, group_name: str = "default", tag: int = 0):
    return _manager.get(group_name).send(tensor, dst_rank, tag)


def recv(src_rank: int, group_name: str = "default", tag: int = 0):
    return _manager.get(group_name).recv(src_rank, tag)


def barrier(group_name: str = "default"):
    return _manager.get(group_name).barrier()


def rendezvous_address() -> str:
    """``tcp://<host>:<port>`` for a free port on this process's host: the
    host of its runtime worker's address (``127.0.0.1`` outside a
    cluster)."""
    from ray_tpu_torch._private import worker as worker_mod

    host = "127.0.0.1"
    if worker_mod.is_initialized():
        address = getattr(worker_mod.global_worker(), "address", "")
        host = address.rsplit(":", 1)[0] or host
    with socket.socket() as s:
        s.bind((host, 0))
        port = s.getsockname()[1]
    return f"tcp://{host}:{port}"


class CollectiveActorMixin:
    """Mixin giving actors the hooks ``create_collective_group`` calls."""

    def _collective_rendezvous(self) -> str:
        return rendezvous_address()

    def _init_collective(self, world_size: int, rank: int, backend: str,
                         group_name: str,
                         init_method: Optional[str] = None) -> bool:
        init_collective_group(world_size, rank, backend, group_name,
                              device=_device_for(backend),
                              init_method=init_method)
        return True
