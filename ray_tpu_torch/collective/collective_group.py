"""The collective group on ``torch.distributed``: the port of
``ray_tpu/collective/collective_group.py``'s ``XlaGroup``.

``TorchGroup`` runs the ops of the JAX package's groups on a
``torch.distributed`` process group: NCCL when its device is the card, gloo
when it is the CPU. Each rank passes its own contribution, and the results
follow ``XlaGroup``'s conventions, where a rank's contribution is its tile
of axis 0:

- ``allreduce``: the reduction of every rank's tensor, on every rank;
- ``allgather``: the ranks' tensors concatenated along axis 0 in rank order;
- ``reducescatter``: rank i's ``1/n`` tile (along axis 0) of the reduction;
- ``alltoall``: axis 0 split into ``n`` tiles, tile j sent to rank j, and
  the tiles received concatenated in rank order;
- ``broadcast``: ``src_rank``'s tensor on every rank;
- ``ppermute``: the tensor of the rank that ``perm`` maps onto this one,
  zeros where none does;
- ``reduce``, ``send`` and ``recv`` as ``CpuStoreGroup`` has them: the
  reduction on ``dst_rank`` (the input unchanged elsewhere), and
  point-to-point transfers that need no shape on the receiving side.

``allreduce``, ``reducescatter`` and ``alltoall`` take ``async_op=True``:
they then return at once a function that waits for the collective and
returns its result. Every ``ReduceOp`` is taken by every reducing op. ``AVERAGE`` is the sum
divided by the world size, as ``XlaGroup`` computes it (gloo has no
average). ``CpuStoreGroup`` and ``CollectiveStore`` sit on the runtime's
actors and are not ported here.
"""

from __future__ import annotations

import datetime
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ray_tpu_torch.collective.types import Backend, ReduceOp
from ray_tpu_torch.utils import DeviceLike, resolve_device

_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM,
              ReduceOp.AVERAGE: dist.ReduceOp.SUM,
              ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT,
              ReduceOp.MIN: dist.ReduceOp.MIN,
              ReduceOp.MAX: dist.ReduceOp.MAX}

# send / recv carry a header before the payload: the dtype's index here, the
# number of dims, and the shape, padded to _MAX_DIMS
_WIRE_DTYPES = (torch.float32, torch.float64, torch.float16, torch.bfloat16,
                torch.int8, torch.uint8, torch.int16, torch.int32, torch.int64,
                torch.bool)
_MAX_DIMS = 8
# how long a rank waits for the others in one op before it raises
_TIMEOUT = datetime.timedelta(minutes=10)


class TorchGroup:
    """A collective group over the ranks of a ``torch.distributed`` process
    group.

    Built by ``init_collective_group`` (which creates the process group) or
    around an existing one (a ``DeviceMesh`` axis's, ``from_process_group``).
    Tensors must lie on the group's device: CUDA for NCCL, the CPU for gloo.
    Results are new tensors; inputs are left as they were."""

    def __init__(self, group_name: str, process_group, device: torch.device,
                 owns: Optional[str] = None):
        self.group_name = group_name
        self.process_group = process_group
        self.device = device
        self.backend = Backend.for_device(device.type)
        self.world_size = dist.get_world_size(process_group)
        self.rank = dist.get_rank(process_group)
        self._global = [dist.get_global_rank(process_group, r)
                        for r in range(self.world_size)]
        # what destroy() tears down: "default" (the default process group,
        # which this group created), "group" (its own subgroup) or None
        self._owns = owns

    @classmethod
    def create(cls, group_name: str, world_size: int, rank: int,
               device: DeviceLike = None, init_method: Optional[str] = None,
               backend: Optional[str] = None) -> "TorchGroup":
        """Rank ``rank`` of a new group of ``world_size`` ranks. The first
        group of a process creates the default process group through
        ``init_method`` (``tcp://host:port``, ``file:///path``, or the
        ``MASTER_ADDR`` environment when None); later ones are subgroups of
        it. The backend follows ``device`` (the card by default); on the
        card NCCL is bound to it and brought up before this returns, and a
        failure raises."""
        dev = resolve_device(device)
        want = Backend.for_device(dev.type)
        if backend is not None and Backend.validate(backend) != want:
            raise ValueError(f"backend {backend!r} does not run on {dev}; "
                             f"{dev.type} tensors take {want}")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        if not dist.is_initialized():
            kwargs = {"device_id": dev} if dev.type == "cuda" else {}
            dist.init_process_group(want, init_method=init_method,
                                    world_size=world_size, rank=rank,
                                    timeout=_TIMEOUT, **kwargs)
            owns, pg = "default", dist.group.WORLD
        else:
            if dist.get_rank() != rank:
                raise ValueError(f"rank {rank} is rank {dist.get_rank()} of "
                                 "the default process group")
            owns, pg = "group", dist.new_group(list(range(world_size)),
                                               backend=want, timeout=_TIMEOUT)
        group = cls(group_name, pg, dev, owns)
        if group.world_size != world_size:
            raise ValueError(f"the process group has {group.world_size} "
                             f"ranks, not {world_size}")
        if dev.type == "cuda":  # NCCL's communicator, up now or an error
            group.barrier()
            torch.cuda.synchronize(dev)
        return group

    @classmethod
    def from_process_group(cls, group_name: str, process_group,
                           device: DeviceLike = None) -> "TorchGroup":
        """A group over an existing process group (not destroyed with it)."""
        return cls(group_name, process_group, resolve_device(device))

    # -- helpers ----------------------------------------------------------

    def _tensor(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            return torch.as_tensor(x, device=self.device)
        if x.device.type != self.device.type:
            raise ValueError(f"group {self.group_name!r} ({self.backend}) "
                             f"takes {self.device.type} tensors, got one on "
                             f"{x.device}")
        return x

    def _tiles(self, x: torch.Tensor, what: str) -> int:
        if x.dim() == 0 or x.shape[0] % self.world_size:
            raise ValueError(f"{what} splits axis 0 into {self.world_size} "
                             f"tiles; got shape {tuple(x.shape)}")
        return x.shape[0] // self.world_size

    def _finish(self, out: torch.Tensor, op: ReduceOp) -> torch.Tensor:
        return out / self.world_size if op == ReduceOp.AVERAGE else out

    # -- collectives ------------------------------------------------------

    def _issue(self, out: torch.Tensor, work, op: ReduceOp, async_op: bool):
        """The result, or with ``async_op`` a function that waits for the
        collective and returns it (on the card, ordering the caller's
        stream after it)."""
        if not async_op:
            return self._finish(out, op)

        def wait() -> torch.Tensor:
            work.wait()
            return self._finish(out, op)

        return wait

    def allreduce(self, tensor, op: ReduceOp = ReduceOp.SUM,
                  async_op: bool = False):
        out = self._tensor(tensor).clone(
            memory_format=torch.contiguous_format)
        work = dist.all_reduce(out, op=_TORCH_OPS[op],
                               group=self.process_group, async_op=async_op)
        return self._issue(out, work, op, async_op)

    def reduce(self, tensor, dst_rank: int = 0,
               op: ReduceOp = ReduceOp.SUM) -> torch.Tensor:
        x = self._tensor(tensor)
        out = x.clone(memory_format=torch.contiguous_format)
        dist.reduce(out, self._global[dst_rank], op=_TORCH_OPS[op],
                    group=self.process_group)
        return self._finish(out, op) if self.rank == dst_rank else x.clone()

    def allgather(self, tensor) -> torch.Tensor:
        x = self._tensor(tensor).contiguous()
        if x.dim() == 0:
            x = x.reshape(1)
        out = x.new_empty((self.world_size * x.shape[0],) + x.shape[1:])
        dist.all_gather_into_tensor(out, x, group=self.process_group)
        return out

    def reducescatter(self, tensor, op: ReduceOp = ReduceOp.SUM,
                      async_op: bool = False):
        x = self._tensor(tensor).contiguous()
        tile = self._tiles(x, "reducescatter")
        out = x.new_empty((tile,) + x.shape[1:])
        work = dist.reduce_scatter_tensor(out, x, op=_TORCH_OPS[op],
                                          group=self.process_group,
                                          async_op=async_op)
        return self._issue(out, work, op, async_op)

    def alltoall(self, tensor, async_op: bool = False):
        x = self._tensor(tensor).contiguous()
        self._tiles(x, "alltoall")
        out = torch.empty_like(x)
        work = dist.all_to_all_single(out, x, group=self.process_group,
                                      async_op=async_op)
        return self._issue(out, work, ReduceOp.SUM, async_op)

    def broadcast(self, tensor, src_rank: int = 0) -> torch.Tensor:
        out = self._tensor(tensor).clone(
            memory_format=torch.contiguous_format)
        dist.broadcast(out, self._global[src_rank], group=self.process_group)
        return out

    def ppermute(self, tensor, perm: Sequence[Tuple[int, int]]
                 ) -> torch.Tensor:
        """``jax.lax.ppermute``: each ``(src, dst)`` pair sends src's tensor
        to dst, all pairs at once; a rank that no pair targets gets zeros."""
        x = self._tensor(tensor).contiguous()
        out = torch.zeros_like(x)
        ops = []
        for src, dst in perm:
            if src == dst == self.rank:
                out.copy_(x)
            elif src == self.rank:
                ops.append(dist.P2POp(dist.isend, x, self._global[dst],
                                      self.process_group))
            elif dst == self.rank:
                ops.append(dist.P2POp(dist.irecv, out, self._global[src],
                                      self.process_group))
        for req in dist.batch_isend_irecv(ops) if ops else ():
            req.wait()
        return out

    def ring_shift(self, tensors: Sequence[torch.Tensor]):
        """Start sending each tensor to the next rank (rank + 1 mod n) and
        receiving as many of the same shapes from the previous one. Returns
        ``(received, requests)``: wait on every request before reading what
        was received. The tensors must be contiguous and stay unchanged
        until then."""
        n = self.world_size
        nxt = self._global[(self.rank + 1) % n]
        prv = self._global[(self.rank - 1) % n]
        received = [torch.empty_like(x) for x in tensors]
        ops = ([dist.P2POp(dist.isend, x, nxt, self.process_group)
                for x in tensors]
               + [dist.P2POp(dist.irecv, x, prv, self.process_group)
                  for x in received])
        return received, dist.batch_isend_irecv(ops)

    def send(self, tensor, dst_rank: int, tag: int = 0) -> None:
        x = self._tensor(tensor).contiguous()
        if x.dtype not in _WIRE_DTYPES or x.dim() > _MAX_DIMS:
            raise ValueError(f"send takes up to {_MAX_DIMS}-d tensors of "
                             f"{_WIRE_DTYPES}; got {x.dtype} {tuple(x.shape)}")
        header = torch.zeros(2 + _MAX_DIMS, dtype=torch.int64,
                             device=self.device)
        header[0], header[1] = _WIRE_DTYPES.index(x.dtype), x.dim()
        header[2:2 + x.dim()] = torch.tensor(x.shape, dtype=torch.int64)
        dst = self._global[dst_rank]
        dist.send(header, dst, group=self.process_group, tag=tag)
        dist.send(x, dst, group=self.process_group, tag=tag)

    def recv(self, src_rank: int, tag: int = 0) -> torch.Tensor:
        header = torch.empty(2 + _MAX_DIMS, dtype=torch.int64,
                             device=self.device)
        src = self._global[src_rank]
        dist.recv(header, src, group=self.process_group, tag=tag)
        code, ndim, *shape = header.tolist()
        out = torch.empty(shape[:ndim], dtype=_WIRE_DTYPES[code],
                          device=self.device)
        dist.recv(out, src, group=self.process_group, tag=tag)
        return out

    def allreduce_quantized(self, wire: Dict, codec) -> Dict:
        """Quantized-SUM allreduce of an encoded contribution (``quant.
        to_wire``): every rank's codes and scales are gathered (1 byte an
        element on the wire, not 4), dequantized and summed in fp32 in rank
        order, and the sum quantized once, as ``CpuStoreGroup``'s store
        does. Every rank gets the same encoded sum; decode it with
        ``quant.dequantize(quant.from_wire(...))``."""
        from ray_tpu_torch.collective import quant

        codes = self.allgather(wire["codes"]).reshape(self.world_size, -1)
        scales = self.allgather(wire["scales"]).reshape(self.world_size, -1)
        extra = wire.get("extra")
        extras = (self.allgather(extra.to(self.device)).reshape(
            self.world_size, -1) if extra is not None else None)
        payloads = [dict(wire, codes=codes[r], scales=scales[r],
                         **({"extra": extras[r]} if extras is not None
                            else {}))
                    for r in range(self.world_size)]
        return quant.reduce_wire_payloads(payloads, codec.spec())

    def barrier(self) -> None:
        """Every rank has arrived (an allreduce of one value, which NCCL and
        gloo both run without a device list)."""
        self.allreduce(torch.zeros(1, device=self.device))

    def destroy(self) -> None:
        if self._owns == "default":
            dist.destroy_process_group()
        elif self._owns == "group" and dist.is_initialized():
            dist.destroy_process_group(self.process_group)
        self.process_group = None
