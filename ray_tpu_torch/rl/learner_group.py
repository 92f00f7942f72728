"""Multi-learner gradient sync over the collective groups: the port of
``ray_tpu/rl/learner_group.py``.

Reference: rllib/core/learner/learner_group.py:101: a LearnerGroup spawns
``num_learners`` remote Learner actors, fans each training batch out to
them, and the learners sum gradients before applying updates so their
parameters stay identical (rllib/core/learner/torch/torch_learner.py:524-547
does this with torch DDP). Here the groups are the port's ``TorchGroup``s:
``backend="cpu"`` is gloo (the JAX package's store-actor tier is not
ported), ``"xla"`` NCCL, which takes one rank a card.

The sync contract every learner core follows: compute gradients on its
shard as *global-denominator contributions* (weighted sums divided by the
global sample count), allreduce-SUM one flat fp32 vector of
``[raveled grads | metric scalars]``, unravel, apply. The vector crosses as
a host tensor over gloo (as the JAX one crosses as numpy), so learners that
share one card sync over gloo. With identical parameter initialization
(same seed on every rank) and identical reduced gradients, parameters never
diverge across learners.
"""

from __future__ import annotations

import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.collective import quant


def group_device(group_name: str) -> torch.device:
    """Where a group's tensors live: the CPU for gloo, the card for NCCL."""
    from ray_tpu_torch import collective as col

    return col.get_group(group_name).device


def sync_gradients(grads: Dict[str, torch.Tensor], scalars, group_name: str,
                   compression=None, error_feedback=None
                   ) -> Tuple[Dict[str, torch.Tensor], np.ndarray]:
    """Allreduce-SUM a flat dict of gradients and a metrics vector. Returns
    (reduced grads on the grads' device, reduced scalars as numpy).

    The caller is responsible for scaling: local grads must already be
    global-denominator contributions (sum over ranks == the global-batch
    gradient), and scalars likewise: the sum across ranks IS the value.

    With ``compression`` (int8/fp8/bf16, collective/quant.py) the grad
    vector rides the quantized allreduce while the METRICS vector rides the
    same exchange as a raw fp32 "extra", summed exactly. Pass a persistent
    ``quant.ErrorFeedback`` so quantization error carries into the next
    step instead of accumulating as bias.
    """
    from ray_tpu_torch import collective as col

    # the leaves in the JAX package's ravel_pytree order (flax's sorted
    # paths), so a quantized wire's blocks hold the same leaves
    keys = sorted(grads)
    dev = grads[keys[0]].device
    gdev = group_device(group_name)
    flat = torch.cat([grads[k].reshape(-1) for k in keys]).to(
        device=gdev, dtype=torch.float32)
    scalars = torch.as_tensor(scalars, dtype=torch.float32).reshape(-1).to(
        gdev)
    codec = quant.resolve_codec(compression)
    if codec is None:
        out = col.allreduce(torch.cat([flat, scalars]),
                            group_name=group_name)
        reduced, out_scalars = out[: flat.numel()], out[flat.numel():]
    else:
        if error_feedback is not None:
            qt = error_feedback.encode("sync_gradients", flat)
        else:
            qt = quant.quantize(flat, codec)
        out_wire = col.allreduce_quantized(quant.to_wire(qt, extra=scalars),
                                           codec, group_name=group_name)
        reduced = quant.dequantize(quant.from_wire(out_wire)).to(
            torch.float32)
        out_scalars = out_wire["extra"]
    reduced = reduced.to(dev)
    out, pos = {}, 0
    for k in keys:
        n = grads[k].numel()
        out[k] = reduced[pos:pos + n].reshape(grads[k].shape)
        pos += n
    return out, out_scalars.to(torch.float32).cpu().numpy()


class _LearnerWorker:
    """One learner actor: rank ``rank`` of the gradient-sync group.

    ``factory(rank, world_size, group_name)`` builds the algorithm-specific
    learner core (e.g. PPOLearner), which must expose ``update(batch)``,
    ``get_params()``, ``get_state()``, ``set_state(state)``.
    """

    def __init__(self, factory_blob: bytes, rank: int, world_size: int,
                 group_name: str, backend: str,
                 init_method: Optional[str] = None, num_cpus: float = 1.0):
        from ray_tpu_torch import collective as col
        from ray_tpu_torch._private.serialization import loads_trusted

        # as many torch threads as the actor was given cores
        torch.set_num_threads(max(1, int(num_cpus)))
        if world_size > 1:
            nccl = col.Backend.validate(backend) == col.Backend.NCCL
            col.init_collective_group(world_size, rank, backend=backend,
                                      group_name=group_name,
                                      device="cuda" if nccl else "cpu",
                                      init_method=init_method)
        # store name -> last published version (delta bases)
        self._published: Dict[str, int] = {}
        # the blob is authored by the driving LearnerGroup (trusted)
        factory: Callable = loads_trusted(factory_blob)
        self.core = factory(rank=rank, world_size=world_size,
                            group_name=group_name if world_size > 1 else None)
        self.rank = rank

    def ready(self) -> int:
        return self.rank

    def update(self, batch) -> Dict[str, float]:
        return self.core.update(batch)

    def get_params(self):
        return self.core.get_params()

    def publish_weights(self, store_name: str, version=None,
                        durable: bool = False, delta: bool = False,
                        compression=None) -> int:
        """Publish current params to the named WeightStore from INSIDE the
        learner: the algorithm's process never relays weight bytes.
        Env-runners pull via ``env_runner.WeightSync``. ``delta=True``
        publishes against this learner's previous publish to the same
        store; ``compression`` quantizes the chunk payloads
        (collective/quant.py codecs)."""
        from ray_tpu_torch.weights import WeightStore

        params = self.core.get_params()
        delta_from = self._published.get(store_name) if delta else None
        ver = WeightStore(store_name).publish(
            params, version=version, durable=durable,
            delta_from=delta_from, compression=compression)
        self._published[store_name] = ver
        return ver

    def get_state(self):
        return self.core.get_state()

    def set_state(self, state):
        self.core.set_state(state)

    def call(self, method: str, *args, **kwargs):
        """Escape hatch for algorithm-specific learner methods."""
        return getattr(self.core, method)(*args, **kwargs)


class LearnerGroup:
    """The algorithm's handle on N learner actors with synced gradients
    (reference: rllib/core/learner/learner_group.py:101).

    ``update(batch)`` ships the batch once through the object store (every
    learner receives the same ref; each slices its own shard per the sync
    contract) and returns rank 0's metrics: ranks agree on all reduced
    metrics by construction. ``device`` is the learners' (the card unless
    "cpu"): on the card each asks for ``1 / num_learners`` of a ``GPU``,
    on the CPU for none.
    """

    def __init__(self, factory: Callable, num_learners: int,
                 backend: str = "cpu", group_name: Optional[str] = None,
                 num_cpus_per_learner: float = 1.0, device=None):
        from ray_tpu_torch import collective as col
        from ray_tpu_torch._private.serialization import dumps

        if num_learners < 1:
            raise ValueError("num_learners must be >= 1")
        self.num_learners = num_learners
        self.group_name = group_name or f"learner_group:{uuid.uuid4().hex[:8]}"
        on_card = torch.device("cuda" if device is None else device
                               ).type == "cuda"
        self.num_gpus_per_learner = 1.0 / num_learners if on_card else 0
        init_method = col.rendezvous_address() if num_learners > 1 else None
        blob = dumps(factory)
        worker_cls = ray_tpu_torch.remote(_LearnerWorker)
        self.workers = [
            worker_cls.options(num_cpus=num_cpus_per_learner,
                               num_gpus=self.num_gpus_per_learner).remote(
                blob, rank, num_learners, self.group_name, backend,
                init_method, num_cpus_per_learner)
            for rank in range(num_learners)
        ]
        # rendezvous: every rank must be constructed (and its collective
        # side initialized) before the first update, or rank 0's allreduce
        # would block against missing peers
        ray_tpu_torch.get([w.ready.remote() for w in self.workers],
                          timeout=300)

    def update(self, batch) -> Dict[str, float]:
        ref = ray_tpu_torch.put(batch)
        metrics = ray_tpu_torch.get(
            [w.update.remote(ref) for w in self.workers], timeout=600)
        return metrics[0]

    def update_shards(self, batches: List[Any]) -> Dict[str, float]:
        """One synced update where each learner consumes its OWN batch
        (IMPALA/APPO feed different aggregated rollouts to each learner;
        gradients are still summed). ``batches`` must have exactly
        num_learners entries: every rank must join the allreduce or the
        group deadlocks."""
        if len(batches) != self.num_learners:
            raise ValueError(
                f"update_shards needs exactly {self.num_learners} batches, "
                f"got {len(batches)}")
        metrics = ray_tpu_torch.get(
            [w.update.remote(b) for w, b in zip(self.workers, batches)],
            timeout=600)
        return metrics[0]

    def get_params(self):
        return ray_tpu_torch.get(self.workers[0].get_params.remote(),
                                 timeout=300)

    def get_state(self):
        return ray_tpu_torch.get(self.workers[0].get_state.remote(),
                                 timeout=300)

    def set_state(self, state):
        ref = ray_tpu_torch.put(state)
        ray_tpu_torch.get([w.set_state.remote(ref) for w in self.workers],
                          timeout=300)

    def publish_weights(self, store_name: str, version=None,
                        durable: bool = False, delta: bool = False,
                        compression=None) -> int:
        """Broadcast current params through the weight plane: rank 0
        publishes (learner params are replicated by the sync contract) and
        every subscribed env-runner pulls the new version. Returns the
        published version (monotonic per store)."""
        return ray_tpu_torch.get(
            self.workers[0].publish_weights.remote(store_name, version,
                                                   durable, delta,
                                                   compression),
            timeout=300)

    def foreach_learner(self, method: str, *args, **kwargs) -> List[Any]:
        return ray_tpu_torch.get(
            [w.call.remote(method, *args, **kwargs) for w in self.workers],
            timeout=600)

    def shutdown(self):
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        self.workers = []
