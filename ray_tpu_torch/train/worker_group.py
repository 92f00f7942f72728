"""Training worker group: N actors gang-scheduled on a placement group, the
port of ``ray_tpu/train/worker_group.py``.

Reference: train/v2/_internal/execution/worker_group/worker_group.py:104 —
actors created in a placement group (SPREAD across hosts), each running the
user's train loop.

A process that formed a ``torch.distributed`` process group cannot form
another (as one that initialized ``jax.distributed`` cannot re-form a
smaller mesh), and a worker holding the card keeps its memory until it
exits, so the group always kills its workers on shutdown/restart and
re-creates fresh actor processes. A worker with ``GPU`` in its bundle runs
in a process the raylet forks for its lease, with ``CUDA_VISIBLE_DEVICES``
naming its card. There are no TPU slices: the group always reserves a plain
placement group of ``num_workers`` bundles.
"""

from __future__ import annotations

import os
import socket
import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import ScalingConfig
from ray_tpu_torch.train.context import TrainContext, set_context
from ray_tpu_torch.util.placement_group import (PlacementGroup,
                                                placement_group,
                                                remove_placement_group)
from ray_tpu_torch.util.scheduling_strategies import \
    PlacementGroupSchedulingStrategy

# the collective group whose creation forms the default process group
WORLD_GROUP = "train.world"


@ray_tpu_torch.remote
class TrainWorker:
    def __init__(self, rank: int, world_size: int):
        self.rank = rank
        self.world_size = world_size
        self._distributed = False
        self._grad_sync: Optional[Dict[str, Any]] = None

    def setup_grad_sync(self, group_name: str, backend: str,
                        bucket_bytes: int,
                        compression: Optional[str] = None,
                        init_method: Optional[str] = None) -> bool:
        """Join the group's bucketed grad-sync collective (and its
        ``.norm`` sibling for the sharded update's clip allgather + param
        broadcasts, and the ``.user`` one for the loop's own reducer), in
        that order on every rank: each is a ``dist.new_group`` of the
        default process group, itself a collective. ``init_method`` forms
        the default process group where ``setup_distributed`` did not. The
        train loop reaches the groups through
        ``train.get_context().make_bucket_reducer`` /
        ``make_sharded_optimizer`` (collective/bucketed.py).
        ``compression`` (None/int8/fp8/bf16) is the default codec those
        helpers hand to the reducer/optimizer (collective/quant.py)."""
        from ray_tpu_torch import collective as col
        from ray_tpu_torch.collective.bucketed import \
            init_sharded_optimizer_groups
        from ray_tpu_torch.collective.quant import resolve_codec
        from ray_tpu_torch.collective.types import Backend

        torch_backend = Backend.validate(backend)
        # fail at setup, not mid-train: the explicit quantized exchange runs
        # on the CPU tier only, as in the JAX package (on-device programs
        # quantize inside the step via TrainStepBundle(compression=...))
        if resolve_codec(compression) is not None \
                and torch_backend != Backend.GLOO:
            raise ValueError(
                f"grad_sync_compression={compression!r} requires "
                f"grad_sync_backend='gloo' or 'cpu' (got {backend!r}); "
                f"on-device programs use TrainStepBundle(compression=...) "
                f"instead")
        device = col._device_for(torch_backend)
        init_sharded_optimizer_groups(self.world_size, self.rank,
                                      backend=torch_backend,
                                      base_name=group_name, device=device,
                                      init_method=init_method)
        # a group is dedicated to ONE reducer (ops match by sequence
        # number): user-level bucket reducers get their own sibling so
        # they can't interleave with a sharded optimizer's internal one
        col.init_collective_group(self.world_size, self.rank,
                                  backend=torch_backend,
                                  group_name=f"{group_name}.user",
                                  device=device)
        self._grad_sync = {"group": group_name, "backend": torch_backend,
                           "bucket_bytes": int(bucket_bytes),
                           "world_size": self.world_size,
                           "compression": compression}
        return True

    def get_host_info(self) -> Dict[str, Any]:
        return {
            "hostname": socket.gethostname(),
            "ip": "127.0.0.1",
            "node_id": ray_tpu_torch.get_runtime_context().get_node_id(),
            "pid": os.getpid(),
        }

    def rendezvous(self) -> str:
        """``tcp://<host>:<port>`` for a free port on this worker's host:
        the rendezvous of the group's default process group."""
        from ray_tpu_torch.collective import rendezvous_address

        return rendezvous_address()

    def setup_distributed(self, coordinator: str, num_processes: int,
                          process_id: int, device: str = "cuda") -> bool:
        """Form the default ``torch.distributed`` process group over the
        workers through the port's first collective group of the process:
        NCCL on the card, gloo on the CPU (the counterpart of
        ``jax.distributed.initialize``, reference: train/v2/jax/config.py:41).
        ``coordinator`` is rank 0's ``tcp://host:port``."""
        from ray_tpu_torch import collective as col

        col.init_collective_group(num_processes, process_id,
                                  group_name=WORLD_GROUP, device=device,
                                  init_method=coordinator)
        self._distributed = True
        return True

    def run(self, fn_blob: bytes, config: Optional[dict], controller,
            latest_checkpoint_path: Optional[str], run_dir: str,
            dataset_shard_blob: Optional[bytes],
            formation: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
        # driver-authored blobs: decoded by the port's by-value pickler
        from ray_tpu_torch._private.serialization import loads_trusted
        from ray_tpu_torch.util import goodput

        # tag this process's goodput ledger with the run so its bucket
        # seconds aggregate under the right job GCS-side
        goodput.set_job(run_dir.rsplit("/", 1)[-1])
        fn = loads_trusted(fn_blob)
        shards = loads_trusted(dataset_shard_blob) if dataset_shard_blob else {}
        ctx = TrainContext(
            rank=self.rank,
            world_size=self.world_size,
            local_rank=0,
            node_rank=self.rank,
            controller=controller,
            latest_checkpoint=(Checkpoint(latest_checkpoint_path)
                               if latest_checkpoint_path else None),
            config=config,
            dataset_shards=shards,
            grad_sync=self._grad_sync,
        )
        ctx.run_dir = run_dir
        ctx.group_formation = dict(formation or {})
        set_context(ctx)
        try:
            if config is not None:
                result = fn(config)
            else:
                result = fn()
            return {"rank": self.rank, "result": result}
        finally:
            set_context(None)

    # -- weight plane (weights/): elastic state hand-off -------------------

    def publish_weight_shards(self, store_name: str, version: int,
                              shard_tree: Any, durable: bool = True) -> int:
        """Publish this rank's shard of the training state (every leaf
        sharded equally along dim 0 across the group). ``durable=True``
        routes the bytes through the store actor so the published version
        outlives this worker — the elastic re-form path: a killed group's
        surviving state is pulled back by the NEXT incarnation, resharded
        onto its (smaller) mesh, via ``pull_weight_shards``. Leaves may be
        numpy arrays or tensors (published as their numpy values)."""
        from ray_tpu_torch.train.scaling_policy import mesh_spec_for
        from ray_tpu_torch.util import tracing
        from ray_tpu_torch.weights import (ShardedTreeSpec, WeightStore,
                                           publish_host_shards)
        from ray_tpu_torch.weights.spec import flatten_tree, host_boxes
        from ray_tpu_torch.weights.store import _as_numpy

        with tracing.profile("train.publish", category="train",
                             store=store_name, version=version):
            mesh = mesh_spec_for(self.world_size)
            skeleton, leaves = flatten_tree(shard_tree)
            leaves = {path: _as_numpy(leaf) for path, leaf in leaves.items()}
            parts, meta, shards = {}, {}, {}
            host = mesh.hosts[self.rank]
            for path, arr in leaves.items():
                parts[path] = ("data",) + (None,) * (arr.ndim - 1)
                meta[path] = ((arr.shape[0] * self.world_size,)
                              + arr.shape[1:], arr.dtype.str)
            spec = ShardedTreeSpec(mesh=mesh, parts=parts, meta=meta)
            for path, arr in leaves.items():
                box = host_boxes(spec.mesh, parts[path], meta[path][0],
                                 host)[0]
                shards[path] = {box: arr}
            publish_host_shards(WeightStore(store_name), version, spec, host,
                                shards, skeleton=skeleton, durable=durable)
        return version

    def pull_weight_shards(self, store_name: str,
                           version: Optional[int] = None) -> Dict[str, Any]:
        """Pull this rank's shard of the newest published state, resharded
        onto THIS group's mesh (the publisher's world size may differ —
        that is the point). Returns ``{"version": v, "tree": shard_tree}``
        with each leaf's dim 0 sized for this world (numpy leaves)."""
        from ray_tpu_torch.train.scaling_policy import mesh_spec_for
        from ray_tpu_torch.weights import ShardedTreeSpec, WeightStore
        from ray_tpu_torch.weights.spec import unflatten_tree
        from ray_tpu_torch.weights.store import _spec_from_payload

        store = WeightStore(store_name)
        man = store.manifest(version)
        src = _spec_from_payload(man["spec"])
        mesh = mesh_spec_for(self.world_size)
        dst = ShardedTreeSpec(
            mesh=mesh,
            parts={p: ("data",) + (None,) * (len(shape) - 1)
                   for p, (shape, _) in src.meta.items()},
            meta=dict(src.meta))
        shards, ver = store.pull_shards(dst, mesh.hosts[self.rank],
                                        man["version"], return_version=True)
        leaves = {p: next(iter(boxes.values())) for p, boxes in shards.items()}
        return {"version": ver, "tree": unflatten_tree(man["skeleton"], leaves)}

    def shutdown(self):
        return True


class WorkerGroup:
    def __init__(self, scaling: ScalingConfig, name_prefix: str = "train",
                 ready_timeout: float = 600.0):
        self.scaling = scaling
        self.ready_timeout = ready_timeout
        self.workers: List[Any] = []
        self.pg: Optional[PlacementGroup] = None
        # seconds from the start of the formation: the placement group
        # ready, then every worker alive
        self.timings: Dict[str, float] = {}
        self._bootstrapped = False  # the default process group is formed
        self._create()

    def _create(self):
        n = self.scaling.num_workers
        timeout = self.ready_timeout
        t0 = time.monotonic()
        self.pg = placement_group(
            [self.scaling.bundle() for _ in range(n)],
            strategy=self.scaling.placement_strategy
            if self.scaling.placement_strategy in
            ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD") else "SPREAD")
        if not self.pg.ready(timeout=timeout):
            from ray_tpu_torch.exceptions import PlacementGroupError

            pg, self.pg = self.pg, None
            try:
                remove_placement_group(pg)  # don't leak the reservation
            except Exception:
                pass
            raise PlacementGroupError(
                f"worker-group placement group ({n} x "
                f"{self.scaling.bundle()}) not ready within {timeout}s")
        self.timings["placement_group_ready_s"] = time.monotonic() - t0
        res = self.scaling.bundle()
        self.workers = [
            TrainWorker.options(
                num_cpus=res.get("CPU", 1.0),
                num_gpus=res.get("GPU", 0.0),
                resources={k: v for k, v in res.items() if k not in ("CPU", "GPU")},
                scheduling_strategy=PlacementGroupSchedulingStrategy(self.pg, i),
                max_restarts=0,
            ).remote(i, n)
            for i in range(n)
        ]
        # make sure every worker is alive before proceeding
        ray_tpu_torch.get([w.get_host_info.remote() for w in self.workers],
                          timeout=self.ready_timeout)
        self.timings["workers_ready_s"] = time.monotonic() - t0

    def _device(self) -> str:
        return "cuda" if self.scaling.use_gpu else "cpu"

    def setup_grad_sync(self, group_name: str, backend: str = "gloo",
                        bucket_bytes: int = 32 << 20,
                        compression: Optional[str] = None):
        """Initialize bucketed grad sync on every worker (driver side). The
        first group of a process needs a rendezvous: rank 0 names one unless
        ``bootstrap_distributed`` formed the default process group."""
        init_method = None
        if not self._bootstrapped:
            init_method = ray_tpu_torch.get(
                self.workers[0].rendezvous.remote(), timeout=60)
        ray_tpu_torch.get([
            w.setup_grad_sync.remote(group_name, backend, bucket_bytes,
                                     compression, init_method)
            for w in self.workers
        ], timeout=300)

    def bootstrap_distributed(self):
        """Form the default process group across all workers (rank 0 hosts
        the rendezvous): NCCL on the card, gloo on the CPU."""
        coordinator = ray_tpu_torch.get(self.workers[0].rendezvous.remote(),
                                        timeout=60)
        refs = [
            w.setup_distributed.remote(coordinator, len(self.workers), i,
                                       self._device())
            for i, w in enumerate(self.workers)
        ]
        ray_tpu_torch.get(refs, timeout=600)
        self._bootstrapped = True

    def run(self, fn_blob, config, controller, latest_ckpt, run_dir, shards_per_rank):
        return [
            w.run.remote(fn_blob, config, controller,
                         latest_ckpt.path if latest_ckpt else None, run_dir,
                         shards_per_rank[i] if shards_per_rank else None,
                         self.timings)
            for i, w in enumerate(self.workers)
        ]

    def shutdown(self):
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        self.workers = []
        if self.pg is not None:
            try:
                remove_placement_group(self.pg)
            except Exception:
                pass
            self.pg = None
