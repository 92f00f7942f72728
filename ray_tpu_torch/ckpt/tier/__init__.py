"""ray_tpu_torch.ckpt.tier: the pluggable checkpoint storage plane, the
port of ``ray_tpu/ckpt/tier``.

Layers:

- ``backend``       — the ``ChunkBackend`` contract + ``LocalFSBackend``
- ``bucket``        — bucket/object-namespace backend, multipart uploads,
                      ``FaultShim`` fault/latency injector
- ``pario``         — bounded-parallel chunk IO with verification
- ``tiered``        — ``TieredStore``: local commits + async mirror pump,
                      residency, eviction, read-through restore
- ``object_plane``  — chunks as owned cluster objects (vault actor)
- ``sweeper``       — keep-last/pinned/grace retention across tiers
"""

from ray_tpu_torch.ckpt.tier.backend import (BackendUnavailable,
                                             ChunkBackend, LocalFSBackend,
                                             backend_from_descriptor)
from ray_tpu_torch.ckpt.tier.bucket import (BucketBackend, DirBucketClient,
                                            FaultShim)
from ray_tpu_torch.ckpt.tier.pario import (ChunkFetchError, ChunkVerifyError,
                                           ParallelIO, coalesce_ranges)
from ray_tpu_torch.ckpt.tier.sweeper import (SweepPolicy, sweep_registered,
                                             sweep_store)
from ray_tpu_torch.ckpt.tier.tiered import TieredStore, attach

__all__ = [
    "BackendUnavailable",
    "ChunkBackend",
    "LocalFSBackend",
    "BucketBackend",
    "DirBucketClient",
    "FaultShim",
    "ChunkFetchError",
    "ChunkVerifyError",
    "ParallelIO",
    "coalesce_ranges",
    "TieredStore",
    "attach",
    "SweepPolicy",
    "sweep_store",
    "sweep_registered",
    "backend_from_descriptor",
    "ObjectPlaneBackend",
]


def __getattr__(name: str):
    # ObjectPlaneBackend pulls in the worker and actor machinery: kept lazy
    # so that offline tools import the tier without the runtime
    if name == "ObjectPlaneBackend":
        from ray_tpu_torch.ckpt.tier.object_plane import ObjectPlaneBackend

        return ObjectPlaneBackend
    raise AttributeError(f"module 'ray_tpu_torch.ckpt.tier' has no attribute "
                         f"{name!r}")
