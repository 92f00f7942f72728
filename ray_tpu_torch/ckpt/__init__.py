"""ray_tpu_torch.ckpt: async sharded checkpointing with content-addressed
chunks, the port of ``ray_tpu.ckpt``. Its on-disk format is the JAX
package's: either package restores the other's checkpoints.

Public surface::

    from ray_tpu_torch import ckpt

    store = ckpt.CheckpointStore("/mnt/ckpts/run1", keep_last=5)
    saver = ckpt.CheckpointSaver(store)
    cid = saver.save({"params": params, "opt": opt_state}, step=n)
    saver.wait()                             # barrier (e.g. before exit)

    tree = ckpt.restore_tree(store)          # latest, full tree, numpy
    state = ckpt.to_torch(tree, "cuda")      # ... as tensors on the card
    shards, stats = ckpt.restore_shards(store, dst_spec, host)
    plan = ckpt.restore_plan(store.latest(), dst_spec)  # no_gather() etc.

    store.pin(cid); store.retention(keep_last=3)
    ckpt.diff_manifests(store.read(a), store.read(b))   # chunk delta

``save`` pauses the caller only while the state is copied to host memory;
serialization, sha256 and the writes run on a background thread. Not
ported yet: the object-plane tier backend and the GCS stats mirror, which
need the runtime.
"""

# Lazy exports (PEP 562): the plane pulls in numpy + the weights geometry,
# which must not ride along into processes that never checkpoint.
_EXPORTS = {
    "Manifest": "manifest", "LeafEntry": "manifest",
    "atomic_write": "manifest", "diff_manifests": "manifest",
    "new_ckpt_id": "manifest",
    "CheckpointStore": "store",
    "CheckpointSaver": "saver", "save_checkpoint": "saver",
    "save_host_shards": "saver", "commit_host_parts": "saver",
    "snapshot_tree": "saver",
    "restore_tree": "restore", "restore_shards": "restore",
    "restore_plan": "restore", "restore_spec": "restore",
    "restore_tree_shards": "restore", "to_torch": "restore",
    # storage tier plane
    "TieredStore": "tier.tiered", "attach": "tier.tiered",
    "ChunkBackend": "tier.backend", "LocalFSBackend": "tier.backend",
    "BucketBackend": "tier.bucket", "DirBucketClient": "tier.bucket",
    "FaultShim": "tier.bucket",
    "ParallelIO": "tier.pario",
    "SweepPolicy": "tier.sweeper", "sweep_store": "tier.sweeper",
}


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module 'ray_tpu_torch.ckpt' has no attribute "
                             f"{name!r}")
    import importlib

    return getattr(importlib.import_module(f"ray_tpu_torch.ckpt.{mod}"), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))


__all__ = sorted(_EXPORTS)
