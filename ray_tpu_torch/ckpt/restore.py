"""Restore: full-tree rebuild and restore-time resharding. The port of
``ray_tpu/ckpt/restore.py``: every function returns numpy arrays, as the
JAX ones do, and ``to_torch`` puts a restored tree's arrays on a device.

Restore is read-shaped like the weight plane's pull: a replicated consumer
(``restore``) rebuilds the whole tree; a sharded consumer
(``restore_shards``) names its target geometry (``MeshSpec`` + partitions
or a full ``ShardedTreeSpec``) and a host, and reads ONLY the chunk files
intersecting that host's destination boxes. When the target mesh differs
from the saved one, the saved spec + target spec run through the weight
plane's planner (``weights/plan.plan_reshard``) — ``restore_plan`` exposes
the plan so callers can assert ``no_gather()`` before touching a byte,
and the per-host chunk reads are exactly the plan's receive edges: no
host ever materializes a full leaf it does not declare replicated.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from ray_tpu_torch.ckpt import manifest as mf
from ray_tpu_torch.ckpt.store import CheckpointStore


def restore_spec(manifest: mf.Manifest):
    """The ``ShardedTreeSpec`` a checkpoint was saved under (array leaves
    only — opaque ``py`` leaves have no geometry and always replicate)."""
    from ray_tpu_torch.weights.spec import (MeshSpec, ShardedTreeSpec,
                                            spec_from_payload)

    if manifest.spec is not None:
        return spec_from_payload(manifest.spec)
    # unsharded save: single-host geometry, every leaf replicated
    return ShardedTreeSpec(
        mesh=MeshSpec.host_mesh(["ckpt"]),
        parts={p: () for p, e in manifest.leaves.items() if e.kind == mf.ND},
        meta={p: (tuple(e.shape), e.dtype)
              for p, e in manifest.leaves.items() if e.kind == mf.ND})


def restore_plan(manifest: mf.Manifest, dst_spec):
    """The reshard plan a sharded restore will execute (saved geometry ->
    ``dst_spec``). Callers assert plan-level invariants (``no_gather()``,
    byte counts) against it."""
    from ray_tpu_torch.weights.plan import plan_reshard

    src = restore_spec(manifest)
    dst_meta = dict(dst_spec.meta)
    src_meta = {p: m for p, m in src.meta.items() if p in dst_meta}
    import dataclasses as _dc

    src = _dc.replace(src, meta=src_meta,
                      parts={p: src.parts.get(p, ()) for p in src_meta})
    return plan_reshard(src, dst_spec)


def _read_chunks(store: CheckpointStore,
                 sizes: Dict[str, int]) -> Dict[str, bytes]:
    """Batch chunk read through the store's tier plane when it has one:
    a ``TieredStore`` serves local bytes and pulls evicted chunks from
    the remote tier in parallel (sha256-verified, cached locally); a
    plain store reads the local pool serially as before."""
    fetch = getattr(store, "fetch_chunks", None)
    if fetch is not None:
        return fetch(sizes)
    return {h: mf.read_chunk(store.root, h) for h in sizes}


def _py_leaves(store: CheckpointStore, manifest: mf.Manifest) -> Dict[str, Any]:
    from ray_tpu_torch._private.serialization import loads_oob

    sizes = {entry.chunks[""][0]: entry.chunks[""][1]
             for entry in manifest.leaves.values() if entry.kind == mf.PY}
    blobs = _read_chunks(store, sizes)
    out = {}
    for path, entry in manifest.leaves.items():
        if entry.kind == mf.PY:
            h, _ = entry.chunks[""]
            out[path] = loads_oob(blobs[h])
    return out


def restore_tree(store: CheckpointStore, ckpt_id: Optional[str] = None,
            *, timeout: float = 30.0) -> Any:
    """Rebuild the FULL tree of ``ckpt_id`` (default: latest committed).
    For replicated consumers only — sharded consumers use
    :func:`restore_shards` and never hold a gathered leaf."""
    import numpy as np

    from ray_tpu_torch.weights.spec import box_slices, unflatten_tree

    if ckpt_id is None:
        manifest = store.latest()
        if manifest is None:
            raise FileNotFoundError(
                f"checkpoint store {store.root!r} has no committed "
                f"checkpoint")
    else:
        manifest = store.wait_for(ckpt_id, timeout=timeout)
    leaves: Dict[str, Any] = _py_leaves(store, manifest)
    sizes = {h: nb for entry in manifest.leaves.values()
             if entry.kind == mf.ND for h, nb in entry.chunks.values()}
    blobs = _read_chunks(store, sizes)
    for path, entry in manifest.leaves.items():
        if entry.kind != mf.ND:
            continue
        dt = np.dtype(entry.dtype)
        out = np.empty(entry.shape, dtype=dt)
        for box_s, (h, _nb) in entry.chunks.items():
            box = mf.decode_box(box_s) or tuple((0, s) for s in entry.shape)
            data = np.frombuffer(blobs[h], dtype=dt)
            out[box_slices(box)] = data.reshape(
                tuple(b - a for a, b in box))
        leaves[path] = out
    return unflatten_tree(manifest.skeleton, leaves)


def restore_shards(store: CheckpointStore, dst_spec, host: str,
                   ckpt_id: Optional[str] = None, *,
                   timeout: float = 30.0,
                   ) -> Tuple[Dict[str, Dict[Any, Any]], Dict[str, Any]]:
    """Read exactly ``host``'s destination shards of ``dst_spec`` from the
    checkpoint, resharding through the saved geometry. Returns
    ``({leaf: {dst_box: array}}, stats)`` where stats carries the bytes
    actually read and the plan's invariants; no full leaf is ever
    materialized unless a destination box IS the full leaf."""
    import numpy as np

    from ray_tpu_torch.weights.spec import (host_boxes, intersect_box,
                                            rel_slices)

    if ckpt_id is None:
        manifest = store.latest()
        if manifest is None:
            raise FileNotFoundError(
                f"checkpoint store {store.root!r} has no committed "
                f"checkpoint")
    else:
        manifest = store.wait_for(ckpt_id, timeout=timeout)
    plan = restore_plan(manifest, dst_spec)
    # pass 1: every (leaf, dst box) names the chunks it intersects — the
    # union is exactly the bytes this host owns under the plan, fetched
    # once each (and, on a TieredStore, concurrently across tiers)
    needed: Dict[str, int] = {}
    per_leaf: Dict[str, list] = {}
    for leaf, (shape, dtype) in dst_spec.meta.items():
        entry = manifest.leaves.get(leaf)
        if entry is None or entry.kind != mf.ND:
            raise KeyError(f"checkpoint {manifest.ckpt_id!r} has no array "
                           f"leaf {leaf!r}")
        chunk_boxes = [
            (mf.decode_box(bs) or tuple((0, s) for s in entry.shape), h, nb)
            for bs, (h, nb) in entry.chunks.items()]
        per_leaf[leaf] = chunk_boxes
        for dbox in host_boxes(dst_spec.mesh, dst_spec.part_of(leaf),
                               shape, host):
            for cbox, h, nb in chunk_boxes:
                if intersect_box(dbox, cbox) is not None:
                    needed[h] = nb
    blobs = _read_chunks(store, needed)
    bytes_read = sum(len(b) for b in blobs.values())
    chunks_read = len(blobs)
    # pass 2: assemble this host's shards from the fetched chunk bytes
    out: Dict[str, Dict[Any, Any]] = {}
    cache: Dict[str, np.ndarray] = {}
    for leaf, (shape, dtype) in dst_spec.meta.items():
        dt = np.dtype(dtype)
        out[leaf] = {}
        for dbox in host_boxes(dst_spec.mesh, dst_spec.part_of(leaf),
                               shape, host):
            shard = np.empty(tuple(b - a for a, b in dbox), dtype=dt)
            for cbox, h, _nb in per_leaf[leaf]:
                inter = intersect_box(dbox, cbox)
                if inter is None:
                    continue
                chunk = cache.get(h)
                if chunk is None:
                    chunk = np.frombuffer(blobs[h], dtype=dt).reshape(
                        tuple(b - a for a, b in cbox))
                    cache[h] = chunk
                shard[rel_slices(inter, dbox)] = chunk[rel_slices(inter, cbox)]
            out[leaf][dbox] = shard
    stats = {"ckpt_id": manifest.ckpt_id, "bytes_read": bytes_read,
             "chunks_read": chunks_read, "no_gather": plan.no_gather(),
             "plan": plan.stats()}
    return out, stats


def restore_tree_shards(store: CheckpointStore, num_hosts: int, rank: int,
                        ckpt_id: Optional[str] = None, *, axis: str = "data",
                        timeout: float = 30.0) -> Dict[str, Any]:
    """Convenience for the elastic-train contract (every array leaf sharded
    along dim 0 across ``num_hosts`` ranks, matching
    ``train.scaling_policy.mesh_spec_for``): returns ``{"ckpt_id", "tree",
    "stats"}`` with this rank's dim-0 shard of every array leaf and full
    copies of opaque leaves."""
    import dataclasses as _dc

    from ray_tpu_torch.train.scaling_policy import mesh_spec_for
    from ray_tpu_torch.weights.spec import ShardedTreeSpec, unflatten_tree

    if ckpt_id is None:
        manifest = store.latest()
        if manifest is None:
            raise FileNotFoundError(
                f"checkpoint store {store.root!r} has no committed "
                f"checkpoint")
        ckpt_id = manifest.ckpt_id
    else:
        manifest = store.wait_for(ckpt_id, timeout=timeout)
    mesh = mesh_spec_for(num_hosts, axis=axis)
    src = restore_spec(manifest)
    dst = ShardedTreeSpec(
        mesh=mesh,
        parts={p: (axis,) + (None,) * (len(shape) - 1)
               for p, (shape, _) in src.meta.items()},
        meta=dict(src.meta))
    shards, stats = restore_shards(store, dst, mesh.hosts[rank], ckpt_id,
                                   timeout=timeout)
    leaves = {p: next(iter(boxes.values())) for p, boxes in shards.items()}
    leaves.update(_py_leaves(store, manifest))
    return {"ckpt_id": ckpt_id,
            "tree": unflatten_tree(manifest.skeleton, leaves),
            "stats": stats}


def to_torch(tree: Any, device) -> Any:
    """A restored tree with each numpy array as a tensor on ``device`` (a
    copy; on the card, one host-to-device copy each) and every other leaf as
    it is. Containers are rebuilt as ``restore_tree`` rebuilds them, the
    package's dataclasses (``OptState``) among them."""
    import numpy as np
    import torch

    from ray_tpu_torch.weights.spec import flatten_tree, unflatten_tree

    skeleton, leaves = flatten_tree(tree)
    return unflatten_tree(skeleton, {
        path: (torch.from_numpy(leaf).to(device, copy=True)
               if isinstance(leaf, np.ndarray) else leaf)
        for path, leaf in leaves.items()})
