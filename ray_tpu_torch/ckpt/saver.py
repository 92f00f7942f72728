"""Async checkpoint saver: bounded-pause snapshot, background commit. The
port of ``ray_tpu/ckpt/saver.py``.

The save path is split so the training step only ever pays for a host-RAM
snapshot (a copy of each local shard — the "barrier"), never for
serialization, hashing, or disk:

1. **snapshot** (caller thread, bounded pause): copy every array leaf to
   host memory (a tensor on the card: one device-to-host copy, which waits
   for the card's queued work on it); opaque non-array leaves are pickled
   immediately (they are tiny and a later mutation must not leak into the
   checkpoint);
2. **write** (background thread): serialize each shard box to bytes, hash
   it, write only chunks whose hash is new (content-addressed dedup — an
   unchanged leaf between steps costs zero write bytes), build the
   manifest, commit it atomically, run retention;
3. **backpressure**: at most one save is in flight; a second ``save()``
   while the previous is still writing blocks *then* (never mid-step),
   and the stall is recorded.

Metrics ride the port's registry (``util/metrics.py``), under the JAX
package's names: ``ray_tpu.ckpt.save_pause_seconds``,
``ray_tpu.ckpt.commit_seconds``, ``ray_tpu.ckpt.backpressure_seconds``
histograms and
``ray_tpu.ckpt.bytes_written`` / ``ray_tpu.ckpt.bytes_deduped`` counters.

Multi-host sharded saves (``save_host_shards`` + ``commit_host_parts``):
every host of the mesh writes its own shard chunks plus an atomic
per-host part-file; the committer (rank 0 by convention) merges the parts
into one manifest once all hosts have landed. No host ever serializes or
writes another host's bytes, and the checkpoint becomes visible only at
the single manifest commit.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional, Tuple

from ray_tpu_torch.ckpt import manifest as mf
from ray_tpu_torch.ckpt.store import CheckpointStore

_metrics_lock = threading.Lock()
_metrics: Optional[dict] = None


def _obs() -> dict:
    """Lazily-created plane metrics on the shared registry."""
    global _metrics
    with _metrics_lock:
        if _metrics is None:
            from ray_tpu_torch.util.metrics import Counter, Histogram

            _metrics = {
                "pause": Histogram(
                    "ray_tpu.ckpt.save_pause_seconds",
                    "train-side pause while snapshotting state to host RAM",
                    boundaries=[0.001, 0.01, 0.1, 1, 10]),
                "commit": Histogram(
                    "ray_tpu.ckpt.commit_seconds",
                    "background serialize+write+commit duration",
                    boundaries=[0.01, 0.1, 1, 10, 100]),
                "backpressure": Histogram(
                    "ray_tpu.ckpt.backpressure_seconds",
                    "save() stall waiting for the previous in-flight save",
                    boundaries=[0.001, 0.01, 0.1, 1, 10]),
                "bytes_written": Counter(
                    "ray_tpu.ckpt.bytes_written",
                    "chunk bytes actually written (post-dedup)"),
                "bytes_deduped": Counter(
                    "ray_tpu.ckpt.bytes_deduped",
                    "chunk bytes skipped because the content already existed"),
            }
        return _metrics


# ---------------------------------------------------------------------------
# snapshot + encode
# ---------------------------------------------------------------------------


def _is_array(leaf: Any) -> bool:
    import numpy as np
    import torch

    return isinstance(leaf, (np.ndarray, torch.Tensor))


def _host_copy(path: str, leaf: Any):
    """A numpy copy of an array leaf, in host memory. A bf16 tensor raises
    ``TypeError`` naming the leaf: numpy has no bf16 without ``ml_dtypes``,
    which the card's machine lacks."""
    import numpy as np
    import torch

    if not isinstance(leaf, torch.Tensor):
        return np.array(leaf, copy=True)
    if leaf.dtype == torch.bfloat16:
        raise TypeError(f"checkpoint leaf {path!r} is a bf16 tensor, which "
                        "has no numpy dtype here; save it as fp32")
    leaf = leaf.detach()
    if leaf.device.type != "cpu":
        return leaf.cpu().numpy()  # from the card: one device-to-host copy
    # on the CPU: numpy's copy, as the JAX package makes it, so that the
    # training loop's in-place updates cannot reach the snapshot. A torch
    # clone would run on the intra-op thread pool, which stalls for tens of
    # milliseconds when the host's cores are busy
    return np.array(leaf.numpy(), copy=True)


def snapshot_tree(tree: Any) -> Tuple[Any, Dict[str, Tuple[str, Any]]]:
    """The bounded-pause half: ``(skeleton, {path: (kind, payload)})``.
    Array leaves (numpy arrays, tensors on any device) are copied to host
    numpy; everything else is pickled NOW (through the serialization
    module) so later in-place mutation by the training loop cannot corrupt
    the checkpoint."""
    from ray_tpu_torch._private.serialization import dumps_oob
    from ray_tpu_torch.weights.spec import flatten_tree

    skeleton, leaves = flatten_tree(tree)
    snap: Dict[str, Tuple[str, Any]] = {}
    for path, leaf in leaves.items():
        if _is_array(leaf):
            snap[path] = (mf.ND, _host_copy(path, leaf))
        else:
            snap[path] = (mf.PY, dumps_oob(leaf))
    return skeleton, snap


def _chunk_bytes(arr) -> memoryview:
    """The C-order bytes of ``arr``, without a copy when it is contiguous
    already (the full-leaf chunk of an unsharded save)."""
    import numpy as np

    return memoryview(np.ascontiguousarray(arr).reshape(-1)).cast("B")


def _write_snapshot(store: CheckpointStore, ckpt_id: str, step: int,
                    skeleton: Any, snap: Dict[str, Tuple[str, Any]],
                    spec: Optional[Any], parent: Optional[str],
                    metrics: Optional[dict], pause_s: float,
                    keep_last: Optional[int]) -> mf.Manifest:
    """Background half: serialize/hash/write chunks, commit the manifest."""
    import numpy as np

    from ray_tpu_torch.util import tracing

    t0 = time.monotonic()
    ser_start = time.time()
    spec_payload = None
    boxes_of = None
    if spec is not None:
        from ray_tpu_torch.weights.spec import spec_payload as _payload
        from ray_tpu_torch.weights.spec import unique_boxes

        spec_payload = _payload(spec)
        boxes_of = {
            path: list(unique_boxes(spec.mesh, spec.part_of(path), shape))
            for path, (shape, _) in spec.meta.items()}
    leaves: Dict[str, mf.LeafEntry] = {}
    written = reused = written_b = reused_b = 0
    for path, (kind, payload) in sorted(snap.items()):
        if kind == mf.PY:
            h, created = mf.write_chunk(store.root, payload)
            entry = mf.LeafEntry(kind=mf.PY, shape=(), dtype="",
                                 chunks={"": (h, len(payload))})
            counts = [(created, len(payload))]
        else:
            from ray_tpu_torch.weights.spec import box_slices

            arr = np.ascontiguousarray(payload)
            full = tuple((0, s) for s in arr.shape)
            boxes = (boxes_of or {}).get(path) or [full]
            chunks: Dict[str, Tuple[str, int]] = {}
            counts = []
            for box in boxes:
                data = _chunk_bytes(arr[box_slices(box)])
                h, created = mf.write_chunk(store.root, data)
                chunks[mf.encode_box(box)] = (h, len(data))
                counts.append((created, len(data)))
            entry = mf.LeafEntry(kind=mf.ND, shape=tuple(arr.shape),
                                 dtype=arr.dtype.str, chunks=chunks)
        leaves[path] = entry
        for created, n in counts:
            if created:
                written += 1
                written_b += n
            else:
                reused += 1
                reused_b += n
    # explicit record (not profile()): an exception mid-serialize must not
    # leave a suspended span generator behind on this background thread
    tracing.record_span("ckpt.serialize", ser_start, time.time(),
                        category="ckpt", ckpt_id=ckpt_id, step=step)
    total_b = written_b + reused_b
    write_s = time.monotonic() - t0
    manifest = mf.Manifest(
        ckpt_id=ckpt_id, step=step, ts=time.time(), parent=parent,
        skeleton=skeleton, spec=spec_payload, leaves=leaves,
        metrics=dict(metrics or {}),
        stats={"bytes_total": total_b, "bytes_written": written_b,
               "bytes_reused": reused_b, "chunks_written": written,
               "chunks_reused": reused,
               "dedup_ratio": (reused_b / total_b) if total_b else 0.0,
               "pause_s": pause_s, "write_s": write_s})
    with tracing.profile("ckpt.commit", category="ckpt", ckpt_id=ckpt_id):
        store.commit(manifest)
        if keep_last is not None:
            store.retention(keep_last)
    obs = _obs()
    obs["commit"].observe(write_s)
    obs["bytes_written"].inc(written_b)
    obs["bytes_deduped"].inc(reused_b)
    return manifest


class CheckpointSaver:
    """Per-process async saver over one store. Thread-safe; at most one
    save in flight (bounded memory: one extra state copy)."""

    def __init__(self, store: CheckpointStore,
                 keep_last: Optional[int] = None):
        self.store = store
        self.keep_last = keep_last if keep_last is not None else store.keep_last
        self._lock = threading.Lock()
        self._inflight: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._last_manifest: Optional[mf.Manifest] = None

    # -- public --------------------------------------------------------

    def save(self, tree: Any, *, step: int = 0,
             metrics: Optional[dict] = None, spec: Optional[Any] = None,
             blocking: bool = False) -> str:
        """Snapshot ``tree`` and commit it in the background. Returns the
        checkpoint id immediately (readers racing the commit use
        ``store.wait_for``). ``spec`` (a ``ShardedTreeSpec``) records the
        shard geometry and splits leaves into per-box chunks; without it
        the tree is saved as one full-extent chunk per leaf."""
        from ray_tpu_torch.util import goodput, tracing

        with self._lock:
            # the whole caller-thread window — waiting out a prior
            # in-flight commit plus the synchronous snapshot — is what
            # the train loop experiences as the checkpoint pause
            with goodput.region("ckpt_pause"):
                self._drain_locked()  # backpressure + surface prior errors
                t0 = time.monotonic()
                with tracing.profile("ckpt.snapshot", category="ckpt",
                                     step=step):
                    skeleton, snap = snapshot_tree(tree)
                pause_s = time.monotonic() - t0
            goodput.count("ckpt_saves")
            _obs()["pause"].observe(pause_s)
            ckpt_id = mf.new_ckpt_id(step)
            parent = self.store.latest_id()

            def _run():
                try:
                    self._last_manifest = _write_snapshot(
                        self.store, ckpt_id, step, skeleton, snap, spec,
                        parent, metrics, pause_s, self.keep_last)
                except BaseException as e:  # surfaced on the next save/wait
                    self._error = e

            t = threading.Thread(target=_run, name="ckpt-saver", daemon=True)
            self._inflight = t
            t.start()
        if blocking:
            self.wait()
        return ckpt_id

    def wait(self, timeout: Optional[float] = None) -> Optional[mf.Manifest]:
        """Block until the in-flight save (if any) commits; re-raises a
        background failure. Returns the last committed manifest."""
        with self._lock:
            self._drain_locked(timeout)
            return self._last_manifest

    def in_flight(self) -> bool:
        t = self._inflight
        return t is not None and t.is_alive()

    # -- internals -----------------------------------------------------

    def _drain_locked(self, timeout: Optional[float] = None):
        t = self._inflight
        if t is not None and t.is_alive():
            t0 = time.monotonic()
            t.join(timeout)
            if t.is_alive():
                raise TimeoutError("checkpoint save still in flight")
            _obs()["backpressure"].observe(time.monotonic() - t0)
        self._inflight = None
        if self._error is not None:
            # the writer thread's _error/_last_manifest stores are ordered by
            # the t.join()/is_alive() above (Thread.join happens-before);
            # taking self._lock in _run instead would deadlock against this
            # locked join
            err, self._error = self._error, None
            raise RuntimeError(f"background checkpoint save failed: {err!r}") \
                from err


def save_checkpoint(store: CheckpointStore, tree: Any, *, step: int = 0,
                    metrics: Optional[dict] = None,
                    spec: Optional[Any] = None,
                    keep_last: Optional[int] = None) -> mf.Manifest:
    """One-shot blocking save (tools, tests, small states)."""
    saver = CheckpointSaver(store, keep_last=keep_last)
    saver.save(tree, step=step, metrics=metrics, spec=spec, blocking=True)
    manifest = saver.wait()
    assert manifest is not None
    return manifest


# ---------------------------------------------------------------------------
# multi-host sharded save: chunks per host, one manifest commit
# ---------------------------------------------------------------------------


def save_host_shards(store: CheckpointStore, ckpt_id: str, spec: Any,
                     host: str, shards: Dict[str, Dict[Any, Any]],
                     *, skeleton: Any = None, step: int = 0) -> int:
    """One host's side of a sharded save: write the chunk bytes of the
    shard boxes this host is the designated writer for (first replica
    holder, matching the weight plane's publish convention), then land an
    atomic part-file describing them. Returns chunks written."""
    import numpy as np

    from ray_tpu_torch.weights.spec import unique_boxes

    if skeleton is None:
        skeleton = {leaf: leaf for leaf in sorted(spec.meta)}
    part: Dict[str, Any] = {"host": host, "step": step, "leaves": {}}
    n = 0
    for leaf, boxes in shards.items():
        shape, _ = spec.meta[leaf]
        grid = unique_boxes(spec.mesh, spec.part_of(leaf), shape)
        entries = {}
        for box, arr in boxes.items():
            if grid.get(box, (host,))[0] != host:
                continue  # a replica peer writes this box
            data = _chunk_bytes(_host_copy(leaf, arr))
            h, _created = mf.write_chunk(store.root, data)
            entries[mf.encode_box(box)] = [h, len(data)]
            n += 1
        if entries:
            part["leaves"][leaf] = entries
    import json

    mf.atomic_write(_part_path(store.root, ckpt_id, host),
                    json.dumps(part).encode())
    return n


def _part_path(root: str, ckpt_id: str, host: str) -> str:
    import os

    return os.path.join(root, mf.PART_DIR, ckpt_id,
                        f"{ckpt_id}.{host}.json")


def commit_host_parts(store: CheckpointStore, ckpt_id: str, spec: Any,
                      *, skeleton: Any = None, step: int = 0,
                      metrics: Optional[dict] = None,
                      timeout: float = 300.0) -> mf.Manifest:
    """The committer's side: wait for every mesh host's part-file, merge
    them into one manifest, commit atomically. Refuses to commit a
    checkpoint with missing shard boxes — a partial save never becomes
    visible."""
    import json
    import os

    from ray_tpu_torch.weights.spec import spec_payload, unique_boxes

    if skeleton is None:
        skeleton = {leaf: leaf for leaf in sorted(spec.meta)}
    hosts = list(spec.mesh.hosts)
    deadline = time.monotonic() + timeout
    parts = {}
    while len(parts) < len(hosts):
        for host in hosts:
            if host in parts:
                continue
            try:
                with open(_part_path(store.root, ckpt_id, host)) as f:
                    parts[host] = json.load(f)
            except (FileNotFoundError, json.JSONDecodeError):
                continue
        if len(parts) < len(hosts):
            if time.monotonic() >= deadline:
                missing = sorted(set(hosts) - set(parts))
                raise TimeoutError(
                    f"sharded save {ckpt_id!r}: hosts {missing} never "
                    f"landed their part-files within {timeout}s; refusing "
                    f"to commit a partial checkpoint")
            time.sleep(0.02)
    leaves: Dict[str, mf.LeafEntry] = {}
    total_b = 0
    for leaf, (shape, dtype) in spec.meta.items():
        chunks: Dict[str, Tuple[str, int]] = {}
        for part in parts.values():
            for box_s, (h, nb) in (part["leaves"].get(leaf) or {}).items():
                chunks[box_s] = (h, int(nb))
                total_b += int(nb)
        expect = {mf.encode_box(b) for b in
                  unique_boxes(spec.mesh, spec.part_of(leaf), shape)}
        if set(chunks) != expect:
            raise ValueError(
                f"sharded save {ckpt_id!r}: leaf {leaf!r} boxes "
                f"{sorted(set(chunks))} != expected {sorted(expect)}")
        leaves[leaf] = mf.LeafEntry(kind=mf.ND, shape=tuple(shape),
                                    dtype=dtype, chunks=chunks)
    manifest = mf.Manifest(
        ckpt_id=ckpt_id, step=step, ts=time.time(),
        parent=store.latest_id(), skeleton=skeleton,
        spec=spec_payload(spec), leaves=leaves, metrics=dict(metrics or {}),
        stats={"bytes_total": total_b, "hosts": len(hosts)})
    store.commit(manifest)
    # part files are commit scaffolding, not checkpoint state
    import shutil

    shutil.rmtree(os.path.join(store.root, mf.PART_DIR, ckpt_id),
                  ignore_errors=True)
    return manifest
