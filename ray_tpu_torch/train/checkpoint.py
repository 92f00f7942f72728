"""Train checkpoints: directory handles over the checkpoint plane, the port
of ``ray_tpu/train/checkpoint.py``.

Reference: ray.train.Checkpoint (directory handle) and ``CheckpointManager``
(train/v2/_internal/execution/checkpoint/checkpoint_manager.py:71).

The manager is a thin policy layer over the port's ``ckpt`` plane: a
reported checkpoint directory is snapshotted as a tree of file-bytes leaves
and committed as an immutable manifest + content-addressed chunks
(``<run_dir>/ckpts/``). Consecutive checkpoints whose files did not change
dedup to the same chunks, a torn save is never visible, and
``latest()/best()`` materialize a directory back out of the manifest on
demand. The on-disk layout is the JAX package's, so either package's
manager reads the other's run directory.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Dict, List, Optional


class Checkpoint:
    """A directory of checkpoint artifacts."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    def as_directory(self) -> str:
        return self.path

    def to_directory(self, dest: str) -> str:
        if os.path.abspath(dest) != self.path:
            shutil.copytree(self.path, dest, dirs_exist_ok=True)
        return dest

    def __repr__(self):
        return f"Checkpoint({self.path})"


# ---------------------------------------------------------------------------
# directory <-> tree codec (files as uint8 leaves on the ckpt plane)
# ---------------------------------------------------------------------------


def dir_to_tree(path: str) -> Dict[str, Any]:
    """A checkpoint directory as a flat ``{relpath: uint8 array}`` tree —
    the shape the checkpoint plane stores. File bytes are read into RAM
    here (the snapshot barrier), so the source directory may be deleted
    the moment this returns."""
    import numpy as np

    out: Dict[str, Any] = {}
    root = os.path.abspath(path)
    for dirpath, _dirnames, filenames in os.walk(root):
        for name in sorted(filenames):
            full = os.path.join(dirpath, name)
            rel = os.path.relpath(full, root)
            with open(full, "rb") as f:
                out[rel] = np.frombuffer(f.read(), dtype=np.uint8)
    return out


def tree_to_dir(tree: Dict[str, Any], dest: str) -> str:
    """Materialize a file tree restored from a manifest back into a
    directory (each file lands atomically)."""
    from ray_tpu_torch.ckpt.manifest import atomic_write

    os.makedirs(dest, exist_ok=True)
    for rel, data in tree.items():
        atomic_write(os.path.join(dest, rel), bytes(memoryview(data)))
    return dest


def checkpoint_store(run_dir: str):
    """The run's checkpoint-plane store (shared by workers + controller).

    Local-only by default. It becomes a :class:`~ray_tpu_torch.ckpt.TieredStore`
    when the run already carries a ``TIER`` descriptor (resuming a tiered
    run re-attaches its backend) or when ``ckpt_tier_root`` (env
    ``RAY_TPU_CKPT_TIER_ROOT``) names a bucket root — each run then
    mirrors asynchronously into ``<tier_root>/<run_name>/`` and restores
    read through the tiers, so a host that lost its local pool (or a
    replacement host) still restores."""
    from ray_tpu_torch._private.config import RAY_CONFIG
    from ray_tpu_torch.ckpt import CheckpointStore
    from ray_tpu_torch.ckpt.tier.tiered import TIER_FILE

    root = os.path.join(run_dir, "ckpts")
    name = os.path.basename(os.path.abspath(run_dir)) or "train"
    if os.path.exists(os.path.join(root, TIER_FILE)):
        from ray_tpu_torch.ckpt import TieredStore

        return TieredStore(root, name=name)
    tier_root = RAY_CONFIG.ckpt_tier_root
    if tier_root:
        from ray_tpu_torch.ckpt import (BucketBackend, DirBucketClient,
                                  TieredStore)

        client = DirBucketClient(os.path.join(tier_root, name))
        return TieredStore(root, name=name, backend=BucketBackend(client))
    return CheckpointStore(root, name=name)


class CheckpointManager:
    """Tracks reported checkpoints, keeps top-K by the configured score
    attribute. Storage is the checkpoint plane; records reference manifest
    ids and directories are materialized lazily on access."""

    def __init__(self, run_dir: str, num_to_keep: Optional[int] = None,
                 score_attribute: Optional[str] = None, score_order: str = "max"):
        self.run_dir = run_dir
        self.num_to_keep = num_to_keep
        self.score_attribute = score_attribute
        self.score_order = score_order
        self.index = 0
        self.records: List[Dict[str, Any]] = []
        # manifests that never committed (saver crashed mid-write): cached
        # so every latest() after the first does not re-pay the wait
        self._failed_ids: set = set()
        os.makedirs(run_dir, exist_ok=True)
        self.store = checkpoint_store(run_dir)
        self._load_state()

    def _state_path(self) -> str:
        return os.path.join(self.run_dir, "checkpoint_manager.json")

    def _load_state(self):
        try:
            with open(self._state_path()) as f:
                state = json.load(f)
            self.index = state["index"]
            self.records = [self._migrate_record(i, r)
                            for i, r in enumerate(state["records"])]
        except (FileNotFoundError, json.JSONDecodeError, KeyError):
            pass

    @staticmethod
    def _migrate_record(i: int, rec: Dict[str, Any]) -> Dict[str, Any]:
        """Accept pre-plane records ({"path": dir, ...}): they have no
        manifest (ckpt_id None) and resolve straight to their directory —
        a run started on the previous layout resumes instead of crashing."""
        if "ckpt_id" in rec:
            return rec
        path = rec.get("path", "")
        try:
            index = int(os.path.basename(path).rsplit("_", 1)[-1])
        except (ValueError, IndexError):
            index = i + 1
        return {"ckpt_id": None, "index": index, "path": path,
                "metrics": rec.get("metrics", {}), "time": rec.get("time", 0)}

    def _save_state(self):
        from ray_tpu_torch.ckpt.manifest import atomic_write

        atomic_write(self._state_path(),
                     json.dumps({"index": self.index,
                                 "records": self.records}).encode())

    # -- registration --------------------------------------------------

    def register(self, source_dir: str, metrics: Dict[str, Any]) -> Checkpoint:
        """Persist a reported checkpoint directory through the plane
        (blocking — used by callers that hand over a directory they are
        about to delete)."""
        from ray_tpu_torch.ckpt import save_checkpoint

        manifest = save_checkpoint(self.store, dir_to_tree(source_dir),
                                   step=self.index + 1, metrics=metrics)
        return self.register_manifest(manifest.ckpt_id, metrics)

    def register_manifest(self, ckpt_id: str,
                          metrics: Dict[str, Any]) -> Checkpoint:
        """Record an already-saved (possibly still committing) checkpoint
        manifest — the worker-side async save path."""
        self.index += 1
        self.records.append({"ckpt_id": ckpt_id, "index": self.index,
                             "metrics": metrics, "time": time.time()})
        self._prune()
        self._save_state()
        return Checkpoint(self._dir_for(self.records[-1]))

    # -- retention -----------------------------------------------------

    def _ranked(self) -> List[Dict[str, Any]]:
        if not self.score_attribute:
            return list(self.records)
        sign = 1 if self.score_order == "max" else -1
        return sorted(
            self.records,
            key=lambda r: sign * float(
                r["metrics"].get(self.score_attribute, 0.0)),
            reverse=True)

    def _prune(self):
        if self.num_to_keep is None or len(self.records) <= self.num_to_keep:
            return
        if self.score_attribute:
            keep = self._ranked()[: self.num_to_keep]
        else:
            keep = self.records[-self.num_to_keep:]
        for rec in self.records:
            if rec not in keep:
                shutil.rmtree(self._dir_for(rec), ignore_errors=True)
        self.records = [r for r in self.records if r in keep]
        # drop the superseded manifests and GC their now-orphan chunks;
        # the store's grace window protects chunks of a save whose
        # manifest has not committed yet (the worker-side async path)
        self.store.retention(keep_last=0,
                             keep_ids=[r["ckpt_id"] for r in self.records
                                       if r.get("ckpt_id")])

    # -- access --------------------------------------------------------

    def _dir_for(self, rec: Dict[str, Any]) -> str:
        return rec.get("path") or os.path.join(
            self.run_dir, f"checkpoint_{rec['index']:06d}")

    def _materialize(self, rec: Dict[str, Any],
                     timeout: float = 10.0) -> Optional[str]:
        """Directory for a record, restored from its manifest on first
        access. Returns None when the manifest never committed (saver
        died mid-write) — callers fall back to the previous record."""
        dest = self._dir_for(rec)
        if os.path.isdir(dest):
            return dest
        if rec.get("ckpt_id") is None:  # pre-plane record, dir is gone
            return None
        if rec["ckpt_id"] in self._failed_ids:
            return None
        from ray_tpu_torch.ckpt import restore_tree

        try:
            self.store.wait_for(rec["ckpt_id"], timeout=timeout)
            tree = restore_tree(self.store, rec["ckpt_id"])
        except (TimeoutError, FileNotFoundError, KeyError, ValueError):
            # blacklist only once the record is old enough that its save
            # can no longer be in flight — a merely-slow commit must not
            # be skipped forever, a truly torn one must only be waited
            # for once
            if time.time() - rec.get("time", 0) > 60.0:
                self._failed_ids.add(rec["ckpt_id"])
            return None
        return tree_to_dir(tree, dest)

    def latest(self) -> Optional[Checkpoint]:
        """Newest restorable checkpoint: records whose manifest never
        committed (a save torn by a crash) are skipped, newest-first."""
        for i, rec in enumerate(reversed(self.records)):
            # only the newest record may still be mid-commit; give it a
            # short grace window, fall straight through for older ones
            path = self._materialize(rec, timeout=10.0 if i == 0 else 0.0)
            if path is not None:
                return Checkpoint(path)
        return None

    def best(self) -> Optional[Checkpoint]:
        if not self.records:
            return None
        if not self.score_attribute:
            return self.latest()
        for rec in self._ranked():
            path = self._materialize(rec)
            if path is not None:
                return Checkpoint(path)
        return None
