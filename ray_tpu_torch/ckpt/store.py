"""CheckpointStore: a named checkpoint directory, the port of
``ray_tpu/ckpt/store.py``.

One store root holds many checkpoints sharing one content-addressed chunk
pool (``manifest.py`` layout). The store adds the management plane:

- ``list()/latest()/read()`` — enumeration and lookup, tolerant of torn
  files (a crashed save is invisible, never an error);
- ``pin()/unpin()`` — pinned checkpoints survive retention (milestones,
  eval-best);
- ``retention(keep_last)`` — bounded keep-last GC: unpinned manifests
  beyond the newest ``keep_last`` are dropped, then chunks no surviving
  manifest references are deleted. Drops are *counted* (manifests/chunks/
  bytes) and persisted beside the checkpoints, so truncation is visible,
  never silent.

The JAX store also mirrors its stats into the cluster's GCS when one is up,
and does nothing there without one, by its own contract. The port has no
runtime yet, so ``mirror()`` returns at once, as the JAX one does with no
cluster; the GCS mirror comes with the runtime's port.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.ckpt import manifest as mf


class CheckpointStore:
    """Handle on one checkpoint directory (create-or-attach)."""

    def __init__(self, root: str, name: Optional[str] = None,
                 keep_last: Optional[int] = None):
        self.root = os.path.abspath(os.fspath(root))
        self.name = name or os.path.basename(self.root.rstrip("/")) or "ckpt"
        self.keep_last = keep_last
        os.makedirs(self.root, exist_ok=True)
        # monotonically-accumulated drop/GC counters (persisted so they
        # survive the process: truncation evidence must not vanish)
        self._counters = self._load_counters()

    # -- lookup --------------------------------------------------------

    def list(self) -> List[mf.Manifest]:
        """All valid checkpoints, oldest-first."""
        return [mf.read_manifest(self.root, cid)
                for cid in mf.list_manifest_ids(self.root)]

    def list_ids(self) -> List[str]:
        return mf.list_manifest_ids(self.root)

    def read(self, ckpt_id: str) -> mf.Manifest:
        return mf.read_manifest(self.root, ckpt_id)

    def latest_id(self) -> Optional[str]:
        """The committed ``LATEST`` pointer; falls back to the newest
        valid manifest when the pointer is missing or torn."""
        cid = mf.read_latest_id(self.root)
        if cid is not None:
            return cid
        ids = mf.list_manifest_ids(self.root)
        return ids[-1] if ids else None

    def latest(self) -> Optional[mf.Manifest]:
        cid = self.latest_id()
        return mf.read_manifest(self.root, cid) if cid else None

    def wait_for(self, ckpt_id: str, timeout: float = 30.0) -> mf.Manifest:
        """Block until ``ckpt_id``'s manifest is committed (the async
        saver hands out ids at snapshot time; readers that race the
        background commit park here instead of failing)."""
        deadline = time.monotonic() + timeout
        while True:
            try:
                return mf.read_manifest(self.root, ckpt_id)
            except (FileNotFoundError, json.JSONDecodeError, KeyError):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"checkpoint {ckpt_id!r} not committed within "
                        f"{timeout}s (saver crashed mid-write?)")
                time.sleep(0.02)

    # -- commit --------------------------------------------------------

    def commit(self, manifest: mf.Manifest) -> None:
        mf.commit(self.root, manifest)
        self.mirror(min_interval=2.0)

    # -- pins ----------------------------------------------------------

    def pins(self) -> List[str]:
        try:
            with open(os.path.join(self.root, mf.PINS_FILE)) as f:
                return list(json.load(f))
        except (FileNotFoundError, json.JSONDecodeError):
            return []

    def pin(self, ckpt_id: str) -> None:
        self.read(ckpt_id)  # refuse to pin something that does not exist
        pins = self.pins()
        if ckpt_id not in pins:
            pins.append(ckpt_id)
            mf.atomic_write(os.path.join(self.root, mf.PINS_FILE),
                            json.dumps(pins).encode())
        self.mirror()

    def unpin(self, ckpt_id: str) -> None:
        pins = [p for p in self.pins() if p != ckpt_id]
        mf.atomic_write(os.path.join(self.root, mf.PINS_FILE),
                        json.dumps(pins).encode())
        self.mirror()

    # -- retention -----------------------------------------------------

    def retention(self, keep_last: Optional[int] = None,
                  keep_ids: Optional[List[str]] = None,
                  grace_s: float = 300.0) -> Dict[str, int]:
        """Bounded retention: keep the newest ``keep_last`` checkpoints
        (plus every pinned one, plus any explicitly listed ``keep_ids``),
        drop the rest, then garbage-collect unreferenced chunks. Returns
        and accumulates drop counters.

        ``grace_s``: chunks younger than this are never collected, even
        when no manifest references them — an async saver (or a sharded
        save's peer hosts) writes chunks BEFORE its manifest commits, and
        a concurrent retention pass must not delete them out from under
        the commit. Pass 0 only when no save can be in flight."""
        keep_last = self.keep_last if keep_last is None else keep_last
        ids = mf.list_manifest_ids(self.root)
        keep = set(self.pins()) | set(keep_ids or ())
        if keep_last is None:
            keep.update(ids)
        elif keep_last > 0:
            # keep-last counts checkpoints NOT already kept by pin/keep_ids:
            # pinned auxiliary manifests (e.g. the weight plane's durable
            # ``weights-*`` versions, which sort after ``step*`` ids) must
            # not consume keep-last slots and evict the newest training
            # checkpoint
            keep.update([cid for cid in ids if cid not in keep][-keep_last:])
        drop = [cid for cid in ids if cid not in keep]
        dropped_chunks = dropped_bytes = 0
        live: Dict[str, int] = {}
        for cid in ids:
            if cid in keep:
                try:
                    live.update(self.read(cid).chunk_set())
                except (FileNotFoundError, json.JSONDecodeError, KeyError):
                    continue
        # chunks referenced by in-flight sharded saves (un-committed
        # part-files) are live regardless of age: a slow peer host's
        # already-written chunks must survive a racing retention pass
        # even past the grace window
        from ray_tpu_torch.ckpt.tier.sweeper import _inflight_chunks

        live.update(_inflight_chunks(self.root))
        for cid in drop:
            try:
                os.remove(mf.manifest_path(self.root, cid))
            except FileNotFoundError:
                pass
        # chunk GC: anything on disk no surviving manifest references
        cdir = os.path.join(self.root, mf.CHUNK_DIR)
        if os.path.isdir(cdir):
            for sub in os.listdir(cdir):
                subdir = os.path.join(cdir, sub)
                if not os.path.isdir(subdir):
                    continue
                for h in os.listdir(subdir):
                    if h in live or ".tmp." in h:
                        continue
                    path = os.path.join(subdir, h)
                    try:
                        if grace_s and (time.time() - os.path.getmtime(path)
                                        < grace_s):
                            continue  # may belong to an in-flight save
                        nbytes = os.path.getsize(path)
                        os.remove(path)
                        dropped_chunks += 1
                        dropped_bytes += nbytes
                    except OSError:
                        continue
        out = {"dropped_manifests": len(drop),
               "dropped_chunks": dropped_chunks,
               "dropped_bytes": dropped_bytes}
        if drop or dropped_chunks:
            for k, v in out.items():
                self._counters[k] = self._counters.get(k, 0) + v
            self._save_counters()
        self.mirror()
        return out

    # -- stats / mirror --------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        manifests = self.list()
        pins = set(self.pins())
        chunk_bytes = 0
        cdir = os.path.join(self.root, mf.CHUNK_DIR)
        if os.path.isdir(cdir):
            for sub in os.listdir(cdir):
                subdir = os.path.join(cdir, sub)
                if os.path.isdir(subdir):
                    for h in os.listdir(subdir):
                        if ".tmp." not in h:
                            try:
                                chunk_bytes += os.path.getsize(
                                    os.path.join(subdir, h))
                            except OSError:
                                pass
        latest = self.latest_id()
        return {
            "name": self.name,
            "root": self.root,
            "latest": latest,
            "num_checkpoints": len(manifests),
            "pinned": sorted(pins),
            "chunk_pool_bytes": chunk_bytes,
            "drops": dict(self._counters),
            "checkpoints": [
                {"ckpt_id": m.ckpt_id, "step": m.step, "ts": m.ts,
                 "parent": m.parent, "total_bytes": m.total_bytes(),
                 "num_leaves": len(m.leaves),
                 "pinned": m.ckpt_id in pins,
                 "stats": m.stats, "metrics": m.metrics}
                for m in manifests
            ],
        }

    def mirror(self, min_interval: float = 0.0) -> None:
        """Where the JAX store mirrors its stats into the GCS KV for the
        state API, dashboard and CLI. There is no cluster for the port to
        mirror into yet, so this returns at once (the JAX store's no-cluster
        path); ``TieredStore`` and the saver call it where the JAX ones
        do."""
        return None

    # -- counters ------------------------------------------------------

    def _counters_path(self) -> str:
        return os.path.join(self.root, "retention_counters.json")

    def _load_counters(self) -> Dict[str, int]:
        try:
            with open(self._counters_path()) as f:
                return {k: int(v) for k, v in json.load(f).items()}
        except (FileNotFoundError, json.JSONDecodeError, ValueError):
            return {}

    def _save_counters(self) -> None:
        mf.atomic_write(self._counters_path(),
                        json.dumps(self._counters).encode())
