"""TieredStore: a CheckpointStore whose chunk pool spans storage tiers. The
port of ``ray_tpu/ckpt/tier/tiered.py``.

Commits are EXACTLY today's local path — bounded-pause snapshot, local
chunk writes, atomic manifest commit — so the training loop never waits
on a remote tier. Durability arrives asynchronously:

1. **commit** lands locally; the checkpoint's *residency* becomes
   ``local``;
2. the **mirror pump** (one background thread) replicates chunk bytes to
   the remote :class:`ChunkBackend` through the parallel IO engine
   (content-address dedup: a chunk uploads once, ever — across steps AND
   across re-mirror attempts), then the manifest, and only then flips
   residency to ``remote``. A crash mid-mirror leaves ``mirroring`` —
   a partially-uploaded checkpoint is never presented as durable, and
   re-mirroring is idempotent by content address;
3. **evict_local** (explicit or policy-driven) drops local chunk bytes
   of a ``remote`` checkpoint (keeping chunks other local-resident
   checkpoints still reference). Restore then **read-through fetches**:
   local pool first, missing chunks pulled in parallel from the remote
   tier, sha256-verified, and cached back into the local pool.

The residency index lives at ``<root>/RESIDENCY`` (atomic JSON) and rides
``stats()`` (the JAX store also mirrors it into the GCS, which the port does
not have yet). The backend descriptor persists at ``<root>/TIER`` so any
process (a sweeper, a replacement host) can re-attach with :func:`attach`.
A failed mirror is logged as a warning where the JAX store records a
cluster event.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.ckpt import manifest as mf
from ray_tpu_torch.ckpt.store import CheckpointStore
from ray_tpu_torch.ckpt.tier.backend import (ChunkBackend, backend_from_descriptor)
from ray_tpu_torch.ckpt.tier.pario import ChunkFetchError, ParallelIO

logger = logging.getLogger(__name__)

RESIDENCY_FILE = "RESIDENCY"
TIER_FILE = "TIER"

# residency states (monotonic per mirror attempt; evict sets "evicted"
# alongside "remote" — an evicted checkpoint is still fully durable)
LOCAL = "local"
MIRRORING = "mirroring"
REMOTE = "remote"


class TieredStore(CheckpointStore):
    """Local store + one remote chunk tier behind it."""

    def __init__(self, root: str, name: Optional[str] = None,
                 keep_last: Optional[int] = None, *,
                 backend: Optional[ChunkBackend] = None,
                 mirror: Optional[bool] = None,
                 io: Optional[ParallelIO] = None,
                 io_threads: Optional[int] = None,
                 sweep: Optional[Dict[str, Any]] = None):
        super().__init__(root, name, keep_last)
        from ray_tpu_torch._private.config import RAY_CONFIG

        if backend is None:
            backend, persisted_sweep = _read_tier_file(self.root)
            if backend is None:
                raise ValueError(
                    f"store {self.root!r} has no TIER descriptor; pass "
                    f"backend= on first construction")
            if sweep is None:
                sweep = persisted_sweep
        self.backend = backend
        self.io = io or ParallelIO(backend, threads=io_threads)
        self.mirror_enabled = (RAY_CONFIG.ckpt_mirror_enabled
                               if mirror is None else bool(mirror))
        self.sweep_policy = dict(sweep) if sweep else None
        self._res_lock = threading.Lock()
        self._pump_q: "queue.Queue[Optional[str]]" = queue.Queue()
        self._pump_thread: Optional[threading.Thread] = None
        self._pump_stop = threading.Event()
        mf.atomic_write(os.path.join(self.root, TIER_FILE), json.dumps({
            "backend": self.backend.descriptor(),
            "sweep": self.sweep_policy}, sort_keys=True).encode())

    # -- residency index -----------------------------------------------

    def residency(self) -> Dict[str, Dict[str, Any]]:
        try:
            with open(os.path.join(self.root, RESIDENCY_FILE)) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return {}

    def _update_residency(self, ckpt_id: str, state: Optional[str] = None,
                          drop: bool = False, **extra: Any) -> None:
        with self._res_lock:
            idx = self.residency()
            if drop:
                idx.pop(ckpt_id, None)
            else:
                entry = idx.get(ckpt_id) or {}
                if state is not None:
                    entry["state"] = state
                entry["ts"] = time.time()
                entry.update(extra)
                idx[ckpt_id] = entry
            mf.atomic_write(os.path.join(self.root, RESIDENCY_FILE),
                            json.dumps(idx, sort_keys=True).encode())

    # -- commit: local as today, then enqueue the mirror ---------------

    def commit(self, manifest: mf.Manifest) -> None:
        super().commit(manifest)
        self.enqueue_mirror(manifest.ckpt_id)

    def enqueue_mirror(self, ckpt_id: str) -> None:
        """Register a locally-durable checkpoint for async mirroring.
        Used by ``commit`` and by non-commit writers (the weight plane's
        durable publish writes its manifest without moving ``LATEST`` and
        enqueues here). With mirroring disabled the checkpoint still gets
        a ``local`` residency entry."""
        self._update_residency(ckpt_id, LOCAL)
        if self.mirror_enabled:
            self._ensure_pump()
            self._pump_q.put(ckpt_id)

    # -- mirror pump ---------------------------------------------------

    def _ensure_pump(self) -> None:
        t = self._pump_thread
        if t is not None and t.is_alive():
            return
        self._pump_stop.clear()
        t = threading.Thread(target=self._pump_run, name="ckpt-mirror-pump",
                             daemon=True)
        self._pump_thread = t
        t.start()

    def _pump_run(self) -> None:
        while not self._pump_stop.is_set():
            try:
                cid = self._pump_q.get(timeout=0.2)
            except queue.Empty:
                continue
            if cid is None:
                return
            try:
                self.mirror_now(cid)
            except BaseException as e:
                # partial remote state is never presented as durable:
                # residency stays "mirroring" (+ the error) until an
                # explicit, idempotent re-mirror succeeds
                self._update_residency(cid, MIRRORING, error=repr(e))
                logger.warning("store %s: mirror of %s failed: %r",
                               self.name, cid, e)

    def mirror_now(self, ckpt_id: Optional[str] = None) -> Dict[str, int]:
        """Synchronously replicate one checkpoint (default: latest) to the
        remote tier. Idempotent by content address: chunks the tier holds
        are skipped, so retrying a crashed mirror uploads only the
        remainder. Order is chunks -> manifest -> residency flip, so a
        reader of the remote tier never sees a manifest whose chunks are
        missing, and residency=remote implies full durability."""
        ckpt_id = ckpt_id or self.latest_id()
        if ckpt_id is None:
            raise FileNotFoundError(f"store {self.root!r} has no checkpoint")
        manifest = self.read(ckpt_id)
        self._update_residency(ckpt_id, MIRRORING, error=None)
        t0 = time.monotonic()
        sizes = manifest.chunk_set()
        missing: Dict[str, int] = {}
        pre_dedup_chunks = pre_dedup_bytes = 0
        for h, n in sizes.items():
            if self.backend.has(h):
                pre_dedup_chunks += 1
                pre_dedup_bytes += n
            else:
                missing[h] = n
        counters = self.io.put_many(
            {h: (lambda h=h: mf.read_chunk(self.root, h)) for h in missing},
            sizes=missing)
        counters["dedup_chunks"] += pre_dedup_chunks
        counters["dedup_bytes"] += pre_dedup_bytes
        with open(mf.manifest_path(self.root, ckpt_id), "rb") as f:
            self.backend.put_manifest(ckpt_id, f.read())
        counters["mirror_s"] = time.monotonic() - t0
        self._update_residency(ckpt_id, REMOTE, error=None, **counters)
        self.mirror()  # refresh the KV stats mirror with new residency
        return counters

    def wait_mirrored(self, ckpt_id: Optional[str] = None,
                      timeout: float = 60.0) -> Dict[str, Any]:
        """Block until ``ckpt_id`` (default latest) is fully remote.
        Raises ``RuntimeError`` if its mirror attempt failed (the pump
        left an error on the residency entry) and ``TimeoutError`` if it
        never lands."""
        ckpt_id = ckpt_id or self.latest_id()
        if ckpt_id is None:
            raise FileNotFoundError(f"store {self.root!r} has no checkpoint")
        deadline = time.monotonic() + timeout
        while True:
            entry = self.residency().get(ckpt_id) or {}
            if entry.get("state") == REMOTE:
                return entry
            if entry.get("error"):
                raise RuntimeError(
                    f"mirror of {ckpt_id} failed: {entry['error']}")
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"checkpoint {ckpt_id} not mirrored within {timeout}s "
                    f"(state={entry.get('state')!r})")
            time.sleep(0.02)

    # -- eviction ------------------------------------------------------

    def evict_local(self, ckpt_id: str) -> Dict[str, int]:
        """Drop the local chunk bytes of a fully-mirrored checkpoint.
        Refuses unless residency is ``remote`` AND the remote tier still
        holds every chunk (verified now — never trade the only copy
        away). Chunks shared with a local-resident checkpoint stay."""
        entry = self.residency().get(ckpt_id) or {}
        if entry.get("state") != REMOTE:
            raise ValueError(
                f"refusing to evict {ckpt_id}: residency is "
                f"{entry.get('state', 'unknown')!r}, not {REMOTE!r}")
        manifest = self.read(ckpt_id)
        sizes = manifest.chunk_set()
        missing = [h for h in sizes if not self.backend.has(h)]
        if missing:
            raise RuntimeError(
                f"refusing to evict {ckpt_id}: remote tier lost "
                f"{len(missing)} chunks (e.g. {missing[0][:12]}…)")
        # chunks still referenced by a NON-evicted local checkpoint stay
        keep: set = set()
        residency = self.residency()
        for cid in self.list_ids():
            if cid == ckpt_id:
                continue
            if (residency.get(cid) or {}).get("evicted"):
                continue
            try:
                keep.update(self.read(cid).chunk_set())
            except (FileNotFoundError, json.JSONDecodeError, KeyError):
                continue
        dropped = freed = 0
        for h, n in sizes.items():
            if h in keep:
                continue
            path = mf.chunk_path(self.root, h)
            try:
                os.remove(path)
                dropped += 1
                freed += n
            except FileNotFoundError:
                pass
        self._update_residency(ckpt_id, REMOTE, evicted=True,
                               evicted_chunks=dropped, evicted_bytes=freed)
        self.mirror()
        return {"evicted_chunks": dropped, "evicted_bytes": freed}

    # -- read-through fetch (the restore path) -------------------------

    def fetch_chunks(self, sizes: Dict[str, int], *,
                     prefer: str = "local",
                     cache: bool = True) -> Dict[str, bytes]:
        """Read chunks across tiers: the local pool serves what it has,
        the rest is fetched in parallel from the remote tier (sha256
        verified) and — with ``cache=True`` — written back into the local
        pool so one remote round-trip serves every later reader on this
        host. ``prefer="remote"`` inverts the order (verification tools);
        a corrupt/unavailable remote chunk then falls back to the local
        copy instead of failing the batch."""
        out: Dict[str, bytes] = {}
        want_remote: Dict[str, int] = {}
        for h, n in sizes.items():
            if prefer != "remote" and os.path.exists(
                    mf.chunk_path(self.root, h)):
                out[h] = mf.read_chunk(self.root, h)
            else:
                want_remote[h] = n
        if want_remote:
            try:
                fetched = self.io.fetch(want_remote)
            except ChunkFetchError as e:
                fetched = dict(e.partial)
                # per-chunk fallback to the local tier; only a chunk
                # missing from EVERY tier fails the fetch
                unrecovered = {}
                for h, err in e.errors.items():
                    if os.path.exists(mf.chunk_path(self.root, h)):
                        fetched[h] = mf.read_chunk(self.root, h)
                    else:
                        unrecovered[h] = err
                if unrecovered:
                    raise ChunkFetchError(unrecovered, {**out, **fetched})
            for h, data in fetched.items():
                out[h] = data
                if cache:
                    mf.write_chunk(self.root, data)
        return out

    # -- verification / adoption ---------------------------------------

    def verify(self, ckpt_id: Optional[str] = None,
               deep: bool = False) -> Dict[str, Any]:
        """Check one checkpoint's remote durability. Shallow: manifest +
        every chunk present on the tier. ``deep=True`` additionally
        fetches every chunk and sha256-verifies the bytes."""
        ckpt_id = ckpt_id or self.latest_id()
        if ckpt_id is None:
            raise FileNotFoundError(f"store {self.root!r} has no checkpoint")
        manifest = self.read(ckpt_id)
        sizes = manifest.chunk_set()
        report: Dict[str, Any] = {"ckpt_id": ckpt_id, "chunks": len(sizes),
                                  "bytes": sum(sizes.values()), "deep": deep}
        try:
            self.backend.get_manifest(ckpt_id)
            report["manifest_remote"] = True
        except KeyError:
            report["manifest_remote"] = False
        missing = [h for h in sizes if not self.backend.has(h)]
        report["missing_chunks"] = len(missing)
        corrupt: List[str] = []
        if deep and not missing:
            try:
                self.io.fetch(sizes)
            except ChunkFetchError as e:
                corrupt = sorted(e.errors)
        report["corrupt_chunks"] = len(corrupt)
        report["ok"] = (report["manifest_remote"] and not missing
                        and not corrupt)
        return report

    def adopt_remote(self) -> List[str]:
        """Pull manifests that exist on the remote tier but not locally
        (a fresh/replacement host attaching to a durable store): the
        manifests land in the local index with residency
        ``remote, evicted`` — chunk bytes arrive lazily via read-through
        on first restore."""
        local = set(self.list_ids())
        adopted = []
        for cid in self.backend.list_manifests():
            if cid in local:
                continue
            data = self.backend.get_manifest(cid)
            json.loads(data)  # refuse to adopt a torn manifest
            mf.atomic_write(mf.manifest_path(self.root, cid), data)
            self._update_residency(cid, REMOTE, evicted=True, adopted=True)
            adopted.append(cid)
        if adopted:
            self.mirror()
        return adopted

    # -- stats / shutdown ----------------------------------------------

    def stats(self) -> Dict[str, Any]:
        s = super().stats()
        residency = self.residency()
        summary: Dict[str, int] = {}
        for entry in residency.values():
            key = "evicted" if entry.get("evicted") else \
                entry.get("state", "unknown")
            summary[key] = summary.get(key, 0) + 1
        s["tier"] = {
            "backend": self.backend.descriptor(),
            "mirror_enabled": self.mirror_enabled,
            "pump_alive": (self._pump_thread is not None
                           and self._pump_thread.is_alive()),
            "residency": residency,
            "residency_summary": summary,
            "io": dict(self.io.counters),
        }
        if self.sweep_policy:
            s["sweep"] = dict(self.sweep_policy)
        for row in s["checkpoints"]:
            entry = residency.get(row["ckpt_id"]) or {}
            row["residency"] = ("evicted" if entry.get("evicted")
                                else entry.get("state", LOCAL))
        return s

    def close(self, timeout: float = 5.0) -> None:
        """Stop the mirror pump (in-flight mirror finishes; queued ones
        are abandoned — they re-mirror idempotently on next attach)."""
        self._pump_stop.set()
        self._pump_q.put(None)
        t = self._pump_thread
        if t is not None and t.is_alive():
            t.join(timeout)


def _read_tier_file(root: str):
    try:
        with open(os.path.join(root, TIER_FILE)) as f:
            d = json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return None, None
    desc = d.get("backend")
    backend = backend_from_descriptor(desc) if desc else None
    return backend, d.get("sweep")


def attach(root: str, **kwargs: Any) -> TieredStore:
    """Re-attach to a tiered store from its persisted ``TIER`` descriptor
    (CLI, sweeper, a replacement host)."""
    store = TieredStore(root, **kwargs)
    return store
