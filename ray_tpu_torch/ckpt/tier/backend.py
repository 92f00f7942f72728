"""ChunkBackend: the pluggable storage contract of the checkpoint tier. The
port of ``ray_tpu/ckpt/tier/backend.py``, without the object-plane backend,
which needs the runtime.

A backend stores exactly two kinds of immutable blobs — content-addressed
*chunks* (named by the SHA-256 of their bytes) and *manifests* (named by
checkpoint id) — plus the store-level pointer files (``LATEST``,
residency index) as small named blobs. Because chunk names commit to
their content, every backend write is idempotent and every cross-backend
copy is verifiable: a reader recomputes the hash and rejects silently
corrupted bytes (``pario.py`` does this on every cross-tier read).

The contract is intentionally tiny — the mirror pump, the parallel IO
engine and the retention sweeper are all written against it:

- ``put(h, data) -> created`` — idempotent content-addressed write.
  ``created=False`` is the dedup hit (the tier already holds the bytes);
- ``get(h, offset, length)`` — ranged read (object-store ``Range:`` GETs;
  the local tier seeks). ``length=None`` reads to the end;
- ``has / delete / list_chunks / chunk_mtime`` — existence, reaping and
  enumeration for the sweeper. ``chunk_mtime`` returning ``None`` means
  "age unknown": the sweeper then refuses to reap (conservative — an
  in-flight mirror must never lose a chunk to a grace-window guess);
- ``put_manifest / get_manifest / list_manifests / delete_manifest`` —
  same shape for the (small, JSON) manifest blobs;
- ``descriptor()`` — a JSON-able ``{"kind": ...}`` payload from which
  :func:`backend_from_descriptor` reconstructs an equivalent backend in
  another process (a sweeper, a restoring host).

``LocalFSBackend`` is the store's on-disk layout verbatim — the tiered
store's *local* tier is byte-compatible with every existing store root.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from ray_tpu_torch.ckpt import manifest as mf


class BackendUnavailable(RuntimeError):
    """The tier cannot serve the request right now (network fault, object
    owner dead, injected failure). Callers treat this as retryable."""


class ChunkBackend:
    """Abstract storage tier. All methods may raise
    :class:`BackendUnavailable`; everything else is a bug."""

    kind = "abstract"

    # -- chunks --------------------------------------------------------

    def put(self, h: str, data: bytes) -> bool:
        raise NotImplementedError

    def get(self, h: str, offset: int = 0,
            length: Optional[int] = None) -> bytes:
        raise NotImplementedError

    def has(self, h: str) -> bool:
        raise NotImplementedError

    def delete(self, h: str) -> None:
        raise NotImplementedError

    def list_chunks(self) -> Dict[str, int]:
        """hash -> nbytes for every chunk the tier holds."""
        raise NotImplementedError

    def chunk_mtime(self, h: str) -> Optional[float]:
        """Upload time of a chunk, or ``None`` when the tier cannot tell
        (the sweeper then never reaps it)."""
        return None

    # -- manifests -----------------------------------------------------

    def put_manifest(self, ckpt_id: str, data: bytes) -> None:
        raise NotImplementedError

    def get_manifest(self, ckpt_id: str) -> bytes:
        raise NotImplementedError

    def list_manifests(self) -> List[str]:
        raise NotImplementedError

    def delete_manifest(self, ckpt_id: str) -> None:
        raise NotImplementedError

    # -- admin ---------------------------------------------------------

    def stats(self) -> Dict[str, object]:
        chunks = self.list_chunks()
        return {"kind": self.kind, "num_chunks": len(chunks),
                "chunk_bytes": sum(chunks.values()),
                "num_manifests": len(self.list_manifests())}

    def descriptor(self) -> Dict[str, object]:
        raise NotImplementedError


class LocalFSBackend(ChunkBackend):
    """Today's on-disk checkpoint layout behind the backend contract —
    ``<root>/chunks/<hh>/<hash>`` + ``<root>/manifests/<id>.json``,
    byte-compatible with every pre-tier store root."""

    kind = "localfs"

    def __init__(self, root: str):
        self.root = os.path.abspath(os.fspath(root))

    # -- chunks --------------------------------------------------------

    def put(self, h: str, data: bytes) -> bool:
        path = mf.chunk_path(self.root, h)
        if os.path.exists(path):
            return False
        mf.atomic_write(path, data)
        return True

    def get(self, h: str, offset: int = 0,
            length: Optional[int] = None) -> bytes:
        try:
            with open(mf.chunk_path(self.root, h), "rb") as f:
                if offset:
                    f.seek(offset)
                return f.read() if length is None else f.read(length)
        except FileNotFoundError:
            raise KeyError(h) from None

    def has(self, h: str) -> bool:
        return os.path.exists(mf.chunk_path(self.root, h))

    def delete(self, h: str) -> None:
        try:
            os.remove(mf.chunk_path(self.root, h))
        except FileNotFoundError:
            pass

    def list_chunks(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        cdir = os.path.join(self.root, mf.CHUNK_DIR)
        if not os.path.isdir(cdir):
            return out
        for sub in os.listdir(cdir):
            subdir = os.path.join(cdir, sub)
            if not os.path.isdir(subdir):
                continue
            for h in os.listdir(subdir):
                if ".tmp." in h:
                    continue
                try:
                    out[h] = os.path.getsize(os.path.join(subdir, h))
                except OSError:
                    continue
        return out

    def chunk_mtime(self, h: str) -> Optional[float]:
        try:
            return os.path.getmtime(mf.chunk_path(self.root, h))
        except OSError:
            return None

    # -- manifests -----------------------------------------------------

    def put_manifest(self, ckpt_id: str, data: bytes) -> None:
        mf.atomic_write(mf.manifest_path(self.root, ckpt_id), data)

    def get_manifest(self, ckpt_id: str) -> bytes:
        try:
            with open(mf.manifest_path(self.root, ckpt_id), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise KeyError(ckpt_id) from None

    def list_manifests(self) -> List[str]:
        mdir = os.path.join(self.root, mf.MANIFEST_DIR)
        try:
            names = os.listdir(mdir)
        except FileNotFoundError:
            return []
        return sorted(n[:-5] for n in names
                      if n.endswith(".json") and ".tmp." not in n)

    def delete_manifest(self, ckpt_id: str) -> None:
        try:
            os.remove(mf.manifest_path(self.root, ckpt_id))
        except FileNotFoundError:
            pass

    def descriptor(self) -> Dict[str, object]:
        return {"kind": self.kind, "root": self.root}


def backend_from_descriptor(d: Dict[str, object]) -> ChunkBackend:
    """Reconstruct a backend from its :meth:`ChunkBackend.descriptor`
    payload — how a sweeper or another host re-attaches to a store's
    remote tier from a different process. An object-plane descriptor (the
    JAX package's vault of cluster objects) raises: its backend needs the
    runtime, which the port does not have yet."""
    kind = d.get("kind")
    if kind == "localfs":
        return LocalFSBackend(str(d["root"]))
    if kind == "bucket":
        from ray_tpu_torch.ckpt.tier.bucket import (
            BucketBackend, bucket_client_from_descriptor)

        client = bucket_client_from_descriptor(dict(d["client"]))  # type: ignore[arg-type]
        return BucketBackend(client, prefix=str(d.get("prefix") or ""))
    if kind == "object_plane":
        raise ValueError(
            "chunk backend 'object_plane' keeps chunks as objects of a "
            "running cluster; the port has no runtime yet, so it cannot "
            "attach to one")
    raise ValueError(f"unknown chunk backend descriptor kind {kind!r}")
