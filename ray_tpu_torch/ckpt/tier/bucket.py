"""Bucket-style chunk tier: a prefix/key object namespace with ranged
reads and multipart-style uploads. The port of
``ray_tpu/ckpt/tier/bucket.py``.

``DirBucketClient`` is the in-tree client — a bucket API (put/get/head/
list/delete + multipart) over a plain directory, one file per key. It is
the shape of a real object store (S3/GCS) boiled down to what the tier
needs: immutable whole-object puts, ``Range:`` reads, and uploads that
become visible only at ``complete_multipart`` (an aborted multipart is
invisible — the parts live under a hidden staging prefix until the final
atomic rename).

``FaultShim`` wraps any client with injectable per-op latency, failure
after N operations (raises :class:`BackendUnavailable`), and byte
corruption on reads — the test harness for every crash/fault path in the
tier (mirror-pump death mid-upload, sha-verify rejection, parallel-vs-
serial restore pricing under realistic per-object latency).

``BucketBackend`` maps the chunk/manifest contract onto bucket keys::

    <prefix>chunks/<hh>/<hash>      (multipart above ckpt_multipart_bytes)
    <prefix>manifests/<ckpt_id>.json

Chunk writes are idempotent by content address: ``put`` HEADs first, so
re-mirroring after a crash uploads only what is actually missing.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from typing import Dict, List, Optional

from ray_tpu_torch.ckpt.tier.backend import BackendUnavailable, ChunkBackend

_STAGING = ".multipart/"  # staging prefix; never listed, never a chunk


class DirBucketClient:
    """Bucket semantics over a directory: one file per key, writes visible
    only after an atomic rename (a reader never sees a torn object)."""

    kind = "dir"

    def __init__(self, root: str):
        self.root = os.path.abspath(os.fspath(root))
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key: str) -> str:
        if ".." in key.split("/"):
            raise ValueError(f"bucket key escapes the root: {key!r}")
        return os.path.join(self.root, *key.split("/"))

    # -- objects -------------------------------------------------------

    def put_object(self, key: str, data: bytes) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def get_object(self, key: str, start: int = 0,
                   length: Optional[int] = None) -> bytes:
        try:
            with open(self._path(key), "rb") as f:
                if start:
                    f.seek(start)
                return f.read() if length is None else f.read(length)
        except FileNotFoundError:
            raise KeyError(key) from None

    def head_object(self, key: str) -> Optional[Dict[str, float]]:
        try:
            st = os.stat(self._path(key))
        except OSError:
            return None
        return {"size": st.st_size, "mtime": st.st_mtime}

    def list_objects(self, prefix: str = "") -> Dict[str, int]:
        out: Dict[str, int] = {}
        for dirpath, _dirs, files in os.walk(self.root):
            for name in files:
                if ".tmp." in name:
                    continue
                full = os.path.join(dirpath, name)
                key = os.path.relpath(full, self.root).replace(os.sep, "/")
                if key.startswith(_STAGING) or not key.startswith(prefix):
                    continue
                try:
                    out[key] = os.path.getsize(full)
                except OSError:
                    continue
        return out

    def delete_object(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    # -- multipart -----------------------------------------------------

    def create_multipart(self, key: str) -> str:
        upload_id = uuid.uuid4().hex
        os.makedirs(self._path(f"{_STAGING}{upload_id}"), exist_ok=True)
        # the target key rides in the staging dir so complete() needs
        # only the upload id (mirrors real multipart-upload handles)
        self.put_object(f"{_STAGING}{upload_id}/.key", key.encode())
        return upload_id

    def upload_part(self, upload_id: str, part_no: int, data: bytes) -> None:
        self.put_object(f"{_STAGING}{upload_id}/{part_no:06d}", data)

    def complete_multipart(self, upload_id: str) -> None:
        """Concatenate the parts in order into the target key with one
        atomic rename — an incomplete multipart is never visible."""
        stage = self._path(f"{_STAGING}{upload_id}")
        key = self.get_object(f"{_STAGING}{upload_id}/.key").decode()
        parts = sorted(n for n in os.listdir(stage)
                       if n != ".key" and ".tmp." not in n)
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
        with open(tmp, "wb") as out:
            for name in parts:
                with open(os.path.join(stage, name), "rb") as f:
                    out.write(f.read())
            out.flush()
            os.fsync(out.fileno())
        os.replace(tmp, path)
        self.abort_multipart(upload_id)

    def abort_multipart(self, upload_id: str) -> None:
        import shutil

        shutil.rmtree(self._path(f"{_STAGING}{upload_id}"),
                      ignore_errors=True)

    def descriptor(self) -> Dict[str, object]:
        return {"kind": self.kind, "root": self.root}


def bucket_client_from_descriptor(d: Dict[str, object]) -> "DirBucketClient":
    if d.get("kind") == "dir":
        return DirBucketClient(str(d["root"]))
    raise ValueError(f"unknown bucket client descriptor kind {d.get('kind')!r}")


class FaultShim:
    """Injectable fault/latency wrapper around a bucket client.

    - ``latency_s`` sleeps before every op (or per-op via ``{"get": s}``);
    - ``fail_after`` raises :class:`BackendUnavailable` once the op
      counter passes it (``fail_ops`` restricts which ops count/fail) —
      "the mirror pump died mid-upload" in one line;
    - ``corrupt_get`` flips the first byte of read data (optionally only
      for keys matching the predicate) — exercises sha256 rejection.

    Thread-safe: the parallel IO engine hammers it from worker threads.
    """

    def __init__(self, client: DirBucketClient, *,
                 latency_s: object = 0.0,
                 fail_after: Optional[int] = None,
                 fail_ops: Optional[tuple] = None,
                 corrupt_get: object = False):
        self.client = client
        self.latency_s = latency_s
        self.fail_after = fail_after
        self.fail_ops = tuple(fail_ops or ())
        self.corrupt_get = corrupt_get
        self.op_counts: Dict[str, int] = {}
        self._lock = threading.Lock()
        self.kind = client.kind

    def _enter(self, op: str, key: str = "") -> None:
        with self._lock:
            self.op_counts[op] = self.op_counts.get(op, 0) + 1
            counted = sum(v for k, v in self.op_counts.items()
                          if not self.fail_ops or k in self.fail_ops)
        lat = self.latency_s
        if isinstance(lat, dict):
            lat = lat.get(op, 0.0)
        if lat:
            time.sleep(lat)
        if (self.fail_after is not None
                and (not self.fail_ops or op in self.fail_ops)
                and counted > self.fail_after):
            raise BackendUnavailable(
                f"injected fault: op {op!r} on {key!r} after "
                f"{self.fail_after} ops")

    def clear_fault(self) -> None:
        self.fail_after = None

    def ops(self, op: Optional[str] = None) -> int:
        with self._lock:
            if op is not None:
                return self.op_counts.get(op, 0)
            return sum(self.op_counts.values())

    # -- delegated ops -------------------------------------------------

    def put_object(self, key, data):
        self._enter("put", key)
        return self.client.put_object(key, data)

    def get_object(self, key, start: int = 0, length: Optional[int] = None):
        self._enter("get", key)
        data = self.client.get_object(key, start, length)
        corrupt = self.corrupt_get
        if callable(corrupt):
            corrupt = corrupt(key)
        if corrupt and data:
            data = bytes([data[0] ^ 0xFF]) + data[1:]
        return data

    def head_object(self, key):
        self._enter("head", key)
        return self.client.head_object(key)

    def list_objects(self, prefix: str = ""):
        self._enter("list", prefix)
        return self.client.list_objects(prefix)

    def delete_object(self, key):
        self._enter("delete", key)
        return self.client.delete_object(key)

    def create_multipart(self, key):
        self._enter("create_multipart", key)
        return self.client.create_multipart(key)

    def upload_part(self, upload_id, part_no, data):
        self._enter("upload_part", upload_id)
        return self.client.upload_part(upload_id, part_no, data)

    def complete_multipart(self, upload_id):
        self._enter("complete_multipart", upload_id)
        return self.client.complete_multipart(upload_id)

    def abort_multipart(self, upload_id):
        return self.client.abort_multipart(upload_id)

    def descriptor(self):
        # the shim is a test harness, not durable state: a re-attached
        # backend (sweeper, CLI) talks to the unwrapped client
        return self.client.descriptor()


class BucketBackend(ChunkBackend):
    """Chunk/manifest contract over a bucket client + key prefix."""

    kind = "bucket"

    def __init__(self, client, prefix: str = "",
                 multipart_bytes: Optional[int] = None):
        if prefix and not prefix.endswith("/"):
            prefix += "/"
        self.client = client
        self.prefix = prefix
        if multipart_bytes is None:
            from ray_tpu_torch._private.config import RAY_CONFIG

            multipart_bytes = RAY_CONFIG.ckpt_multipart_bytes
        self.multipart_bytes = int(multipart_bytes)

    def _chunk_key(self, h: str) -> str:
        return f"{self.prefix}chunks/{h[:2]}/{h}"

    def _manifest_key(self, ckpt_id: str) -> str:
        return f"{self.prefix}manifests/{ckpt_id}.json"

    # -- chunks --------------------------------------------------------

    def put(self, h: str, data: bytes) -> bool:
        key = self._chunk_key(h)
        if self.client.head_object(key) is not None:
            return False  # content-addressed dedup: uploaded once, ever
        if len(data) > self.multipart_bytes:
            upload_id = self.client.create_multipart(key)
            try:
                for i in range(0, len(data), self.multipart_bytes):
                    self.client.upload_part(
                        upload_id, i // self.multipart_bytes,
                        data[i:i + self.multipart_bytes])
                self.client.complete_multipart(upload_id)
            except BaseException:
                self.client.abort_multipart(upload_id)
                raise
        else:
            self.client.put_object(key, data)
        return True

    def get(self, h: str, offset: int = 0,
            length: Optional[int] = None) -> bytes:
        return self.client.get_object(self._chunk_key(h), offset, length)

    def has(self, h: str) -> bool:
        return self.client.head_object(self._chunk_key(h)) is not None

    def delete(self, h: str) -> None:
        self.client.delete_object(self._chunk_key(h))

    def list_chunks(self) -> Dict[str, int]:
        objs = self.client.list_objects(f"{self.prefix}chunks/")
        return {key.rsplit("/", 1)[-1]: size for key, size in objs.items()}

    def chunk_mtime(self, h: str) -> Optional[float]:
        head = self.client.head_object(self._chunk_key(h))
        return None if head is None else head.get("mtime")

    # -- manifests -----------------------------------------------------

    def put_manifest(self, ckpt_id: str, data: bytes) -> None:
        self.client.put_object(self._manifest_key(ckpt_id), data)

    def get_manifest(self, ckpt_id: str) -> bytes:
        return self.client.get_object(self._manifest_key(ckpt_id))

    def list_manifests(self) -> List[str]:
        objs = self.client.list_objects(f"{self.prefix}manifests/")
        return sorted(key.rsplit("/", 1)[-1][:-5] for key in objs
                      if key.endswith(".json"))

    def delete_manifest(self, ckpt_id: str) -> None:
        self.client.delete_object(self._manifest_key(ckpt_id))

    def descriptor(self) -> Dict[str, object]:
        return {"kind": self.kind, "client": self.client.descriptor(),
                "prefix": self.prefix}
