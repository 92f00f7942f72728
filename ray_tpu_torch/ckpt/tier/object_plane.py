"""Object-plane chunk tier, the port of ``ray_tpu/ckpt/tier/object_plane.py``:
chunks live as owned objects in the port cluster's object store, held by a
named detached vault actor and registered in GCS KV (``ns="ckpt_obj"``).

This is the "spill into the cluster itself" tier (reference analog: object
spilling / the plasma store as a storage substrate): a checkpoint mirrored
here survives the *saving host* dying — the vault actor owns the object
refs, so the bytes live wherever the store put them and are fetched over
the object transfer plane on restore. It is weaker than a bucket tier (a
full cluster loss loses the vault) and exists for the middle of the
durability spectrum: fast intra-cluster re-shard/restore traffic without
touching external storage.

Registration: every chunk put lands a ``{namespace}/{hash} -> {nbytes,
ts}`` row in GCS KV ns="ckpt_obj" (best-effort), so the sweeper and the
state API can enumerate object-plane residency without waking the vault.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from ray_tpu_torch.ckpt.tier.backend import BackendUnavailable, ChunkBackend

_VAULT_PREFIX = "rtpu_chunk_vault:"
_KV_NS = "ckpt_obj"


class ChunkVaultActor:
    """Detached owner of the object-plane chunk pool for one namespace.
    Re-puts every blob so the refs are actor-owned: chunks outlive the
    uploading worker by design."""

    def __init__(self, namespace: str):
        self.namespace = namespace
        self._chunks: Dict[str, object] = {}   # hash -> ObjectRef
        self._meta: Dict[str, Dict[str, float]] = {}  # hash -> nbytes/ts
        self._manifests: Dict[str, bytes] = {}

    def _register(self, h: str, nbytes: int, ts: float) -> None:
        try:
            from ray_tpu_torch._private import wire
            from ray_tpu_torch.experimental.internal_kv import _internal_kv_put

            _internal_kv_put(f"{self.namespace}/{h}".encode(),
                             wire.dumps({"nbytes": nbytes, "ts": ts}),
                             namespace=_KV_NS)
        except Exception:
            pass  # registration is an index, not the source of truth

    def put_chunk(self, h: str, data: bytes) -> bool:
        if h in self._chunks:
            return False
        import ray_tpu_torch

        self._chunks[h] = ray_tpu_torch.put(data)
        self._meta[h] = {"nbytes": len(data), "ts": time.time()}
        self._register(h, len(data), self._meta[h]["ts"])
        return True

    def get_chunk(self, h: str, offset: int = 0,
                  length: Optional[int] = None) -> Optional[bytes]:
        # returns None (not raise) for a missing chunk: remote exceptions
        # arrive wrapped, and the backend wants a clean KeyError
        ref = self._chunks.get(h)
        if ref is None:
            return None
        import ray_tpu_torch

        data = ray_tpu_torch.get(ref)
        if offset or length is not None:
            end = None if length is None else offset + length
            data = data[offset:end]
        return data

    def has_chunk(self, h: str) -> bool:
        return h in self._chunks

    def delete_chunk(self, h: str) -> None:
        self._chunks.pop(h, None)
        self._meta.pop(h, None)
        try:
            from ray_tpu_torch.experimental.internal_kv import _internal_kv_del

            _internal_kv_del(f"{self.namespace}/{h}".encode(),
                             namespace=_KV_NS)
        except Exception:
            pass

    def list_chunks(self) -> Dict[str, int]:
        return {h: int(m["nbytes"]) for h, m in self._meta.items()}

    def chunk_mtime(self, h: str) -> Optional[float]:
        m = self._meta.get(h)
        return None if m is None else float(m["ts"])

    def put_manifest(self, ckpt_id: str, data: bytes) -> None:
        self._manifests[ckpt_id] = bytes(data)

    def get_manifest(self, ckpt_id: str) -> Optional[bytes]:
        return self._manifests.get(ckpt_id)

    def list_manifests(self) -> List[str]:
        return sorted(self._manifests)

    def delete_manifest(self, ckpt_id: str) -> None:
        self._manifests.pop(ckpt_id, None)


class ObjectPlaneBackend(ChunkBackend):
    """Chunk/manifest contract over a :class:`ChunkVaultActor`."""

    kind = "object_plane"

    def __init__(self, namespace: str, create: bool = True,
                 timeout: float = 60.0):
        self.namespace = namespace
        self.timeout = timeout
        try:
            import ray_tpu_torch

            name = _VAULT_PREFIX + namespace
            if create:
                actor_cls = ray_tpu_torch.remote(ChunkVaultActor)
                self._actor = actor_cls.options(
                    name=name, lifetime="detached", get_if_exists=True,
                    max_concurrency=32, num_cpus=0.05).remote(namespace)
            else:
                self._actor = ray_tpu_torch.get_actor(name)
        except Exception as e:
            raise BackendUnavailable(
                f"object-plane vault {namespace!r} unreachable: {e!r}") from e

    def _call(self, method: str, *args):
        import ray_tpu_torch

        try:
            return ray_tpu_torch.get(
                getattr(self._actor, method).remote(*args),
                timeout=self.timeout)
        except Exception as e:
            raise BackendUnavailable(
                f"object-plane vault {self.namespace!r} call "
                f"{method} failed: {e!r}") from e

    def put(self, h: str, data: bytes) -> bool:
        return bool(self._call("put_chunk", h, data))

    def get(self, h: str, offset: int = 0,
            length: Optional[int] = None) -> bytes:
        data = self._call("get_chunk", h, offset, length)
        if data is None:
            raise KeyError(h)
        return data

    def has(self, h: str) -> bool:
        return bool(self._call("has_chunk", h))

    def delete(self, h: str) -> None:
        self._call("delete_chunk", h)

    def list_chunks(self) -> Dict[str, int]:
        return self._call("list_chunks")

    def chunk_mtime(self, h: str) -> Optional[float]:
        return self._call("chunk_mtime", h)

    def put_manifest(self, ckpt_id: str, data: bytes) -> None:
        self._call("put_manifest", ckpt_id, data)

    def get_manifest(self, ckpt_id: str) -> bytes:
        data = self._call("get_manifest", ckpt_id)
        if data is None:
            raise KeyError(ckpt_id)
        return data

    def list_manifests(self) -> List[str]:
        return self._call("list_manifests")

    def delete_manifest(self, ckpt_id: str) -> None:
        self._call("delete_manifest", ckpt_id)

    def descriptor(self) -> Dict[str, object]:
        return {"kind": self.kind, "namespace": self.namespace}
