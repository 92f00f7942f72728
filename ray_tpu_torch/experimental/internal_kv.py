"""Internal KV API over the GCS KV table, the port of
``ray_tpu/experimental/internal_kv.py`` (reference:
python/ray/experimental/internal_kv.py; server side gcs_kv_manager.cc).
Durable across GCS restarts when the cluster runs with GCS fault
tolerance (see store_client.py)."""

from __future__ import annotations

from typing import List, Optional


def _core():
    from ray_tpu_torch._private.worker import global_worker

    return global_worker()


def _call(method: str, req: dict) -> dict:
    core = _core()
    return core._run(core._gcs_call(method, req))


def _internal_kv_initialized() -> bool:
    from ray_tpu_torch._private.worker import is_initialized

    return is_initialized()


def _internal_kv_put(key: bytes, value: bytes, overwrite: bool = True,
                     namespace: str = "") -> bool:
    """Returns True if the key was already present and NOT overwritten."""
    reply = _call("KVPut", {"ns": namespace, "key": _s(key), "value": value,
                            "overwrite": overwrite})
    return not reply["added"]


def _internal_kv_get(key: bytes, namespace: str = "") -> Optional[bytes]:
    return _call("KVGet", {"ns": namespace, "key": _s(key)})["value"]


def _internal_kv_exists(key: bytes, namespace: str = "") -> bool:
    return _internal_kv_get(key, namespace) is not None


def _internal_kv_del(key: bytes, del_by_prefix: bool = False,
                     namespace: str = "") -> int:
    return _call("KVDel", {"ns": namespace, "key": _s(key),
                           "prefix": del_by_prefix})["deleted"]


def _internal_kv_list(prefix: bytes, namespace: str = "") -> List[bytes]:
    keys = _call("KVKeys", {"ns": namespace, "prefix": _s(prefix)})["keys"]
    return [k.encode() if isinstance(k, str) else k for k in keys]


def _s(key) -> str:
    return key.decode() if isinstance(key, (bytes, bytearray)) else key
