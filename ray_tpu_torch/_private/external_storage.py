"""Pluggable external storage for object spilling.

Reference: python/ray/_private/external_storage.py — spilled objects go to
a configured backend (local filesystem, NFS mount, S3, or a user plugin),
identified per object by an opaque URI the store hands back on restore or
delete. Config (RAY_TPU_OBJECT_SPILL_STORAGE):

- ``""`` / ``"filesystem"``  — local directory (object_spill_dir)
- ``"module.path:ClassName"`` — user plugin implementing ExternalStorage,
  constructed with the spill directory as its single argument
- ``"s3://bucket/prefix"``   — S3, which needs boto3: the port of this
  module (of ``ray_tpu/_private/external_storage.py``) does not import it,
  as the card's machine lacks it, and raises at setup naming it
"""

from __future__ import annotations

import os
from typing import Union


class ExternalStorage:
    """Spill backend interface (reference: external_storage.py
    ExternalStorage.spill_objects/restore_spilled_objects)."""

    def spill(self, key: str, data: Union[bytes, memoryview]) -> str:
        """Persist ``data`` under ``key``; returns the object's URI."""
        raise NotImplementedError

    def restore(self, uri: str) -> bytes:
        raise NotImplementedError

    def restore_range(self, uri: str, offset: int, length: int) -> bytes:
        """Ranged read for chunked transfers of spilled objects; backends
        with native range support (fs seek, S3 Range header) override."""
        return self.restore(uri)[offset: offset + length]

    def delete(self, uri: str) -> None:
        raise NotImplementedError


class FileSystemStorage(ExternalStorage):
    """Default backend: one file per object in a local (or NFS) directory."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def spill(self, key: str, data: Union[bytes, memoryview]) -> str:
        path = os.path.join(self.directory, key)
        with open(path, "wb") as f:
            f.write(data)
        return path

    def restore(self, uri: str) -> bytes:
        with open(uri, "rb") as f:
            return f.read()

    def restore_range(self, uri: str, offset: int, length: int) -> bytes:
        with open(uri, "rb") as f:
            f.seek(offset)
            return f.read(length)

    def delete(self, uri: str) -> None:
        try:
            os.unlink(uri)
        except FileNotFoundError:
            pass


def setup_external_storage(spec: str, default_dir: str) -> ExternalStorage:
    """Resolve the configured spill backend (see module docstring)."""
    spec = (spec or "").strip()
    if spec in ("", "filesystem"):
        return FileSystemStorage(default_dir)
    if spec.startswith("s3://"):
        rest = spec[len("s3://"):]
        bucket, _, prefix = rest.partition("/")
        if not bucket:
            raise ValueError(f"bad s3 spill spec {spec!r}")
        raise RuntimeError(
            "object_spill_storage=s3://... needs boto3, which the port does "
            "not use: spill to the local filesystem or to a module:Class "
            "plugin instead")
    if ":" in spec:
        import importlib

        mod_name, _, cls_name = spec.partition(":")
        cls = getattr(importlib.import_module(mod_name), cls_name)
        storage = cls(default_dir)
        if not isinstance(storage, ExternalStorage):
            raise TypeError(
                f"{spec!r} must construct an ExternalStorage, got "
                f"{type(storage).__name__}")
        return storage
    raise ValueError(f"unrecognized object_spill_storage spec {spec!r}")
