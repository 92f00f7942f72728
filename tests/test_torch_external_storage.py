"""A mirror of ``tests/test_external_storage.py`` on the port's runtime
(``ray_tpu_torch``, on the CPU): the same scenarios and assertions.

Pluggable external spill storage (reference tier:
python/ray/tests/test_object_spilling with custom external storage)."""

import pytest

from ray_tpu_torch._private.config import RAY_CONFIG
from ray_tpu_torch._private.external_storage import (
    ExternalStorage,
    FileSystemStorage,
    setup_external_storage,
)
from ray_tpu_torch._private.object_store import ObjectStoreServer


class CountingStorage(ExternalStorage):
    """Plugin backend: delegates to the filesystem but counts every call —
    proves spill/restore/delete route through the plugin, not open()."""

    calls = {"spill": 0, "restore": 0, "delete": 0}

    def __init__(self, directory):
        self._fs = FileSystemStorage(directory)

    def spill(self, key, data):
        CountingStorage.calls["spill"] += 1
        return "plugin://" + self._fs.spill(key, data)

    def restore(self, uri):
        CountingStorage.calls["restore"] += 1
        return self._fs.restore(uri[len("plugin://"):])

    def delete(self, uri):
        CountingStorage.calls["delete"] += 1
        self._fs.delete(uri[len("plugin://"):])


def test_setup_resolves_specs(tmp_path):
    fs = setup_external_storage("", str(tmp_path))
    assert isinstance(fs, FileSystemStorage)
    fs = setup_external_storage("filesystem", str(tmp_path))
    assert isinstance(fs, FileSystemStorage)
    plugin = setup_external_storage(
        "test_torch_external_storage:CountingStorage", str(tmp_path))
    assert isinstance(plugin, CountingStorage)
    with pytest.raises(ValueError):
        setup_external_storage("not-a-valid-spec", str(tmp_path))


@pytest.mark.parametrize("package", ["ray_tpu_torch", "ray_tpu"])
def test_s3_spec_raises_naming_boto3(package, tmp_path, monkeypatch):
    """Without boto3 an S3 spill spec raises at setup, naming boto3, in both
    packages (the port never uses it)."""
    import importlib
    import sys

    monkeypatch.setitem(sys.modules, "boto3", None)  # import boto3 fails
    mod = importlib.import_module(f"{package}._private.external_storage")
    with pytest.raises(RuntimeError, match="boto3"):
        mod.setup_external_storage("s3://bucket/prefix", str(tmp_path))


def test_filesystem_roundtrip_and_range(tmp_path):
    fs = FileSystemStorage(str(tmp_path))
    uri = fs.spill("k1", b"0123456789")
    assert fs.restore(uri) == b"0123456789"
    assert fs.restore_range(uri, 3, 4) == b"3456"
    fs.delete(uri)
    fs.delete(uri)  # idempotent


def test_store_spills_through_plugin(tmp_path, monkeypatch):
    monkeypatch.setattr(RAY_CONFIG, "object_spill_storage",
                        "test_torch_external_storage:CountingStorage")
    CountingStorage.calls = {"spill": 0, "restore": 0, "delete": 0}
    store = ObjectStoreServer("feedface" * 4, capacity=1 << 20,
                              spill_dir=str(tmp_path))
    try:
        # fill past capacity: 3 x 512KB into a 1MB store forces LRU spill
        payloads = {}
        for i in range(3):
            oid = bytes([i]) * 28
            data = bytes([65 + i]) * (512 * 1024)
            reply = store.create(oid, len(data), 0)
            assert reply["status"] == "ok", reply
            from ray_tpu_torch._private.object_store import ShmSegment

            if "shm_name" in reply:
                seg = ShmSegment(reply["shm_name"])
                seg.buf[: len(data)] = data
                seg.close()
            else:
                seg = ShmSegment(reply["arena_name"])
                memoryview(seg.buf)[reply["offset"]: reply["offset"]
                                    + len(data)] = data
                seg.close()
            store.seal(oid, 0)
            payloads[oid] = data
        assert CountingStorage.calls["spill"] >= 1
        # every object remains readable (spilled ones restore via plugin)
        for oid, data in payloads.items():
            got = store.read_chunk(oid, 0, len(data))
            assert got[:16] == data[:16]
        assert (CountingStorage.calls["restore"]
                + CountingStorage.calls["spill"]) >= 3
        store.delete(list(payloads))
        assert CountingStorage.calls["delete"] >= 1
    finally:
        store.shutdown()
