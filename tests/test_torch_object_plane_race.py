"""A mirror of ``tests/test_object_plane_race.py`` on the port's runtime
(``ray_tpu_torch``, on the CPU): the same scenarios and assertions.

Seal-once / execution-epoch fencing of the object plane.

Reproduces the duplicate-execution race (a zombie task attempt whose reply
was lost keeps running and writes its result while the owner's retry writes
the same object id) and verifies the fix: attempt-fenced stores, a
max-attempt location directory, and self-healing deletion of displaced
copies. Reference semantics: plasma's seal-once object lifecycle
(src/ray/object_manager/plasma/obj_lifecycle_mgr.cc).
"""

import asyncio
import os
import time

import numpy as np
import pytest

from ray_tpu_torch._private import wire
import ray_tpu_torch
from ray_tpu_torch._private.object_store import ObjectStoreServer


# ---------------------------------------------------------------------------
# unit tier: store-level attempt fencing
# ---------------------------------------------------------------------------


@pytest.fixture
def store(tmp_path):
    s = ObjectStoreServer("deadbeef" * 4, capacity=1 << 20,
                          spill_dir=str(tmp_path))
    yield s
    s.shutdown()


def _write(store, oid, payload, attempt):
    reply = store.create(oid, len(payload), attempt)
    if reply["status"] != "ok":
        return reply
    if "shm_name" in reply:
        from ray_tpu_torch._private.object_store import ShmSegment

        seg = ShmSegment(reply["shm_name"])
        try:
            seg.buf[: len(payload)] = payload
        finally:
            seg.close()
    else:
        from ray_tpu_torch._private.object_store import ShmSegment

        seg = ShmSegment(reply["arena_name"])
        try:
            off = reply["offset"]
            seg.buf[off : off + len(payload)] = payload
        finally:
            seg.close()
    store.seal(oid, attempt)
    return reply


def _read(store, oid):
    from ray_tpu_torch._private.object_store import ShmSegment

    acc = store.access(oid)
    if acc["status"] == "inline":
        return acc["blob"]
    if acc["status"] == "shm_arena":
        seg = ShmSegment(acc["arena_name"])
        try:
            return bytes(seg.buf[acc["offset"] : acc["offset"] + acc["size"]])
        finally:
            seg.close()
    seg = ShmSegment(acc["shm_name"])
    try:
        return bytes(seg.buf[: acc["size"]])
    finally:
        seg.close()


def test_newer_attempt_displaces_stale_copy(store):
    oid = os.urandom(16)
    _write(store, oid, b"A" * 256, attempt=0)
    _write(store, oid, b"B" * 300, attempt=1)
    assert store.object_attempt(oid) == 1
    assert _read(store, oid) == b"B" * 300


def test_stale_writer_is_fenced(store):
    oid = os.urandom(16)
    _write(store, oid, b"B" * 300, attempt=1)
    reply = store.create(oid, 256, 0)  # zombie arrives late
    assert reply["status"] == "stale_attempt"
    assert _read(store, oid) == b"B" * 300


def test_stale_seal_ignored(store):
    """A zombie that created before the retry displaced it must not be able
    to seal (and wake readers onto) the replacement entry."""
    oid = os.urandom(16)
    created = store.create(oid, 256, 0)
    assert created["status"] == "ok"  # zombie mid-write
    _write(store, oid, b"B" * 300, attempt=1)
    assert store.seal(oid, 0) is False  # zombie's seal: fenced
    assert store.object_attempt(oid) == 1
    assert _read(store, oid) == b"B" * 300


def test_same_attempt_create_is_idempotent(store):
    oid = os.urandom(16)
    _write(store, oid, b"A" * 256, attempt=2)
    reply = store.create(oid, 256, 2)
    assert reply["status"] == "exists"


def test_put_inline_attempt_rules(store):
    oid = os.urandom(16)
    store.put_inline(oid, b"old", attempt=0)
    store.put_inline(oid, b"new", attempt=1)
    assert store.access(oid)["blob"] == b"new"
    store.put_inline(oid, b"zombie", attempt=0)  # late zombie: ignored
    assert store.access(oid)["blob"] == b"new"


def test_stale_write_chunk_fenced(store):
    oid = os.urandom(16)
    store.create(oid, 64, 0)
    _write(store, oid, b"B" * 300, attempt=1)
    with pytest.raises(KeyError):
        store.write_chunk(oid, 0, b"Z" * 8, attempt=0)


# ---------------------------------------------------------------------------
# integration tier: zombie task execution (reply-dropped PushTask)
# ---------------------------------------------------------------------------


@pytest.fixture
def zombie_cluster():
    ray_tpu_torch.shutdown()
    # every worker's FIRST PushTask executes fully but the reply connection
    # drops — the owner retries, producing a duplicate execution racing the
    # zombie's store writes
    os.environ["RAY_TPU_TESTING_RPC_REPLY_FAILURE"] = "PushTask=1:0"
    try:
        ray_tpu_torch.init(num_cpus=2, device="cpu")
        yield ray_tpu_torch
    finally:
        ray_tpu_torch.shutdown()
        os.environ.pop("RAY_TPU_TESTING_RPC_REPLY_FAILURE", None)


def test_zombie_retry_consistency(zombie_cluster):
    """The detector scenario from data/dataset.py: a block's stored bytes
    must match the metadata from the accepted attempt, even when a zombie
    attempt wrote the same object id with different (nondeterministic)
    content."""

    @ray_tpu_torch.remote(num_returns=2, max_retries=2)
    def produce():
        # nondeterministic sizes: each attempt produces a different row
        # count, so metadata/data divergence between attempts is detectable
        rows = 150_000 + int.from_bytes(os.urandom(2), "big")
        data = np.arange(rows, dtype=np.float64)  # > inline threshold
        return {"rows": rows}, data

    meta_ref, data_ref = produce.remote()
    meta = ray_tpu_torch.get(meta_ref, timeout=120)
    data = ray_tpu_torch.get(data_ref, timeout=120)
    assert meta["rows"] == len(data), (
        "object-plane consistency bug: accepted attempt's metadata does not "
        "match the stored block")


def test_zombie_retry_consistency_stress(zombie_cluster):
    """Many concurrent duplicate executions; every task's metadata must
    match its stored data."""

    @ray_tpu_torch.remote(num_returns=2, max_retries=2)
    def produce(i):
        rows = 100_000 + int.from_bytes(os.urandom(2), "big")
        return {"rows": rows, "i": i}, np.full(rows, i, dtype=np.float64)

    pairs = [produce.remote(i) for i in range(8)]
    for i, (meta_ref, data_ref) in enumerate(pairs):
        meta = ray_tpu_torch.get(meta_ref, timeout=180)
        data = ray_tpu_torch.get(data_ref, timeout=180)
        assert meta["rows"] == len(data)
        assert meta["i"] == i
        assert data[0] == i


# ---------------------------------------------------------------------------
# multi-node tier: directory max-attempt rule + self-healing deletes
# ---------------------------------------------------------------------------


def _rpc(address, method, req, timeout=30.0):
    from ray_tpu_torch._private.rpc import RetryingRpcClient

    async def go():
        client = RetryingRpcClient(address)
        try:
            return wire.loads(await client.call(
                method, wire.dumps(req), timeout=timeout))
        finally:
            await client.close()

    return asyncio.run(go())


def test_directory_prefers_newest_attempt_and_self_heals():
    from ray_tpu_torch.cluster_utils import Cluster

    ray_tpu_torch.shutdown()
    cluster = Cluster(head_node_args={"resources": {"CPU": 1.0}})
    cluster.add_node(resources={"CPU": 1.0})
    ray_tpu_torch.init(address=cluster.address)
    try:
        cluster.wait_for_nodes(2)
        nodes = [n for n in ray_tpu_torch.nodes() if n["alive"]]
        assert len(nodes) == 2
        addr_a, addr_b = nodes[0]["address"], nodes[1]["address"]
        oid = os.urandom(16)
        # zombie copy (attempt 0) on node A; committed copy (attempt 1) on B
        _rpc(addr_a, "StorePutInline", {"oid": oid, "blob": b"stale-A",
                                        "attempt": 0})
        _rpc(addr_b, "StorePutInline", {"oid": oid, "blob": b"fresh-B",
                                        "attempt": 1})
        # directory self-heal: node A's displaced copy gets deleted
        deadline = time.time() + 30
        while time.time() < deadline:
            if not _rpc(addr_a, "StoreContains", {"oid": oid})["contains"]:
                break
            time.sleep(0.2)
        assert not _rpc(addr_a, "StoreContains", {"oid": oid})["contains"], (
            "stale attempt-0 copy still present on node A")
        # a pull on node A must fetch the committed attempt-1 bytes
        got = _rpc(addr_a, "StoreGet", {"oid": oid, "timeout": 30.0,
                                        "pull": True}, timeout=45.0)
        if got["status"] == "inline":
            payload = got["blob"]
        elif got["status"] == "shm_arena":
            from ray_tpu_torch._private.object_store import ShmSegment

            seg = ShmSegment(got["arena_name"])
            try:
                payload = bytes(
                    seg.buf[got["offset"] : got["offset"] + got["size"]])
            finally:
                seg.close()
        else:
            from ray_tpu_torch._private.object_store import ShmSegment

            seg = ShmSegment(got["shm_name"])
            try:
                payload = bytes(seg.buf[: got["size"]])
            finally:
                seg.close()
        assert payload == b"fresh-B"
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()
