"""The port's storage-tier plane (``ray_tpu_torch/ckpt/tier``) against the
JAX package's (``ray_tpu/ckpt/tier``): the tests of
``tests/test_ckpt_tier.py`` that need no cluster, each run through both
packages on the same inputs, with what each package did compared.

Covers the tier's acceptance properties:
(a) backend contract — LocalFS and bucket behave identically behind
    ``ChunkBackend``, including multipart uploads whose aborted halves are
    never visible (the object-plane backend needs the runtime: its
    descriptor raises);
(b) parallel IO — bounded fetch with sha256 verification (corrupt remote
    bytes are *rejected*, with per-chunk fallback to the local tier),
    range coalescing, in-flight byte-cap progress;
(c) crash/fault lifecycle — a mirror pump killed mid-upload never
    reports residency ``remote``; re-mirroring is idempotent by content
    address and uploads only the remainder;
(d) retention sweeper — never reaps a chunk reachable from a pinned or
    in-flight (part-file) manifest, on either tier, regardless of age;
(e) elastic restore-through-the-tier — a 4-host sharded save mirrors,
    evicts locally, and restores byte-exact onto a 2-host mesh pulling
    ONLY the intersecting chunks from the remote tier (per-host byte
    and per-op accounting);
and a store one package's tier wrote (mirrored, then evicted locally)
restores through the other's read-through fetch.

Each scenario takes a package (``PORT`` or ``JAX``) and a directory and
returns what it observed: backend op counts, IO counters, mirror, evict and
sweep reports, residency, the chunks left on each tier. ``_same`` runs it
through both and asserts the two records are equal once checkpoint ids,
directories and wall-clock fields are normalised. The properties each
scenario asserts along the way hold for both packages.
"""

import hashlib
import importlib
import json
import os
import re
import shutil
import time
from types import SimpleNamespace

import numpy as np
import pytest


def _package(root: str) -> SimpleNamespace:
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    return SimpleNamespace(
        name=root, ckpt=mod("ckpt"), mf=mod("ckpt.manifest"),
        backend=mod("ckpt.tier.backend"), pario=mod("ckpt.tier.pario"),
        sweeper=mod("ckpt.tier.sweeper"), spec=mod("weights.spec"))


# ray_tpu.ckpt and its tier import no JAX: the reference runs here cheaply
PORT, JAX = _package("ray_tpu_torch"), _package("ray_tpu")

_CKPT_ID = re.compile(r"(step\d{10})-[0-9a-f]{8}")


def _norm(obj, roots):
    """``obj`` with each run's directory replaced by ``<root>``, checkpoint
    ids cut to their step (the suffix is random) and wall-clock fields
    (``ts`` and ``*_s`` durations other than the policy's ``grace_s``)
    dropped."""
    if isinstance(obj, dict):
        return {_norm(k, roots): _norm(v, roots) for k, v in obj.items()
                if not (k == "ts" or (isinstance(k, str) and k.endswith("_s")
                                      and k != "grace_s"))}
    if isinstance(obj, (list, tuple)):
        return [_norm(v, roots) for v in obj]
    if isinstance(obj, (set, frozenset)):
        return sorted(_norm(v, roots) for v in obj)
    if isinstance(obj, str):
        for root in roots:
            obj = obj.replace(root, "<root>")
        return _CKPT_ID.sub(r"\1", obj)
    return obj


def _same(scenario, tmp_path):
    """Run ``scenario(package, root)`` for the port and for the JAX package,
    each in a directory of its own, and assert the records agree."""
    records = {}
    for pkg in (PORT, JAX):
        root = tmp_path / pkg.name
        root.mkdir()
        records[pkg.name] = _norm(scenario(pkg, root), [str(root)])
    assert records[PORT.name] == records[JAX.name]
    return records[PORT.name]


def _tree(scale: float = 1.0, leaves: int = 6, n: int = 256):
    # distinct content per leaf: content addressing must not collapse
    # the tree into one chunk
    return {f"layer{i}": np.arange(n, dtype=np.float32) * scale + i
            for i in range(leaves)}


def _bucket_store(p, root, name, **kw):
    shim = p.ckpt.FaultShim(p.ckpt.DirBucketClient(str(root / "bucket")))
    store = p.ckpt.TieredStore(str(root / name), name=name,
                               backend=p.ckpt.BucketBackend(shim), **kw)
    return store, shim


def _local_chunks(p, store, hashes):
    """Which of ``hashes`` the store's local pool holds."""
    return sorted(h for h in hashes
                  if os.path.exists(p.mf.chunk_path(store.root, h)))


# ---------------------------------------------------------------------------
# (a) backend contract
# ---------------------------------------------------------------------------


def _backend_contract(p, root):
    data = b"tier chunk payload bytes"
    h = hashlib.sha256(data).hexdigest()
    record = []
    for backend in (
            p.ckpt.LocalFSBackend(str(root / "localfs")),
            p.ckpt.BucketBackend(p.ckpt.DirBucketClient(str(root / "bucket")),
                                 prefix="tierA")):
        rec = {"put": backend.put(h, data),
               "put_again": backend.put(h, data)}  # content-addressed dedup
        assert rec["put"] is True and rec["put_again"] is False
        assert backend.has(h)
        assert backend.get(h) == data
        rec["ranged"] = backend.get(h, offset=5, length=7)
        assert rec["ranged"] == data[5:12]
        rec["chunks"] = backend.list_chunks()
        assert rec["chunks"] == {h: len(data)}
        mt = backend.chunk_mtime(h)
        assert mt is not None and abs(mt - time.time()) < 60
        with pytest.raises(KeyError):
            backend.get("0" * 64)
        # manifests ride the same contract
        backend.put_manifest("step0000000001-aa", b'{"x": 1}')
        assert backend.get_manifest("step0000000001-aa") == b'{"x": 1}'
        rec["manifests"] = backend.list_manifests()
        assert rec["manifests"] == ["step0000000001-aa"]
        with pytest.raises(KeyError):
            backend.get_manifest("step0000000009-zz")
        rec["stats"] = backend.stats()
        assert rec["stats"]["num_chunks"] == 1
        assert rec["stats"]["chunk_bytes"] == len(data)
        # descriptor round-trip: an equivalent backend in another process
        rec["descriptor"] = backend.descriptor()
        clone = p.backend.backend_from_descriptor(rec["descriptor"])
        assert clone.has(h) and clone.get(h) == data
        assert clone.list_manifests() == ["step0000000001-aa"]
        backend.delete(h)
        assert not backend.has(h)
        backend.delete(h)  # idempotent
        backend.delete_manifest("step0000000001-aa")
        rec["after_delete"] = (backend.list_chunks(), backend.list_manifests())
        assert rec["after_delete"] == ({}, [])
        record.append(rec)
    return record


def test_backend_contract(tmp_path):
    _same(_backend_contract, tmp_path)


def _multipart(p, root):
    shim = p.ckpt.FaultShim(p.ckpt.DirBucketClient(str(root / "b")))
    backend = p.ckpt.BucketBackend(shim, multipart_bytes=1024)
    data = bytes(range(256)) * 20  # 5120 B: 5 parts above the threshold
    h = hashlib.sha256(data).hexdigest()
    assert backend.put(h, data) is True
    ops_after_put = dict(shim.op_counts)
    assert shim.ops("create_multipart") == 1
    assert shim.ops("complete_multipart") == 1
    assert backend.get(h) == data
    # ranged read across a part boundary
    assert backend.get(h, offset=1000, length=100) == data[1000:1100]

    # a multipart that dies mid-part is aborted and never visible
    shim.fail_after = shim.ops("upload_part") + 2
    shim.fail_ops = ("upload_part",)
    data2 = bytes(reversed(data))
    h2 = hashlib.sha256(data2).hexdigest()
    with pytest.raises(p.backend.BackendUnavailable):
        backend.put(h2, data2)
    assert not backend.has(h2)
    assert backend.list_chunks() == {h: len(data)}
    objects = sorted(shim.client.list_objects(""))
    # no staging leftovers leak into the object listing
    assert all("multipart" not in k for k in objects)
    return {"ops_after_put": ops_after_put, "ops": dict(shim.op_counts),
            "objects": objects}


def test_bucket_multipart_upload_and_aborted_invisible(tmp_path):
    record = _same(_multipart, tmp_path)
    # the JAX tier's part size splits 5120 B into 5 parts; so does the port's
    assert record["ops_after_put"]["upload_part"] == 5


# ---------------------------------------------------------------------------
# (b) parallel IO: coalescing, verification, byte-cap progress
# ---------------------------------------------------------------------------


def _range_cases():
    """The JAX test's cases (unsorted, overlapping, gap-mergeable, touching,
    zero-length) and 40 random lists of up to 12 ranges, from seed 0."""
    cases = [([], 64), ([(100, 10), (0, 10), (15, 5), (300, 8)], 8),
             ([(0, 4), (4, 4), (9, 4), (2, 0)], 0)]
    rng = np.random.default_rng(0)
    for _ in range(40):
        k = int(rng.integers(1, 13))
        ranges = [(int(o), int(n)) for o, n in
                  zip(rng.integers(0, 400, k), rng.integers(0, 40, k))]
        cases.append((ranges, int(rng.choice([0, 1, 8, 64]))))
    return cases


def test_coalesce_ranges():
    for ranges, gap in _range_cases():
        got = PORT.pario.coalesce_ranges(list(ranges), gap)
        if ranges and not any(ln for _, ln in ranges):
            # the JAX copy indexes an empty span list here; the port
            # returns what it returns for no ranges at all
            with pytest.raises(IndexError):
                JAX.pario.coalesce_ranges(list(ranges), gap)
            assert got == []
            continue
        assert got == JAX.pario.coalesce_ranges(list(ranges), gap), (ranges,
                                                                     gap)
        # every byte asked for lies in exactly one merged span
        for off, ln in ranges:
            if ln:
                assert sum(o <= off and off + ln <= o + n
                           for o, n in got) == 1


def _parallel_fetch(p, root):
    pool = str(root / "pool")
    backend = p.ckpt.LocalFSBackend(pool)
    sizes, datas = {}, {}
    for i in range(8):
        data = bytes([i]) * 100
        h, created = p.mf.write_chunk(pool, data)
        assert created
        sizes[h] = len(data)
        datas[h] = data
    # cap far below the batch total: workers queue on the gate but every
    # chunk still lands (progress is guaranteed, an oversized chunk is
    # admitted alone)
    io = p.pario.ParallelIO(backend, threads=4, inflight_bytes=150,
                            coalesce_gap=16)
    out = io.fetch(dict(sizes))
    assert out == datas
    counters = dict(io.counters)
    # corrupt ONE chunk on disk: the fetch rejects it by sha256 and the
    # other seven arrive as the verified partial result
    bad = sorted(sizes)[0]
    with open(p.mf.chunk_path(pool, bad), "wb") as f:
        f.write(b"\xff" + datas[bad][1:])
    with pytest.raises(p.pario.ChunkFetchError) as ei:
        io.fetch(dict(sizes))
    assert set(ei.value.errors) == {bad}
    assert ei.value.partial == {h: d for h, d in datas.items() if h != bad}
    return {"counters": counters, "after_corrupt": dict(io.counters),
            "errors": sorted(ei.value.errors)}


def test_parallel_fetch_verifies_and_reports_per_chunk(tmp_path):
    _same(_parallel_fetch, tmp_path)


def _read_ranges(p, root):
    shim = p.ckpt.FaultShim(p.ckpt.DirBucketClient(str(root / "b")))
    backend = p.ckpt.BucketBackend(shim)
    data = bytes(i % 251 for i in range(4096))
    h = hashlib.sha256(data).hexdigest()
    backend.put(h, data)
    gets = []
    for gap in (0, 64, 1024):
        io = p.pario.ParallelIO(backend, threads=2, coalesce_gap=gap)
        before = shim.ops("get")
        ranges = [(0, 16), (40, 16), (2000, 32), (3000, 8)]
        out = io.read_ranges(h, ranges)
        assert out == [data[off:off + ln] for off, ln in ranges]
        gets.append(shim.ops("get") - before)
    return {"gets": gets, "ops": dict(shim.op_counts)}


def test_read_ranges_coalesces_round_trips(tmp_path):
    record = _same(_read_ranges, tmp_path)
    # gap 64: (0,16)+(40,16) coalesce (gap 24 <= 64); the far two stay apart
    assert record["gets"][1] == 3


# ---------------------------------------------------------------------------
# tiered lifecycle: commit -> mirror pump -> evict -> read-through restore
# ---------------------------------------------------------------------------


def _smoke(p, root):
    store, shim = _bucket_store(p, root, "smoke", mirror=True)
    try:
        tree = _tree(1.5)
        man = p.ckpt.save_checkpoint(store, tree, step=1)
        entry = store.wait_mirrored(man.ckpt_id, timeout=30.0)
        assert entry["state"] == "remote"
        assert store.verify(man.ckpt_id)["ok"]
        evicted = store.evict_local(man.ckpt_id)
        assert _local_chunks(p, store, man.chunk_set()) == []
        assert store.residency()[man.ckpt_id]["evicted"]
        restored = p.ckpt.restore_tree(store)
        for k, arr in tree.items():
            np.testing.assert_array_equal(restored[k], arr)
        # read-through cached the chunks back into the local pool
        assert _local_chunks(p, store, man.chunk_set()) == sorted(
            man.chunk_set())
        # residency rides the store stats for the state API / dashboard
        rows = {r["ckpt_id"]: r for r in store.stats()["checkpoints"]}
        assert rows[man.ckpt_id]["residency"] == "evicted"
        return {"chunks": man.chunk_set(), "mirror": entry,
                "evicted": evicted, "io": dict(store.io.counters),
                "ops": dict(shim.op_counts),
                "residency": store.residency()}
    finally:
        store.close()


def test_tier_smoke_save_mirror_evict_restore(tmp_path):
    """Tier-1 smoke: async save -> pump mirrors -> evict local bytes ->
    restore pulls from the (fault-shimmed) remote tier, byte-exact."""
    _same(_smoke, tmp_path)


def _dedup(p, root):
    store, shim = _bucket_store(p, root, "dedup", mirror=False)
    try:
        tree = _tree(2.0)
        m1 = p.ckpt.save_checkpoint(store, tree, step=1)
        c1 = store.mirror_now(m1.ckpt_id)
        assert c1["upload_chunks"] == len(m1.chunk_set())
        tree["layer0"] = tree["layer0"] + 0.25  # 1-of-6 delta (no other
        # layer's content collides with a fractional shift)
        m2 = p.ckpt.save_checkpoint(store, tree, step=2)
        c2 = store.mirror_now(m2.ckpt_id)
        # re-mirroring an already-remote checkpoint uploads nothing
        c3 = store.mirror_now(m2.ckpt_id)
        assert c3["upload_chunks"] == 0
        assert c3["dedup_chunks"] == len(m2.chunk_set())
        return {"mirrors": [c1, c2, c3], "ops": dict(shim.op_counts),
                "remote": store.backend.list_chunks()}
    finally:
        store.close()


def test_mirror_dedup_across_steps(tmp_path):
    record = _same(_dedup, tmp_path)
    assert record["mirrors"][1]["upload_chunks"] == 1  # only the changed leaf


def _crash(p, root):
    store, shim = _bucket_store(p, root, "crash", mirror=True, io_threads=2)
    try:
        # let 2 chunk uploads through, then the backend "dies"
        shim.fail_after = 2
        shim.fail_ops = ("put",)
        man = p.ckpt.save_checkpoint(store, _tree(3.0), step=1)
        total = len(man.chunk_set())
        with pytest.raises(RuntimeError, match="mirror of"):
            store.wait_mirrored(man.ckpt_id, timeout=30.0)
        entry = dict(store.residency()[man.ckpt_id])
        assert entry["state"] == "mirroring"  # never presented as durable
        assert "BackendUnavailable" in entry.pop("error")
        # the partially-uploaded checkpoint has NO remote manifest: a
        # remote reader can never see a checkpoint missing its chunks
        assert store.backend.list_manifests() == []
        landed = len(store.backend.list_chunks())
        assert 0 < landed < total

        # fault clears -> re-mirror is idempotent by content address
        shim.clear_fault()
        c = store.mirror_now(man.ckpt_id)
        assert c["upload_chunks"] == total - landed  # only the remainder
        assert c["dedup_chunks"] == landed
        assert store.residency()[man.ckpt_id]["state"] == "remote"
        assert store.verify(man.ckpt_id, deep=True)["ok"]
        return {"total": total, "landed": landed, "crashed": entry,
                "remirror": c, "remote": store.backend.list_chunks()}
    finally:
        store.close()


def test_pump_killed_mid_upload_never_remote_then_idempotent(tmp_path):
    """(c) the crash contract: a mirror that dies mid-upload leaves
    residency ``mirroring`` (never ``remote``), uploads no manifest, and
    an explicit re-mirror after the fault clears uploads only the
    chunks the first attempt did not land."""
    _same(_crash, tmp_path)


def _corrupt(p, root):
    store, shim = _bucket_store(p, root, "corrupt", mirror=False)
    try:
        tree = _tree(4.0)
        man = p.ckpt.save_checkpoint(store, tree, step=1)
        store.mirror_now(man.ckpt_id)
        sizes = man.chunk_set()
        shim.corrupt_get = lambda key: "chunks/" in key
        # deep verify detects every corrupted chunk
        report = store.verify(man.ckpt_id, deep=True)
        assert not report["ok"]
        # prefer="remote" (verification-style read) falls back per chunk
        # to the intact local copy instead of failing the batch
        out = store.fetch_chunks(dict(sizes), prefer="remote")
        for h in sizes:
            assert hashlib.sha256(out[h]).hexdigest() == h
        fallback = dict(store.io.counters)
        assert fallback["verify_failures"] >= len(sizes)
        # with the local copy evicted too, corrupt bytes are an ERROR —
        # never a silently-wrong restore
        shim.corrupt_get = False
        store.evict_local(man.ckpt_id)
        shim.corrupt_get = lambda key: "chunks/" in key
        with pytest.raises(p.pario.ChunkFetchError) as ei:
            p.ckpt.restore_tree(store, man.ckpt_id)
        shim.corrupt_get = False
        restored = p.ckpt.restore_tree(store, man.ckpt_id)
        for k, arr in tree.items():
            np.testing.assert_array_equal(restored[k], arr)
        return {"report": report, "fallback": fallback,
                "rejected": sorted(ei.value.errors),
                "io": dict(store.io.counters), "ops": dict(shim.op_counts)}
    finally:
        store.close()


def test_corrupt_remote_rejected_with_local_fallback(tmp_path):
    record = _same(_corrupt, tmp_path)
    assert record["report"]["corrupt_chunks"] == 6  # every chunk


def _evict_refusals(p, root):
    store, _shim = _bucket_store(p, root, "evict", mirror=False)
    try:
        m1 = p.ckpt.save_checkpoint(store, _tree(1.0), step=1)
        with pytest.raises(ValueError, match="refusing to evict") as unm:
            store.evict_local(m1.ckpt_id)  # residency is local
        store.mirror_now(m1.ckpt_id)
        # the remote tier losing a chunk blocks eviction of the only copy
        lost = sorted(m1.chunk_set())[0]
        store.backend.delete(lost)
        with pytest.raises(RuntimeError, match="remote tier lost") as lossy:
            store.evict_local(m1.ckpt_id)
        store.io.put_many({lost: p.mf.read_chunk(store.root, lost)})

        # chunks shared with a local-resident checkpoint survive eviction
        tree2 = _tree(1.0)
        tree2["layer0"] = tree2["layer0"] + 0.25
        m2 = p.ckpt.save_checkpoint(store, tree2, step=2)
        store.mirror_now(m2.ckpt_id)
        evicted = store.evict_local(m2.ckpt_id)
        both = set(m1.chunk_set()) | set(m2.chunk_set())
        shared = set(m1.chunk_set()) & set(m2.chunk_set())
        assert shared
        # m1 is still local-resident and needs the shared chunks
        assert _local_chunks(p, store, both) == sorted(m1.chunk_set())
        return {"refusals": [str(unm.value), str(lossy.value)],
                "evicted": evicted, "local": _local_chunks(p, store, both),
                "residency": store.residency()}
    finally:
        store.close()


def test_evict_refuses_unmirrored_and_lossy_remote(tmp_path):
    _same(_evict_refusals, tmp_path)


def _adopt(p, root):
    store, _ = _bucket_store(p, root, "origin", mirror=False)
    tree = _tree(5.0)
    man = p.ckpt.save_checkpoint(store, tree, step=3)
    store.mirror_now(man.ckpt_id)
    store.close()
    # a replacement host attaches to the same bucket with an empty root
    fresh = p.ckpt.TieredStore(
        str(root / "fresh"), name="fresh", mirror=False,
        backend=p.ckpt.BucketBackend(
            p.ckpt.DirBucketClient(str(root / "bucket"))))
    try:
        adopted = fresh.adopt_remote()
        assert adopted == [man.ckpt_id]
        entry = fresh.residency()[man.ckpt_id]
        assert entry["state"] == "remote" and entry["evicted"]
        restored = p.ckpt.restore_tree(fresh, man.ckpt_id)
        for k, arr in tree.items():
            np.testing.assert_array_equal(restored[k], arr)
        return {"adopted": adopted, "residency": fresh.residency(),
                "io": dict(fresh.io.counters),
                "local": _local_chunks(p, fresh, man.chunk_set())}
    finally:
        fresh.close()


def test_adopt_remote_on_fresh_host(tmp_path):
    _same(_adopt, tmp_path)


# ---------------------------------------------------------------------------
# (d) retention sweeper: pinned / in-flight / grace invariants
# ---------------------------------------------------------------------------


def _sweep_keep_last(p, root):
    store, _ = _bucket_store(p, root, "sweep", mirror=False)
    ids = []
    for i in range(3):
        m = p.ckpt.save_checkpoint(store, _tree(float(i + 1)), step=i)
        store.mirror_now(m.ckpt_id)
        ids.append(m.ckpt_id)
    store.pin(ids[0])

    # a pinned auxiliary manifest outside the LATEST chain — the weight
    # plane's durable publish shape (write_manifest + pin, no commit)
    mf = p.mf
    data = b"durable weights payload"
    wh, _ = mf.write_chunk(store.root, data)
    wman = mf.Manifest(
        ckpt_id="weights-pol-v0000000001", step=1, ts=time.time(),
        parent=None, skeleton={"__leaf__": "w"}, spec=None,
        leaves={"w": mf.LeafEntry(
            kind=mf.ND, shape=(len(data),), dtype="|u1",
            chunks={mf.encode_box(((0, len(data)),)): (wh, len(data))})},
        stats={"weights_store": "pol", "weights_version": 1})
    mf.write_manifest(store.root, wman)
    store.pin(wman.ckpt_id)
    store.mirror_now(wman.ckpt_id)
    assert store.latest_id() == ids[-1]  # durable publish moved no LATEST

    # an in-flight sharded save: a part-file referencing an orphan chunk
    # far older than any grace window
    orphan, _ = mf.write_chunk(store.root, b"slow peer host chunk")
    old = time.time() - 86400
    os.utime(mf.chunk_path(store.root, orphan), (old, old))
    part_dir = os.path.join(store.root, mf.PART_DIR, "step0000000099-beef")
    os.makedirs(part_dir)
    mf.atomic_write(
        os.path.join(part_dir, "step0000000099-beef.rank3.json"),
        json.dumps({"host": "rank3", "leaves": {
            "opt/m": {"((0, 4), (0, 4))": [orphan, 20]}}}).encode())
    # plus a plain orphan chunk, equally old, protected by NOTHING
    doomed, _ = mf.write_chunk(store.root, b"no manifest ever named me")
    os.utime(mf.chunk_path(store.root, doomed), (old, old))
    store.close()

    report = p.sweeper.sweep_store(
        store.root, p.sweeper.SweepPolicy(keep_last=1, grace_s=0))
    survivor = p.ckpt.TieredStore(store.root, mirror=False)
    try:
        left = survivor.list_ids()
        remote_left = survivor.backend.list_manifests()
        # keep-last=1 drops ids[1]; ids[0] is pinned, ids[2] is newest, and
        # the pinned weights manifest does NOT consume the keep-last slot
        assert ids[0] in left and ids[2] in left and wman.ckpt_id in left
        assert ids[1] not in left and ids[1] not in remote_left
        # pinned checkpoints still restore from both tiers
        np.testing.assert_array_equal(
            p.ckpt.restore_tree(survivor, ids[0])["layer0"],
            _tree(1.0)["layer0"])
        assert survivor.backend.get(wh) == data
        # the in-flight chunk survived (part-file protection beats age);
        # the unprotected orphan was reaped
        kept = _local_chunks(p, survivor, [orphan, doomed])
        assert kept == [orphan]

        # the save commits (part-file gone) -> the orphan loses its
        # protection and the next zero-grace sweep reaps it
        shutil.rmtree(os.path.dirname(part_dir))
        second = p.sweeper.sweep_store(
            store.root, p.sweeper.SweepPolicy(keep_last=1, grace_s=0))
        assert _local_chunks(p, survivor, [orphan]) == []
        return {"report": report, "left": sorted(left),
                "remote_left": sorted(remote_left), "kept": kept,
                "second": second,
                "remote_chunks": survivor.backend.list_chunks()}
    finally:
        survivor.close()


def test_sweeper_keep_last_both_tiers_protects_pins_and_inflight(tmp_path):
    record = _same(_sweep_keep_last, tmp_path)
    assert record["report"]["local"]["dropped_manifests"] == 1
    assert record["report"]["remote"]["dropped_manifests"] == 1


def _sweep_grace(p, root):
    store, _ = _bucket_store(p, root, "grace", mirror=False)
    m = p.ckpt.save_checkpoint(store, _tree(1.0), step=1)
    store.mirror_now(m.ckpt_id)
    # a just-uploaded remote orphan: an in-flight mirror of a checkpoint
    # whose remote manifest has not landed yet
    data = b"mid-mirror remote chunk"
    h = hashlib.sha256(data).hexdigest()
    store.backend.put(h, data)
    store.close()
    spared = p.sweeper.sweep_store(
        store.root, p.sweeper.SweepPolicy(keep_last=None, grace_s=3600))
    backend = p.ckpt.BucketBackend(
        p.ckpt.DirBucketClient(str(root / "bucket")))
    assert backend.has(h)  # young: spared
    reaped = p.sweeper.sweep_store(
        store.root, p.sweeper.SweepPolicy(keep_last=None, grace_s=0))
    assert not backend.has(h)  # grace disabled, nothing references it
    # the mirrored checkpoint's chunks were live throughout
    assert set(backend.list_chunks()) == set(m.chunk_set())
    return {"spared": spared, "reaped": reaped,
            "remote": backend.list_chunks()}


def test_sweeper_grace_window_spares_young_remote_orphans(tmp_path):
    _same(_sweep_grace, tmp_path)


def _retention_aux(p, root):
    store = p.ckpt.CheckpointStore(str(root), name="kl")
    ids = [p.ckpt.save_checkpoint(store, _tree(float(i)), step=i).ckpt_id
           for i in range(2)]
    aux = p.mf.Manifest(ckpt_id="weights-kl-v0000000007", step=7,
                        ts=time.time(), parent=None,
                        skeleton={"__leaf__": "w"}, spec=None, leaves={})
    p.mf.write_manifest(store.root, aux)
    store.pin(aux.ckpt_id)
    out = store.retention(keep_last=1, grace_s=0)
    left = store.list_ids()
    assert ids[1] in left  # the newest training ckpt survived
    assert aux.ckpt_id in left
    assert ids[0] not in left
    return {"retention": out, "left": sorted(left)}


def test_retention_keep_last_ignores_pinned_aux_manifests(tmp_path):
    """Regression: a pinned ``weights-*`` manifest sorts after every
    ``step*`` id and must not consume the keep-last slot (which would
    evict the newest real checkpoint)."""
    _same(_retention_aux, tmp_path)


# ---------------------------------------------------------------------------
# (e) elastic 4 -> 2 restore THROUGH the tier: per-host chunk accounting
# ---------------------------------------------------------------------------


def _sharded_spec(p, num_hosts):
    mesh = p.spec.MeshSpec((num_hosts,), ("data",),
                           tuple(f"rank{i}" for i in range(num_hosts)))
    return p.spec.ShardedTreeSpec(
        mesh=mesh,
        parts={"opt/m": ("data", None), "opt/v": ("data", None)},
        meta={"opt/m": ((8, 4), "<f4"), "opt/v": ((8, 4), "<f4")})


def _global_tree():
    return {"opt/m": np.arange(32, dtype=np.float32).reshape(8, 4),
            "opt/v": np.arange(32, 64, dtype=np.float32).reshape(8, 4)}


def _elastic_through_tier(p, root):
    store, shim = _bucket_store(p, root, "elastic", mirror=False)
    try:
        spec4 = _sharded_spec(p, 4)
        cid = p.ckpt.new_ckpt_id(7)
        full = _global_tree()
        for host in spec4.mesh.hosts:
            shards = {}
            for leaf in spec4.meta:
                box = p.spec.host_boxes(spec4.mesh, spec4.part_of(leaf),
                                        spec4.meta[leaf][0], host)[0]
                shards[leaf] = {box: full[leaf][p.spec.box_slices(box)]}
            p.ckpt.save_host_shards(store, cid, spec4, host, shards, step=7)
        man = p.ckpt.commit_host_parts(store, cid, spec4, step=7)
        assert man.ckpt_id == cid
        store.mirror_now(cid)
        store.evict_local(cid)
        assert _local_chunks(p, store, man.chunk_set()) == []

        spec2 = _sharded_spec(p, 2)
        total = sum(a.nbytes for a in full.values())
        hosts = []
        for rank, host in enumerate(spec2.mesh.hosts):
            gets_before = shim.ops("get")
            shards, stats = p.ckpt.restore_shards(store, spec2, host, cid)
            assert stats["no_gather"]
            # each of the 2 hosts reads exactly its half of every leaf,
            # fetching only the chunks its half intersects
            assert stats["bytes_read"] == total // 2
            assert shim.ops("get") - gets_before == stats["chunks_read"]
            for leaf, arr in full.items():
                (box, shard), = shards[leaf].items()
                np.testing.assert_array_equal(
                    shard, arr[rank * 4:(rank + 1) * 4])
            hosts.append({"stats": stats,
                          "gets": shim.ops("get") - gets_before,
                          "boxes": {leaf: list(s) for leaf, s in
                                    shards.items()}})
        return {"chunks": len(man.chunk_set()), "hosts": hosts,
                "ops": dict(shim.op_counts)}
    finally:
        store.close()


def test_sharded_save_mirror_evict_restore_2host_accounting(tmp_path):
    record = _same(_elastic_through_tier, tmp_path)
    assert record["chunks"] == 8  # 4 boxes x 2 leaves
    # the other host's half is never fetched (ranks' source boxes are
    # disjoint, so the read-through cache cannot help either)
    assert [h["gets"] for h in record["hosts"]] == [4, 4]


def test_object_plane_descriptor_names_the_missing_runtime():
    with pytest.raises(ValueError, match="no runtime"):
        PORT.backend.backend_from_descriptor(
            {"kind": "object_plane", "namespace": "x"})


def _mirror_and_evict(p, root, tree):
    store = p.ckpt.TieredStore(
        str(root / "run"), name="run", mirror=False,
        backend=p.ckpt.BucketBackend(
            p.ckpt.DirBucketClient(str(root / "bucket"))))
    man = p.ckpt.save_checkpoint(store, tree, step=4)
    store.mirror_now(man.ckpt_id)
    store.evict_local(man.ckpt_id)
    store.close()
    return man


def _restore_through_bucket(p, root, man, tree):
    store = p.ckpt.attach(str(root / "run"), mirror=False)
    try:
        assert store.residency()[man.ckpt_id]["evicted"]
        restored = p.ckpt.restore_tree(store)
        for k, arr in tree.items():
            np.testing.assert_array_equal(restored[k], arr)
        assert store.io.counters["fetch_chunks"] == len(man.chunk_set())
        assert store.verify(man.ckpt_id, deep=True)["ok"]
    finally:
        store.close()


def test_restores_a_jax_tiered_store_through_the_remote_tier(tmp_path):
    """A checkpoint the JAX package's TieredStore mirrored to a bucket and
    evicted locally restores in the port from the bucket alone, every chunk
    sha256-verified, through the TIER descriptor both packages write."""
    tree = _tree(6.0)
    man = _mirror_and_evict(JAX, tmp_path, tree)
    _restore_through_bucket(PORT, tmp_path, man, tree)


def test_jax_restores_a_port_tiered_store_through_the_remote_tier(tmp_path):
    """The converse: the port mirrors and evicts, the JAX package restores."""
    tree = _tree(7.0)
    man = _mirror_and_evict(PORT, tmp_path, tree)
    _restore_through_bucket(JAX, tmp_path, man, tree)
