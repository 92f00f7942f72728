"""Per-node shared-memory object store (plasma equivalent).

Reference: ``src/ray/object_manager/plasma`` — an immutable object store with
create/seal/get/delete over a local protocol, LRU eviction with **spill to
disk** (``local_object_manager.h``), and chunked node-to-node transfer
(``object_manager/pull_manager.cc`` / ``push_manager.cc``).

The port of ``ray_tpu/_private/object_store.py``. Deviations from the
reference design:
- objects live in one /dev/shm arena managed by the C++ allocator in
  ``csrc/store.cc`` (``cpp_store.py``), or, when ``object_store_backend`` is
  ``shm``, in one /dev/shm file per object, mapped with mmap, so host
  processes read tensors zero-copy before they copy them to the card;
- the port's segment names start ``rtpt_`` (the JAX runtime's ``rtpu_``), so
  a port raylet's sweep of stale segments never touches a JAX cluster's;
- buffer offsets are 64-byte aligned so numpy and torch can map them directly.

Blob layout inside a segment (written client-side so the store never copies):
  [u32 magic][u64 inband_len][u32 nbuf][(u64 off, u64 len) * nbuf]
  [inband pickle bytes][64-aligned out-of-band buffers...]
"""

from __future__ import annotations

import asyncio
import mmap
import os
import struct
import time
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private.config import RAY_CONFIG

_MAGIC = 0x52545055  # 'RTPU'
_ALIGN = 64


def _align(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


class ShmSegment:
    """A named /dev/shm file mapping."""

    def __init__(self, name: str, size: Optional[int] = None, create: bool = False):
        self.name = name
        self.path = f"/dev/shm/{name}"
        if create:
            try:
                fd = os.open(self.path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
            except FileExistsError:
                # names are single-writer per session: an existing file is a
                # stale leftover from a dead session — reclaim the name,
                # but only if it is old enough (a twin may be between its
                # create and mmap, invisible in /proc) AND no live process
                # maps it: a split-brain twin collides loudly instead of
                # being silently corrupted
                try:
                    age = time.time() - os.stat(self.path).st_mtime
                except FileNotFoundError:
                    age = 1e9  # a racing reclaimer already removed it
                if age < 10.0 or _shm_mapped_by_live_process(name):
                    raise
                try:
                    os.unlink(self.path)
                except FileNotFoundError:
                    pass  # racing reclaimer won; the create below retries
                fd = os.open(self.path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
            os.ftruncate(fd, size)
        else:
            fd = os.open(self.path, os.O_RDWR)
            size = os.fstat(fd).st_size
        try:
            self.buf = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        self.size = size

    def close(self):
        try:
            self.buf.close()
        except (BufferError, ValueError):  # raylint: disable=EXC001 exported memoryviews still alive; mapping freed at process exit
            pass

    def unlink(self):
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass


def _shm_mapped_by_live_process(name: str) -> bool:
    """True when any live process maps /dev/shm/<name> (scans /proc)."""
    import glob

    needle = "/dev/shm/" + name
    for maps in glob.glob("/proc/[0-9]*/maps"):
        try:
            with open(maps) as f:
                for line in f:
                    if needle in line:
                        return True
        except OSError:  # raylint: disable=EXC001 /proc scan: pids exit mid-walk, other-uid maps unreadable
            continue
    return False


def sweep_stale_shm(prefix: str = "rtpt_", min_age_s: float = 10.0) -> int:
    """Remove /dev/shm segments left behind by dead sessions. A segment is
    stale when no live process maps it (scanned via /proc/*/maps) and it is
    older than ``min_age_s`` (guards the create→mmap window of a concurrent
    session). Run at node start (reference: plasma unlinks its store file on
    startup)."""
    import glob

    live = set()
    for maps in glob.glob("/proc/[0-9]*/maps"):
        try:
            with open(maps) as f:
                for line in f:
                    idx = line.find("/dev/shm/" + prefix)
                    if idx >= 0:
                        live.add(line[idx + 9:].split()[0])
        except OSError:  # raylint: disable=EXC001 /proc scan: pids exit mid-walk, other-uid maps unreadable
            continue
    removed = 0
    now = time.time()
    me = os.getuid()
    for path in glob.glob(f"/dev/shm/{prefix}*"):
        try:
            st = os.stat(path)
            # never touch another user's segments: their /proc/*/maps may
            # be unreadable to us, making liveness undecidable
            if st.st_uid != me or os.path.basename(path) in live or \
                    now - st.st_mtime < min_age_s:
                continue
            os.unlink(path)
            removed += 1
        except OSError:  # raylint: disable=EXC001 concurrent GC: another raylet may unlink the segment first
            pass
    return removed


def plan_layout(inband: bytes, buffers: List[memoryview]) -> Tuple[int, List[int]]:
    header = 4 + 8 + 4 + 16 * len(buffers)
    off = _align(header + len(inband))
    offsets = []
    for b in buffers:
        offsets.append(off)
        off = _align(off + b.nbytes)
    return off, offsets


def write_blob(mem, inband: bytes, buffers: List[memoryview], offsets: List[int]):
    header = struct.pack("<IQI", _MAGIC, len(inband), len(buffers))
    pos = len(header)
    mem[0:pos] = header
    for b, off in zip(buffers, offsets):
        mem[pos : pos + 16] = struct.pack("<QQ", off, b.nbytes)
        pos += 16
    mem[pos : pos + len(inband)] = inband
    for b, off in zip(buffers, offsets):
        flat = b if (b.format == "B" and b.ndim == 1) else b.cast("B")
        mem[off : off + b.nbytes] = flat


def read_blob(mem) -> Tuple[bytes, List[memoryview]]:
    view = memoryview(mem)
    magic, inband_len, nbuf = struct.unpack_from("<IQI", view, 0)
    if magic != _MAGIC:
        raise ValueError("corrupt object blob")
    pos = 16
    offsets = []
    for _ in range(nbuf):
        off, length = struct.unpack_from("<QQ", view, pos)
        offsets.append((off, length))
        pos += 16
    inband = bytes(view[pos : pos + inband_len])
    buffers = [view[off : off + length] for off, length in offsets]
    return inband, buffers


def pack_blob(inband: bytes, buffers: List[memoryview]) -> bytes:
    """Serialize the same layout into a contiguous bytes (for inline/wire)."""
    total, offsets = plan_layout(inband, buffers)
    out = bytearray(total)
    write_blob(out, inband, buffers, offsets)
    return bytes(out)


# ---------------------------------------------------------------------------
# Store server (runs inside the raylet process)
# ---------------------------------------------------------------------------


class _Entry:
    __slots__ = (
        "state", "shm", "shm_name", "size", "last_access", "spill_path", "inline",
        "arena_offset", "attempt", "arena_key", "owner",
    )

    def __init__(self):
        self.state = "CREATED"  # CREATED | SEALED | SPILLED
        self.shm: Optional[ShmSegment] = None
        self.shm_name = ""
        self.size = 0
        self.last_access = time.monotonic()
        self.spill_path = ""
        self.inline: Optional[bytes] = None
        self.owner = ""  # owner worker address (owner-resident directory)
        self.arena_offset: Optional[int] = None  # set when backed by the arena
        # execution-epoch fence (reference: plasma's seal-once semantics,
        # obj_lifecycle_mgr.cc — here generalized so a retried task's newer
        # attempt replaces a zombie attempt's copy and stale writers abort)
        self.attempt = 0
        self.arena_key: Optional[bytes] = None


class ObjectStoreServer:
    """Node-local store: create/seal/get with LRU spill-to-disk eviction.

    Allocation backends: the native C++ arena (csrc/store.cc, first-fit +
    coalescing over one mmap'd /dev/shm file — the plasma-allocator
    equivalent) under ``object_store_backend`` ``auto`` or ``cpp``, and one
    /dev/shm file per object only when ``shm`` is named. Unlike the JAX
    store, ``auto`` raises when the arena cannot be built, as every native
    build of the port does."""

    def __init__(self, node_hex: str, capacity: Optional[int] = None,
                 spill_dir: Optional[str] = None):
        self.node_hex = node_hex
        self.capacity = capacity or RAY_CONFIG.object_store_memory
        self.used = 0
        self.spill_dir = spill_dir or RAY_CONFIG.object_spill_dir or os.path.join(
            RAY_CONFIG.torch_session_root, f"spill_{node_hex[:8]}")
        from ray_tpu_torch._private.external_storage import setup_external_storage

        # pluggable spill backend (reference: _private/external_storage.py):
        # local fs by default; s3://... or a module:Class plugin via config
        self.storage = setup_external_storage(
            RAY_CONFIG.object_spill_storage, self.spill_dir)
        self.objects: Dict[bytes, _Entry] = {}
        self.waiters: Dict[bytes, List[asyncio.Future]] = {}
        self.num_spilled = 0
        self.num_restored = 0
        self.arena = None
        self.arena_name = f"rtpt_arena_{node_hex[:8]}"
        self._arena_view: Optional[ShmSegment] = None
        backend = RAY_CONFIG.object_store_backend
        if backend in ("auto", "cpp"):
            from ray_tpu_torch._private.cpp_store import CppArena

            self.arena = CppArena(self.arena_name, self.capacity)
            self._arena_view = ShmSegment(self.arena_name)
        elif backend != "shm":
            raise ValueError(f"object_store_backend must be auto, cpp or "
                             f"shm, not {backend!r}")

    def _shm_name(self, oid: bytes, attempt: int = 0) -> str:
        # attempt-qualified so a retry's copy never aliases a zombie writer's
        # still-mapped file
        suffix = f"_a{attempt}" if attempt else ""
        return f"rtpt_{self.node_hex[:8]}_{oid.hex()}{suffix}"

    def _arena_key(self, oid: bytes, attempt: int) -> bytes:
        # native arena keys are fixed 16 bytes; attempt-salt the key so a
        # replaced entry's region can sit quarantined under its own key
        # while the newer attempt allocates the same object id
        if attempt == 0:
            return oid
        import hashlib

        return hashlib.blake2b(oid + attempt.to_bytes(4, "big"),
                               digest_size=16).digest()

    def _region(self, e: _Entry):
        """Server-side view of an entry's bytes (arena slice or shm file)."""
        if e.arena_offset is not None:
            view = memoryview(self._arena_view.buf)
            return view[e.arena_offset : e.arena_offset + e.size]
        return memoryview(e.shm.buf)[: e.size]

    def _quarantine_arena(self, key: bytes, size: int):
        """Defer freeing a displaced arena region: its (stale) writer may
        still be streaming bytes into a client-side mapping; immediate reuse
        would corrupt the replacement. Freed after a grace period."""
        def _free():
            if self.arena is not None:
                self.arena.free(key)
                self.used -= size
        try:
            asyncio.get_running_loop().call_later(30.0, _free)
        except RuntimeError:
            _free()

    def _evict_for(self, need: int) -> bool:
        """Spill least-recently-used sealed objects until `need` bytes fit."""
        if need > self.capacity:
            return False
        def fits() -> bool:
            if self.arena is not None:
                return self.arena.largest_free() >= need + 64
            return self.used + need <= self.capacity

        if fits():
            return True
        candidates = sorted(
            (e.last_access, oid)
            for oid, e in self.objects.items()
            if e.state == "SEALED"
            and (e.shm is not None or e.arena_offset is not None)
        )
        for _, oid in candidates:
            self._spill(oid)
            if fits():
                return True
        return fits()

    def _spill(self, oid: bytes):
        e = self.objects[oid]
        e.spill_path = self.storage.spill(oid.hex(), self._region(e))
        e.state = "SPILLED"
        if e.arena_offset is not None:
            self.arena.free(e.arena_key)
            e.arena_offset = None
        elif e.shm is not None:
            e.shm.close()
            e.shm.unlink()
            e.shm = None
        self.used -= e.size
        self.num_spilled += 1

    def _restore(self, oid: bytes) -> bool:
        e = self.objects[oid]
        if not self._evict_for(e.size):
            return False
        data = self.storage.restore(e.spill_path)
        if self.arena is not None:
            e.arena_key = e.arena_key or self._arena_key(oid, e.attempt)
            off = self.arena.alloc(e.arena_key, e.size)
            if off is None or off == -2:
                return False
            memoryview(self._arena_view.buf)[off : off + e.size] = data
            self.arena.seal(e.arena_key)
            e.arena_offset = off
        else:
            shm = ShmSegment(self._shm_name(oid, e.attempt), e.size, create=True)
            shm.buf[:] = data
            e.shm, e.shm_name = shm, shm.name
        self.storage.delete(e.spill_path)
        e.spill_path = ""
        e.state = "SEALED"
        self.used += e.size
        self.num_restored += 1
        return True

    # -- operations (all called on the raylet event loop) --

    def create(self, oid: bytes, size: int, attempt: int = 0,
               owner: str = "") -> dict:
        existing = self.objects.get(oid)
        if existing is not None:
            if attempt < existing.attempt:
                # a newer execution epoch already owns this id: the (zombie)
                # writer must abort without writing or sealing
                return {"status": "stale_attempt", "attempt": existing.attempt}
            if attempt == existing.attempt:
                return {"status": "exists", "state": existing.state}
            # newer attempt replaces the stale copy (seal-once per epoch)
            self._displace(oid, existing)
        if not self._evict_for(size):
            return {"status": "oom", "capacity": self.capacity}
        e = _Entry()
        e.size = size
        e.attempt = attempt
        e.owner = owner
        if self.arena is not None:
            e.arena_key = self._arena_key(oid, attempt)
            off = self.arena.alloc(e.arena_key, size)
            if off == -2:
                # key still quarantined from a displaced copy of this very
                # attempt: the only writer of that epoch is stale — stand down
                return {"status": "stale_attempt", "attempt": attempt}
            if off is None:
                return {"status": "oom", "capacity": self.capacity}
            e.arena_offset = off
            self.objects[oid] = e
            self.used += size
            return {"status": "ok", "arena_name": self.arena_name,
                    "offset": off, "size": size}
        e.shm = ShmSegment(self._shm_name(oid, attempt), size, create=True)
        e.shm_name = e.shm.name
        self.objects[oid] = e
        self.used += size
        return {"status": "ok", "shm_name": e.shm_name}

    def _displace(self, oid: bytes, e: _Entry):
        """Drop a stale-attempt entry so a newer attempt can take the id."""
        del self.objects[oid]
        if e.arena_offset is not None:
            # the stale writer may still hold a client-side mapping into the
            # arena region: quarantine rather than free-and-reuse
            self._quarantine_arena(e.arena_key, e.size)
        elif e.shm is not None:
            self.used -= e.size
            e.shm.close()
            e.shm.unlink()
        if e.spill_path:
            self.storage.delete(e.spill_path)

    def put_inline(self, oid: bytes, blob: bytes, attempt: int = 0,
                   owner: str = "") -> bool:
        existing = self.objects.get(oid)
        if existing is not None:
            if attempt < existing.attempt:
                return False  # stale epoch: rejected
            if attempt == existing.attempt:
                return True  # idempotent
            self._displace(oid, existing)
        e = _Entry()
        e.inline = blob
        e.size = len(blob)
        e.state = "SEALED"
        e.attempt = attempt
        e.owner = owner
        self.objects[oid] = e
        self._wake(oid)
        return True

    def seal(self, oid: bytes, attempt: int = 0) -> bool:
        e = self.objects.get(oid)
        if e is None:
            raise KeyError(f"seal of unknown object {oid.hex()}")
        if e.attempt != attempt:
            return False  # stale writer's seal: fenced off
        e.state = "SEALED"
        e.last_access = time.monotonic()
        self._wake(oid)
        return True

    def _wake(self, oid: bytes):
        for fut in self.waiters.pop(oid, []):
            if not fut.done():
                fut.set_result(True)

    def contains(self, oid: bytes) -> bool:
        e = self.objects.get(oid)
        return e is not None and e.state in ("SEALED", "SPILLED")

    async def wait_local(self, oid: bytes, timeout: float) -> bool:
        if self.contains(oid):
            return True
        fut = asyncio.get_event_loop().create_future()
        self.waiters.setdefault(oid, []).append(fut)
        try:
            await asyncio.wait_for(fut, timeout)
            return True
        except asyncio.TimeoutError:
            return False
        finally:
            # cancelled/timed-out waiters must not pile up on oids that
            # never seal (StoreWaitAny cancels these every chunk)
            lst = self.waiters.get(oid)
            if lst is not None:
                try:
                    lst.remove(fut)
                except ValueError:  # raylint: disable=EXC001 waiter already removed by a concurrent seal
                    pass
                if not lst:
                    self.waiters.pop(oid, None)

    def access(self, oid: bytes) -> dict:
        """Local read: returns shm name (restoring from spill) or inline blob."""
        e = self.objects.get(oid)
        if e is None or e.state == "CREATED":
            return {"status": "missing"}
        e.last_access = time.monotonic()
        if e.inline is not None:
            return {"status": "inline", "blob": e.inline}
        if e.state == "SPILLED" and not self._restore(oid):
            return {"status": "oom"}
        if e.arena_offset is not None:
            return {"status": "shm_arena", "arena_name": self.arena_name,
                    "offset": e.arena_offset, "size": e.size}
        return {"status": "shm", "shm_name": e.shm_name, "size": e.size}

    def read_chunk(self, oid: bytes, offset: int, length: int,
                   attempt: Optional[int] = None) -> Optional[bytes]:
        """Remote transfer read path (works for sealed or spilled objects).
        ``attempt`` fences the source: a mid-pull displacement by a newer
        epoch must abort the transfer, not mix epochs in one blob."""
        e = self.objects.get(oid)
        if e is None or e.state == "CREATED":
            return None
        if attempt is not None and e.attempt != attempt:
            return None
        e.last_access = time.monotonic()
        if e.inline is not None:
            return e.inline[offset : offset + length]
        if e.state == "SPILLED":
            return self.storage.restore_range(e.spill_path, offset, length)
        return bytes(self._region(e)[offset : offset + length])

    def object_owner(self, oid: bytes) -> str:
        e = self.objects.get(oid)
        return e.owner if e is not None else ""

    def object_size(self, oid: bytes) -> Optional[int]:
        e = self.objects.get(oid)
        return None if e is None else e.size

    def object_attempt(self, oid: bytes) -> int:
        e = self.objects.get(oid)
        return 0 if e is None else e.attempt

    def write_chunk(self, oid: bytes, offset: int, data: bytes,
                    attempt: int = 0):
        """Pull-side write (store-mediated; remote data lands directly in shm)."""
        e = self.objects.get(oid)
        if e is None or (e.shm is None and e.arena_offset is None):
            raise KeyError(f"write_chunk on missing object {oid.hex()}")
        if e.attempt != attempt:
            raise KeyError(f"write_chunk fenced: {oid.hex()} now at "
                           f"attempt {e.attempt}")
        self._region(e)[offset : offset + len(data)] = data

    def delete(self, oids: List[bytes]):
        for oid in oids:
            e = self.objects.pop(oid, None)
            if e is None:
                continue
            for fut in self.waiters.pop(oid, []):
                if not fut.done():
                    fut.cancel()
            if e.arena_offset is not None:
                self.used -= e.size
                self.arena.free(e.arena_key)
            elif e.shm is not None:
                self.used -= e.size
                e.shm.close()
                e.shm.unlink()
            if e.spill_path:
                self.storage.delete(e.spill_path)

    _ZERO_CHUNK = b"\x00" * (8 * 1024 * 1024)

    def prewarm_step(self, offset: int) -> Optional[int]:
        """Pre-touch one arena chunk at ``offset`` (first-touch /dev/shm
        page faults are ~60x slower than warm writes on some hosts).
        Returns the next offset, or None when done. Runs on the store's
        event loop between awaits, so the live-region check is atomic with
        respect to allocations; chunks overlapping any live entry are
        skipped rather than zeroed."""
        if self._arena_view is None:
            return None
        limit = min(self.capacity, RAY_CONFIG.object_store_prewarm_bytes)
        if offset >= limit:
            return None
        n = min(len(self._ZERO_CHUNK), limit - offset)
        end = offset + n
        for e in self.objects.values():
            if e.arena_offset is not None \
                    and e.arena_offset < end and offset < e.arena_offset + e.size:
                return end  # live data here: skip this chunk
        memoryview(self._arena_view.buf)[offset:end] = self._ZERO_CHUNK[:n]
        return end

    def stats(self) -> dict:
        return {
            "capacity": self.capacity,
            "used": self.used,
            "num_objects": len(self.objects),
            "num_spilled": self.num_spilled,
            "num_restored": self.num_restored,
            "backend": "cpp_arena" if self.arena is not None else "shm_files",
        }

    def shutdown(self):
        self.delete(list(self.objects.keys()))
        if self._arena_view is not None:
            self._arena_view.close()
        if self.arena is not None:
            self.arena.close()
            self.arena = None


# ---------------------------------------------------------------------------
# Client-side segment cache (zero-copy reads keep segments mapped)
# ---------------------------------------------------------------------------


class SegmentCache:
    def __init__(self):
        self._segments: Dict[str, ShmSegment] = {}

    def open(self, name: str) -> ShmSegment:
        seg = self._segments.get(name)
        if seg is None:
            seg = ShmSegment(name)
            self._segments[name] = seg
        return seg

    def clear(self):
        for seg in self._segments.values():
            seg.close()
        self._segments.clear()
