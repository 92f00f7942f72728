"""Channels: mutable shared-memory slot rings for compiled-graph and
pipeline data flow, the port of ``ray_tpu/dag/channels.py``.

Reference: python/ray/experimental/channel/shared_memory_channel.py backed by
C++ mutable objects (core_worker/experimental_mutable_object_manager.cc —
versioned buffers with writer/reader synchronization; the writer BLOCKS
until every registered reader has consumed the value ``depth`` writes back,
so pipeline stages observe every value, reference
shared_memory_channel.py:151).

Design (the JAX package's): a fixed-capacity /dev/shm segment holding a ring
of ``depth`` seqlock slots. Global write sequence ``n`` lands in slot
``n % depth`` and seals it at version ``2*(n//depth) + 2`` (odd while
writing). Each slot carries per-reader ack words; the writer of value ``n``
first waits until every reader has acked value ``n - depth`` (the previous
occupant of the slot), which keeps the no-drop rendezvous while letting the
producer run ``depth`` values ahead — with ``depth >= 2`` a pipeline stage's
SEND overlaps its next compute op instead of blocking on the downstream ack.

Segment layout (all offsets 64-byte aligned)::

  [u32 magic][u32 depth][u32 num_readers][u32 _][u64 slot_capacity] pad->64
  depth x slots:
    [u64 version][u64 payload_len][u64 seq][u64 ack[MAX_READERS]] pad->192
    [payload bytes ... slot_capacity]

Payloads use tensor-aware zero-copy framing: tree leaves that are torch
tensors or numpy arrays are copied straight into the slot (one copy, no
pickle), and a small pickled *skeleton* — the tree with leaves replaced by
placeholders, plus per-leaf (kind, dtype name, shape, quantization)
metadata — rides alongside a buffer table::

  [u8 fmt][u8 _ x3][u32 skel_len][u32 nbufs][u32 _]
  [ (u64 off, u64 nbytes) x nbufs ]  [skel pickle]  pad->64  [buffers...]

A tensor's leaf is its raw bytes tagged with torch's dtype name, so a bf16
tensor crosses without a numpy dtype for it (the card's machine has no
``ml_dtypes``). A tensor on the card is copied to the host as it is
written into the slot; it arrives as a CPU tensor, which the reader moves
to its own device. A numpy leaf arrives as a numpy array.

The reader validates ``payload_len`` and ``seq`` *under* the version
snapshot (a torn header can otherwise present a garbage length), copies the
raw payload, re-checks the version, and acks BEFORE deserializing — writer
backpressure releases at copy time, not at unpickle time. Leaves
materialize as views over the private copy.

Segment names are ``rtpt_chan_<name>`` (the JAX package's ``rtpu_chan_``),
so a port cluster and a JAX cluster on one host never collide.

One writer, up to MAX_READERS readers, single host; the cross-host leg
(``CrossHostWriter`` / ``CrossHostReader``) pushes the same frames into the
reader's worker mailbox.
"""

from __future__ import annotations

import struct
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._private.object_store import ShmSegment
from ray_tpu_torch._private.serialization import dumps, loads_trusted

MAX_READERS = 16
SHM_PREFIX = "rtpt_chan_"
_SEG_HDR = 64
_SLOT_HDR = 192  # u64 version + u64 len + u64 seq + u64 ack[16] = 152 -> 192
_MAGIC = 0x52545443  # "RTTC"
_ALIGN = 64
_PAYLOAD_HDR = 16  # u8 fmt + pad + u32 skel_len + u32 nbufs + pad
_FMT_TREE = 1
_XHOST_RETRIES = 3


def _align(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


class ChannelClosed(Exception):
    pass


class _Stop:
    """Teardown sentinel: propagated stage to stage."""

    def __reduce__(self):
        return (_Stop, ())


STOP = _Stop()


class ChannelError:
    """Error sentinel: carries a stage's exception to downstream readers."""

    def __init__(self, err: str):
        self.err = err


class _Leaf:
    """Skeleton placeholder for an array leaf (index into the leaf table)."""

    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i

    def __reduce__(self):
        return (_Leaf, (self.i,))


def _is_array_leaf(x: Any) -> bool:
    if isinstance(x, torch.Tensor):
        return True
    return isinstance(x, np.ndarray) and not x.dtype.hasobject


def _extract_leaves(value: Any) -> Tuple[Any, List[Any]]:
    """Replace tensor and array leaves of dict/list/tuple containers with
    placeholders; anything else stays inline in the skeleton pickle."""
    leaves: List[Any] = []

    def walk(x):
        if _is_array_leaf(x):
            if isinstance(x, torch.Tensor):
                x = x.detach()
                if not x.is_contiguous():
                    x = x.contiguous()
            elif not x.flags["C_CONTIGUOUS"]:  # ascontiguousarray would
                x = np.ascontiguousarray(x)    # promote 0-d to shape (1,)
            leaves.append(x)
            return _Leaf(len(leaves) - 1)
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, tuple):
            items = [walk(v) for v in x]
            return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
        if isinstance(x, list):
            return [walk(v) for v in x]
        return x

    return walk(value), leaves


def _plant_leaves(skel: Any, leaves: List[Any]) -> Any:
    def walk(x):
        if isinstance(x, _Leaf):
            return leaves[x.i]
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, tuple):
            items = [walk(v) for v in x]
            return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
        if isinstance(x, list):
            return [walk(v) for v in x]
        return x

    return walk(skel)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _bytes_of(leaf: Any) -> Any:
    """A leaf's raw bytes as a flat uint8 tensor or array (on the leaf's
    device for a tensor)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.reshape(-1).view(torch.uint8)
    # reshape first: 0-d arrays reject dtype-changing views
    return leaf.reshape(-1).view(np.uint8)


def _encode_frame(value: Any, codec=None) -> Tuple[bytes, list, dict]:
    """Build the frame: returns (skeleton blob, buffer list, stats). Each
    buffer is a flat uint8 tensor (on its leaf's device) or array.

    With a codec, floating tensor leaves stream quantized (codes + fp32
    block scales as separate buffers); other leaves always take the exact
    path."""
    t0 = time.perf_counter()
    skel, leaves = _extract_leaves(value)
    metas = []
    bufs: List[Any] = []
    for leaf in leaves:
        if isinstance(leaf, np.ndarray) and codec is not None \
                and np.issubdtype(leaf.dtype, np.floating):
            leaf = torch.from_numpy(leaf)  # quantized leaves stream as tensors
        if isinstance(leaf, torch.Tensor):
            if codec is not None and leaf.is_floating_point():
                from ray_tpu_torch.collective.quant import quantize

                qt = quantize(leaf, codec)
                m = {"bi": len(bufs), "q": qt.meta(), "sbi": None}
                bufs.append(qt.codes)
                if qt.scales.numel():
                    m["sbi"] = len(bufs)
                    bufs.append(qt.scales.view(torch.uint8))
                metas.append(m)
                continue
            metas.append({"bi": len(bufs), "kind": "torch",
                          "dtype": _dtype_name(leaf.dtype),
                          "shape": tuple(leaf.shape)})
        else:
            metas.append({"bi": len(bufs), "kind": "numpy",
                          "dtype": leaf.dtype.str, "shape": leaf.shape})
        bufs.append(_bytes_of(leaf))
    t1 = time.perf_counter()
    skel_blob = dumps((skel, metas))
    t2 = time.perf_counter()
    return skel_blob, bufs, {"encode_s": t1 - t0, "pickle_s": t2 - t1,
                             "skel_bytes": len(skel_blob)}


def _layout(skel_blob: bytes, bufs: list) -> Tuple[List[int], int]:
    """Each buffer's offset in the payload, and the payload's length."""
    offs = []
    cursor = _align(_PAYLOAD_HDR + 16 * len(bufs) + len(skel_blob))
    for b in bufs:
        offs.append(cursor)
        cursor = _align(cursor + b.nbytes)
    return offs, cursor


def _write_payload(mem, pbase: int, skel_blob: bytes, bufs: list,
                   offs: List[int]) -> None:
    """Write the frame at ``pbase`` of the writable buffer ``mem`` (a slot's
    mmap or a bytearray): header, buffer table, skeleton, then each buffer
    by one copy (a tensor on the card by one device-to-host copy)."""
    nbufs = len(bufs)
    skel_off = _PAYLOAD_HDR + 16 * nbufs
    struct.pack_into("<BxxxIIxxxx", mem, pbase, _FMT_TREE, len(skel_blob),
                     nbufs)
    for i, b in enumerate(bufs):
        struct.pack_into("<QQ", mem, pbase + _PAYLOAD_HDR + 16 * i, offs[i],
                         b.nbytes)
    mem[pbase + skel_off:pbase + skel_off + len(skel_blob)] = skel_blob
    for b, off in zip(bufs, offs):
        if not b.nbytes:
            continue
        if isinstance(b, torch.Tensor):
            dst = torch.frombuffer(mem, dtype=torch.uint8, count=b.nbytes,
                                   offset=pbase + off)
            dst.copy_(b)
        else:
            dst = np.frombuffer(mem, np.uint8, count=b.nbytes,
                                offset=pbase + off)
            dst[:] = b


def _leaf_view(raw: np.ndarray, off: int, nb: int) -> torch.Tensor:
    """Bytes [off, off + nb) of the private copy ``raw`` as a uint8 tensor
    sharing its memory."""
    if nb == 0:
        return torch.empty(0, dtype=torch.uint8)
    return torch.from_numpy(raw[off:off + nb])


def _decode_frame(raw: np.ndarray) -> Any:
    """Rebuild the value from a private copy of the payload (post-ack)."""
    fmt = int(raw[0])
    if fmt != _FMT_TREE:
        raise RuntimeError(f"unknown channel frame format {fmt}")
    skel_len, nbufs = struct.unpack_from("<II", raw, 4)
    table_end = _PAYLOAD_HDR + 16 * nbufs
    table = np.frombuffer(raw, "<u8", count=2 * nbufs,
                          offset=_PAYLOAD_HDR).reshape(nbufs, 2)
    skel, metas = loads_trusted(raw[table_end:table_end + skel_len].tobytes())
    leaves = []
    for m in metas:
        off, nb = int(table[m["bi"], 0]), int(table[m["bi"], 1])
        if "q" in m:
            from ray_tpu_torch.collective.quant import (QuantizedTensor,
                                                        dequantize)

            q = m["q"]
            if m["sbi"] is not None:
                soff, snb = (int(table[m["sbi"], 0]),
                             int(table[m["sbi"], 1]))
                scales = _leaf_view(raw, soff, snb).view(torch.float32)
            else:
                scales = torch.zeros(0, dtype=torch.float32)
            leaves.append(dequantize(QuantizedTensor(
                q["codec"], q["block"], tuple(q["shape"]), q["dtype"],
                _leaf_view(raw, off, nb), scales)))
        elif m["kind"] == "torch":
            dt = getattr(torch, m["dtype"])
            flat = _leaf_view(raw, off, nb)
            leaves.append((flat.view(dt) if nb else torch.empty(0, dtype=dt))
                          .reshape(m["shape"]))
        else:
            leaves.append(raw[off:off + nb].view(np.dtype(m["dtype"]))
                          .reshape(m["shape"]))
    return _plant_leaves(skel, leaves)


def frame_bytes(value: Any, codec=None) -> bytes:
    """The whole frame of ``value`` as one blob (the cross-host leg's
    payload; a slot holds the same bytes)."""
    skel_blob, bufs, _ = _encode_frame(value, codec)
    offs, total = _layout(skel_blob, bufs)
    out = bytearray(total)
    _write_payload(out, 0, skel_blob, bufs, offs)
    return bytes(out)


def decode_bytes(blob: bytes) -> Any:
    """``frame_bytes``' inverse, over a private writable copy."""
    raw = np.frombuffer(bytearray(blob), np.uint8)
    return _decode_frame(raw)


class Channel:
    """Single-writer, acked multi-reader mutable slot ring.

    The writer passes ``num_readers`` and ``depth`` at create time; each
    reader attaches with a distinct ``reader_slot`` in [0, num_readers).
    ``write`` of value ``n`` blocks until all readers have acked value
    ``n - depth`` (ring backpressure), so no reader ever misses a value.
    Attach-side endpoints derive their resume sequence from the shm state
    (slot seqs for writers, own ack words for readers), so a restarted
    process re-joins an in-flight ring where it left off.
    """

    def __init__(self, name: str, capacity: int = 1 << 20,
                 create: bool = False, num_readers: int = 1,
                 reader_slot: Optional[int] = None, depth: int = 1):
        if num_readers > MAX_READERS:
            raise ValueError(f"at most {MAX_READERS} readers per channel")
        if depth < 1:
            raise ValueError(f"channel depth must be >= 1, got {depth}")
        self.name = f"{SHM_PREFIX}{name}"
        self.capacity = _align(capacity)
        self.num_readers = num_readers
        self.reader_slot = reader_slot
        self.depth = depth
        self._codec = None
        self.last_write_stats: dict = {}
        self.last_read_stats: dict = {}
        stride = _SLOT_HDR + self.capacity
        if create:
            size = _SEG_HDR + depth * stride
            self.seg = ShmSegment(self.name, size, create=True)
            # ftruncate gives zeroed pages: only the header needs writing
            struct.pack_into("<IIII Q", self.seg.buf, 0, _MAGIC, depth,
                             num_readers, 0, self.capacity)
            self._wseq = 0
            self._rseq = 0
        else:
            self.seg = ShmSegment(self.name)
            magic, depth, nr, _, cap = struct.unpack_from(
                "<IIII Q", self.seg.buf, 0)
            if magic != _MAGIC:
                raise RuntimeError(
                    f"channel {self.name}: bad segment magic {magic:#x}")
            self.depth, self.num_readers, self.capacity = depth, nr, int(cap)
            if self.reader_slot is None:
                self.reader_slot = 0  # single-reader attach convenience
            # resume sequences from shm state (crash-restart safe)
            best = -1
            for i in range(self.depth):
                v = self._version(i)
                if v and v % 2 == 0:
                    best = max(best, (v // 2 - 1) * self.depth + i)
            self._wseq = best + 1
            best = -1
            for i in range(self.depth):
                a = self._ack(i, self.reader_slot)
                if a:
                    best = max(best, (a // 2 - 1) * self.depth + i)
            self._rseq = best + 1

    def set_codec(self, codec) -> None:
        """Quantized streaming for float leaves of subsequent writes
        (None / "int8" / "fp8" / "bf16" / QuantCodec)."""
        from ray_tpu_torch.collective.quant import resolve_codec

        self._codec = resolve_codec(codec)

    # -- slot accessors --

    def _slot_base(self, slot: int) -> int:
        return _SEG_HDR + slot * (_SLOT_HDR + self.capacity)

    def _version(self, slot: int) -> int:
        return struct.unpack_from("<Q", self.seg.buf, self._slot_base(slot))[0]

    def _length(self, slot: int) -> int:
        return struct.unpack_from(
            "<Q", self.seg.buf, self._slot_base(slot) + 8)[0]

    def _seq(self, slot: int) -> int:
        return struct.unpack_from(
            "<Q", self.seg.buf, self._slot_base(slot) + 16)[0]

    def _ack(self, slot: int, reader: int) -> int:
        return struct.unpack_from(
            "<Q", self.seg.buf, self._slot_base(slot) + 24 + 8 * reader)[0]

    def _acks(self, slot: int) -> List[int]:
        return [self._ack(slot, i) for i in range(self.num_readers)]

    # -- writer --

    def write(self, value: Any, timeout: Optional[float] = 300.0):
        skel_blob, bufs, stats = _encode_frame(value, self._codec)
        offs, total = _layout(skel_blob, bufs)
        if total > self.capacity:
            raise ValueError(
                f"channel {self.name}: value of {total}B exceeds slot "
                f"capacity {self.capacity}B")
        n = self._wseq
        slot = n % self.depth
        base = self._slot_base(slot)
        sealed = 2 * (n // self.depth) + 2
        version = self._version(slot)
        if version % 2 != 0:
            raise RuntimeError(f"channel {self.name}: concurrent writer")
        # ring backpressure: every reader must have consumed the value that
        # previously occupied this slot (seq n - depth) before overwrite
        t0 = time.perf_counter()
        if n >= self.depth:
            deadline = time.monotonic() + (timeout or 300.0)
            spins = 0
            while any(a < sealed - 2 for a in self._acks(slot)):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"channel {self.name}: reader did not consume value "
                        f"seq {n - self.depth} (slot {slot} version "
                        f"{self._version(slot)}, acks={self._acks(slot)}, "
                        f"want ack >= {sealed - 2})")
                spins += 1
                time.sleep(0 if spins < 2000 else 0.0002)
        stats["ack_wait_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        struct.pack_into("<Q", self.seg.buf, base, sealed - 1)  # odd: writing
        _write_payload(self.seg.buf, base + _SLOT_HDR, skel_blob, bufs, offs)
        struct.pack_into("<QQ", self.seg.buf, base + 8, total, n)
        struct.pack_into("<Q", self.seg.buf, base, sealed)  # even: sealed
        stats["copy_s"] = time.perf_counter() - t0
        stats["wire_bytes"] = total
        self._wseq = n + 1
        self.last_write_stats = stats

    # -- reader --

    def read(self, timeout: float = 300.0) -> Any:
        """Blocks until value ``n`` (this reader's next sequence) is sealed
        in its ring slot, copies it under a consistent version snapshot,
        acks (freeing the writer), THEN deserializes."""
        if self.reader_slot is None:
            raise RuntimeError("attach with reader_slot to read")
        n = self._rseq
        slot = n % self.depth
        base = self._slot_base(slot)
        want = 2 * (n // self.depth) + 2
        deadline = time.monotonic() + timeout
        spins = 0
        t_start = time.perf_counter()
        while True:
            v1 = self._version(slot)
            if v1 == want:
                # length and seq validated UNDER the snapshot: a torn header
                # mid-write must never drive the payload copy
                length = self._length(slot)
                if _PAYLOAD_HDR <= length <= self.capacity \
                        and self._seq(slot) == n:
                    t0 = time.perf_counter()
                    raw = np.empty(length, np.uint8)
                    raw[:] = np.frombuffer(self.seg.buf, np.uint8,
                                           count=length,
                                           offset=base + _SLOT_HDR)
                    if self._version(slot) == v1:  # consistent snapshot
                        t1 = time.perf_counter()
                        # ack BEFORE deserializing: writer backpressure
                        # releases at copy time, decode overlaps the next
                        # upstream write
                        struct.pack_into(
                            "<Q", self.seg.buf,
                            base + 24 + 8 * self.reader_slot, want)
                        self._rseq = n + 1
                        value = _decode_frame(raw)
                        t2 = time.perf_counter()
                        self.last_read_stats = {
                            "wait_s": t0 - t_start, "copy_s": t1 - t0,
                            "decode_s": t2 - t1, "wire_bytes": int(length)}
                        return value
            elif v1 > want:
                raise RuntimeError(
                    f"channel {self.name}: reader {self.reader_slot} lost "
                    f"sync at seq {n} (slot {slot} version {v1} > expected "
                    f"{want}; writer overwrote an unacked value)")
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"channel {self.name}: no value for seq {n} after "
                    f"{timeout}s (slot {slot}: version={self._version(slot)} "
                    f"want={want} len={self._length(slot)} "
                    f"slot_seq={self._seq(slot)} acks={self._acks(slot)})")
            # adaptive: spin hot briefly (hop latency ~µs), then yield
            spins += 1
            time.sleep(0 if spins < 2000 else 0.0002)

    def peek_version(self) -> int:
        return self._version((self._rseq if self.reader_slot is not None
                              else self._wseq) % self.depth)

    def close(self, unlink: bool = False):
        self.seg.close()
        if unlink:
            self.seg.unlink()


class IntraProcessChannel:
    """Same-process channel (reference: intra_process_channel.py)."""

    def __init__(self, depth: int = 1):
        import queue

        self._q = queue.Queue(maxsize=depth)

    def write(self, value, timeout=None):
        self._q.put(value, timeout=timeout)

    def read(self, timeout: float = 300.0):
        return self._q.get(timeout=timeout)

    def close(self, unlink: bool = False):
        pass


# ---------------------------------------------------------------------------
# cross-host channels (reference: the cross-node leg of compiled-graph
# channels, experimental_mutable_object_provider.cc — a writer pushes each
# version to a reader-hosted mailbox; the awaited push is the backpressure)
# ---------------------------------------------------------------------------


class CrossHostWriter:
    """Single writer pushing every value to each reader's worker mailbox
    over the worker RPC plane, as one frame (``frame_bytes``).

    Pushes carry a per-channel sequence number and retry transient RPC
    failures with backoff; the mailbox dedups on the sequence so a retried
    push after an ambiguous failure never double-delivers."""

    def __init__(self, name: str, push_targets):
        from ray_tpu_torch._private import worker as worker_mod

        self.name = name
        self._targets = list(push_targets)  # [(mailbox_name, worker_addr)]
        self._w = worker_mod.global_worker()
        self._seq = 0
        self._codec = None

    def set_codec(self, codec) -> None:
        from ray_tpu_torch.collective.quant import resolve_codec

        self._codec = resolve_codec(codec)

    def write(self, value: Any, timeout: Optional[float] = 300.0):
        import asyncio

        from ray_tpu_torch._private import wire as _p

        blob = frame_bytes(value, self._codec)
        seq = self._seq
        self._seq += 1
        t = timeout or 300.0

        # concurrent fan-out: one slow reader only costs its own mailbox
        # push, not a serial wait in front of every later reader (the
        # bounded mailbox still backpressures the writer per-reader)
        async def _push(mbox, addr):
            msg = _p.dumps({"name": mbox, "blob": blob, "seq": seq})
            delay = 0.05
            for attempt in range(_XHOST_RETRIES + 1):
                try:
                    await self._w._worker_client(addr).call(
                        "ChanPush", msg, timeout=t, retries=0)
                    return
                except asyncio.CancelledError:
                    raise
                except Exception:  # transient RPC surface; idempotent via seq
                    if attempt == _XHOST_RETRIES:
                        raise
                    await asyncio.sleep(delay)
                    delay *= 2

        async def _fanout():
            await asyncio.gather(*[_push(m, a) for m, a in self._targets])

        self._w._run(_fanout(), t * (_XHOST_RETRIES + 1) + 10.0)

    def read(self, timeout: float = 300.0):
        raise RuntimeError("cross-host channel writer cannot read")

    def close(self, unlink: bool = False):
        pass


class CrossHostReader:
    """Reader end: pops from THIS worker's mailbox (values were pushed by
    the remote writer)."""

    def __init__(self, mailbox: str):
        from ray_tpu_torch._private import worker as worker_mod

        self.name = mailbox
        self._w = worker_mod.global_worker()

    def read(self, timeout: float = 300.0) -> Any:
        return decode_bytes(self._w.chan_pop(self.name, timeout))

    def write(self, value, timeout=None):
        raise RuntimeError("cross-host channel reader cannot write")

    def close(self, unlink: bool = False):
        if unlink:
            self._w.chan_close(self.name)


def open_reader(name: str, slot: int, spec: Optional[dict] = None):
    """Channel factory, reader side: shm seqlock ring (same-node) or the
    per-reader cross-host mailbox."""
    if spec and spec.get("type") == "xhost":
        return CrossHostReader(f"{name}@{slot}")
    return Channel(name, reader_slot=slot)


def open_writer(name: str, spec: Optional[dict] = None):
    if spec and spec.get("type") == "xhost":
        return CrossHostWriter(name, spec["push"])
    return Channel(name)
