"""Additional datasources: TFRecord, WebDataset, SQL, HuggingFace, the port
of ``ray_tpu/data/datasources.py``.

Reference: python/ray/data/datasource/ — ``tfrecords_datasource.py``,
``webdataset_datasource.py``, ``sql_datasource.py``, ``read_api.py``
``from_huggingface``. TPU-first notes: TFRecord framing + the
``tf.train.Example`` proto are parsed/emitted with a self-contained wire
codec (no tensorflow dependency in the image), WebDataset shards are plain
tarfiles, and SQL rides any DB-API connection factory. The files are the
JAX package's, byte for byte: either package reads what the other
wrote.
"""

from __future__ import annotations

import functools
import io
import struct
import tarfile
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ray_tpu_torch.data.block import Block, BlockAccessor
from ray_tpu_torch.data.dataset import Dataset, _expand_paths, _make_dataset

# ---------------------------------------------------------------------------
# TFRecord (record framing: tensorflow/core/lib/io/record_writer.cc;
# payloads: tf.train.Example protos)
# ---------------------------------------------------------------------------

_CRC_TABLE: Optional[List[int]] = None


def _crc32c(data: bytes) -> int:
    """Castagnoli CRC (table-driven); TFRecord masks it per record."""
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


def _write_varint(out: bytearray, v: int):
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_varint(buf: bytes, pos: int):
    out = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _tag(field: int, wire: int) -> bytes:
    out = bytearray()
    _write_varint(out, (field << 3) | wire)
    return bytes(out)


def _len_delim(field: int, payload: bytes) -> bytes:
    out = bytearray(_tag(field, 2))
    _write_varint(out, len(payload))
    out += payload
    return bytes(out)


def _encode_feature(value) -> bytes:
    """tf.train.Feature: 1=BytesList 2=FloatList 3=Int64List."""
    if isinstance(value, (bytes, str)):
        value = [value]
    elif isinstance(value, np.ndarray):
        value = value.tolist()
    elif not isinstance(value, (list, tuple)):
        value = [value]
    first = value[0] if value else 0
    if isinstance(first, (bytes, str)):
        inner = b"".join(
            _len_delim(1, v.encode() if isinstance(v, str) else v)
            for v in value)
        return _len_delim(1, inner)
    if isinstance(first, (float, np.floating)):
        packed = struct.pack(f"<{len(value)}f", *[float(v) for v in value])
        return _len_delim(2, _tag(1, 2) + _varint_bytes(len(packed)) + packed)
    packed = bytearray()
    for v in value:
        _write_varint(packed, int(v) & 0xFFFFFFFFFFFFFFFF)
    return _len_delim(3, _tag(1, 2) + _varint_bytes(len(packed))
                      + bytes(packed))


def _varint_bytes(v: int) -> bytes:
    out = bytearray()
    _write_varint(out, v)
    return bytes(out)


def encode_example(row: Dict[str, Any]) -> bytes:
    """Serialize one row as a tf.train.Example proto."""
    entries = b"".join(
        _len_delim(1, _len_delim(1, k.encode()) + _len_delim(
            2, _encode_feature(v)))
        for k, v in row.items())
    return _len_delim(1, entries)  # Example.features


def _parse_packed_floats(buf: bytes) -> List[float]:
    return list(struct.unpack(f"<{len(buf) // 4}f", buf))


def _parse_feature(buf: bytes):
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        ln, pos = _read_varint(buf, pos)
        body = buf[pos:pos + ln]
        pos += ln
        if field == 1:  # BytesList
            out, p = [], 0
            while p < len(body):
                t, p = _read_varint(body, p)
                n, p = _read_varint(body, p)
                out.append(body[p:p + n])
                p += n
            return out[0] if len(out) == 1 else out
        if field == 2:  # FloatList (packed)
            p = 0
            vals: List[float] = []
            while p < len(body):
                t, p = _read_varint(body, p)
                if (t & 7) == 2:
                    n, p = _read_varint(body, p)
                    vals.extend(_parse_packed_floats(body[p:p + n]))
                    p += n
                else:
                    vals.append(struct.unpack("<f", body[p:p + 4])[0])
                    p += 4
            return vals[0] if len(vals) == 1 else vals
        if field == 3:  # Int64List (packed varints)
            p = 0
            ints: List[int] = []
            while p < len(body):
                t, p = _read_varint(body, p)
                if (t & 7) == 2:
                    n, p = _read_varint(body, p)
                    q = p
                    while q < p + n:
                        v, q = _read_varint(body, q)
                        if v >= 1 << 63:
                            v -= 1 << 64
                        ints.append(v)
                    p += n
                else:
                    v, p = _read_varint(body, p)
                    if v >= 1 << 63:
                        v -= 1 << 64
                    ints.append(v)
            return ints[0] if len(ints) == 1 else ints
    return None


def decode_example(buf: bytes) -> Dict[str, Any]:
    row: Dict[str, Any] = {}
    pos = 0
    tag, pos = _read_varint(buf, pos)  # Example.features
    ln, pos = _read_varint(buf, pos)
    feats = buf[pos:pos + ln]
    pos = 0
    while pos < len(feats):
        tag, pos = _read_varint(feats, pos)
        ln, pos = _read_varint(feats, pos)
        entry = feats[pos:pos + ln]
        pos += ln
        key = value = None
        p = 0
        while p < len(entry):
            t, p = _read_varint(entry, p)
            n, p = _read_varint(entry, p)
            body = entry[p:p + n]
            p += n
            if (t >> 3) == 1:
                key = body.decode()
            else:
                value = _parse_feature(body)
        if key is not None:
            row[key] = value
    return row


def _read_tfrecord_file(path: str) -> Block:
    rows = []
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                break
            (length,) = struct.unpack("<Q", header[:8])
            data = f.read(length)
            f.read(4)  # data crc (not verified on read, like the reference)
            rows.append(decode_example(data))
    return BlockAccessor.build_from_rows(rows)


def read_tfrecords(paths, parallelism: int = 8) -> Dataset:
    """Reference: data/datasource/tfrecords_datasource.py (sans tf dep)."""
    files = _expand_paths(paths, (".tfrecords", ".tfrecord"))
    return _make_dataset(
        [functools.partial(_read_tfrecord_file, f) for f in files])


def write_tfrecords(rows: List[Dict[str, Any]], path: str):
    """Emit a TFRecord file readable by tensorflow (masked crc32c frames)."""
    with open(path, "wb") as f:
        for row in rows:
            data = encode_example(row)
            hdr = struct.pack("<Q", len(data))
            f.write(hdr)
            f.write(struct.pack("<I", _masked_crc(hdr)))
            f.write(data)
            f.write(struct.pack("<I", _masked_crc(data)))


# ---------------------------------------------------------------------------
# WebDataset (tar shards, files grouped by key prefix;
# reference: data/datasource/webdataset_datasource.py)
# ---------------------------------------------------------------------------


def _read_webdataset_shard(path: str) -> Block:
    rows: List[Dict[str, Any]] = []
    current: Dict[str, Any] = {}
    key = None
    with tarfile.open(path, "r") as tar:
        for member in tar:
            if not member.isfile():
                continue
            base = member.name.split("/")[-1]
            k, _, suffix = base.partition(".")
            if key is not None and k != key:
                rows.append(current)
                current = {}
            key = k
            data = tar.extractfile(member).read()
            if suffix in ("txt", "cls", "json"):
                try:
                    data = data.decode()
                except UnicodeDecodeError:
                    pass
            current.setdefault("__key__", key)
            current[suffix] = data
    if current:
        rows.append(current)
    return BlockAccessor.build_from_rows(rows)


def read_webdataset(paths, parallelism: int = 8) -> Dataset:
    files = _expand_paths(paths, (".tar",))
    return _make_dataset(
        [functools.partial(_read_webdataset_shard, f) for f in files])


def write_webdataset(rows: List[Dict[str, Any]], path: str):
    with tarfile.open(path, "w") as tar:
        for i, row in enumerate(rows):
            key = row.get("__key__", f"{i:06d}")
            for suffix, value in row.items():
                if suffix == "__key__":
                    continue
                data = value.encode() if isinstance(value, str) else value
                info = tarfile.TarInfo(name=f"{key}.{suffix}")
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))


# ---------------------------------------------------------------------------
# SQL (reference: data/datasource/sql_datasource.py — any DB-API factory)
# ---------------------------------------------------------------------------


def read_sql(sql: str, connection_factory: Callable[[], Any],
             parallelism: int = 1) -> Dataset:
    def _read() -> Block:
        conn = connection_factory()
        try:
            cur = conn.cursor()
            cur.execute(sql)
            cols = [d[0] for d in cur.description]
            rows = [dict(zip(cols, r)) for r in cur.fetchall()]
            return BlockAccessor.build_from_rows(rows)
        finally:
            conn.close()

    return _make_dataset([_read])


# ---------------------------------------------------------------------------
# HuggingFace datasets (reference: read_api.py from_huggingface)
# ---------------------------------------------------------------------------


def from_huggingface(hf_dataset, parallelism: int = 8) -> Dataset:
    """Blocks from an arrow-backed HuggingFace dataset's table (converted
    to the port's Table, each column in its arrow type), else from its
    rows."""
    import ray_tpu_torch.data as rdata

    try:
        table = hf_dataset.data.table
    except AttributeError:
        return rdata.from_items(list(hf_dataset))
    from ray_tpu_torch.data.dataset import _from_arrow, from_blocks

    n = max(1, min(parallelism, table.num_rows or 1))
    step = -(-max(table.num_rows, 1) // n)
    return from_blocks([_from_arrow(table.slice(i, step))
                        for i in range(0, table.num_rows, step)])
