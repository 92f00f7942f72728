"""gRPC over cleartext HTTP/2 with prior knowledge, on the standard library.

The port's gRPC transport (``serve/grpc_ingress.py`` runs on it). The JAX
ingress runs ``grpcio``; the port depends on no third-party package, and
gRPC to the ingress carries no protobuf (bodies are ``wire`` bytes), so
all it takes is HTTP/2 (RFC 9113), HPACK (RFC 7541) and gRPC's framing and
status rules (gRPC's "PROTOCOL-HTTP2"):

* :class:`H2Connection`, a connection's protocol state with no I/O: the
  preface, ``SETTINGS`` and their ACK, ``HEADERS`` split into
  ``CONTINUATION`` frames at the peer's ``SETTINGS_MAX_FRAME_SIZE``,
  ``DATA`` under both flow-control windows (connection and stream) in both
  directions, ``PING`` ACKs, ``WINDOW_UPDATE``, ``RST_STREAM`` and
  ``GOAWAY``. Data the peer's windows do not admit yet waits in the stream
  and goes out as its ``WINDOW_UPDATE`` frames arrive.
* :class:`HpackDecoder` (the static table, the dynamic table with its size
  updates and evictions, Huffman-coded strings with RFC 7541's padding
  rules) and :class:`HpackEncoder` (literals without indexing, no Huffman
  coding, which every decoder reads).
* :class:`GrpcServer`: a server on ``asyncio.start_server`` in a thread of
  its own, whose handlers run on a pool of threads (16, as the JAX
  ingress's ``futures.ThreadPoolExecutor(max_workers=16)``), never on the
  loop. Unary and server-streaming methods; each streamed message is
  flushed as it is yielded; a request message over 4 MiB (grpcio's
  default limit) is answered with ``RESOURCE_EXHAUSTED``;
  ``grpc-timeout`` becomes a deadline answered with ``DEADLINE_EXCEEDED``; a client's ``RST_STREAM`` makes the call's
  ``context.is_active()`` false; a compressed message is answered with
  ``UNIMPLEMENTED``; an error before any message is a trailers-only
  response.
* :class:`GrpcChannel`: a blocking client that multiplexes concurrent
  calls on one connection (a reader thread dispatches frames to the
  calls), with deadlines and cancellation (``RST_STREAM(CANCEL)``).

Failed calls raise :class:`GrpcError`, whose ``code()`` is a
:class:`StatusCode` (gRPC's names and numbers) and ``details()`` the
status message, where ``grpcio`` raises ``grpc.RpcError``.
"""

from __future__ import annotations

import asyncio
import collections
import enum
import queue
import socket
import threading
import time
from concurrent import futures
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

Headers = List[Tuple[str, str]]

# ---------------------------------------------------------------------------
# gRPC status
# ---------------------------------------------------------------------------


class StatusCode(enum.IntEnum):
    """gRPC's status codes, with gRPC's names and numbers."""

    OK = 0
    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    NOT_FOUND = 5
    ALREADY_EXISTS = 6
    PERMISSION_DENIED = 7
    RESOURCE_EXHAUSTED = 8
    FAILED_PRECONDITION = 9
    ABORTED = 10
    OUT_OF_RANGE = 11
    UNIMPLEMENTED = 12
    INTERNAL = 13
    UNAVAILABLE = 14
    DATA_LOSS = 15
    UNAUTHENTICATED = 16


class GrpcError(Exception):
    """A call that ended with a status other than ``OK``."""

    def __init__(self, code: StatusCode, details: str = ""):
        super().__init__(f"{code.name}: {details}")
        self._code = code
        self._details = details

    def code(self) -> StatusCode:
        return self._code

    def details(self) -> str:
        return self._details


def _status(value: str) -> StatusCode:
    try:
        return StatusCode(int(value))
    except ValueError:
        return StatusCode.UNKNOWN


def encode_grpc_message(text: str) -> str:
    """Percent-encode a status message as gRPC sends it: the UTF-8 bytes
    outside 0x20-0x7E, and ``%`` itself."""
    return "".join(chr(b) if 0x20 <= b <= 0x7E and b != 0x25 else f"%{b:02X}"
                   for b in text.encode("utf-8"))


def decode_grpc_message(text: str) -> str:
    raw = text.encode("latin-1", "replace")
    out = bytearray()
    i = 0
    while i < len(raw):
        digits = raw[i + 1:i + 3]
        if raw[i] == 0x25 and len(digits) == 2 and \
                all(c in b"0123456789abcdefABCDEF" for c in digits):
            out.append(int(digits, 16))
            i += 3
        else:
            out.append(raw[i])
            i += 1
    return out.decode("utf-8", "replace")


_TIMEOUT_UNITS = {"H": 3600.0, "M": 60.0, "S": 1.0, "m": 1e-3, "u": 1e-6,
                  "n": 1e-9}


def encode_timeout(seconds: float) -> str:
    """``grpc-timeout``: at most 8 digits and a unit, rounded up."""
    seconds = max(seconds, 0.0)
    for unit, scale in (("n", 1e-9), ("u", 1e-6), ("m", 1e-3), ("S", 1.0),
                        ("M", 60.0), ("H", 3600.0)):
        value = -int(-seconds // scale)
        if value < 10 ** 8:
            return f"{value}{unit}"
    return "99999999H"


def decode_timeout(value: str) -> Optional[float]:
    value = value.strip()
    if len(value) < 2 or value[-1] not in _TIMEOUT_UNITS or \
            not value[:-1].isdigit() or len(value) > 9:
        return None
    return int(value[:-1]) * _TIMEOUT_UNITS[value[-1]]


# ---------------------------------------------------------------------------
# HPACK (RFC 7541)
# ---------------------------------------------------------------------------

_STATIC_TABLE: Tuple[Tuple[str, str], ...] = (
    (":authority", ""), (":method", "GET"), (":method", "POST"),
    (":path", "/"), (":path", "/index.html"), (":scheme", "http"),
    (":scheme", "https"), (":status", "200"), (":status", "204"),
    (":status", "206"), (":status", "304"), (":status", "400"),
    (":status", "404"), (":status", "500"), ("accept-charset", ""),
    ("accept-encoding", "gzip, deflate"), ("accept-language", ""),
    ("accept-ranges", ""), ("accept", ""),
    ("access-control-allow-origin", ""), ("age", ""), ("allow", ""),
    ("authorization", ""), ("cache-control", ""),
    ("content-disposition", ""), ("content-encoding", ""),
    ("content-language", ""), ("content-length", ""),
    ("content-location", ""), ("content-range", ""), ("content-type", ""),
    ("cookie", ""), ("date", ""), ("etag", ""), ("expect", ""),
    ("expires", ""), ("from", ""), ("host", ""), ("if-match", ""),
    ("if-modified-since", ""), ("if-none-match", ""), ("if-range", ""),
    ("if-unmodified-since", ""), ("last-modified", ""), ("link", ""),
    ("location", ""), ("max-forwards", ""), ("proxy-authenticate", ""),
    ("proxy-authorization", ""), ("range", ""), ("referer", ""),
    ("refresh", ""), ("retry-after", ""), ("server", ""),
    ("set-cookie", ""), ("strict-transport-security", ""),
    ("transfer-encoding", ""), ("user-agent", ""), ("vary", ""),
    ("via", ""), ("www-authenticate", ""))

# RFC 7541 Appendix B: the Huffman code of each symbol, as (code, length in
# bits), for the octets 0-255 and EOS (256). Canonical: codes of one length
# are consecutive in symbol order.
HUFFMAN_CODES: Tuple[Tuple[int, int], ...] = (
    (0x1ff8, 13), (0x7fffd8, 23), (0xfffffe2, 28), (0xfffffe3, 28),
    (0xfffffe4, 28), (0xfffffe5, 28), (0xfffffe6, 28), (0xfffffe7, 28),
    (0xfffffe8, 28), (0xffffea, 24), (0x3ffffffc, 30), (0xfffffe9, 28),
    (0xfffffea, 28), (0x3ffffffd, 30), (0xfffffeb, 28), (0xfffffec, 28),
    (0xfffffed, 28), (0xfffffee, 28), (0xfffffef, 28), (0xffffff0, 28),
    (0xffffff1, 28), (0xffffff2, 28), (0x3ffffffe, 30), (0xffffff3, 28),
    (0xffffff4, 28), (0xffffff5, 28), (0xffffff6, 28), (0xffffff7, 28),
    (0xffffff8, 28), (0xffffff9, 28), (0xffffffa, 28), (0xffffffb, 28),
    (0x14, 6), (0x3f8, 10), (0x3f9, 10), (0xffa, 12),
    (0x1ff9, 13), (0x15, 6), (0xf8, 8), (0x7fa, 11),
    (0x3fa, 10), (0x3fb, 10), (0xf9, 8), (0x7fb, 11),
    (0xfa, 8), (0x16, 6), (0x17, 6), (0x18, 6),
    (0x0, 5), (0x1, 5), (0x2, 5), (0x19, 6),
    (0x1a, 6), (0x1b, 6), (0x1c, 6), (0x1d, 6),
    (0x1e, 6), (0x1f, 6), (0x5c, 7), (0xfb, 8),
    (0x7ffc, 15), (0x20, 6), (0xffb, 12), (0x3fc, 10),
    (0x1ffa, 13), (0x21, 6), (0x5d, 7), (0x5e, 7),
    (0x5f, 7), (0x60, 7), (0x61, 7), (0x62, 7),
    (0x63, 7), (0x64, 7), (0x65, 7), (0x66, 7),
    (0x67, 7), (0x68, 7), (0x69, 7), (0x6a, 7),
    (0x6b, 7), (0x6c, 7), (0x6d, 7), (0x6e, 7),
    (0x6f, 7), (0x70, 7), (0x71, 7), (0x72, 7),
    (0xfc, 8), (0x73, 7), (0xfd, 8), (0x1ffb, 13),
    (0x7fff0, 19), (0x1ffc, 13), (0x3ffc, 14), (0x22, 6),
    (0x7ffd, 15), (0x3, 5), (0x23, 6), (0x4, 5),
    (0x24, 6), (0x5, 5), (0x25, 6), (0x26, 6),
    (0x27, 6), (0x6, 5), (0x74, 7), (0x75, 7),
    (0x28, 6), (0x29, 6), (0x2a, 6), (0x7, 5),
    (0x2b, 6), (0x76, 7), (0x2c, 6), (0x8, 5),
    (0x9, 5), (0x2d, 6), (0x77, 7), (0x78, 7),
    (0x79, 7), (0x7a, 7), (0x7b, 7), (0x7ffe, 15),
    (0x7fc, 11), (0x3ffd, 14), (0x1ffd, 13), (0xffffffc, 28),
    (0xfffe6, 20), (0x3fffd2, 22), (0xfffe7, 20), (0xfffe8, 20),
    (0x3fffd3, 22), (0x3fffd4, 22), (0x3fffd5, 22), (0x7fffd9, 23),
    (0x3fffd6, 22), (0x7fffda, 23), (0x7fffdb, 23), (0x7fffdc, 23),
    (0x7fffdd, 23), (0x7fffde, 23), (0xffffeb, 24), (0x7fffdf, 23),
    (0xffffec, 24), (0xffffed, 24), (0x3fffd7, 22), (0x7fffe0, 23),
    (0xffffee, 24), (0x7fffe1, 23), (0x7fffe2, 23), (0x7fffe3, 23),
    (0x7fffe4, 23), (0x1fffdc, 21), (0x3fffd8, 22), (0x7fffe5, 23),
    (0x3fffd9, 22), (0x7fffe6, 23), (0x7fffe7, 23), (0xffffef, 24),
    (0x3fffda, 22), (0x1fffdd, 21), (0xfffe9, 20), (0x3fffdb, 22),
    (0x3fffdc, 22), (0x7fffe8, 23), (0x7fffe9, 23), (0x1fffde, 21),
    (0x7fffea, 23), (0x3fffdd, 22), (0x3fffde, 22), (0xfffff0, 24),
    (0x1fffdf, 21), (0x3fffdf, 22), (0x7fffeb, 23), (0x7fffec, 23),
    (0x1fffe0, 21), (0x1fffe1, 21), (0x3fffe0, 22), (0x1fffe2, 21),
    (0x7fffed, 23), (0x3fffe1, 22), (0x7fffee, 23), (0x7fffef, 23),
    (0xfffea, 20), (0x3fffe2, 22), (0x3fffe3, 22), (0x3fffe4, 22),
    (0x7ffff0, 23), (0x3fffe5, 22), (0x3fffe6, 22), (0x7ffff1, 23),
    (0x3ffffe0, 26), (0x3ffffe1, 26), (0xfffeb, 20), (0x7fff1, 19),
    (0x3fffe7, 22), (0x7ffff2, 23), (0x3fffe8, 22), (0x1ffffec, 25),
    (0x3ffffe2, 26), (0x3ffffe3, 26), (0x3ffffe4, 26), (0x7ffffde, 27),
    (0x7ffffdf, 27), (0x3ffffe5, 26), (0xfffff1, 24), (0x1ffffed, 25),
    (0x7fff2, 19), (0x1fffe3, 21), (0x3ffffe6, 26), (0x7ffffe0, 27),
    (0x7ffffe1, 27), (0x3ffffe7, 26), (0x7ffffe2, 27), (0xfffff2, 24),
    (0x1fffe4, 21), (0x1fffe5, 21), (0x3ffffe8, 26), (0x3ffffe9, 26),
    (0xffffffd, 28), (0x7ffffe3, 27), (0x7ffffe4, 27), (0x7ffffe5, 27),
    (0xfffec, 20), (0xfffff3, 24), (0xfffed, 20), (0x1fffe6, 21),
    (0x3fffe9, 22), (0x1fffe7, 21), (0x1fffe8, 21), (0x7ffff3, 23),
    (0x3fffea, 22), (0x3fffeb, 22), (0x1ffffee, 25), (0x1ffffef, 25),
    (0xfffff4, 24), (0xfffff5, 24), (0x3ffffea, 26), (0x7ffff4, 23),
    (0x3ffffeb, 26), (0x7ffffe6, 27), (0x3ffffec, 26), (0x3ffffed, 26),
    (0x7ffffe7, 27), (0x7ffffe8, 27), (0x7ffffe9, 27), (0x7ffffea, 27),
    (0x7ffffeb, 27), (0xffffffe, 28), (0x7ffffec, 27), (0x7ffffed, 27),
    (0x7ffffee, 27), (0x7ffffef, 27), (0x7fffff0, 27), (0x3ffffee, 26),
    (0x3fffffff, 30),
)

_EOS = 256


def _huffman_tables():
    """Per code length: the first code, the number of codes, and their
    symbols in code order (canonical decoding)."""
    by_len: Dict[int, List[Tuple[int, int]]] = collections.defaultdict(list)
    for sym, (code, n) in enumerate(HUFFMAN_CODES):
        by_len[n].append((code, sym))
    table = []
    for n in sorted(by_len):
        entries = sorted(by_len[n])
        table.append((n, entries[0][0], len(entries),
                      tuple(s for _, s in entries)))
    return tuple(table)


_HUFFMAN_BY_LEN = _huffman_tables()


class HpackError(ValueError):
    """A header block that does not decode (a COMPRESSION_ERROR)."""


def huffman_decode(data: bytes) -> bytes:
    """Decode a Huffman-coded string. Raises :class:`HpackError` on EOS in
    the string, padding longer than 7 bits, or padding that is not the
    most significant bits of EOS (all ones)."""
    out = bytearray()
    acc = 0  # the bits not decoded yet, nbits of them
    nbits = 0
    for byte in data:
        acc = (acc << 8) | byte
        nbits += 8
        decoded = True
        while decoded:
            decoded = False
            for n, first, count, symbols in _HUFFMAN_BY_LEN:
                if n > nbits:
                    break  # the next symbol needs more bytes
                code = acc >> (nbits - n)
                if code - first < count:
                    sym = symbols[code - first]
                    if sym == _EOS:
                        raise HpackError("EOS in a Huffman-coded string")
                    out.append(sym)
                    nbits -= n
                    acc &= (1 << nbits) - 1
                    decoded = True
                    break
    if nbits > 7:
        raise HpackError("Huffman padding longer than 7 bits")
    if acc != (1 << nbits) - 1:
        raise HpackError("Huffman padding is not a prefix of EOS")
    return bytes(out)


def _decode_int(data: bytes, pos: int, prefix: int) -> Tuple[int, int]:
    """RFC 7541 5.1: an integer with a ``prefix``-bit prefix at
    ``data[pos]``; returns (value, next position)."""
    if pos >= len(data):
        raise HpackError("truncated integer")
    mask = (1 << prefix) - 1
    value = data[pos] & mask
    pos += 1
    if value < mask:
        return value, pos
    shift = 0
    while True:
        if pos >= len(data):
            raise HpackError("truncated integer")
        b = data[pos]
        pos += 1
        value += (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value, pos
        if shift > 56:
            raise HpackError("integer too large")


def _encode_int(value: int, prefix: int, flags: int) -> bytes:
    mask = (1 << prefix) - 1
    if value < mask:
        return bytes((flags | value,))
    out = bytearray((flags | mask,))
    value -= mask
    while value >= 0x80:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


# SETTINGS_HEADER_TABLE_SIZE's initial value (RFC 9113 6.5.2); this side
# never advertises another
HEADER_TABLE_SIZE = 4096


class HpackDecoder:
    """Header block decoder with the dynamic table, which holds at most
    :data:`HEADER_TABLE_SIZE` octets; size updates above it are refused.
    ``huffman_strings`` counts the strings that arrived Huffman-coded."""

    def __init__(self):
        self.table_size = HEADER_TABLE_SIZE  # the encoder's current limit
        self._dynamic: collections.deque = collections.deque()
        self._size = 0
        self.huffman_strings = 0

    def _add(self, name: str, value: str) -> None:
        # RFC 7541 4.1 counts octets: a latin-1 str has one char per octet
        size = len(name) + len(value) + 32
        if size > self.table_size:
            self._dynamic.clear()  # an entry larger than the table empties it
            self._size = 0
            return
        self._dynamic.appendleft((name, value, size))
        self._size += size
        self._evict()

    def _evict(self) -> None:
        while self._size > self.table_size:
            *_, size = self._dynamic.pop()
            self._size -= size

    def _entry(self, index: int) -> Tuple[str, str]:
        if index <= 0:
            raise HpackError("header index 0")
        if index <= len(_STATIC_TABLE):
            return _STATIC_TABLE[index - 1]
        i = index - len(_STATIC_TABLE) - 1
        if i >= len(self._dynamic):
            raise HpackError(f"header index {index} beyond the tables")
        name, value, _ = self._dynamic[i]
        return name, value

    def _string(self, data: bytes, pos: int) -> Tuple[str, int]:
        if pos >= len(data):
            raise HpackError("truncated string")
        huffman = data[pos] & 0x80
        n, pos = _decode_int(data, pos, 7)
        if pos + n > len(data):
            raise HpackError("truncated string")
        raw = data[pos:pos + n]
        if huffman:
            raw = huffman_decode(raw)
            self.huffman_strings += 1
        return raw.decode("latin-1"), pos + n

    def decode(self, data: bytes) -> Headers:
        headers: Headers = []
        pos = 0
        seen_field = False
        while pos < len(data):
            b = data[pos]
            if b & 0x80:  # indexed field
                index, pos = _decode_int(data, pos, 7)
                headers.append(self._entry(index))
            elif b & 0x40:  # literal with incremental indexing
                index, pos = _decode_int(data, pos, 6)
                if index:
                    name = self._entry(index)[0]
                else:
                    name, pos = self._string(data, pos)
                value, pos = self._string(data, pos)
                headers.append((name, value))
                self._add(name, value)
            elif b & 0x20:  # dynamic table size update
                if seen_field:
                    raise HpackError("table size update after a field")
                size, pos = _decode_int(data, pos, 5)
                if size > HEADER_TABLE_SIZE:
                    raise HpackError(f"table size {size} above the "
                                     f"advertised {HEADER_TABLE_SIZE}")
                self.table_size = size
                self._evict()
                continue
            else:  # literal without indexing (0000) or never indexed (0001)
                index, pos = _decode_int(data, pos, 4)
                if index:
                    name = self._entry(index)[0]
                else:
                    name, pos = self._string(data, pos)
                value, pos = self._string(data, pos)
                headers.append((name, value))
            seen_field = True
        return headers


_STATIC_NAMES: Dict[str, int] = {}
for _i, (_name, _value) in enumerate(_STATIC_TABLE):
    _STATIC_NAMES.setdefault(_name, _i + 1)
_STATIC_PAIRS = {pair: i + 1 for i, pair in enumerate(_STATIC_TABLE)}


class HpackEncoder:
    """Header block encoder: an exact static-table match is indexed, every
    other field is a literal without indexing (the name indexed where the
    static table has it), and no string is Huffman-coded. It keeps no
    dynamic table, so the peer's table size needs no update."""

    @staticmethod
    def _string(text: str) -> bytes:
        raw = text.encode("latin-1")
        return _encode_int(len(raw), 7, 0x00) + raw

    def encode(self, headers: Headers) -> bytes:
        out = bytearray()
        for name, value in headers:
            index = _STATIC_PAIRS.get((name, value))
            if index:
                out += _encode_int(index, 7, 0x80)
                continue
            index = _STATIC_NAMES.get(name, 0)
            out += _encode_int(index, 4, 0x00)
            if not index:
                out += self._string(name)
            out += self._string(value)
        return bytes(out)


# ---------------------------------------------------------------------------
# HTTP/2 framing and flow control (RFC 9113), with no I/O
# ---------------------------------------------------------------------------

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

DATA, HEADERS, PRIORITY, RST_STREAM, SETTINGS = 0x0, 0x1, 0x2, 0x3, 0x4
PUSH_PROMISE, PING, GOAWAY, WINDOW_UPDATE, CONTINUATION = 0x5, 0x6, 0x7, \
    0x8, 0x9

FLAG_END_STREAM = 0x1
FLAG_ACK = 0x1
FLAG_END_HEADERS = 0x4
FLAG_PADDED = 0x8
FLAG_PRIORITY = 0x20

SETTINGS_HEADER_TABLE_SIZE = 0x1
SETTINGS_ENABLE_PUSH = 0x2
SETTINGS_MAX_CONCURRENT_STREAMS = 0x3
SETTINGS_INITIAL_WINDOW_SIZE = 0x4
SETTINGS_MAX_FRAME_SIZE = 0x5
SETTINGS_MAX_HEADER_LIST_SIZE = 0x6

NO_ERROR, PROTOCOL_ERROR, INTERNAL_ERROR, FLOW_CONTROL_ERROR = 0, 1, 2, 3
STREAM_CLOSED, FRAME_SIZE_ERROR, CANCEL, COMPRESSION_ERROR = 5, 6, 8, 9

DEFAULT_WINDOW = 65535
DEFAULT_MAX_FRAME = 16384
MAX_WINDOW = (1 << 31) - 1
# what this side lets a peer send before it hears more: the windows are
# given back as data arrives, so they bound a burst, not a message
LOCAL_STREAM_WINDOW = 1 << 22
LOCAL_CONNECTION_WINDOW = 1 << 24


class H2ProtocolError(Exception):
    """A connection error: the connection ends with ``GOAWAY(code)``."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


def _frame(kind: int, flags: int, stream_id: int,
           payload: bytes = b"") -> bytes:
    return (len(payload).to_bytes(3, "big") + bytes((kind, flags))
            + stream_id.to_bytes(4, "big") + payload)


class _Stream:
    __slots__ = ("id", "send_window", "out", "end_queued", "closed_local",
                 "closed_remote", "consumed")

    def __init__(self, stream_id: int, send_window: int):
        self.id = stream_id
        self.send_window = send_window
        # queued frames: ("headers", block, end_stream) or
        # ("data", memoryview, end_stream)
        self.out: collections.deque = collections.deque()
        self.end_queued = False
        self.closed_local = False
        self.closed_remote = False
        self.consumed = 0  # DATA bytes received and not yet given back


class H2Connection:
    """One HTTP/2 connection's state, either side, with no I/O: feed it the
    bytes that arrive (:meth:`receive`, which returns events) and write out
    what :meth:`data_to_send` returns after every call.

    Events: ``("headers", stream_id, headers, end_stream)``, ``("data",
    stream_id, bytes, end_stream)``, ``("reset", stream_id, error_code)``
    and ``("goaway", last_stream_id, error_code)``."""

    def __init__(self, client: bool):
        self.client = client
        self.encoder = HpackEncoder()
        self.decoder = HpackDecoder()
        self.peer_initial_window = DEFAULT_WINDOW
        self.peer_max_frame = DEFAULT_MAX_FRAME
        self.send_window = DEFAULT_WINDOW  # the connection's, toward the peer
        self.streams: Dict[int, _Stream] = {}
        self.next_stream_id = 1
        self.highest_peer_stream = 0
        self.goaway_received = False
        self._out = bytearray()
        self._in = bytearray()
        self._preface_pending = not client
        self._block: Optional[list] = None  # [stream_id, end_stream, bytes]
        self._conn_consumed = 0

    # -- output ------------------------------------------------------------

    def initiate(self) -> None:
        """The preface (a client's magic, then either side's SETTINGS) and
        the connection window raised to this side's."""
        if self.client:
            self._out += PREFACE
        settings = [(SETTINGS_INITIAL_WINDOW_SIZE, LOCAL_STREAM_WINDOW)]
        if self.client:
            settings.append((SETTINGS_ENABLE_PUSH, 0))
        self._out += _frame(SETTINGS, 0, 0, b"".join(
            k.to_bytes(2, "big") + v.to_bytes(4, "big") for k, v in settings))
        self._out += _frame(WINDOW_UPDATE, 0, 0, (
            LOCAL_CONNECTION_WINDOW - DEFAULT_WINDOW).to_bytes(4, "big"))

    def data_to_send(self) -> bytes:
        out = bytes(self._out)
        self._out.clear()
        return out

    def new_stream_id(self) -> int:
        sid = self.next_stream_id
        self.next_stream_id += 2
        self.streams[sid] = _Stream(sid, self.peer_initial_window)
        return sid

    def send_headers(self, stream_id: int, headers: Headers,
                     end_stream: bool = False) -> bool:
        """Queue a header block (request, response or trailers); False
        when the stream is gone or ended."""
        s = self.streams.get(stream_id)
        if s is None or s.end_queued:
            return False
        s.out.append(("headers", self.encoder.encode(headers), end_stream))
        s.end_queued = end_stream
        self._flush()
        return True

    def send_data(self, stream_id: int, data: bytes,
                  end_stream: bool = False) -> bool:
        """Queue data; what the windows admit goes out now, the rest as
        the peer's WINDOW_UPDATE frames arrive."""
        s = self.streams.get(stream_id)
        if s is None or s.end_queued:
            return False
        s.out.append(("data", memoryview(data), end_stream))
        s.end_queued = end_stream
        self._flush()
        return True

    def reset_stream(self, stream_id: int, code: int) -> None:
        s = self.streams.pop(stream_id, None)
        if s is not None:
            self._out += _frame(RST_STREAM, 0, stream_id,
                                code.to_bytes(4, "big"))

    def close(self, code: int, message: str = "") -> None:
        last = self.highest_peer_stream
        self._out += _frame(GOAWAY, 0, 0, last.to_bytes(4, "big")
                            + code.to_bytes(4, "big")
                            + message.encode("utf-8", "replace"))

    def _emit_headers(self, s: _Stream, block: bytes, end_stream: bool):
        n = self.peer_max_frame
        chunks = [block[i:i + n] for i in range(0, len(block), n)] or [b""]
        flags = FLAG_END_STREAM if end_stream else 0
        if len(chunks) == 1:
            flags |= FLAG_END_HEADERS
        self._out += _frame(HEADERS, flags, s.id, chunks[0])
        for i, chunk in enumerate(chunks[1:], 2):
            self._out += _frame(CONTINUATION,
                                FLAG_END_HEADERS if i == len(chunks) else 0,
                                s.id, chunk)

    def _flush(self) -> None:
        for s in list(self.streams.values()):
            while s.out:
                kind, payload, end = s.out[0]
                if kind == "headers":
                    self._emit_headers(s, payload, end)
                    s.out.popleft()
                else:
                    if len(payload) == 0:
                        self._out += _frame(DATA, FLAG_END_STREAM if end
                                            else 0, s.id)
                        s.out.popleft()
                    else:
                        n = min(len(payload), s.send_window,
                                self.send_window, self.peer_max_frame)
                        if n <= 0:
                            break
                        last = n == len(payload)
                        self._out += _frame(
                            DATA, FLAG_END_STREAM if end and last else 0,
                            s.id, bytes(payload[:n]))
                        s.send_window -= n
                        self.send_window -= n
                        if last:
                            s.out.popleft()
                        else:
                            s.out[0] = (kind, payload[n:], end)
                            continue
                if end:
                    s.closed_local = True
            self._maybe_forget(s)

    def _maybe_forget(self, s: _Stream) -> None:
        if s.closed_local and s.closed_remote and not s.out:
            self.streams.pop(s.id, None)

    # -- input -------------------------------------------------------------

    def receive(self, data: bytes) -> list:
        """Take the bytes that arrived; returns the events they complete.
        Raises :class:`H2ProtocolError` on a connection error (then send
        ``close(e.code)`` and drop the connection)."""
        self._in += data
        events: list = []
        if self._preface_pending:
            if len(self._in) < len(PREFACE):
                if not PREFACE.startswith(bytes(self._in)):
                    raise H2ProtocolError(PROTOCOL_ERROR, "bad preface")
                return events
            if bytes(self._in[:len(PREFACE)]) != PREFACE:
                raise H2ProtocolError(PROTOCOL_ERROR, "bad preface")
            del self._in[:len(PREFACE)]
            self._preface_pending = False
        buf = self._in
        pos = 0
        while len(buf) - pos >= 9:
            length = int.from_bytes(buf[pos:pos + 3], "big")
            if length > DEFAULT_MAX_FRAME:
                raise H2ProtocolError(FRAME_SIZE_ERROR,
                                      f"frame of {length} bytes")
            if len(buf) - pos < 9 + length:
                break
            kind, flags = buf[pos + 3], buf[pos + 4]
            sid = int.from_bytes(buf[pos + 5:pos + 9], "big") & 0x7FFFFFFF
            payload = bytes(buf[pos + 9:pos + 9 + length])
            pos += 9 + length
            self._on_frame(kind, flags, sid, payload, events)
        del buf[:pos]
        self._give_back()
        return events

    def _give_back(self) -> None:
        """WINDOW_UPDATE for what arrived: the connection's always, a
        stream's while the peer may still send on it."""
        if self._conn_consumed:
            self._out += _frame(WINDOW_UPDATE, 0, 0,
                                self._conn_consumed.to_bytes(4, "big"))
            self._conn_consumed = 0
        for s in self.streams.values():
            if s.consumed:
                if not s.closed_remote:
                    self._out += _frame(WINDOW_UPDATE, 0, s.id,
                                        s.consumed.to_bytes(4, "big"))
                s.consumed = 0

    @staticmethod
    def _strip_padding(flags: int, payload: bytes) -> bytes:
        if not flags & FLAG_PADDED:
            return payload
        if not payload or payload[0] >= len(payload):
            raise H2ProtocolError(PROTOCOL_ERROR, "bad padding")
        return payload[1:len(payload) - payload[0]]

    def _on_frame(self, kind, flags, sid, payload, events) -> None:
        if self._block is not None and kind != CONTINUATION:
            raise H2ProtocolError(PROTOCOL_ERROR,
                                  "header block interrupted")
        if kind == DATA:
            if sid == 0:
                raise H2ProtocolError(PROTOCOL_ERROR, "DATA on stream 0")
            self._conn_consumed += len(payload)
            data = self._strip_padding(flags, payload)
            s = self.streams.get(sid)
            if s is None or s.closed_remote:
                if s is None and not self._known_closed(sid):
                    raise H2ProtocolError(PROTOCOL_ERROR,
                                          f"DATA on idle stream {sid}")
                return
            s.consumed += len(payload)
            end = bool(flags & FLAG_END_STREAM)
            if end:
                s.closed_remote = True
            events.append(("data", sid, data, end))
            if end:
                self._maybe_forget(s)
        elif kind == HEADERS:
            if sid == 0:
                raise H2ProtocolError(PROTOCOL_ERROR, "HEADERS on stream 0")
            block = self._strip_padding(flags, payload)
            if flags & FLAG_PRIORITY:
                block = block[5:]
            self._block = [sid, bool(flags & FLAG_END_STREAM),
                           bytearray(block)]
            if flags & FLAG_END_HEADERS:
                self._end_block(events)
        elif kind == CONTINUATION:
            if self._block is None or self._block[0] != sid:
                raise H2ProtocolError(PROTOCOL_ERROR,
                                      "CONTINUATION out of place")
            self._block[2] += payload
            if flags & FLAG_END_HEADERS:
                self._end_block(events)
        elif kind == RST_STREAM:
            if sid == 0 or len(payload) != 4:
                raise H2ProtocolError(PROTOCOL_ERROR, "bad RST_STREAM")
            if self.streams.pop(sid, None) is not None:
                events.append(("reset", sid, int.from_bytes(payload, "big")))
        elif kind == SETTINGS:
            self._on_settings(flags, sid, payload)
        elif kind == PING:
            if sid != 0 or len(payload) != 8:
                raise H2ProtocolError(PROTOCOL_ERROR, "bad PING")
            if not flags & FLAG_ACK:
                self._out += _frame(PING, FLAG_ACK, 0, payload)
        elif kind == GOAWAY:
            if len(payload) < 8:
                raise H2ProtocolError(FRAME_SIZE_ERROR, "bad GOAWAY")
            self.goaway_received = True
            events.append(("goaway",
                           int.from_bytes(payload[:4], "big") & 0x7FFFFFFF,
                           int.from_bytes(payload[4:8], "big")))
        elif kind == WINDOW_UPDATE:
            if len(payload) != 4:
                raise H2ProtocolError(FRAME_SIZE_ERROR, "bad WINDOW_UPDATE")
            inc = int.from_bytes(payload, "big") & 0x7FFFFFFF
            if sid == 0:
                if inc == 0:
                    raise H2ProtocolError(PROTOCOL_ERROR,
                                          "WINDOW_UPDATE of 0")
                self.send_window += inc
                if self.send_window > MAX_WINDOW:
                    raise H2ProtocolError(FLOW_CONTROL_ERROR,
                                          "connection window overflow")
            else:
                s = self.streams.get(sid)
                if s is not None:
                    if inc == 0 or s.send_window + inc > MAX_WINDOW:
                        self.reset_stream(sid, PROTOCOL_ERROR if inc == 0
                                          else FLOW_CONTROL_ERROR)
                        events.append(("reset", sid, PROTOCOL_ERROR))
                        return
                    s.send_window += inc
            self._flush()
        elif kind == PUSH_PROMISE:
            raise H2ProtocolError(PROTOCOL_ERROR, "PUSH_PROMISE refused")
        # PRIORITY and unknown frame types are ignored

    def _known_closed(self, sid: int) -> bool:
        if (sid % 2 == 1) == self.client:
            return sid < self.next_stream_id
        return sid <= self.highest_peer_stream

    def _end_block(self, events) -> None:
        sid, end, block = self._block
        self._block = None
        try:
            headers = self.decoder.decode(bytes(block))
        except HpackError as e:
            raise H2ProtocolError(COMPRESSION_ERROR, str(e))
        s = self.streams.get(sid)
        if s is None:
            if self.client or sid % 2 == 0 or sid <= self.highest_peer_stream:
                return  # a stream this side already reset or finished
            self.highest_peer_stream = sid
            s = self.streams[sid] = _Stream(sid, self.peer_initial_window)
        if s.closed_remote:
            return
        if end:
            s.closed_remote = True
        events.append(("headers", sid, headers, end))
        if end:
            self._maybe_forget(s)

    def _on_settings(self, flags, sid, payload) -> None:
        if sid != 0:
            raise H2ProtocolError(PROTOCOL_ERROR, "SETTINGS on a stream")
        if flags & FLAG_ACK:
            if payload:
                raise H2ProtocolError(FRAME_SIZE_ERROR, "SETTINGS ACK body")
            return
        if len(payload) % 6:
            raise H2ProtocolError(FRAME_SIZE_ERROR, "bad SETTINGS")
        for i in range(0, len(payload), 6):
            key = int.from_bytes(payload[i:i + 2], "big")
            value = int.from_bytes(payload[i + 2:i + 6], "big")
            if key == SETTINGS_INITIAL_WINDOW_SIZE:
                if value > MAX_WINDOW:
                    raise H2ProtocolError(FLOW_CONTROL_ERROR,
                                          "initial window too large")
                delta = value - self.peer_initial_window
                self.peer_initial_window = value
                for s in self.streams.values():
                    s.send_window += delta
            elif key == SETTINGS_MAX_FRAME_SIZE:
                if not DEFAULT_MAX_FRAME <= value <= (1 << 24) - 1:
                    raise H2ProtocolError(PROTOCOL_ERROR,
                                          "bad SETTINGS_MAX_FRAME_SIZE")
                self.peer_max_frame = value
            elif key == SETTINGS_ENABLE_PUSH and value > 1:
                raise H2ProtocolError(PROTOCOL_ERROR,
                                      "bad SETTINGS_ENABLE_PUSH")
        self._out += _frame(SETTINGS, FLAG_ACK, 0)
        self._flush()


# ---------------------------------------------------------------------------
# gRPC messages
# ---------------------------------------------------------------------------


def frame_message(payload: bytes) -> bytes:
    """gRPC's 5-byte prefix: an uncompressed flag and the length."""
    return b"\x00" + len(payload).to_bytes(4, "big") + payload


class MessageReader:
    """Cuts a stream's DATA into gRPC messages. Raises :class:`GrpcError`:
    ``UNIMPLEMENTED`` on a compressed message, ``RESOURCE_EXHAUSTED`` as
    soon as a prefix announces a message over ``limit`` bytes."""

    def __init__(self, limit: Optional[int] = None):
        self._buf = bytearray()
        self._limit = limit

    def feed(self, data: bytes) -> List[bytes]:
        self._buf += data
        out = []
        while len(self._buf) >= 5:
            n = int.from_bytes(self._buf[1:5], "big")
            if self._limit is not None and n > self._limit:
                # grpcio's server's words, so the JAX ingress's equal these
                raise GrpcError(StatusCode.RESOURCE_EXHAUSTED,
                                f"SERVER: Received message larger than max "
                                f"({n} vs. {self._limit})")
            if len(self._buf) < 5 + n:
                break
            if self._buf[0] & 1:
                raise GrpcError(StatusCode.UNIMPLEMENTED,
                                "compressed messages are not supported")
            out.append(bytes(self._buf[5:5 + n]))
            del self._buf[:5 + n]
        return out

    @property
    def partial(self) -> bool:
        return bool(self._buf)


def _identity(x):
    return x


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------


class RpcMethodHandler(collections.namedtuple(
        "RpcMethodHandler", "kind behavior request_deserializer "
        "response_serializer")):
    """What a service returns for a method path: ``kind`` is
    ``"unary_unary"`` or ``"unary_stream"``; ``behavior(request, context)``
    returns the response (unary) or yields them (stream)."""


def unary_unary_rpc_method_handler(behavior, request_deserializer=None,
                                   response_serializer=None):
    return RpcMethodHandler("unary_unary", behavior,
                            request_deserializer or _identity,
                            response_serializer or _identity)


def unary_stream_rpc_method_handler(behavior, request_deserializer=None,
                                    response_serializer=None):
    return RpcMethodHandler("unary_stream", behavior,
                            request_deserializer or _identity,
                            response_serializer or _identity)


HandlerCallDetails = collections.namedtuple("HandlerCallDetails", "method")


class _Abort(Exception):
    def __init__(self, code: StatusCode, details: str):
        super().__init__(details)
        self.code = code
        self.details = details


class ServicerContext:
    """A handler's view of its call."""

    def __init__(self, call: "_ServerCall"):
        self._call = call

    def is_active(self) -> bool:
        """False once the client cancelled, the connection dropped, the
        deadline passed or the call was answered."""
        return self._call.active

    def abort(self, code: StatusCode, details: str = ""):
        """End the call with ``code`` and ``details``; raises, as
        grpcio's ``context.abort`` does."""
        raise _Abort(StatusCode(code), details)


class _ServerCall:
    __slots__ = ("sid", "handler", "timer", "reader", "messages", "active",
                 "open", "headers_sent")

    def __init__(self, sid: int):
        self.sid = sid
        self.handler: Optional[RpcMethodHandler] = None
        self.timer = None  # the deadline's, on the loop
        self.reader = MessageReader(MAX_REQUEST_MESSAGE)
        self.messages: List[bytes] = []
        self.active = True  # what context.is_active() reads, from threads
        self.open = True  # the response not ended yet (loop only)
        self.headers_sent = False


_RESPONSE_HEADERS = [(":status", "200"), ("content-type", "application/grpc")]
# as the JAX ingress's grpcio server: 16 handler threads, requests of at
# most 4 MiB (grpcio's default max_receive_message_length)
_HANDLER_THREADS = 16
MAX_REQUEST_MESSAGE = 4 << 20


class _ServerConnection:
    """One client connection, on the server's loop."""

    def __init__(self, server: "GrpcServer", writer: asyncio.StreamWriter):
        self.server = server
        self.writer = writer
        self.h2 = H2Connection(client=False)
        self.calls: Dict[int, _ServerCall] = {}

    def flush(self) -> None:
        data = self.h2.data_to_send()
        if data and not self.writer.is_closing():
            self.writer.write(data)

    async def serve(self, reader: asyncio.StreamReader) -> None:
        self.h2.initiate()
        self.flush()
        try:
            while True:
                data = await reader.read(1 << 16)
                if not data:
                    break
                try:
                    events = self.h2.receive(data)
                except H2ProtocolError as e:
                    self.h2.close(e.code, str(e))
                    self.flush()
                    break
                for event in events:
                    self._on_event(event)
                self.flush()
        except OSError:
            pass  # the client went away
        finally:
            for call in self.calls.values():
                call.active = False
                call.open = False
                if call.timer is not None:
                    call.timer.cancel()
            self.calls.clear()
            self.writer.close()

    def _on_event(self, event) -> None:
        kind, sid = event[0], event[1]
        if kind == "headers":
            call = self.calls.get(sid)
            if call is None:
                self._new_call(sid, event[2], event[3])
            elif event[3]:  # trailers from the client end its side
                self._dispatch(call)
        elif kind == "data":
            call = self.calls.get(sid)
            if call is None or call.handler is None:
                return
            try:
                call.messages += call.reader.feed(event[2])
            except GrpcError as e:
                self.finish(call, e.code(), e.details())
                return
            if event[3]:
                self._dispatch(call)
        elif kind == "reset":
            call = self.calls.pop(sid, None)
            if call is not None:
                call.active = False
                call.open = False
                if call.timer is not None:
                    call.timer.cancel()

    def _new_call(self, sid: int, headers: Headers, end: bool) -> None:
        fields = dict(headers)
        if fields.get(":method") != "POST" or not fields.get(
                "content-type", "").startswith("application/grpc"):
            status = "405" if fields.get(":method") != "POST" else "415"
            self.h2.send_headers(sid, [(":status", status)], end_stream=True)
            return
        path = fields.get(":path", "")
        call = self.calls[sid] = _ServerCall(sid)
        timeout = decode_timeout(fields.get("grpc-timeout", ""))
        if timeout is not None:
            call.timer = asyncio.get_running_loop().call_later(
                timeout, self._expire, call)
        try:
            handler = self.server.service(HandlerCallDetails(path))
        except Exception as e:
            self.finish(call, StatusCode.INTERNAL, f"service lookup: {e}")
            return
        if handler is None:
            self.finish(call, StatusCode.UNIMPLEMENTED, "Method not found!")
            return
        call.handler = handler
        if end:
            self._dispatch(call)

    def _dispatch(self, call: _ServerCall) -> None:
        if not call.open or call.handler is None:
            return
        if len(call.messages) != 1 or call.reader.partial:
            partial = " and a partial one" if call.reader.partial else ""
            self.finish(call, StatusCode.INTERNAL,
                        f"expected one request message, got "
                        f"{len(call.messages)}{partial}")
            return
        request, call.messages = call.messages[0], []
        self.server.pool.submit(self.server.run_call, self, call, request)

    def _expire(self, call: _ServerCall) -> None:
        call.timer = None
        if call.open:
            self.finish(call, StatusCode.DEADLINE_EXCEEDED,
                        "Deadline Exceeded")
            self.flush()

    def send_message(self, call: _ServerCall, payload: bytes) -> None:
        if not call.open:
            return
        if not call.headers_sent:
            call.headers_sent = True
            self.h2.send_headers(call.sid, _RESPONSE_HEADERS)
        self.h2.send_data(call.sid, frame_message(payload))
        self.flush()

    def finish(self, call: _ServerCall, code: StatusCode,
               details: str = "") -> None:
        """The status: trailers after the messages, or a trailers-only
        response where no message went out."""
        if not call.open:
            return
        call.open = False
        call.active = False
        if call.timer is not None:
            call.timer.cancel()
            call.timer = None
        self.calls.pop(call.sid, None)
        trailers = [("grpc-status", str(int(code)))]
        if details:
            trailers.append(("grpc-message", encode_grpc_message(details)))
        if not call.headers_sent:
            trailers = _RESPONSE_HEADERS + trailers
        self.h2.send_headers(call.sid, trailers, end_stream=True)
        self.flush()


class GrpcServer:
    """A gRPC server for unary and server-streaming methods.
    ``service(HandlerCallDetails)`` returns the method's
    :class:`RpcMethodHandler`, or None (``UNIMPLEMENTED``), as a grpcio
    ``GenericRpcHandler.service`` does. The loop runs in a thread of its
    own; handlers run on :data:`_HANDLER_THREADS` threads. A request
    message over :data:`MAX_REQUEST_MESSAGE` bytes is answered with
    ``RESOURCE_EXHAUSTED``."""

    def __init__(self, service: Callable[[HandlerCallDetails],
                                         Optional[RpcMethodHandler]]):
        self.service = service
        self.pool = futures.ThreadPoolExecutor(
            max_workers=_HANDLER_THREADS, thread_name_prefix="grpc-handler")
        self.port = 0
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._server = None
        self._connections: set = set()

    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Bind and serve; returns the bound port. A failure to bind
        raises."""
        bound: futures.Future = futures.Future()

        def run():
            loop = asyncio.new_event_loop()
            self._loop = loop
            try:
                self._server = loop.run_until_complete(
                    asyncio.start_server(self._accept, host, port))
            except BaseException as e:
                loop.close()
                bound.set_exception(e)
                return
            bound.set_result(self._server.sockets[0].getsockname()[1])
            try:
                loop.run_forever()
            finally:
                loop.run_until_complete(loop.shutdown_asyncgens())
                loop.close()

        self._thread = threading.Thread(target=run, name="grpc-server",
                                        daemon=True)
        self._thread.start()
        self.port = bound.result(timeout=60)
        return self.port

    async def _accept(self, reader, writer) -> None:
        conn = _ServerConnection(self, writer)
        self._connections.add(conn)
        try:
            await conn.serve(reader)
        finally:
            self._connections.discard(conn)

    def post(self, fn, *args) -> None:
        """Run ``fn(*args)`` on the loop (from a handler thread)."""
        try:
            self._loop.call_soon_threadsafe(fn, *args)
        except RuntimeError:
            pass  # the server stopped

    def run_call(self, conn: _ServerConnection, call: _ServerCall,
                 request: bytes) -> None:
        """One call, on a pool thread: the handler's messages and status
        go to the loop in order."""
        handler = call.handler
        context = ServicerContext(call)
        try:
            request = handler.request_deserializer(request)
        except Exception as e:
            self.post(conn.finish, call, StatusCode.INTERNAL,
                      f"Exception deserializing request: {e}")
            return
        try:
            if handler.kind == "unary_unary":
                response = handler.behavior(request, context)
                self.post(conn.send_message, call,
                          handler.response_serializer(response))
            else:
                for response in handler.behavior(request, context):
                    self.post(conn.send_message, call,
                              handler.response_serializer(response))
            self.post(conn.finish, call, StatusCode.OK, "")
        except _Abort as e:
            self.post(conn.finish, call, e.code, e.details)
        except Exception as e:
            self.post(conn.finish, call, StatusCode.UNKNOWN,
                      f"Exception calling application: {e}")

    def stop(self) -> None:
        """Close the listener and every connection, and end the loop's
        thread (waiting up to 5 s); running handlers see ``is_active()``
        false."""
        loop = self._loop
        if loop is None or loop.is_closed():
            return

        def shutdown():
            if self._server is not None:
                self._server.close()
            for conn in list(self._connections):
                conn.h2.close(NO_ERROR)
                conn.flush()
                conn.writer.close()
            loop.call_later(0.05, loop.stop)

        try:
            loop.call_soon_threadsafe(shutdown)
        except RuntimeError:
            return
        if self._thread is not None:
            self._thread.join(5.0)
        self.pool.shutdown(wait=False, cancel_futures=True)


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------

_HTTP_TO_GRPC = {400: StatusCode.INTERNAL, 401: StatusCode.UNAUTHENTICATED,
                 403: StatusCode.PERMISSION_DENIED,
                 404: StatusCode.UNIMPLEMENTED, 429: StatusCode.UNAVAILABLE,
                 502: StatusCode.UNAVAILABLE, 503: StatusCode.UNAVAILABLE,
                 504: StatusCode.UNAVAILABLE}

USER_AGENT = "ray-tpu-torch-grpc/1"


class _ClientCall:
    def __init__(self, channel: "GrpcChannel", h2: H2Connection,
                 sock: socket.socket, sid: int, deadline: Optional[float]):
        self.channel = channel
        self.h2 = h2
        self.sock = sock
        self.sid = sid
        self.deadline = deadline
        self.events: queue.SimpleQueue = queue.SimpleQueue()
        self.reader = MessageReader()
        self.headers_seen = False
        self.done = False

    def end(self) -> None:
        """Forget the call; a stream still open on this side is reset
        (``RST_STREAM(CANCEL)``), so the server sees the client leave."""
        if self.done:
            return
        self.done = True
        self.channel._end(self)

    def messages(self) -> Iterator[bytes]:
        """The response messages as they arrive; raises
        :class:`GrpcError` unless the call ends with ``OK``."""
        while True:
            timeout = None
            if self.deadline is not None:
                timeout = self.deadline - time.monotonic()
                if timeout <= 0:
                    self.end()
                    raise GrpcError(StatusCode.DEADLINE_EXCEEDED,
                                    "Deadline Exceeded")
            try:
                event = self.events.get(timeout=timeout)
            except queue.Empty:
                continue
            kind = event[0]
            if kind == "data":
                try:
                    messages = self.reader.feed(event[2])
                except GrpcError:
                    self.end()
                    raise
                yield from messages
                if event[3]:
                    self.end()
                    raise GrpcError(StatusCode.INTERNAL,
                                    "the stream ended without a status")
            elif kind == "headers":
                fields = dict(event[2])
                if not self.headers_seen:
                    self.headers_seen = True
                    status = fields.get(":status", "200")
                    if status != "200":
                        self.end()
                        raise GrpcError(
                            _HTTP_TO_GRPC.get(int(status) if status.isdigit()
                                              else 0, StatusCode.UNKNOWN),
                            f"HTTP status {status}")
                if "grpc-status" in fields:
                    self.end()
                    code = _status(fields["grpc-status"])
                    if code != StatusCode.OK:
                        raise GrpcError(code, decode_grpc_message(
                            fields.get("grpc-message", "")))
                    if self.reader.partial:
                        raise GrpcError(StatusCode.INTERNAL,
                                        "a truncated message")
                    return
                if event[3]:
                    self.end()
                    raise GrpcError(StatusCode.INTERNAL,
                                    "the stream ended without a status")
            elif kind == "reset":
                self.end()
                code = event[2]
                raise GrpcError(StatusCode.CANCELLED if code == CANCEL
                                else StatusCode.UNAVAILABLE if code == 7
                                else StatusCode.INTERNAL,
                                f"the server reset the stream (HTTP/2 error "
                                f"code {code})")
            else:  # "closed"
                self.end()
                raise GrpcError(StatusCode.UNAVAILABLE, event[2])


class GrpcChannel:
    """A blocking client on one HTTP/2 connection (opened at the first call
    and again after the server closed it), shared by the calls of any
    number of threads. The multi-callables mirror grpcio's
    ``channel.unary_unary`` and ``channel.unary_stream``."""

    def __init__(self, target: str):
        host, _, port = target.rpartition(":")
        self._address = (host.strip("[]") or "127.0.0.1", int(port))
        self._authority = target
        self._lock = threading.RLock()
        self._h2: Optional[H2Connection] = None
        self._sock: Optional[socket.socket] = None
        self._calls: Dict[Tuple[int, int], _ClientCall] = {}
        self._closed = False

    def unary_unary(self, method: str, request_serializer=None,
                    response_deserializer=None):
        serialize = request_serializer or _identity
        deserialize = response_deserializer or _identity

        def call(request, timeout: Optional[float] = None):
            messages = list(self._start(method, serialize(request),
                                        timeout).messages())
            if len(messages) != 1:
                raise GrpcError(StatusCode.INTERNAL,
                                f"expected one response message, got "
                                f"{len(messages)}")
            return deserialize(messages[0])

        return call

    def unary_stream(self, method: str, request_serializer=None,
                     response_deserializer=None):
        serialize = request_serializer or _identity
        deserialize = response_deserializer or _identity

        def call(request, timeout: Optional[float] = None):
            return _responses(self._start(method, serialize(request),
                                          timeout), deserialize)

        return call

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if self._h2 is not None:
                self._h2.close(NO_ERROR)
                self._send(self._sock, self._h2)
            if self._sock is not None:
                try:
                    self._sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
            self._h2 = self._sock = None

    def _connect(self) -> None:
        if self._h2 is not None and not self._h2.goaway_received:
            return
        try:
            sock = socket.create_connection(self._address, timeout=30)
        except OSError as e:
            raise GrpcError(StatusCode.UNAVAILABLE,
                            f"failed to connect to {self._authority}: {e}")
        sock.settimeout(None)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        h2 = H2Connection(client=True)
        h2.initiate()
        self._h2, self._sock = h2, sock
        self._send(sock, h2)
        threading.Thread(target=self._read_loop, args=(sock, h2),
                         name="grpc-channel-reader", daemon=True).start()

    def _send(self, sock: socket.socket, h2: H2Connection) -> None:
        data = h2.data_to_send()
        if data:
            try:
                sock.sendall(data)
            except OSError:
                pass  # the reader sees the connection go and ends its calls

    def _start(self, method: str, payload: bytes,
               timeout: Optional[float]) -> _ClientCall:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            if self._closed:
                raise GrpcError(StatusCode.UNAVAILABLE,
                                "the channel is closed")
            self._connect()
            h2, sock = self._h2, self._sock
            sid = h2.new_stream_id()
            call = _ClientCall(self, h2, sock, sid, deadline)
            self._calls[(id(h2), sid)] = call
            headers = [(":method", "POST"), (":scheme", "http"),
                       (":path", method), (":authority", self._authority),
                       ("content-type", "application/grpc"),
                       ("te", "trailers"), ("user-agent", USER_AGENT)]
            if timeout is not None:
                headers.append(("grpc-timeout", encode_timeout(timeout)))
            h2.send_headers(sid, headers)
            h2.send_data(sid, frame_message(payload), end_stream=True)
            self._send(sock, h2)
        return call

    def _end(self, call: _ClientCall) -> None:
        with self._lock:
            self._calls.pop((id(call.h2), call.sid), None)
            if call.sid in call.h2.streams:
                call.h2.reset_stream(call.sid, CANCEL)
                self._send(call.sock, call.h2)

    def _read_loop(self, sock: socket.socket, h2: H2Connection) -> None:
        reason = "the connection closed"
        try:
            while True:
                data = sock.recv(1 << 16)
                if not data:
                    break
                with self._lock:
                    try:
                        events = h2.receive(data)
                    except H2ProtocolError as e:
                        h2.close(e.code, str(e))
                        self._send(sock, h2)
                        reason = f"HTTP/2 protocol error: {e}"
                        break
                    self._send(sock, h2)
                    for event in events:
                        if event[0] == "goaway":
                            if self._h2 is h2:
                                self._h2 = None  # new calls connect anew
                            for (conn, sid), call in list(
                                    self._calls.items()):
                                if conn == id(h2) and sid > event[1]:
                                    call.events.put(
                                        ("closed", sid,
                                         "the server closed the connection"))
                            continue
                        call = self._calls.get((id(h2), event[1]))
                        if call is not None:
                            call.events.put(event)
        except OSError as e:
            reason = f"the connection failed: {e}"
        finally:
            with self._lock:
                if self._h2 is h2:
                    self._h2 = self._sock = None
                for (conn, sid), call in list(self._calls.items()):
                    if conn == id(h2):
                        call.events.put(("closed", sid, reason))
            try:
                sock.close()
            except OSError:
                pass


def _responses(call: _ClientCall, deserialize) -> Iterator[Any]:
    try:
        for message in call.messages():
            yield deserialize(message)
    finally:
        call.end()  # closed early: cancel the stream
