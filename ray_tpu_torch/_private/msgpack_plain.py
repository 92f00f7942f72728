"""The msgpack subset the runtime speaks, in pure Python: the plain version
of the runtime's codec.

The JAX runtime frames every RPC and encodes every typed struct with the
third-party ``msgpack`` package (``ray_tpu/_private/rpc.py``, ``wire.py``),
which the port does not depend on. The runtime runs the native codec
(``csrc/msgpack.cc`` behind :mod:`ray_tpu_torch._private.msgpack`); this
module is what the tests hold it against, and owns the classes both share.
:func:`packb` writes the bytes ``msgpack.packb(obj, use_bin_type=True,
default=...)`` writes, and :func:`unpackb` reads them as
``msgpack.unpackb(data, raw=False, use_list=True, ext_hook=...,
strict_map_key=False)`` does, so a port process and a JAX process could
read each other's frames.

Covered: nil, bool, ints of every width up to 64 bits (signed and
unsigned), float64, str, bin (``bytes``, ``bytearray``, ``memoryview``),
array (``list``, ``tuple``; decoded as lists), map and ext types. Not
covered, as the runtime never asks for them: float32 packing, the
timestamp extension, and the package's other modes (``raw=True``,
``use_bin_type=False``, tuples for arrays, strict map keys).
"""

from __future__ import annotations

import struct
from collections import namedtuple
from typing import Any, Callable, Optional

__all__ = ["ExtType", "ExtraData", "FormatError", "packb", "unpackb"]


class ExtType(namedtuple("ExtType", "code data")):
    """An extension value: an application type code in [0, 127] and its
    bytes (negative codes are reserved by the format)."""

    def __new__(cls, code: int, data: bytes):
        if not isinstance(code, int):
            raise TypeError("code must be int")
        if not isinstance(data, bytes):
            raise TypeError("data must be bytes")
        if not 0 <= code <= 127:
            raise ValueError("code must be 0~127")
        return super().__new__(cls, code, data)


class FormatError(ValueError):
    """The bytes are not msgpack (a reserved or unknown first byte)."""


class ExtraData(ValueError):
    """One value decoded and bytes were left after it."""

    def __init__(self, unpacked, extra):
        self.unpacked = unpacked
        self.extra = extra
        super().__init__("unpack(b) received extra data.")


_MAX_DEPTH = 512  # msgpack's default nesting limit

_pack_B = struct.Struct(">B").pack
_pack_BB = struct.Struct(">BB").pack
_pack_BH = struct.Struct(">BH").pack
_pack_BI = struct.Struct(">BI").pack
_pack_BQ = struct.Struct(">BQ").pack
_pack_Bb = struct.Struct(">Bb").pack
_pack_Bh = struct.Struct(">Bh").pack
_pack_Bi = struct.Struct(">Bi").pack
_pack_Bq = struct.Struct(">Bq").pack
_pack_Bd = struct.Struct(">Bd").pack


def _pack_int(n: int, out: list) -> None:
    if n >= 0:
        if n < 0x80:
            out.append(_pack_B(n))
        elif n <= 0xFF:
            out.append(_pack_BB(0xCC, n))
        elif n <= 0xFFFF:
            out.append(_pack_BH(0xCD, n))
        elif n <= 0xFFFFFFFF:
            out.append(_pack_BI(0xCE, n))
        elif n <= 0xFFFFFFFFFFFFFFFF:
            out.append(_pack_BQ(0xCF, n))
        else:
            raise OverflowError("Integer value out of range")
    elif n >= -32:
        out.append(_pack_B(n & 0xFF))
    elif n >= -0x80:
        out.append(_pack_Bb(0xD0, n))
    elif n >= -0x8000:
        out.append(_pack_Bh(0xD1, n))
    elif n >= -0x80000000:
        out.append(_pack_Bi(0xD2, n))
    elif n >= -0x8000000000000000:
        out.append(_pack_Bq(0xD3, n))
    else:
        raise OverflowError("Integer value out of range")


def _pack_bin(b, out: list) -> None:
    n = len(b)
    if n <= 0xFF:
        out.append(_pack_BB(0xC4, n))
    elif n <= 0xFFFF:
        out.append(_pack_BH(0xC5, n))
    elif n <= 0xFFFFFFFF:
        out.append(_pack_BI(0xC6, n))
    else:
        raise ValueError("bin data too long")
    out.append(b)


def _pack_header(n: int, fix: int, fix_max: int, c16: int, c32: int,
                 out: list) -> None:
    if n < fix_max:
        out.append(_pack_B(fix | n))
    elif n <= 0xFFFF:
        out.append(_pack_BH(c16, n))
    elif n <= 0xFFFFFFFF:
        out.append(_pack_BI(c32, n))
    else:
        raise ValueError("object too large")


_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _pack(obj: Any, out: list, default: Optional[Callable], depth: int,
          default_used: bool = False) -> None:
    if depth > _MAX_DEPTH:
        raise ValueError("recursion limit exceeded.")
    while True:
        if obj is None:
            out.append(b"\xc0")
        elif obj is True:
            out.append(b"\xc3")
        elif obj is False:
            out.append(b"\xc2")
        elif isinstance(obj, int):
            _pack_int(int(obj), out)
        elif isinstance(obj, float):
            out.append(_pack_Bd(0xCB, obj))
        elif isinstance(obj, (bytes, bytearray)):
            _pack_bin(bytes(obj), out)
        elif isinstance(obj, str):
            b = obj.encode("utf-8")
            n = len(b)
            if n < 32:
                out.append(_pack_B(0xA0 | n))
            elif n <= 0xFF:
                out.append(_pack_BB(0xD9, n))
            elif n <= 0xFFFF:
                out.append(_pack_BH(0xDA, n))
            elif n <= 0xFFFFFFFF:
                out.append(_pack_BI(0xDB, n))
            else:
                raise ValueError("unicode string is too large")
            out.append(b)
        elif isinstance(obj, dict):
            _pack_header(len(obj), 0x80, 16, 0xDE, 0xDF, out)
            for k, v in obj.items():
                _pack(k, out, default, depth + 1)
                _pack(v, out, default, depth + 1)
        elif isinstance(obj, ExtType):
            code, data = obj
            n = len(data)
            fix = _FIXEXT.get(n)
            if fix is not None:
                out.append(_pack_Bb(fix, code))
            elif n <= 0xFF:
                out.append(_pack_BB(0xC7, n) + _pack_Bb(0, code)[1:])
            elif n <= 0xFFFF:
                out.append(_pack_BH(0xC8, n) + _pack_Bb(0, code)[1:])
            elif n <= 0xFFFFFFFF:
                out.append(_pack_BI(0xC9, n) + _pack_Bb(0, code)[1:])
            else:
                raise ValueError("EXT data is too large")
            out.append(data)
        elif isinstance(obj, (list, tuple)):
            _pack_header(len(obj), 0x90, 16, 0xDC, 0xDD, out)
            for v in obj:
                _pack(v, out, default, depth + 1)
        elif isinstance(obj, memoryview):
            _pack_bin(obj.tobytes(), out)
        elif default is not None and not default_used:
            obj = default(obj)
            default_used = True
            continue
        else:
            raise TypeError(f"can not serialize {type(obj).__name__!r} object")
        return


def packb(obj: Any, default: Optional[Callable[[Any], Any]] = None) -> bytes:
    """Encode ``obj`` as ``msgpack.packb(obj, use_bin_type=True,
    default=default)`` does; ``default`` maps a value of another type to one
    of the types above (called once per value, as msgpack calls it)."""
    out: list = []
    _pack(obj, out, default, 0)
    return b"".join(out)


class _Reader:
    __slots__ = ("data", "pos", "ext_hook")

    def __init__(self, data: bytes,
                 ext_hook: Optional[Callable[[int, bytes], Any]]):
        self.data = data
        self.pos = 0
        self.ext_hook = ext_hook

    def take(self, n: int) -> bytes:
        p = self.pos
        end = p + n
        if end > len(self.data):
            raise ValueError("Unpack failed: incomplete input")
        self.pos = end
        return self.data[p:end]

    def unpack(self, fmt: struct.Struct):
        p = self.pos
        end = p + fmt.size
        if end > len(self.data):
            raise ValueError("Unpack failed: incomplete input")
        self.pos = end
        return fmt.unpack_from(self.data, p)[0]

    def ext(self, n: int) -> Any:
        code = self.unpack(_S_b)
        data = self.take(n)
        if self.ext_hook is not None:
            return self.ext_hook(code, data)
        return ExtType(code, data)

    def array(self, n: int, depth: int) -> list:
        return [self.read(depth + 1) for _ in range(n)]

    def map(self, n: int, depth: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read(depth + 1)
            out[k] = self.read(depth + 1)
        return out

    def read(self, depth: int = 0) -> Any:
        if depth > _MAX_DEPTH:
            raise ValueError("recursion limit exceeded.")
        if self.pos >= len(self.data):
            raise ValueError("Unpack failed: incomplete input")
        b = self.data[self.pos]
        self.pos += 1
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b < 0x90:
            return self.map(b & 0x0F, depth)
        if b < 0xA0:
            return self.array(b & 0x0F, depth)
        if b < 0xC0:
            return self.take(b & 0x1F).decode("utf-8")
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        handler = _HANDLERS.get(b)
        if handler is None:
            raise FormatError(f"Unpack failed: unknown first byte 0x{b:x}")
        return handler(self, depth)


_S_B, _S_H, _S_I, _S_Q = (struct.Struct(f) for f in (">B", ">H", ">I", ">Q"))
_S_b, _S_h, _S_i, _S_q = (struct.Struct(f) for f in (">b", ">h", ">i", ">q"))
_S_f, _S_d = struct.Struct(">f"), struct.Struct(">d")

_HANDLERS = {
    0xC4: lambda r, d: bytes(r.take(r.unpack(_S_B))),
    0xC5: lambda r, d: bytes(r.take(r.unpack(_S_H))),
    0xC6: lambda r, d: bytes(r.take(r.unpack(_S_I))),
    0xC7: lambda r, d: r.ext(r.unpack(_S_B)),
    0xC8: lambda r, d: r.ext(r.unpack(_S_H)),
    0xC9: lambda r, d: r.ext(r.unpack(_S_I)),
    0xCA: lambda r, d: r.unpack(_S_f),
    0xCB: lambda r, d: r.unpack(_S_d),
    0xCC: lambda r, d: r.unpack(_S_B),
    0xCD: lambda r, d: r.unpack(_S_H),
    0xCE: lambda r, d: r.unpack(_S_I),
    0xCF: lambda r, d: r.unpack(_S_Q),
    0xD0: lambda r, d: r.unpack(_S_b),
    0xD1: lambda r, d: r.unpack(_S_h),
    0xD2: lambda r, d: r.unpack(_S_i),
    0xD3: lambda r, d: r.unpack(_S_q),
    0xD4: lambda r, d: r.ext(1),
    0xD5: lambda r, d: r.ext(2),
    0xD6: lambda r, d: r.ext(4),
    0xD7: lambda r, d: r.ext(8),
    0xD8: lambda r, d: r.ext(16),
    0xD9: lambda r, d: r.take(r.unpack(_S_B)).decode("utf-8"),
    0xDA: lambda r, d: r.take(r.unpack(_S_H)).decode("utf-8"),
    0xDB: lambda r, d: r.take(r.unpack(_S_I)).decode("utf-8"),
    0xDC: lambda r, d: r.array(r.unpack(_S_H), d),
    0xDD: lambda r, d: r.array(r.unpack(_S_I), d),
    0xDE: lambda r, d: r.map(r.unpack(_S_H), d),
    0xDF: lambda r, d: r.map(r.unpack(_S_I), d),
}


def unpackb(data, ext_hook: Optional[Callable[[int, bytes], Any]] = None
            ) -> Any:
    """Decode one value that fills ``data``, as ``msgpack.unpackb(data,
    raw=False, use_list=True, ext_hook=ext_hook, strict_map_key=False)``
    does. Raises ``ValueError`` (or its subclasses :class:`FormatError` and
    :class:`ExtraData`) on bytes that are not exactly one msgpack value."""
    reader = _Reader(bytes(data), ext_hook)
    value = reader.read()
    if reader.pos != len(reader.data):
        raise ExtraData(value, reader.data[reader.pos:])
    return value
