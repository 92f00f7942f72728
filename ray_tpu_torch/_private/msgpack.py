"""The runtime's msgpack codec: ``csrc/msgpack.cc``, a CPython extension
module built with g++ at first use (``native_build.load_extension``).

Every RPC frame (``rpc.py``) and every typed wire struct (``wire.py``)
goes through :func:`packb` and :func:`unpackb`, which write and read the
bytes of the ``msgpack`` package (``msgpack.packb(obj, use_bin_type=True,
default=...)``, ``msgpack.unpackb(data, raw=False, ext_hook=...,
strict_map_key=False)``). The pure-Python ``msgpack_plain`` module is the
plain version the tests hold this one against, value for value and error
for error; the two share ``ExtType``, ``FormatError`` and ``ExtraData``. A
failed build raises: the runtime never falls back to the plain codec.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Optional

from ray_tpu_torch._private.msgpack_plain import (ExtraData, ExtType,
                                                  FormatError)

__all__ = ["ExtType", "ExtraData", "FormatError", "packb", "unpackb"]

_lock = threading.Lock()
_native = None


def _load():
    global _native
    with _lock:
        if _native is None:
            from ray_tpu_torch._private.native_build import (CSRC_DIR,
                                                             load_extension)

            mod = load_extension(os.path.join(CSRC_DIR, "msgpack.cc"),
                                 "ray_tpu_torch_msgpack")
            mod._setup(ExtType, FormatError, ExtraData)
            _native = mod
    return _native


def packb(obj: Any, default: Optional[Callable[[Any], Any]] = None) -> bytes:
    """Encode ``obj`` as ``msgpack.packb(obj, use_bin_type=True,
    default=default)`` does; ``default`` maps a value of another type to one
    the codec packs (called once per value, as msgpack calls it)."""
    return (_native or _load()).packb(obj, default)


def unpackb(data, ext_hook: Optional[Callable[[int, bytes], Any]] = None
            ) -> Any:
    """Decode one value that fills ``data`` (any buffer), as
    ``msgpack.unpackb(data, raw=False, use_list=True, ext_hook=ext_hook,
    strict_map_key=False)`` does. Raises ``ValueError`` (or its subclasses
    :class:`FormatError` and :class:`ExtraData`) on bytes that are not
    exactly one msgpack value."""
    return (_native or _load()).unpackb(data, ext_hook)
