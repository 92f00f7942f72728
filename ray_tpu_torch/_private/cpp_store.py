"""ctypes binding for the native arena object store: the port of
``ray_tpu/_private/cpp_store.py``.

Builds ``csrc/store.cc`` (a copy of the JAX package's
``src/object_store/store.cc``) with g++ at first use through
``native_build`` into ``build/ray_tpu_torch/``; the raylet's
ObjectStoreServer uses it as the allocation backend (config
``object_store_backend=auto|cpp``; ``shm`` only when named). A failed build
raises, as every native build of the port does. Workers map the arena file
directly for zero-copy reads/writes.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

from ray_tpu_torch._private.native_build import CSRC_DIR, build_and_load

_SRC = os.path.join(CSRC_DIR, "store.cc")

_lock = threading.Lock()
_lib = None


def load_lib() -> ctypes.CDLL:
    """The arena library, built at first use. Raises ``RuntimeError`` (g++'s
    output) or ``OSError`` when it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = build_and_load(_SRC, "ray_tpu_torch_store")
        lib.rts_open.restype = ctypes.c_void_p
        lib.rts_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int]
        lib.rts_close.argtypes = [ctypes.c_void_p]
        lib.rts_alloc.restype = ctypes.c_int
        lib.rts_alloc.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
                                  ctypes.POINTER(ctypes.c_uint64)]
        lib.rts_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rts_lookup.restype = ctypes.c_int
        lib.rts_lookup.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_uint64),
                                   ctypes.POINTER(ctypes.c_uint64),
                                   ctypes.POINTER(ctypes.c_int)]
        lib.rts_free.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rts_free.restype = ctypes.c_int
        lib.rts_used.restype = ctypes.c_uint64
        lib.rts_used.argtypes = [ctypes.c_void_p]
        lib.rts_capacity.restype = ctypes.c_uint64
        lib.rts_capacity.argtypes = [ctypes.c_void_p]
        lib.rts_num_objects.restype = ctypes.c_uint64
        lib.rts_num_objects.argtypes = [ctypes.c_void_p]
        lib.rts_largest_free.restype = ctypes.c_uint64
        lib.rts_largest_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


class CppArena:
    """Server-side handle to the native arena allocator."""

    def __init__(self, arena_name: str, capacity: int):
        lib = load_lib()
        self.lib = lib
        self.arena_name = arena_name
        self.path = f"/dev/shm/{arena_name}"
        self.capacity = capacity
        self.handle = lib.rts_open(self.path.encode(), capacity, 1)
        if not self.handle:
            raise RuntimeError(f"failed to create arena {self.path}")

    def alloc(self, oid: bytes, size: int) -> Optional[int]:
        off = ctypes.c_uint64()
        rc = self.lib.rts_alloc(self.handle, oid, size, ctypes.byref(off))
        if rc == -2:
            return -2  # exists
        if rc != 0:
            return None
        return off.value

    def seal(self, oid: bytes) -> bool:
        return self.lib.rts_seal(self.handle, oid) == 0

    def lookup(self, oid: bytes) -> Optional[Tuple[int, int, bool]]:
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        sealed = ctypes.c_int()
        if self.lib.rts_lookup(self.handle, oid, ctypes.byref(off),
                               ctypes.byref(size), ctypes.byref(sealed)) != 0:
            return None
        return off.value, size.value, bool(sealed.value)

    def free(self, oid: bytes) -> bool:
        return self.lib.rts_free(self.handle, oid) == 0

    def used(self) -> int:
        return self.lib.rts_used(self.handle)

    def num_objects(self) -> int:
        return self.lib.rts_num_objects(self.handle)

    def largest_free(self) -> int:
        return self.lib.rts_largest_free(self.handle)

    def close(self, unlink: bool = True):
        if self.handle:
            self.lib.rts_close(self.handle)
            self.handle = None
        if unlink:
            try:
                os.unlink(self.path)
            except FileNotFoundError:
                pass
