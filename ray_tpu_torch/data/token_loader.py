"""Native token-file loader for training input pipelines: the port of
``ray_tpu/data/token_loader.py``.

A ctypes wrapper over ``ray_tpu_torch/csrc/loader.cc``, built with g++ at
first use (``_private/native_build.py``): a background C++ thread samples
batches of ``seq + 1`` consecutive tokens from an mmap'd corpus into a ring
of buffers, and Python hands out zero-copy int32 views. The numpy route
(``force_python=True``) samples the same rows from the same seeded xorshift
stream, one batch at a time.

Batch k is the k-th draw of that stream on both routes, whatever the ring
size and however long the consumer takes between batches: the native ring
hands filled buffers out in fill order. A failed build raises; nothing falls
back to the numpy route unasked.

Usage::

    loader = TokenFileLoader("corpus.bin", batch=8, seq=2048, seed=0)
    for batch in loader.batches():        # {"tokens", "targets", "mask"}
        params, opt, loss = bundle.step(params, opt,
                                        to_device(batch, bundle.device))

``to_device`` copies each array to the device before the next batch is
drawn, which is what the views need: they are valid until the next call.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, Iterator

import numpy as np
import torch

from ray_tpu_torch._private import native_build

_SRC = os.path.join(native_build.CSRC_DIR, "loader.cc")


def load_lib() -> ctypes.CDLL:
    """The loader's library, built at first use; raises when the build
    fails."""
    lib = native_build.build_and_load(_SRC, "token_loader",
                                      extra_flags=("-pthread",))
    lib.dl_create.restype = ctypes.c_void_p
    lib.dl_create.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                              ctypes.c_int64, ctypes.c_uint64,
                              ctypes.c_int, ctypes.c_int]
    lib.dl_next.restype = ctypes.c_int
    lib.dl_next.argtypes = [ctypes.c_void_p]
    lib.dl_buffer.restype = ctypes.POINTER(ctypes.c_int32)
    lib.dl_buffer.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.dl_release.restype = None
    lib.dl_release.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.dl_num_tokens.restype = ctypes.c_int64
    lib.dl_num_tokens.argtypes = [ctypes.c_void_p]
    lib.dl_batches_produced.restype = ctypes.c_int64
    lib.dl_batches_produced.argtypes = [ctypes.c_void_p]
    lib.dl_destroy.restype = None
    lib.dl_destroy.argtypes = [ctypes.c_void_p]
    return lib


class TokenFileLoader:
    """Ring-buffered sampling loader over a binary token file."""

    def __init__(self, path: str, batch: int, seq: int, seed: int = 0,
                 n_buffers: int = 3, token_bytes: int = 4,
                 force_python: bool = False):
        self._handle = None
        self._held = None
        if token_bytes not in (2, 4):
            raise ValueError(f"token_bytes must be 2 or 4, got {token_bytes}")
        self.path = path
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.token_bytes = token_bytes
        self.native = not force_python
        if self.native:
            self._lib = load_lib()
            handle = self._lib.dl_create(os.fsencode(path), batch, seq,
                                         seed or 1, n_buffers, token_bytes)
            if not handle:
                raise ValueError(
                    f"cannot open {path!r} as a token file for batch {batch}"
                    f" x {seq} ({token_bytes}-byte tokens, {n_buffers} "
                    "buffers)")
            self._handle = ctypes.c_void_p(handle)
        else:
            dtype = np.uint16 if token_bytes == 2 else np.int32
            self._mm = np.memmap(path, dtype=dtype, mode="r")
            self._rng_state = seed or 1
            self._produced = 0

    @property
    def num_tokens(self) -> int:
        if self.native:
            return int(self._lib.dl_num_tokens(self._handle))
        return int(len(self._mm))

    def _xorshift(self) -> int:
        s = self._rng_state
        s ^= (s << 13) & 0xFFFFFFFFFFFFFFFF
        s ^= s >> 7
        s ^= (s << 17) & 0xFFFFFFFFFFFFFFFF
        self._rng_state = s
        return s

    def next_batch(self) -> Dict[str, np.ndarray]:
        """One {"tokens", "targets", "mask"} batch. On the native route the
        arrays view the ring's buffer and are valid until the NEXT call:
        copy them (``to_device``) before advancing."""
        row = self.seq + 1
        if self.native:
            if self._handle is None:
                raise RuntimeError("loader is closed")
            # release BEFORE blocking on the next slot: with a single
            # buffer, holding it while waiting would deadlock the ring
            if self._held is not None:
                self._lib.dl_release(self._handle, self._held)
                self._held = None
            slot = self._lib.dl_next(self._handle)
            if slot < 0:
                raise RuntimeError("loader stopped")
            self._held = slot
            ptr = self._lib.dl_buffer(self._handle, slot)
            arr = np.ctypeslib.as_array(ptr, shape=(self.batch, row))
        else:
            max_start = self.num_tokens - row
            arr = np.empty((self.batch, row), np.int32)
            for b in range(self.batch):
                start = (self._xorshift() % (max_start + 1)
                         if max_start > 0 else 0)
                arr[b] = self._mm[start:start + row]
            self._produced += 1
        return {
            "tokens": arr[:, :-1],
            "targets": arr[:, 1:],
            "mask": np.ones((self.batch, self.seq), np.float32),
        }

    def batches(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()

    def batches_produced(self) -> int:
        """Batches filled so far: by the ring's thread (ahead of the
        consumer), or on the numpy route by ``next_batch``."""
        if self.native:
            return int(self._lib.dl_batches_produced(self._handle))
        return self._produced

    def close(self):
        if self._handle is not None:
            if self._held is not None:
                self._lib.dl_release(self._handle, self._held)
                self._held = None
            self._lib.dl_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()


def to_device(batch: Dict[str, np.ndarray],
              device: torch.device) -> Dict[str, torch.Tensor]:
    """The batch's arrays as tensors on ``device``: copies, made before this
    returns (from pageable memory, also on the CPU), so the loader may
    advance and reuse its buffer right after."""
    return {k: torch.from_numpy(v).to(device, copy=True)
            for k, v in batch.items()}


def write_token_file(path: str, tokens: np.ndarray, token_bytes: int = 4):
    """Dump a 1-D token array in the loader's format."""
    dtype = np.uint16 if token_bytes == 2 else np.int32
    np.asarray(tokens, dtype=dtype).tofile(path)
