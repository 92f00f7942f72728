"""Build the port's host C++ with g++ at first use and load it with ctypes.

The counterpart of ``ray_tpu/_private/native_build.py``, for the sources
under ``ray_tpu_torch/csrc/`` that run on the host (today the token
loader's ``loader.cc``). As ``ops/_build.py`` does for the CUDA kernels, a
library goes into ``build/ray_tpu_torch/`` at the root of the checkout under
a name keyed by the hash of its source and flags, so an edited source is
rebuilt and an unchanged one loaded as it is. Each process compiles to a
temporary name of its own and renames it into place, so processes that
build the same source at once (the test workers) never write one file
together. A failed build raises: no caller falls back silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, Sequence

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "ray_tpu_torch")

CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def build_and_load(src: str, name: str,
                   extra_flags: Sequence[str] = ()) -> ctypes.CDLL:
    """Compile ``src`` into ``lib<name>_<hash>.so`` (unless built already)
    and load it. Raises ``RuntimeError`` with g++'s output when the build
    fails, and ``OSError`` when the library does not load."""
    flags = (*CXX_FLAGS, *extra_flags)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read())
    digest.update(" ".join(flags).encode())
    so = os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")
    with _lock:
        if so in _loaded:
            return _loaded[so]
        if not os.path.isfile(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = subprocess.run(["g++", *flags, src, "-o", tmp],
                                  capture_output=True, text=True,
                                  timeout=180)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed for {src}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        _loaded[so] = lib
        return lib
