"""Build the port's host C++ with g++ at first use and load it, with ctypes
or as a Python extension module.

The counterpart of ``ray_tpu/_private/native_build.py``, for the sources
under ``ray_tpu_torch/csrc/`` that run on the host (the token loader's
``loader.cc``, the object store's ``store.cc``, and the runtime's msgpack
codec ``msgpack.cc``, an extension module against CPython's headers). As
``ops/_build.py`` does for the CUDA kernels, a library goes into
``build/ray_tpu_torch/`` at the root of the checkout under a name keyed by
the hash of its source and flags, so an edited source is
rebuilt and an unchanged one loaded as it is. Each process compiles to a
temporary name of its own and renames it into place, so processes that
build the same source at once (the test workers) never write one file
together. A failed build raises: no caller falls back silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.machinery
import importlib.util
import os
import subprocess
import sysconfig
import threading
from types import ModuleType
from typing import Dict, Sequence

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "ray_tpu_torch")

CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def build(src: str, name: str, extra_flags: Sequence[str] = (),
          key: str = "") -> str:
    """Compile ``src`` into ``lib<name>_<hash>.so`` unless built already, and
    return its path; the hash covers the source, the flags and ``key``.
    Raises ``RuntimeError`` with g++'s output when the build fails."""
    flags = (*CXX_FLAGS, *extra_flags)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read())
    digest.update(" ".join(flags).encode())
    digest.update(key.encode())
    so = os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")
    if not os.path.isfile(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.run(["g++", *flags, src, "-o", tmp],
                              capture_output=True, text=True, timeout=180)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {src}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    return so


def build_and_load(src: str, name: str,
                   extra_flags: Sequence[str] = ()) -> ctypes.CDLL:
    """Build ``src`` (:func:`build`) and load it with ctypes. Raises
    ``RuntimeError`` when the build fails, and ``OSError`` when the library
    does not load."""
    with _lock:
        so = build(src, name, extra_flags)
        if so not in _loaded:
            _loaded[so] = ctypes.CDLL(so)
        return _loaded[so]


def load_extension(src: str, name: str) -> ModuleType:
    """Build ``src``, a CPython extension module whose init function is
    ``PyInit_<name>``, against this interpreter's headers, and import it
    under ``name``. The headers' directory and the interpreter's extension
    suffix are part of the hash, so another interpreter builds its own
    library. Raises ``RuntimeError`` when the build fails (the headers
    missing among the causes) and ``ImportError`` when it does not load."""
    include = sysconfig.get_paths()["include"]
    flags = (f"-I{include}", "-fno-strict-aliasing", "-fvisibility=hidden")
    with _lock:
        so = build(src, name, flags,
                   key=sysconfig.get_config_var("EXT_SUFFIX") or "")
        loader = importlib.machinery.ExtensionFileLoader(name, so)
        spec = importlib.util.spec_from_file_location(name, so, loader=loader)
        module = importlib.util.module_from_spec(spec)
        loader.exec_module(module)
        return module
