"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``.cu`` source under ``ray_tpu_torch/csrc/`` is one shared library with
a plain C interface (the ``.cuh`` headers there are shared by the sources).
It is compiled at first use, for ``sm_90a`` only, into
``build/ray_tpu_torch/`` at the root of the checkout, under a name keyed by
the hash of the source, the headers and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. ``nvcc``'s resource report
(``-Xptxas -v``) is kept beside the library as ``<name>.log``.

Nothing here runs at import time: the CPU tests import every module of the
package, and this machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "ray_tpu_torch")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass
class BuiltLibrary:
    lib: ctypes.CDLL
    path: str
    seconds: float  # nvcc wall time; 0.0 when an existing build was loaded
    log: str        # nvcc's output, with the -Xptxas -v resource report


_LOADED: Dict[str, BuiltLibrary] = {}


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and os.path.isfile(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build(name: str) -> BuiltLibrary:
    """Compile ``csrc/<name>.cu`` (unless built already) and load it."""
    if name in _LOADED:
        return _LOADED[name]
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    # the key covers the source, the shared headers it may include, the flags
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(n for n in os.listdir(CSRC_DIR) if n.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC_DIR, n) for n in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    tag = digest.hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"lib{name}_{tag}.so")
    log_path = os.path.join(BUILD_DIR, f"lib{name}_{tag}.log")
    seconds, log = 0.0, ""
    if os.path.isfile(so):
        if os.path.isfile(log_path):
            with open(log_path) as f:
                log = f.read()
    else:
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        with open(log_path, "w") as f:
            f.write(log)
        os.replace(tmp, so)
    built = BuiltLibrary(ctypes.CDLL(so), so, seconds, log)
    _LOADED[name] = built
    return built


def build_all(names) -> Dict[str, BuiltLibrary]:
    """Build several sources at once, one nvcc process each."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))


def is_loaded(name: str) -> bool:
    return name in _LOADED
