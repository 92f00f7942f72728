"""A mirror of ``tests/test_native_store.py`` on the port's runtime
(``ray_tpu_torch``, on the CPU): the same scenarios and assertions.

Native-tier unit tests: builds the JAX package's C++ arena-store test
driver (``src/object_store/store_test.cc``) against the port's
``ray_tpu_torch/csrc/store.cc`` and, as the reference, against the JAX
package's store, and runs each through the same C ABI the Python binding
loads (reference: the gtest suites colocated with
src/ray/object_manager/plasma)."""

import os
import subprocess

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRIVER = os.path.join(REPO, "src", "object_store", "store_test.cc")
SOURCES = {"port": os.path.join(REPO, "ray_tpu_torch", "csrc", "store.cc"),
           "jax": os.path.join(REPO, "src", "object_store", "store.cc")}


@pytest.fixture(scope="module", params=sorted(SOURCES))
def test_binary(request, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("native") / "store_test")
    build = subprocess.run(
        ["g++", "-O1", "-std=c++17", SOURCES[request.param], DRIVER,
         "-o", out],
        capture_output=True, text=True, timeout=180)
    assert build.returncode == 0, build.stderr
    return out


def test_arena_store_native_suite(test_binary, tmp_path):
    base = os.path.join("/dev/shm", f"rtpt_ntest_{os.getpid()}")
    try:
        run = subprocess.run([test_binary, base], capture_output=True,
                             text=True, timeout=120)
        assert run.returncode == 0, f"{run.stdout}\n{run.stderr}"
        assert "OK" in run.stdout
    finally:
        for suffix in ".a .b .c .d .e .f".split():
            try:
                os.unlink(base + suffix)
            except OSError:
                pass
