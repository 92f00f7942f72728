"""A mirror of ``tests/test_runtime_env_pip.py`` on the port's runtime
(``ray_tpu_torch``, on the CPU): the same scenarios and assertions.

pip/uv runtime environments: per-env cached venvs, workers launched
inside them (reference: python/ray/_private/runtime_env/pip.py + uv.py,
python/ray/tests/test_runtime_env_2.py).

The CI image has no package index (zero egress), so the test installs a
hand-rolled wheel from a local path — exactly what pip does with any
requirement, minus the network.
"""

import os
import zipfile

import pytest

import ray_tpu_torch
from ray_tpu_torch._private.runtime_env import ensure_env_python, normalize

PKG = "graft_renv_demo"


def _make_wheel(tmp_path, version="0.1", value=42) -> str:
    """A minimal valid wheel: one module + dist-info."""
    name = f"{PKG}-{version}-py3-none-any.whl"
    path = str(tmp_path / name)
    di = f"{PKG}-{version}.dist-info"
    record_rows = []
    with zipfile.ZipFile(path, "w") as z:
        files = {
            f"{PKG}.py": f"VALUE = {value}\n",
            f"{di}/METADATA": (f"Metadata-Version: 2.1\nName: {PKG}\n"
                               f"Version: {version}\n"),
            f"{di}/WHEEL": ("Wheel-Version: 1.0\nGenerator: graft\n"
                            "Root-Is-Purelib: true\nTag: py3-none-any\n"),
        }
        for arc, content in files.items():
            z.writestr(arc, content)
            record_rows.append(f"{arc},,")
        record_rows.append(f"{di}/RECORD,,")
        z.writestr(f"{di}/RECORD", "\n".join(record_rows) + "\n")
    return path


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(resources={"CPU": 4.0}, device="cpu")
    yield
    ray_tpu_torch.shutdown()


def test_pip_env_task(cluster, tmp_path):
    wheel = _make_wheel(tmp_path)

    @ray_tpu_torch.remote(runtime_env={"pip": [wheel]})
    def use_pkg():
        import graft_renv_demo

        return graft_renv_demo.VALUE

    # the base env must NOT have the package — otherwise this test is a lie
    with pytest.raises(ImportError):
        import graft_renv_demo  # noqa: F401

    assert ray_tpu_torch.get(use_pkg.remote(), timeout=300) == 42

    @ray_tpu_torch.remote
    def plain():
        try:
            import graft_renv_demo  # noqa: F401

            return "leaked"
        except ImportError:
            return "isolated"

    # env-hash-keyed worker pool: a no-env task gets a base-env worker
    assert ray_tpu_torch.get(plain.remote(), timeout=120) == "isolated"


def test_pip_env_cached_venv(tmp_path):
    wheel = _make_wheel(tmp_path, version="0.2", value=7)
    renv = normalize({"pip": [wheel]})
    py1 = ensure_env_python(renv)
    assert py1 and os.path.exists(py1)
    import time

    t0 = time.perf_counter()
    py2 = ensure_env_python(renv)
    assert py2 == py1
    assert time.perf_counter() - t0 < 0.5  # cache hit, no rebuild
    # the venv interpreter sees both the new package and the base env
    import subprocess
    import sys as _sys

    out = subprocess.run(
        [py1, "-c", "import graft_renv_demo, msgpack; "
         "print(graft_renv_demo.VALUE)"],
        capture_output=True, text=True, timeout=60,
        env={k: v for k, v in os.environ.items()})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "7"
    del _sys


def test_uv_spec_normalizes_to_pip():
    renv = normalize({"uv": ["left-pad==1.0"]})
    assert renv["pip"]["packages"] == ["left-pad==1.0"]
    assert renv["pip"]["installer"] == "uv"


def test_pip_install_failure_surfaces(cluster):
    @ray_tpu_torch.remote(runtime_env={
        "pip": ["this-package-cannot-exist-graft-xyz==9.9.9"]})
    def f():
        return 1

    from ray_tpu_torch.exceptions import TaskError

    with pytest.raises(TaskError):
        ray_tpu_torch.get(f.remote(), timeout=300)
