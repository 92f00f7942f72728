"""Runtime environments: env_vars, working_dir, py_modules, pip/uv venvs.

Reference: python/ray/_private/runtime_env/ — plugins install envs on the
node before a worker runs the task (working_dir zips ship via GCS KV,
uri_cache.py dedupes by content hash; ``pip.py``/``uv.py`` build per-env
virtualenvs keyed by requirement hash and launch workers inside them).
TPU-first simplifications: no conda/containers, and the "agent" is folded
into the worker pool — the raylet resolves the env (creating the venv on
first use) and spawns workers with the runtime-env descriptor; the worker
applies the rest before registering.

Flow:
- driver: ``prepare(core, renv)`` normalizes, zips local dirs, uploads each
  package once to GCS KV (``renv_pkg:<sha1>``), and rewrites the descriptor
  to reference the KV keys;
- lease requests carry the descriptor; the worker pool keys idle workers by
  (job, env-hash) so a worker only ever runs one runtime env;
- raylet: for ``pip``/``uv`` envs, ``ensure_env_python`` builds (once,
  node-locally, under a file lock) a venv that inherits the base
  interpreter's packages and installs the requirements into it; workers for
  that env run on the venv's interpreter (reference:
  _private/runtime_env/pip.py PipProcessor);
- worker: ``apply(renv, kv_get)`` sets env vars, downloads + extracts
  packages to a node-local cache dir, prepends them to ``sys.path`` and
  chdirs into the working_dir.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile
import zipfile
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.exceptions import RuntimeEnvSetupError

_PKG_NS = "renv"
# apart from the JAX runtime's cache (venvs, extracted packages and their
# locks are keyed by content alone, so a shared root would mix the two)
_CACHE_ROOT = os.path.join(tempfile.gettempdir(),
                           "ray_tpu_torch_runtime_envs")
_UNSUPPORTED = ("conda", "container", "image_uri", "java_jars")


def normalize(renv: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    if not renv:
        return None
    out: Dict[str, Any] = {}
    for k, v in renv.items():
        if k in _UNSUPPORTED:
            raise ValueError(
                f"runtime_env field {k!r} is not supported in this "
                f"environment; use env_vars / working_dir / py_modules / "
                f"pip / uv")
        if k == "env_vars":
            if not all(isinstance(a, str) and isinstance(b, str)
                       for a, b in v.items()):
                raise TypeError("env_vars must be Dict[str, str]")
            out["env_vars"] = dict(v)
        elif k in ("pip", "uv"):
            if "pip" in out:
                raise ValueError("runtime_env may carry pip OR uv, not both")
            if isinstance(v, dict):
                pkgs = list(v.get("packages") or [])
            elif isinstance(v, (list, tuple)):
                pkgs = list(v)
            else:
                raise TypeError(f"{k} must be a list of requirements or a "
                                f"dict with 'packages'")
            if not all(isinstance(p, str) for p in pkgs):
                raise TypeError(f"{k} requirements must be strings")
            out["pip"] = {"packages": sorted(pkgs), "installer": k}
        elif k in ("working_dir", "py_modules"):
            out[k] = v
        else:
            raise ValueError(f"unknown runtime_env field {k!r}")
    return out or None


def env_hash(renv: Optional[Dict[str, Any]]) -> str:
    if not renv:
        return ""
    return hashlib.sha1(
        json.dumps(renv, sort_keys=True).encode()).hexdigest()[:16]


def ensure_env_python(renv: Optional[Dict[str, Any]]) -> Optional[str]:
    """Node side: return the interpreter for this env's venv, building it on
    first use (reference: _private/runtime_env/pip.py PipProcessor +
    uv.py). Blocking — callers run it off the event loop.

    The venv is keyed by the requirement spec, inherits the base
    interpreter's site-packages (so torch/numpy/the framework stay visible),
    and is shared by every worker on the node that asks for the same spec.
    A file lock serializes concurrent builders (two raylets on one host).
    """
    if not renv or "pip" not in renv:
        return None
    spec = renv["pip"]
    key = hashlib.sha1(
        json.dumps(spec, sort_keys=True).encode()).hexdigest()[:16]
    root = os.path.join(_CACHE_ROOT, "venvs", key)
    py = os.path.join(root, "bin", "python")
    marker = os.path.join(root, ".ready")
    if os.path.exists(marker):
        return py
    import fcntl

    os.makedirs(os.path.dirname(root), exist_ok=True)
    lock_path = root + ".lock"
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(marker):  # lost the race, env is ready
                return py
            _build_venv(root, py, spec)
            with open(marker, "w") as f:
                f.write(json.dumps(spec))
            return py
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _build_venv(root: str, py: str, spec: Dict[str, Any]) -> None:
    import shutil

    if os.path.exists(root):
        shutil.rmtree(root, ignore_errors=True)  # torn previous attempt
    r = subprocess.run(
        [sys.executable, "-m", "venv", "--system-site-packages",
         "--without-pip", root], capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeEnvSetupError(f"venv creation failed: {r.stderr[-2000:]}")
    # running from a venv, --system-site-packages points at the BASE
    # interpreter's site-packages, not this venv's: bridge ours in so the
    # baked packages (torch, numpy, pip itself) stay importable
    site_dirs = [p for p in sys.path if p.rstrip(os.sep).endswith("site-packages")]
    if site_dirs:
        vsite = os.path.join(
            root, "lib", f"python{sys.version_info[0]}.{sys.version_info[1]}",
            "site-packages")
        with open(os.path.join(vsite, "_ray_tpu_parent.pth"), "w") as f:
            f.write("\n".join(site_dirs) + "\n")
    pkgs = spec["packages"]
    if not pkgs:
        return
    if spec.get("installer") == "uv" and shutil.which("uv"):
        cmd = ["uv", "pip", "install", "--python", py, *pkgs]
    else:
        cmd = [py, "-m", "pip", "install", "--disable-pip-version-check",
               "--no-input", *pkgs]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=1800)
    if r.returncode != 0:
        raise RuntimeEnvSetupError(
            f"requirement install failed ({' '.join(pkgs[:4])}...):\n"
            f"{r.stdout[-1000:]}\n{r.stderr[-2000:]}")


def _zip_dir(path: str) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        for root, dirs, files in os.walk(path):
            dirs[:] = [d for d in dirs
                       if d not in ("__pycache__", ".git", ".venv")]
            for f in files:
                full = os.path.join(root, f)
                z.write(full, os.path.relpath(full, path))
    return buf.getvalue()


def package_dir(path: str) -> tuple:
    """Zip a local dir for upload; returns (sha, blob, basename)."""
    path = os.path.abspath(os.path.expanduser(path))
    if not os.path.isdir(path):
        raise FileNotFoundError(f"runtime_env directory not found: {path}")
    blob = _zip_dir(path)
    sha = hashlib.sha1(blob).hexdigest()[:16]
    return sha, blob, os.path.basename(path) or "pkg"


def _extract(pkg: Dict[str, str], kv_get: Callable[[str], Optional[bytes]]
             ) -> str:
    dest = os.path.join(_CACHE_ROOT, pkg["sha"])
    marker = os.path.join(dest, ".ready")
    if not os.path.exists(marker):
        blob = kv_get(pkg["kv_key"])
        if blob is None:
            raise RuntimeError(
                f"runtime_env package {pkg['kv_key']} missing from GCS KV")
        tmp = dest + f".tmp.{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        with zipfile.ZipFile(io.BytesIO(blob)) as z:
            z.extractall(tmp)
        try:
            os.rename(tmp, dest)
        except OSError:  # another worker won the race
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)
        with open(marker, "w") as f:
            f.write("ok")
    return dest


def apply(renv: Optional[Dict[str, Any]],
          kv_get: Callable[[str], Optional[bytes]]) -> None:
    """Worker side: make the env effective for this process."""
    if not renv:
        return
    for k, v in (renv.get("env_vars") or {}).items():
        os.environ[k] = v
    for pkg in renv.get("py_modules") or []:
        path = _extract(pkg, kv_get)
        if path not in sys.path:
            sys.path.insert(0, path)
    wd = renv.get("working_dir")
    if wd:
        path = _extract(wd, kv_get)
        if path not in sys.path:
            sys.path.insert(0, path)
        os.chdir(path)
