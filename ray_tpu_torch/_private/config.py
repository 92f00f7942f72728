"""Env-overridable configuration: the port of ``ray_tpu/_private/config.py``,
cut to the keys the checkpoint plane reads.

Every key has a typed default and can be overridden per process with a
``RAY_TPU_<NAME>`` environment variable, the JAX package's names and
defaults, so one environment configures both packages. The rest of the JAX
table (networking, scheduling, the object store, ...) belongs to the
runtime and comes with its port.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

_ENV_PREFIX = "RAY_TPU_"


def _coerce(value: str, default: Any) -> Any:
    if isinstance(default, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(default, int):
        return int(value)
    if isinstance(default, float):
        return float(value)
    if isinstance(default, (dict, list)):
        return json.loads(value)
    return value


class _ConfigRegistry:
    """Typed config table; attribute access returns the (env-overridden) value."""

    def __init__(self):
        self._defs: Dict[str, Any] = {}

    def define(self, name: str, default: Any) -> None:
        self._defs[name] = default

    def __getattr__(self, name: str) -> Any:
        try:
            default = self.__dict__["_defs"][name]
        except KeyError:
            raise AttributeError(f"unknown config {name!r}")
        env = os.environ.get(_ENV_PREFIX + name.upper())
        if env is not None:
            return _coerce(env, default)
        return default


RAY_CONFIG = _ConfigRegistry()
_d = RAY_CONFIG.define

# --- checkpoint storage tier (ckpt/tier) ---
_d("ckpt_io_threads", 8)  # per-host parallel chunk transfer workers
# per-host in-flight payload byte cap for cross-tier chunk transfers
_d("ckpt_io_inflight_bytes", 256 * 1024**2)
# ranged reads separated by at most this many bytes coalesce into one GET
_d("ckpt_io_coalesce_gap", 64 * 1024)
_d("ckpt_mirror_enabled", True)  # TieredStore commits enqueue a mirror
_d("ckpt_multipart_bytes", 8 * 1024**2)  # bucket uploads split above this
# chunks younger than this are never reaped on any tier (in-flight saves
# and mirrors write chunks before the manifest that names them)
_d("ckpt_sweep_grace_s", 300.0)
