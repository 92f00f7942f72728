"""The goodput ledger: exclusive, exhaustive wall-clock attribution. The
port of ``ray_tpu/util/goodput.py``.

Every process classifies its wall time into ``BUCKETS`` with the
:func:`region` context manager (nested regions are exclusive: a child's
time is taken out of its parent's, so each second lands in one bucket) and
:func:`add` for windows measured elsewhere. What no bucket claims is
``idle`` in :func:`snapshot`, so ``sum(buckets) + idle == wall``.

``parallel/train.py`` wraps each step in ``step_compute``, and a
:class:`CompileWatch` keyed on the batch's shapes and dtypes sends the
first call for a new key into ``compile`` (counting a new key of a program
already seen as a recompile). In the port that first call is where the
kernels are built at first use and cuBLAS makes its first plans.

The ledger is on unless ``RAY_TPU_GOODPUT_ENABLED`` says otherwise (the
JAX package's ``RAY_CONFIG.goodput_enabled``, of which the port keeps its
own copy). :func:`flush_payload` builds the payload the runtime's
observability flush would ship; shipping it waits for the runtime's port.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Optional, Tuple

__all__ = [
    "BUCKETS", "CompileWatch", "add", "batch_key", "count", "enabled",
    "flush_payload", "note_mfu", "region", "reset", "set_job", "snapshot",
]

#: Exclusive attribution buckets; ``idle`` is derived (wall minus the sum of
#: these), so the decomposition is exhaustive.
BUCKETS = (
    "step_compute", "collective_wait", "input_stall", "ckpt_pause",
    "compile", "reform_downtime", "bubble", "overhead",
)

_lock = threading.Lock()
_tls = threading.local()

_job: str = ""
_anchor: Optional[float] = None  # perf_counter at the ledger's start
_anchor_ts: float = 0.0          # time.time() at the ledger's start
_buckets: Dict[str, float] = {}
_counters: Dict[str, float] = {}
_mfu: Optional[float] = None

_metrics_lock = threading.Lock()
_metrics: Optional[dict] = None


def enabled() -> bool:
    """``RAY_TPU_GOODPUT_ENABLED`` read as the JAX package's config reads a
    boolean (1, true, yes, on); on when unset."""
    env = os.environ.get("RAY_TPU_GOODPUT_ENABLED")
    return True if env is None else env.lower() in ("1", "true", "yes", "on")


def _obs() -> dict:
    """The ledger's gauges on the shared metrics registry (set on every
    ``flush_payload``)."""
    global _metrics
    with _metrics_lock:
        if _metrics is None:
            from ray_tpu_torch.util.metrics import Gauge

            _metrics = {
                "fraction": Gauge(
                    "ray_tpu.goodput.fraction",
                    "step_compute share of ledger wall time for this "
                    "process's active job"),
                "mfu": Gauge(
                    "ray_tpu.goodput.mfu",
                    "model FLOPs utilization last reported by the train "
                    "loop on this process"),
                "compiles": Gauge(
                    "ray_tpu.goodput.compiles",
                    "cumulative jit compiles observed by the compile "
                    "watch (first-key compiles plus recompiles)"),
                "recompiles": Gauge(
                    "ray_tpu.goodput.recompiles",
                    "cumulative shape/dtype-keyed jit RE-compiles (same "
                    "program, new key) — the recompile-storm signal"),
                "bucket_seconds": Gauge(
                    "ray_tpu.goodput.bucket_seconds",
                    "cumulative attributed wall seconds per goodput "
                    "bucket", tag_keys=("bucket",)),
            }
        return _metrics


def _anchor_locked() -> None:
    global _anchor, _anchor_ts
    if _anchor is None:
        _anchor = time.perf_counter()
        _anchor_ts = time.time()


def set_job(name: str) -> None:
    """Tag the ledger with its job's name. Another name resets the
    accumulators and the wall clock's start."""
    global _job, _anchor, _mfu
    if not enabled():
        return
    with _lock:
        if name != _job:
            _buckets.clear()
            _counters.clear()
            _mfu = None
            _anchor = None
        _job = name
        _anchor_locked()


def _add_locked(bucket: str, seconds: float) -> None:
    _anchor_locked()
    _buckets[bucket] = _buckets.get(bucket, 0.0) + seconds


def add(bucket: str, seconds: float) -> None:
    """Attribute a window measured elsewhere to ``bucket``."""
    if not enabled() or seconds <= 0.0:
        return
    with _lock:
        _add_locked(bucket, float(seconds))


def count(name: str, n: float = 1) -> None:
    """Bump a ledger counter (steps, compiles, recompiles, ...)."""
    if not enabled():
        return
    with _lock:
        _anchor_locked()
        _counters[name] = _counters.get(name, 0) + n


def note_mfu(value: float) -> None:
    """Record the train loop's latest MFU for the ledger's payload."""
    global _mfu
    if not enabled():
        return
    with _lock:
        _anchor_locked()
        _mfu = float(value)


@contextmanager
def region(bucket: str):
    """Attribute the enclosed wall time to ``bucket``. Nesting is exclusive:
    a nested region's whole duration is taken out of its parent's. The
    ledger's wall clock starts, if it has not, as the region opens (the JAX
    module starts it as the first region closes, which leaves that
    region's time outside the wall)."""
    if not enabled():
        yield
        return
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    with _lock:  # the wall clock starts no later than the first region
        _anchor_locked()
    frame = [bucket, time.perf_counter(), 0.0]  # bucket, t0, children's s
    stack.append(frame)
    try:
        yield
    finally:
        stack.pop()
        dt = time.perf_counter() - frame[1]
        own = max(0.0, dt - frame[2])
        with _lock:
            _add_locked(bucket, own)
        if stack:
            stack[-1][2] += dt


def snapshot() -> Dict[str, Any]:
    """The ledger now: every bucket plus ``idle`` (wall less the buckets),
    which sum to ``wall_s``."""
    with _lock:
        wall = 0.0 if _anchor is None else time.perf_counter() - _anchor
        buckets = {b: _buckets.get(b, 0.0) for b in BUCKETS}
        accounted = sum(buckets.values())
        buckets["idle"] = max(0.0, wall - accounted)
        snap: Dict[str, Any] = {
            "job": _job,
            "wall_s": wall,
            "started": _anchor_ts,
            "buckets": buckets,
            "counters": dict(_counters),
        }
        if _mfu is not None:
            snap["mfu"] = _mfu
        return snap


def flush_payload(node: str = "") -> Optional[Dict[str, Any]]:
    """The process's ledger payload, or None when it has nothing to report;
    also sets the ledger's gauges on the metrics registry."""
    if not enabled():
        return None
    snap = snapshot()
    if not snap["job"] and not _counters and not any(
            v > 0.0 for b, v in snap["buckets"].items() if b != "idle"):
        return None
    snap["pid"] = os.getpid()
    snap["time"] = time.time()
    snap["node"] = node
    obs = _obs()
    wall = snap["wall_s"]
    if wall > 0:
        obs["fraction"].set(snap["buckets"]["step_compute"] / wall)
    if snap.get("mfu") is not None:
        obs["mfu"].set(snap["mfu"])
    counters = snap["counters"]
    obs["compiles"].set(counters.get("compiles", 0))
    obs["recompiles"].set(counters.get("recompiles", 0))
    for b, v in snap["buckets"].items():
        obs["bucket_seconds"].set(v, tags={"bucket": b})
    return snap


class CompileWatch:
    """First-call detector keyed on shapes and dtypes. ``observe(fn, key)``
    gives ``"compile"`` for the first key a program sees, ``"recompile"``
    for a new key of a program already seen, and None for a key seen
    before."""

    def __init__(self):
        self._seen: Dict[str, set] = {}
        self._lock = threading.Lock()

    def observe(self, fn: str, key: Tuple) -> Optional[str]:
        with self._lock:
            seen = self._seen.setdefault(fn, set())
            if key in seen:
                return None
            seen.add(key)
            return "compile" if len(seen) == 1 else "recompile"


def batch_key(batch: Dict[str, Any]) -> Tuple:
    """A train batch's key: sorted (name, shape, dtype) triples. Values are
    left out, so reading it never waits for the card."""
    out = []
    for k in sorted(batch):
        v = batch[k]
        shape = tuple(getattr(v, "shape", ()))
        dtype = str(getattr(v, "dtype", type(v).__name__))
        out.append((k, shape, dtype))
    return tuple(out)


def reset() -> None:
    """Zero the ledger."""
    global _job, _anchor, _anchor_ts, _mfu
    with _lock:
        _job = ""
        _anchor = None
        _anchor_ts = 0.0
        _mfu = None
        _buckets.clear()
        _counters.clear()
    _tls.stack = []
