"""Causal spans and their chrome://tracing export: the port of
``ray_tpu/util/tracing.py``.

Every span carries ``trace_id``, ``span_id`` and ``parent_id``. The active
span rides a ``contextvars`` variable, so nested :func:`profile` blocks form
a tree; a span recorded on another thread joins it by naming the parent it
was handed (``current_context()`` read where the work was submitted), as
``collective.bucketed``'s reducer thread does. :func:`export_chrome_trace`
writes the spans as ``ph: "X"`` slices, with a flow-event pair for every
parent-to-child edge that crosses a thread, so Perfetto draws it as an
arrow.

Every process buffers its spans and flushes them to the GCS KV (``trace``
namespace, one ``spans_<proc>_<n>`` key per flush): every 32 spans, one
second after the first unflushed span, at worker shutdown and at exit.
:func:`get_spans` gathers them cluster-wide, and the GCS timeline
(``state.get_timeline``) draws them beside the task slices. In the
runtime's local mode spans stay in the process; with no runtime at all
they stay in the buffer, and :func:`get_spans` reads them from there.

Enable with ``RAY_TPU_ENABLE_TRACING=1`` (the JAX package's switch; on the
driver set it before ``init``, and workers inherit it) or :func:`enable`.
"""

from __future__ import annotations

import atexit
import contextlib
import contextvars
import json
import os
import threading
import time
import uuid
from typing import List, Optional, Tuple

from ray_tpu_torch._private import wire

_lock = threading.Lock()
_buffer: List[dict] = []  # recorded here, not yet flushed to the GCS
_local_spans: List[dict] = []  # flushed in the runtime's local mode
_flush_counter = 0
_enabled: Optional[bool] = None

_FLUSH_EVERY = 32
_FLUSH_INTERVAL_S = 1.0
_MAX_BUFFER = 10_000  # drop-oldest beyond this: tracing never grows unbounded
_timer: Optional[threading.Timer] = None
# names this process's flush keys: pids collide across nodes and restarts
_proc_tag = uuid.uuid4().hex[:10]
_atexit_registered = False

_ctx: "contextvars.ContextVar[Optional[Tuple[str, str]]]" = \
    contextvars.ContextVar("ray_tpu_torch_trace_ctx", default=None)


def new_trace_id() -> str:
    return uuid.uuid4().hex


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def current_context() -> Optional[Tuple[str, str]]:
    """The active (trace_id, span_id), or None outside any span."""
    return _ctx.get()


def set_context(trace_id: str, span_id: str):
    """Install (trace_id, span_id) as the active span; returns a token for
    :func:`reset_context`."""
    return _ctx.set((trace_id, span_id))


def reset_context(token) -> None:
    try:
        _ctx.reset(token)
    except ValueError:
        # a token from another context: clearing is the right fallback, so
        # that no stale span leaks into later work
        _ctx.set(None)


def enabled() -> bool:
    global _enabled
    if _enabled is None:
        _enabled = os.environ.get("RAY_TPU_ENABLE_TRACING", "") in ("1",
                                                                    "true")
    return _enabled


def enable():
    global _enabled
    os.environ["RAY_TPU_ENABLE_TRACING"] = "1"
    _enabled = True


def disable():
    """Turn tracing off in this process (the environment switch too)."""
    global _enabled
    os.environ.pop("RAY_TPU_ENABLE_TRACING", None)
    _enabled = False


def record_span(name: str, start_s: float, end_s: float,
                category: str = "task", **extra):
    """Buffer one span; the buffer ships every :data:`_FLUSH_EVERY` spans
    and :data:`_FLUSH_INTERVAL_S` after its first. ``trace_id`` and
    ``parent_id`` come from the active context where they are not
    passed."""
    if not enabled():
        return
    if "trace_id" not in extra:
        ctx = _ctx.get()
        if ctx is not None:
            extra["trace_id"] = ctx[0]
            extra.setdefault("parent_id", ctx[1])
    span = {
        "name": name,
        "cat": category,
        "ts": start_s,
        "dur": end_s - start_s,
        "pid": os.getpid(),
        "tid": threading.get_ident() % 100_000,
        **extra,
    }
    global _timer
    flush_now = False
    with _lock:
        _ensure_atexit()
        _buffer.append(span)
        if len(_buffer) > _MAX_BUFFER:
            del _buffer[: len(_buffer) - _MAX_BUFFER]
        if len(_buffer) >= _FLUSH_EVERY:
            # hand off without waiting for the GCS: a traced submit loop
            # must not stall every 32 spans (_MAX_BUFFER bounds the rest)
            flush_now = True
        elif _timer is None:
            _timer = threading.Timer(_FLUSH_INTERVAL_S, _timer_flush)
            _timer.daemon = True
            _timer.start()
    if flush_now:
        flush(block=False)


def _timer_flush():
    global _timer
    with _lock:
        _timer = None
    flush()


def _flush_at_exit():
    # spans of the last flush interval would otherwise die with the timer
    try:
        flush()
    except Exception:
        pass


def _ensure_atexit():
    global _atexit_registered
    if not _atexit_registered:
        _atexit_registered = True
        atexit.register(_flush_at_exit)


@contextlib.contextmanager
def profile(name: str, category: str = "user", **extra):
    """A span around the block, a child of the active span, and itself the
    active span inside the block, so nested blocks tree up."""
    if not enabled():
        yield
        return
    parent = _ctx.get()
    span_id = new_span_id()
    trace_id = parent[0] if parent is not None else new_trace_id()
    token = _ctx.set((trace_id, span_id))
    t0 = time.time()
    try:
        yield
    finally:
        reset_context(token)
        record_span(name, t0, time.time(), category=category,
                    trace_id=trace_id, span_id=span_id,
                    parent_id=parent[1] if parent is not None else None,
                    **extra)


def reset_after_fork():
    """Drop what a worker forked from the zygote inherits of the span
    pipeline: the buffer, the flush counter and proc tag (the child would
    re-ship the zygote's spans under the zygote's keys), the timer (its
    thread did not survive the fork, so the child would think a flush is
    armed) and the active context."""
    global _timer, _flush_counter, _proc_tag
    with _lock:
        _buffer.clear()
        _timer = None
        _flush_counter = 0
        _proc_tag = uuid.uuid4().hex[:10]
    del _local_spans[:]
    _ctx.set(None)


def _core_or_none():
    """The runtime's worker, or None where this process has no runtime."""
    from ray_tpu_torch._private.worker import global_worker, is_initialized

    return global_worker() if is_initialized() else None


def flush(block: bool = True):
    """Ship the buffered spans to the GCS KV; safe to call anywhere.

    ``block=False`` (the size-triggered flush) does not wait for the GCS;
    explicit callers (``get_spans``, shutdown, exit) do. With no runtime
    the spans stay in the buffer; a flush that fails puts them back."""
    global _flush_counter
    core = _core_or_none()
    if core is None:
        return  # spans recorded before init ship after it
    with _lock:
        if not _buffer:
            return
        spans, _buffer[:] = list(_buffer), []
        _flush_counter += 1
        counter = _flush_counter

    def _rebuffer():
        with _lock:
            _buffer[:0] = spans
            if len(_buffer) > _MAX_BUFFER:
                del _buffer[: len(_buffer) - _MAX_BUFFER]

    try:
        if getattr(core, "mode", "") == "local":
            _local_spans.extend(spans)
            return
        req = {"ns": "trace", "key": f"spans_{_proc_tag}_{counter}",
               "value": wire.dumps(spans)}

        async def _put_guarded():
            try:
                await core._gcs_call("KVPut", req)
            except Exception:
                _rebuffer()

        import asyncio

        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is not None and running is core.loop:
            # on the worker's own loop (an async task): blocking would
            # deadlock, so fire and forget
            from ray_tpu_torch._private.async_util import spawn

            spawn(_put_guarded(), what="trace-span flush")
        elif not block:
            asyncio.run_coroutine_threadsafe(_put_guarded(), core.loop)
        else:
            core._run(_put_guarded())
    except Exception:
        _rebuffer()  # tracing never takes the workload down


def get_spans() -> List[dict]:
    """Every span recorded so far, by start time: cluster-wide on a
    cluster, this process's own in local mode or without a runtime."""
    flush()
    core = _core_or_none()
    if core is None:
        with _lock:
            return sorted(_buffer, key=lambda s: s["ts"])
    if getattr(core, "mode", "") == "local":
        return sorted(_local_spans, key=lambda s: s["ts"])
    keys = core._run(core._gcs_call(
        "KVKeys", {"ns": "trace", "prefix": "spans_"}))["keys"]
    out: List[dict] = []
    for key in keys:
        blob = core._run(core._gcs_call(
            "KVGet", {"ns": "trace", "key": key}))["value"]
        if blob:
            out.extend(wire.loads(blob))
    return sorted(out, key=lambda s: s["ts"])


def clear():
    """Drop every span recorded so far: the GCS trace table and this
    process's buffers."""
    with _lock:
        _buffer.clear()
    del _local_spans[:]
    core = _core_or_none()
    if core is None or getattr(core, "mode", "") == "local":
        return
    core._run(core._gcs_call("KVDel", {"ns": "trace", "key": "spans_",
                                       "prefix": True}))


_SPAN_META = ("name", "cat", "ts", "dur", "pid", "tid")


def spans_to_chrome_events(spans: List[dict],
                           flow_id_base: int = 0) -> List[dict]:
    """Span records as chrome-trace events: ``ph: "X"`` slices, and a
    flow-event pair for each parent-to-child edge across tracks."""
    events = [
        {
            "name": s["name"],
            "cat": s.get("cat", "task"),
            "ph": "X",
            "ts": s["ts"] * 1e6,  # microseconds
            "dur": max(s["dur"], 0.0) * 1e6,
            "pid": s.get("pid", 0),
            "tid": s.get("tid", 0),
            "args": {k: v for k, v in s.items() if k not in _SPAN_META},
        }
        for s in spans
    ]
    by_id = {s["span_id"]: s for s in spans if s.get("span_id")}
    flow_n = flow_id_base
    for s in spans:
        parent = by_id.get(s.get("parent_id") or "")
        if parent is None:
            continue
        same_track = (parent.get("pid"), parent.get("tid")) == \
            (s.get("pid"), s.get("tid"))
        if same_track:
            continue  # same-thread nesting already renders as stacked slices
        flow_n += 1
        # the flow's start must land inside the parent slice for Perfetto
        # to bind the arrow to it
        start_ts = min(max(s["ts"], parent["ts"]),
                       parent["ts"] + max(parent["dur"], 0.0))
        events.append({
            "name": "task_flow", "cat": "flow", "ph": "s", "id": flow_n,
            "ts": start_ts * 1e6, "pid": parent.get("pid", 0),
            "tid": parent.get("tid", 0),
        })
        events.append({
            "name": "task_flow", "cat": "flow", "ph": "f", "bp": "e",
            "id": flow_n, "ts": s["ts"] * 1e6, "pid": s.get("pid", 0),
            "tid": s.get("tid", 0),
        })
    return events


def export_chrome_trace(path: str) -> int:
    """Write the spans as a chrome://tracing (Perfetto) JSON file; returns
    the number of events written."""
    events = spans_to_chrome_events(get_spans())
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    return len(events)
