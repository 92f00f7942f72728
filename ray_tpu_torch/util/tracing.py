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

Enable with ``RAY_TPU_ENABLE_TRACING=1`` (the JAX package's switch) or
:func:`enable`. Spans are kept in the process, as the JAX module keeps them
in the runtime's local mode, and read back with :func:`get_spans`.

Not ported yet: shipping spans to the runtime's GCS, so a worker's spans
stay in that worker (``ROADMAP.md`` queue 1 item 2).
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import threading
import time
import uuid
from typing import List, Optional, Tuple

_lock = threading.Lock()
_spans: List[dict] = []
_enabled: Optional[bool] = None

_MAX_BUFFER = 10_000  # drop-oldest beyond this: tracing never grows unbounded

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
    """Keep one span. ``trace_id`` and ``parent_id`` come from the active
    context where they are not passed."""
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
    with _lock:
        _spans.append(span)
        if len(_spans) > _MAX_BUFFER:
            del _spans[: len(_spans) - _MAX_BUFFER]


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
    """Drop the spans and the active context a worker forked from the zygote
    inherits, so that it never reports the zygote's spans as its own."""
    with _lock:
        _spans.clear()
    _ctx.set(None)


def get_spans() -> List[dict]:
    """Every span recorded in this process so far, by start time."""
    with _lock:
        return sorted(_spans, key=lambda s: s["ts"])


def clear():
    """Drop every span recorded so far."""
    with _lock:
        _spans.clear()


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
