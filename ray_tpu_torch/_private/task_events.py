"""Task lifecycle event pipeline: the per-process event buffer.

Reference: ``src/ray/core_worker/task_event_buffer.cc`` — every core worker
buffers per-task state transitions (status events + profile events) and
periodically flushes them in batches to the GCS ``GcsTaskManager``
(``gcs/gcs_server/gcs_task_manager.cc``), which keeps a bounded per-job
store powering ``ray summary tasks``, ``ray list tasks`` and the dashboard
timeline.

Here: both sides of a task record timestamped transitions into this
module's bounded buffer — the OWNER records SUBMITTED / LEASE_REQUESTED /
SCHEDULED / RETRYING / FINISHED / FAILED, the EXECUTING worker records
RUNNING — and the core worker's observability flush loop ships batches to
the GCS ``AddTaskEvents`` RPC (``_private/gcs.py``), where the
GcsTaskManager-equivalent merges them per task id. Surfaced via
``util.state.list_tasks()/get_task()/summarize_tasks()``, the dashboard's
``/api/tasks``, and the ``ray-tpu tasks`` CLI.

Always on by default (like the reference's task events): recording is a
lock + list append; set ``RAY_TPU_TASK_EVENTS=0`` to disable entirely.
The buffer is bounded (drop-oldest + drop counter, mirrored to the GCS so
truncation is visible, never silent).
"""

from __future__ import annotations

import atexit
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

# Lifecycle states, in nominal order (reference: common.proto TaskStatus).
SUBMITTED = "SUBMITTED"
LEASE_REQUESTED = "LEASE_REQUESTED"
SCHEDULED = "SCHEDULED"
RUNNING = "RUNNING"
RETRYING = "RETRYING"
FINISHED = "FINISHED"
FAILED = "FAILED"

TERMINAL_STATES = (FINISHED, FAILED)

_MAX_BUFFER = 10_000  # drop-oldest beyond this: events never leak unbounded
_ERR_MAX = 200  # error summaries are truncated; full tracebacks stay in logs

_lock = threading.Lock()
_buffer: "deque[dict]" = deque()
_dropped = 0
_enabled: Optional[bool] = None


def enabled() -> bool:
    # double-checked under _lock: the unlocked fast path never writes, so
    # a racing set_enabled() override cannot be overwritten by a stale
    # env read (the old unlocked check-then-act lost exactly that update)
    global _enabled
    if _enabled is None:
        with _lock:
            if _enabled is None:
                _enabled = os.environ.get(
                    "RAY_TPU_TASK_EVENTS", "1") not in ("0", "false")
    return _enabled


def set_enabled(value: Optional[bool]):
    """Override the env flag (None = re-read it); used by tests/benchmarks."""
    global _enabled
    with _lock:
        _enabled = value


def _append(entry) -> None:
    """Bounded drop-oldest append — the single buffer-management path for
    both dict events and SUBMITTED slab tuples."""
    global _dropped
    with _lock:
        if len(_buffer) >= _MAX_BUFFER:
            _buffer.popleft()
            _dropped += 1
        _buffer.append(entry)


def _base_event(task_id_hex: str, state: str, ts: float, attempt: int,
                name: str, job_id: str, span_id: str, parent_span: str,
                arg_bytes: int) -> Dict[str, Any]:
    """The field-elision ladder shared by :func:`record` and the slab
    expansion — one source of truth for the event shape."""
    event: Dict[str, Any] = {"task_id": task_id_hex, "state": state,
                             "ts": ts, "attempt": attempt}
    if name:
        event["name"] = name
    if job_id:
        event["job_id"] = job_id
    if span_id:
        event["span_id"] = span_id
    if parent_span:
        event["parent_span"] = parent_span
    if arg_bytes:
        event["arg_bytes"] = int(arg_bytes)
    return event


def record_submitted(task_id_hex: str, ts: float, name: str, job_id: str,
                     arg_bytes: int, span_id: str = "",
                     parent_span: str = "") -> None:
    """Slab append for the owner's SUBMITTED record — the one lifecycle
    event that rides the ``.remote()`` hot loop. Appends a bare tuple;
    :func:`drain` expands it into the normal event dict off the hot path
    (flush time), so a 20k-task burst pays tuple-pack + append per task
    instead of an 8-key dict construction."""
    if not enabled():
        return
    _append((task_id_hex, ts, name, job_id, arg_bytes, span_id, parent_span))


def _expand_submitted(slab: tuple) -> dict:
    task_id_hex, ts, name, job_id, arg_bytes, span_id, parent_span = slab
    return _base_event(task_id_hex, SUBMITTED, ts, 0, name, job_id,
                       span_id, parent_span, arg_bytes)


def record(task_id_hex: str, state: str, *, name: str = "", job_id: str = "",
           attempt: int = 0, error: str = "", worker: str = "",
           node: str = "", arg_bytes: int = 0, ret_bytes: int = 0,
           span_id: str = "", parent_span: str = "") -> None:
    """Buffer one state transition. Cheap (lock + append); never raises.

    ``arg_bytes`` rides the owner's SUBMITTED event (serialized argument
    payload size), ``ret_bytes`` the terminal FINISHED event (serialized
    return payload size, inline or store-resident) — the per-task object
    accounting surfaced by ``summarize_tasks``. ``span_id`` is the task's
    deterministic execution-span id and ``parent_span`` the submitter's
    active span: the GCS timeline endpoint joins them across task records
    to draw parent→child flow arrows without needing the span table."""
    if not enabled():
        return
    event = _base_event(task_id_hex, state, time.time(), attempt,
                        name, job_id, span_id, parent_span, arg_bytes)
    if ret_bytes:
        event["ret_bytes"] = int(ret_bytes)
    if error:
        # summary, not transcript: first line, bounded (full tracebacks
        # stay in worker logs / the task's error object)
        event["error"] = error.splitlines()[0][:_ERR_MAX]
    if worker:
        event["worker"] = worker
    if node:
        event["node"] = node
    _append(event)


def drain() -> Tuple[List[dict], int]:
    """Take everything buffered (called by the flush loop). Returns
    (events, dropped_since_last_drain)."""
    global _dropped
    with _lock:
        if not _buffer and not _dropped:
            return [], 0
        events, dropped = list(_buffer), _dropped
        _buffer.clear()
        _dropped = 0
    # slab entries (SUBMITTED hot path) expand here, off the submit loop
    return [_expand_submitted(e) if type(e) is tuple else e
            for e in events], dropped


def rebuffer(events: List[dict], dropped: int = 0):
    """Put events (and the drained drop count) back after a failed flush
    (oldest-first, still bounded) — a failed ship must not erase the
    truncation evidence the counter exists to surface."""
    global _dropped
    with _lock:
        _dropped += dropped
        _buffer.extendleft(reversed(events))
        while len(_buffer) > _MAX_BUFFER:
            _buffer.popleft()
            _dropped += 1


def pending() -> int:
    with _lock:
        return len(_buffer)


def reset_after_fork():
    """Drop the buffer a forked child inherited from its parent's image.
    Without this a zygote-forked worker re-ships the zygote process's
    buffered transitions (and their drop counter) to the GCS on its first
    flush, duplicating records the parent already owns."""
    global _dropped, _enabled
    with _lock:
        _buffer.clear()
        _dropped = 0
    _enabled = None  # re-read the env in the child (runtime env may differ)


def flush():
    """Synchronously push buffered events to the GCS; safe to call anywhere
    (worker shutdown, atexit). Mirrors tracing.flush()'s tiering: no-op
    pre-init and in local mode; from the worker's own event loop it ships
    fire-and-forget (blocking there would deadlock the loop)."""
    events, dropped = drain()
    if not events and not dropped:
        return
    try:
        from ray_tpu_torch._private.worker import global_worker, is_initialized

        if not is_initialized():
            rebuffer(events, dropped)
            return
        core = global_worker()
        if getattr(core, "mode", "") == "local" or not hasattr(core, "_gcs_call"):
            return  # local mode: lifecycle is inline; nothing to ship
        req = {"events": events, "dropped": dropped}

        async def _put_guarded():
            try:
                await core._gcs_call("AddTaskEvents", req)
            except Exception:
                rebuffer(events, dropped)

        import asyncio

        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is not None and running is core.loop:
            from ray_tpu_torch._private.async_util import spawn

            spawn(_put_guarded(), what="task-event flush")
        else:
            core._run(_put_guarded())
    except Exception:
        # observability must never take down the workload
        rebuffer(events, dropped)


# tail-event protection: transitions recorded in the last flush interval
# before process exit must not die with the process (tracing.py registers
# the same hook for spans on first record)
atexit.register(flush)
