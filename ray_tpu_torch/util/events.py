"""Structured cluster events: the port of ``ray_tpu/util/events.py``.

System components report typed events (a Serve scale action, a checkpoint
mirror that failed) to the GCS, which keeps a bounded ring of them (1000)
and publishes each on the ``events`` pubsub channel; :func:`list_events`
reads them back. In the runtime's local mode, and with no runtime, events
stay in this process's ring.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

SEVERITIES = ("DEBUG", "INFO", "WARNING", "ERROR", "FATAL")

_local_events: List[Dict[str, Any]] = []


def _on_worker_loop(core) -> bool:
    try:
        import asyncio

        return asyncio.get_running_loop() is core.loop
    except RuntimeError:
        return False


def record(source: str, severity: str, message: str, **metadata) -> None:
    """Report one structured event to the GCS (best-effort, never raises).
    Safe from driver threads, sync tasks and async actor methods (those run
    on the worker's loop, so the report is fired and not awaited)."""
    from ray_tpu_torch._private.worker import global_worker, is_initialized

    severity = severity.upper()
    if severity not in SEVERITIES:
        severity = "INFO"
    event = {"ts": time.time(), "source": source, "severity": severity,
             "message": message, "metadata": metadata}
    try:
        if not is_initialized():
            _local_events.append(event)
            return
        core = global_worker()
        if getattr(core, "mode", "") == "local":
            _local_events.append(event)
            return
        coro = core._gcs_call("ReportEvent", {"event": event})
        if _on_worker_loop(core):
            from ray_tpu_torch._private.async_util import spawn

            spawn(coro, what="event report")
        else:
            core._run(coro, 10.0)
    except Exception:
        pass


def list_events(source: Optional[str] = None,
                severity: Optional[str] = None,
                limit: int = 200) -> List[Dict[str, Any]]:
    """Recent cluster events, newest last."""
    from ray_tpu_torch._private.worker import global_worker

    severity = severity.upper() if severity else None
    core = global_worker()
    if getattr(core, "mode", "") == "local" or not hasattr(core, "_gcs_call"):
        out = list(_local_events)
        if source:
            out = [e for e in out if e.get("source") == source]
        if severity:
            out = [e for e in out if e.get("severity") == severity]
        return out[-limit:]
    out = core._run(core._gcs_call("GetEvents", {
        "source": source, "severity": severity, "limit": limit}), 30.0)
    return out["events"]
