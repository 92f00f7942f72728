"""Small asyncio helpers shared across the runtime.

``spawn`` is the sanctioned way to start fire-and-forget background work on
an event loop (enforced by raylint rule ASY003): a bare
``asyncio.ensure_future(coro())`` whose result is never awaited, stored, or
given a done-callback silently swallows any exception the coroutine raises
(Python only logs it at garbage-collection time, often minutes later or
never) — on a control plane that turns a crashed scheduling loop into a
distributed hang with no trace. ``spawn`` attaches a done-callback that
retrieves and logs the failure immediately, with context.

Reference: the reference runtime's ``PeriodicalRunner`` / posted-task
error handling around its instrumented_io_context.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Awaitable, Optional

logger = logging.getLogger("ray_tpu_torch.async")


def spawn(coro: Awaitable, what: str = "",
          log: Optional[logging.Logger] = None,
          loop: Optional[asyncio.AbstractEventLoop] = None) -> asyncio.Task:
    """Schedule ``coro`` as a background task with failure logging.

    Cancellation is not an error (shutdown cancels background work);
    any other exception is retrieved and logged with ``what`` as context,
    so background failures surface in the process log instead of dying
    with the task object.
    """
    if loop is not None:
        task = loop.create_task(coro)
    else:
        task = asyncio.ensure_future(coro)
    label = what or getattr(coro, "__qualname__", "background task")

    def _done(t: "asyncio.Task"):
        if t.cancelled():
            return
        exc = t.exception()  # also marks the exception as retrieved
        if exc is not None:
            (log or logger).warning("background task %r failed: %r",
                                    label, exc)

    task.add_done_callback(_done)
    return task
