"""Public exception types (reference: python/ray/exceptions.py)."""

from __future__ import annotations


class RayTpuError(Exception):
    """Base class for all framework errors."""


class TaskError(RayTpuError):
    """A task raised; re-raised at `get` with the remote traceback attached.

    Reference: RayTaskError in python/ray/exceptions.py.
    """

    def __init__(self, cause_repr: str, traceback_str: str = "", cause: BaseException | None = None):
        self.cause_repr = cause_repr
        self.traceback_str = traceback_str
        self.cause = cause
        super().__init__(cause_repr)

    def __str__(self):
        if self.traceback_str:
            return f"{self.cause_repr}\n\nremote traceback:\n{self.traceback_str}"
        return self.cause_repr


class WorkerCrashedError(RayTpuError):
    """The worker executing the task died unexpectedly (e.g. OOM-killed)."""


class OutOfMemoryError(TaskError):
    """The memory monitor killed the worker running this task (reference:
    ray.exceptions.OutOfMemoryError; raylet worker_killing_policy)."""


class StrayInterrupt(RayTpuError):
    """Marker cause: a cancellation async-exc landed in the wrong task on
    a shared executor thread; the interrupted task is retried."""


class TaskCancelledError(TaskError):
    """The task was cancelled via ray_tpu.cancel (reference:
    ray.exceptions.TaskCancelledError). Default-constructible: cooperative
    cancellation raises this CLASS into the running task's thread."""

    def __init__(self, cause_repr: str = "TaskCancelledError: task was cancelled",
                 traceback_str: str = "", cause: BaseException | None = None):
        super().__init__(cause_repr, traceback_str, cause)


class ActorError(RayTpuError):
    pass


class ActorDiedError(ActorError):
    """The actor is permanently dead (creation failed, killed, or out of restarts)."""


class ActorUnavailableError(ActorError):
    """The actor is temporarily unreachable (restarting); the call may be retried."""


class ObjectLostError(RayTpuError):
    """All copies of the object were lost and lineage reconstruction failed."""


class OwnerDiedError(ObjectLostError):
    pass


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class PendingCallsLimitExceeded(RayTpuError):
    pass


class RuntimeEnvSetupError(RayTpuError):
    pass


class PlacementGroupError(RayTpuError):
    pass
