"""Runtime context (reference: python/ray/runtime_context.py)."""

from __future__ import annotations

from typing import Optional


class RuntimeContext:
    def __init__(self, worker):
        self._worker = worker

    @property
    def job_id(self):
        return self._worker.job_id

    def get_job_id(self) -> str:
        return self._worker.job_id.hex()

    def get_task_id(self) -> Optional[str]:
        tid = getattr(self._worker, "current_task_id", None)
        return tid.hex() if tid is not None else None

    def get_actor_id(self) -> Optional[str]:
        aid = getattr(self._worker, "current_actor_id", None)
        return aid.hex() if aid is not None else None

    def get_node_id(self) -> Optional[str]:
        nid = getattr(self._worker, "node_id", None)
        if nid is not None:
            return nid.hex()
        # drivers connect to an existing raylet: only the hex is recorded
        return getattr(self._worker, "node_hex", None) or None

    def get_worker_id(self) -> Optional[str]:
        wid = getattr(self._worker, "worker_id", None)
        return wid.hex() if wid is not None else None

    @property
    def namespace(self) -> str:
        return getattr(self._worker, "namespace", "default")

    def get_assigned_resources(self):
        return dict(getattr(self._worker, "assigned_resources", {}) or {})

    def current_actor(self):
        from ray_tpu_torch._private import worker as _worker

        aid = getattr(self._worker, "current_actor_id", None)
        if aid is None:
            raise RuntimeError("not running inside an actor")
        return _worker.global_worker().get_actor_handle(aid)


def get_runtime_context() -> RuntimeContext:
    from ray_tpu_torch._private import worker as _worker

    return RuntimeContext(_worker.global_worker())
