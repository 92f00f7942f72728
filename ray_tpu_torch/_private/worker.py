"""Global worker state and the public API implementation.

Reference: python/ray/_private/worker.py (``ray.init`` at :1432, ``ray.get``
:2863, ``ray.put`` :3010, ``ray.wait`` :3079, ``ray.remote`` :3564). Two
execution modes:

- local mode: tasks/actors execute inline in the driver process (reference's
  ``local_mode``) — used for debugging and fast unit tests.
- cluster mode: a ``CoreWorker`` connected to a GCS + raylet(s)
  (``core_worker.py``).

The port of ``ray_tpu/_private/worker.py``. Its ``init`` takes ``device=``,
as every entry point of the port does: ``"cuda"`` (the default) starts a
cluster whose raylet advertises the host's cards as ``GPU`` and raises when
the host has none; ``"cpu"`` starts one without cards. ``num_gpus`` replaces
``num_tpus``. A driver finds a running cluster through
``RAY_TPU_TORCH_ADDRESS``, never the JAX runtime's ``RAY_TPU_ADDRESS``.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import inspect
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch._private.common import ActorOptions, TaskOptions
from ray_tpu_torch._private.config import RAY_CONFIG
from ray_tpu_torch._private.ids import ActorID, JobID, ObjectID, TaskID
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    GetTimeoutError,
    TaskError,
)
from ray_tpu_torch.object_ref import ObjectRef

_global_worker = None
_lock = threading.RLock()


def global_worker():
    if _global_worker is None:
        raise RuntimeError("ray_tpu_torch.init() has not been called")
    return _global_worker


def is_initialized() -> bool:
    return _global_worker is not None


# ---------------------------------------------------------------------------
# Local mode
# ---------------------------------------------------------------------------


class LocalWorker:
    """Inline execution for debugging/tests (reference: local_mode)."""

    mode = "local"

    def __init__(self, namespace: str = "default"):
        self.job_id = JobID.from_int(1)
        self.namespace = namespace
        self._objects: Dict[ObjectID, Any] = {}
        self._actors: Dict[ActorID, Any] = {}
        self._actor_meta: Dict[ActorID, Tuple[str, str]] = {}  # id -> (name, ns)
        self._named: Dict[Tuple[str, str], ActorID] = {}
        self._put_index = 0
        self._task_id = TaskID.of(self.job_id)
        self.current_task_id = self._task_id
        self.current_actor_id: Optional[ActorID] = None

    # -- objects --
    def put(self, value: Any) -> ObjectRef:
        self._put_index += 1
        oid = ObjectID.from_put(self._task_id, self._put_index % 0x7FFF)
        self._objects[oid] = value
        return ObjectRef(oid)

    def _store_result(self, oid: ObjectID, value: Any):
        self._objects[oid] = value

    def get(self, refs, timeout: Optional[float] = None):
        single = isinstance(refs, ObjectRef)
        if single:
            refs = [refs]
        out = []
        for ref in refs:
            if ref.id not in self._objects:
                raise GetTimeoutError(f"object {ref.hex()} not found in local mode")
            value = self._objects[ref.id]
            if isinstance(value, TaskError):
                raise value
            out.append(value)
        return out[0] if single else out

    def _run_coroutine(self, coro):
        """One persistent private loop: async actors may stash loop-bound
        futures across calls, and py3.12's get_event_loop() no longer
        conjures a loop in the main thread."""
        loop = getattr(self, "_loop", None)
        if loop is None or loop.is_closed():
            loop = self._loop = asyncio.new_event_loop()
        return loop.run_until_complete(coro)

    def wait(self, refs, num_returns=1, timeout=None, fetch_local=True):
        ready = [r for r in refs if r.id in self._objects]
        return ready[:num_returns], [r for r in refs if r not in ready[:num_returns]]

    def as_future(self, ref) -> concurrent.futures.Future:
        fut: concurrent.futures.Future = concurrent.futures.Future()
        try:
            fut.set_result(self.get(ref))
        except Exception as e:
            fut.set_exception(e)
        return fut

    async def await_ref(self, ref):
        return self.get(ref)

    # -- tasks --
    def _resolve_args(self, args, kwargs):
        args = [self.get(a) if isinstance(a, ObjectRef) else a for a in args]
        kwargs = {
            k: self.get(v) if isinstance(v, ObjectRef) else v for k, v in kwargs.items()
        }
        return args, kwargs

    def _execute(self, fn, args, kwargs, num_returns: int, refs: List[ObjectRef]):
        try:
            args, kwargs = self._resolve_args(args, kwargs)
            result = fn(*args, **kwargs)
            if inspect.iscoroutine(result):
                result = self._run_coroutine(result)
            if num_returns == 1:
                self._store_result(refs[0].id, result)
            else:
                values = list(result)
                for ref, v in zip(refs, values):
                    self._store_result(ref.id, v)
        except Exception as e:
            err = TaskError(repr(e), traceback.format_exc(), cause=e)
            for ref in refs:
                self._store_result(ref.id, err)

    def submit_task(self, remote_fn, args, kwargs, opts: TaskOptions):
        task_id = TaskID.of(self.job_id)
        refs = [
            ObjectRef(ObjectID.for_task_return(task_id, i))
            for i in range(opts.num_returns)
        ]
        self._execute(remote_fn.function, args, kwargs, opts.num_returns, refs)
        return refs[0] if opts.num_returns == 1 else refs

    # -- actors --
    def create_actor(self, actor_cls, args, kwargs, opts: ActorOptions):
        from ray_tpu_torch.actor import ActorHandle

        if opts.name and opts.get_if_exists:
            key = (opts.namespace or self.namespace, opts.name)
            if key in self._named:
                aid = self._named[key]
                inst = self._actors[aid]
                return ActorHandle(aid, _instance_methods(inst), type(inst).__name__)
        actor_id = ActorID.of(self.job_id)
        args, kwargs = self._resolve_args(args, kwargs)
        instance = actor_cls.cls(*args, **kwargs)
        self._actors[actor_id] = instance
        if opts.name:
            key = (opts.namespace or self.namespace, opts.name)
            if key in self._named:
                raise ValueError(f"actor name {opts.name!r} already taken")
            self._named[key] = actor_id
            self._actor_meta[actor_id] = key
        return ActorHandle(actor_id, _instance_methods(instance), actor_cls.class_name)

    def submit_actor_task(self, handle, method_name, args, kwargs, num_returns=1,
                          tensor_transport=""):
        # local mode runs in-process: values are already "device-resident",
        # so the transport tag is a no-op
        if handle.actor_id not in self._actors:
            raise ActorDiedError(f"actor {handle.actor_id.hex()} is dead")
        instance = self._actors[handle.actor_id]
        task_id = TaskID.of(self.job_id)
        refs = [
            ObjectRef(ObjectID.for_task_return(task_id, i)) for i in range(num_returns)
        ]
        method = getattr(instance, method_name)
        prev = self.current_actor_id
        self.current_actor_id = handle.actor_id
        try:
            self._execute(method, args, kwargs, num_returns, refs)
        finally:
            self.current_actor_id = prev
        return refs[0] if num_returns == 1 else refs

    def get_actor(self, name: str, namespace: Optional[str] = None):
        from ray_tpu_torch.actor import ActorHandle

        key = (namespace or self.namespace, name)
        if key not in self._named:
            raise ValueError(f"no actor named {name!r}")
        aid = self._named[key]
        inst = self._actors[aid]
        return ActorHandle(aid, _instance_methods(inst), type(inst).__name__)

    def kill_actor(self, handle, no_restart=True):
        self._actors.pop(handle.actor_id, None)
        key = self._actor_meta.pop(handle.actor_id, None)
        if key:
            self._named.pop(key, None)

    def cancel(self, ref, force=False, recursive=True):
        pass  # inline tasks already completed

    # -- cluster info --
    def cluster_resources(self):
        import os

        return {"CPU": float(os.cpu_count() or 1)}

    def available_resources(self):
        return self.cluster_resources()

    def nodes(self):
        return []

    def shutdown(self):
        self._objects.clear()
        self._actors.clear()
        self._named.clear()

    def free_objects(self, ids):
        for i in ids:
            self._objects.pop(i, None)


def _instance_methods(instance):
    return [
        n
        for n in dir(instance)
        if not n.startswith("__") and callable(getattr(instance, n, None))
    ]


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def init(
    address: Optional[str] = None,
    *,
    num_cpus: Optional[float] = None,
    num_gpus: Optional[float] = None,
    resources: Optional[Dict[str, float]] = None,
    labels: Optional[Dict[str, str]] = None,
    local_mode: bool = False,
    namespace: str = "default",
    ignore_reinit_error: bool = False,
    object_store_memory: Optional[int] = None,
    log_to_driver: bool = True,
    runtime_env: Optional[Dict[str, Any]] = None,
    include_dashboard: bool = False,
    dashboard_port: Optional[int] = None,
    _system_config: Optional[Dict[str, Any]] = None,
    device: str = "cuda",
):
    """Start (or connect to) a cluster and attach this process as the driver.

    Reference: ray.init (python/ray/_private/worker.py:1432). A new cluster
    on ``device="cuda"`` advertises the cards ``util.accelerators`` detects
    (unless ``num_gpus`` says otherwise) and raises when there are none;
    ``device="cpu"`` advertises ``num_gpus`` (default 0).
    """
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', not {device!r}")
    global _global_worker
    with _lock:
        if _global_worker is not None:
            if ignore_reinit_error:
                return _global_worker
            raise RuntimeError("ray_tpu_torch.init() already called (use "
                               "ignore_reinit_error=True)")
        if address is None:
            # submitted jobs find their cluster through the environment
            # (reference: RAY_ADDRESS handling in ray.init)
            import os

            address = os.environ.get("RAY_TPU_TORCH_ADDRESS") or None
        if _system_config:
            import os

            for k, v in _system_config.items():
                os.environ[f"RAY_TPU_{k.upper()}"] = str(v)
        if address and (address.startswith("ray-tpu://")
                        or address.startswith("ray_tpu://")):
            # client mode: thin external client -> in-cluster proxy
            # (reference: ray:// via python/ray/util/client)
            import logging as _logging

            unsupported = {"runtime_env": runtime_env, "num_cpus": num_cpus,
                           "num_gpus": num_gpus, "resources": resources,
                           "local_mode": local_mode or None}
            dropped = [k for k, v in unsupported.items() if v]
            if dropped:
                _logging.getLogger("ray_tpu_torch").warning(
                    "client mode ignores init() options %s — set them on "
                    "the cluster/proxy side", dropped)
            from ray_tpu_torch.util.client.client import ClientWorker

            _global_worker = ClientWorker(address, namespace=namespace)
            return _global_worker
        if local_mode:
            if runtime_env and runtime_env.get("env_vars"):
                import os

                os.environ.update(runtime_env["env_vars"])
            _global_worker = LocalWorker(namespace=namespace)
            return _global_worker
        if address is None and num_gpus is None:
            if device == "cpu":
                num_gpus = 0
            else:
                from ray_tpu_torch.util.accelerators import num_gpus_on_host

                if not num_gpus_on_host():
                    raise RuntimeError(
                        "ray_tpu_torch.init: no CUDA card on this host; pass "
                        "device='cpu' for a cluster without one")
        from ray_tpu_torch._private.core_worker import connect_driver

        _global_worker = connect_driver(
            address=address,
            num_cpus=num_cpus,
            num_gpus=num_gpus,
            resources=resources or {},
            labels=labels or {},
            namespace=namespace,
            object_store_memory=object_store_memory,
            log_to_driver=log_to_driver,
            include_dashboard=include_dashboard,
            dashboard_port=dashboard_port,
        )
        if runtime_env:
            from ray_tpu_torch._private.runtime_env import normalize

            # job-level default: merged into every task/actor whose options
            # don't set their own runtime_env
            _global_worker.job_runtime_env = normalize(runtime_env)
        from ray_tpu_torch.util import tracing as _tracing

        if _tracing.enabled():
            # tracing must reach workers on pre-started clusters too: ride
            # the job runtime env (raylet merges env_vars into worker spawns)
            renv = dict(_global_worker.job_runtime_env or {})
            env_vars = dict(renv.get("env_vars") or {})
            env_vars.setdefault("RAY_TPU_ENABLE_TRACING", "1")
            renv["env_vars"] = env_vars
            _global_worker.job_runtime_env = renv
        return _global_worker


def shutdown():
    global _global_worker
    with _lock:
        if _global_worker is not None:
            _global_worker.shutdown()
            _global_worker = None


def put(value: Any) -> ObjectRef:
    if isinstance(value, ObjectRef):
        raise TypeError("put() on an ObjectRef is not allowed")
    return global_worker().put(value)


def get(refs, *, timeout: Optional[float] = None):
    from ray_tpu_torch.dag import CompiledDAGRef

    if isinstance(refs, CompiledDAGRef):
        return refs.get(timeout if timeout is not None else 300.0)
    if isinstance(refs, (list, tuple)):
        bad = [r for r in refs if not isinstance(r, ObjectRef)]
        if bad:
            raise TypeError(f"get() expects ObjectRefs, got {type(bad[0]).__name__}")
    elif not isinstance(refs, ObjectRef):
        raise TypeError(f"get() expects an ObjectRef, got {type(refs).__name__}")
    return global_worker().get(refs, timeout=timeout)


def wait(
    refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: Optional[float] = None,
    fetch_local: bool = True,
):
    if isinstance(refs, ObjectRef):
        raise TypeError("wait() expects a list of ObjectRefs")
    if num_returns > len(refs):
        raise ValueError("num_returns exceeds number of refs")
    return global_worker().wait(
        list(refs), num_returns=num_returns, timeout=timeout, fetch_local=fetch_local
    )


def kill(actor_handle, *, no_restart: bool = True):
    global_worker().kill_actor(actor_handle, no_restart=no_restart)


def cancel(ref: ObjectRef, *, force: bool = False, recursive: bool = True):
    global_worker().cancel(ref, force=force, recursive=recursive)


def get_actor(name: str, namespace: Optional[str] = None):
    return global_worker().get_actor(name, namespace)


def remote(*args, **kwargs):
    """@ray_tpu.remote decorator for functions and classes.

    Reference: ray.remote (python/ray/_private/worker.py:3564).
    """
    from ray_tpu_torch.actor import ActorClass, build_actor_options
    from ray_tpu_torch.remote_function import RemoteFunction, build_task_options

    def make(target, options):
        if inspect.isclass(target):
            return ActorClass(target, build_actor_options(ActorOptions(), options))
        if not callable(target):
            raise TypeError("@remote must decorate a function or class")
        opts = build_task_options(TaskOptions(), options)
        return RemoteFunction(target, opts)

    if len(args) == 1 and not kwargs and (callable(args[0]) or inspect.isclass(args[0])):
        return make(args[0], {})
    if args:
        raise TypeError("@remote options must be keyword arguments")

    def decorator(target):
        return make(target, kwargs)

    return decorator


def cluster_resources() -> Dict[str, float]:
    return global_worker().cluster_resources()


def available_resources() -> Dict[str, float]:
    return global_worker().available_resources()


def nodes() -> List[Dict[str, Any]]:
    return global_worker().nodes()
