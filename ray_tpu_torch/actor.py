"""@ray_tpu_torch.remote on classes: ActorClass / ActorHandle / ActorMethod,
the port of ``ray_tpu/actor.py``.

Reference: python/ray/actor.py (ActorClass._remote, ActorHandle,
concurrency groups, max_restarts semantics), and DAG authoring
(``bind``, ``ray_tpu_torch/dag``).
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional

from ray_tpu_torch._private.common import ActorOptions
from ray_tpu_torch._private.ids import ActorID

_OPTION_FIELDS = set(ActorOptions.__dataclass_fields__)


def build_actor_options(defaults: ActorOptions, overrides: Dict[str, Any]) -> ActorOptions:
    opts = copy.copy(defaults)
    for key, value in overrides.items():
        if key in _OPTION_FIELDS:
            setattr(opts, key, value)
        else:
            raise ValueError(f"unknown actor option {key!r}")
    strat = opts.scheduling_strategy
    if strat is not None and hasattr(strat, "placement_group"):
        opts.placement_group = strat.placement_group
        opts.placement_group_bundle_index = getattr(strat, "placement_group_bundle_index", -1)
    return opts


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str, num_returns: int = 1):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns

    def options(self, **overrides) -> "ActorMethod":
        m = ActorMethod(self._handle, self._method_name, self._num_returns)
        m._overrides = overrides
        return m

    def remote(self, *args, **kwargs):
        from ray_tpu_torch._private import worker as _worker

        overrides = getattr(self, "_overrides", {})
        return _worker.global_worker().submit_actor_task(
            self._handle, self._method_name, args, kwargs,
            num_returns=overrides.get("num_returns", self._num_returns),
            tensor_transport=overrides.get("tensor_transport", ""),
        )

    def bind(self, *args, **kwargs):
        from ray_tpu_torch.dag import ClassMethodNode

        return ClassMethodNode(self._handle, self._method_name, args, kwargs)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"actor method {self._method_name} cannot be called directly; use .remote(...)"
        )


class ActorHandle:
    def __init__(self, actor_id: ActorID, method_names, class_name: str = "",
                 max_task_retries: int = 0):
        self._actor_id = actor_id
        self._method_names = tuple(method_names)
        self._class_name = class_name
        self._max_task_retries = max_task_retries

    @property
    def actor_id(self) -> ActorID:
        return self._actor_id

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("__"):
            raise AttributeError(name)
        if self._method_names and name not in self._method_names:
            raise AttributeError(
                f"actor {self._class_name or self._actor_id} has no method {name!r}"
            )
        return ActorMethod(self, name)

    def __reduce__(self):
        return (
            _rebuild_handle,
            (self._actor_id.binary(), self._method_names, self._class_name,
             self._max_task_retries),
        )

    def __hash__(self):
        return hash(self._actor_id)

    def __eq__(self, other):
        return isinstance(other, ActorHandle) and other._actor_id == self._actor_id

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()[:12]})"


def _rebuild_handle(id_bytes, method_names, class_name, max_task_retries):
    return ActorHandle(ActorID(id_bytes), method_names, class_name, max_task_retries)


class ActorClass:
    def __init__(self, cls: type, options: ActorOptions):
        self._cls = cls
        self._options = options
        self.__doc__ = cls.__doc__

    @property
    def cls(self) -> type:
        return self._cls

    @property
    def class_name(self) -> str:
        return self._cls.__name__

    @property
    def actor_options(self) -> ActorOptions:
        return self._options

    def method_names(self):
        return [
            n
            for n in dir(self._cls)
            if not n.startswith("__") and callable(getattr(self._cls, n, None))
        ]

    def options(self, **overrides) -> "ActorClass":
        return ActorClass(self._cls, build_actor_options(self._options, overrides))

    def remote(self, *args, **kwargs) -> ActorHandle:
        from ray_tpu_torch._private import worker as _worker

        return _worker.global_worker().create_actor(self, args, kwargs, self._options)

    def bind(self, *args, **kwargs):
        from ray_tpu_torch.dag import ClassNode

        return ClassNode(self, args, kwargs)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"actor class {self.class_name} cannot be instantiated directly; "
            f"use .remote(...)"
        )


def method(num_returns: int = 1, concurrency_group: str = "", tensor_transport: str = ""):
    """@ray_tpu_torch.method decorator for per-method options (reference:
    ray.method). Any non-empty ``tensor_transport`` but ``"object"`` keeps
    the returned value in the producing worker and ships a
    ``DeviceObjectMarker`` (``experimental/device_objects.py``)."""

    def decorator(fn):
        fn.__ray_tpu_num_returns__ = num_returns
        fn.__ray_tpu_concurrency_group__ = concurrency_group
        fn.__ray_tpu_tensor_transport__ = tensor_transport
        return fn

    return decorator
