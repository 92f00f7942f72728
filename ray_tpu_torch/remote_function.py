"""@ray_tpu_torch.remote on functions: the port of
``ray_tpu/remote_function.py`` (reference: python/ray/remote_function.py).
DAG authoring (``bind``) raises until the port has it."""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict

from ray_tpu_torch._private.common import TaskOptions


_OPTION_FIELDS = set(TaskOptions.__dataclass_fields__)


def build_task_options(defaults: TaskOptions, overrides: Dict[str, Any]) -> TaskOptions:
    opts = copy.copy(defaults)
    for key, value in overrides.items():
        if key in _OPTION_FIELDS:
            setattr(opts, key, value)
        else:
            raise ValueError(f"unknown option {key!r}")
    # a PlacementGroupSchedulingStrategy implies the pg fields
    strat = opts.scheduling_strategy
    if strat is not None and hasattr(strat, "placement_group"):
        opts.placement_group = strat.placement_group
        opts.placement_group_bundle_index = getattr(
            strat, "placement_group_bundle_index", -1
        )
    if opts.runtime_env:
        # validate HERE (decoration / .options() time), once — not per
        # .remote() in the submit hot loop; invalid envs raise to the user
        from ray_tpu_torch._private import runtime_env as renv_mod

        opts.runtime_env = renv_mod.normalize(opts.runtime_env)
    return opts


class RemoteFunction:
    def __init__(self, function: Callable, options: TaskOptions):
        self._function = function
        self._options = options
        self._function_name = getattr(function, "__qualname__", repr(function))
        self.__doc__ = function.__doc__

    @property
    def function(self) -> Callable:
        return self._function

    @property
    def function_name(self) -> str:
        return self._function_name

    @property
    def task_options(self) -> TaskOptions:
        return self._options

    def options(self, **overrides) -> "RemoteFunction":
        return RemoteFunction(self._function, build_task_options(self._options, overrides))

    def remote(self, *args, **kwargs):
        from ray_tpu_torch._private import worker as _worker

        return _worker.global_worker().submit_task(self, args, kwargs, self._options)

    def bind(self, *args, **kwargs):
        """DAG authoring (reference: python/ray/dag/function_node.py)."""
        from ray_tpu_torch.dag import FunctionNode

        return FunctionNode(self, args, kwargs)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"remote function {self._function_name} cannot be called directly; "
            f"use .remote(...)"
        )
