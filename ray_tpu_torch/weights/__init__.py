"""The geometry of sharded state, for the checkpoint plane: mesh specs,
shard boxes, pytrees (``spec``) and the resharding planner (``plan``), the
port of ``ray_tpu/weights``' hardware-free half. The weight store and its
transports (publish, pull, live resharding between actors) need the
runtime and come with its port.

Lazy exports (PEP 562): importing the package imports neither module.
"""

_EXPORTS = {
    "TransferEdge": "plan", "TransferPlan": "plan", "plan_reshard": "plan",
    "DcnCostModel": "plan", "RedistributionProgram": "plan",
    "ReshardLoweringError": "plan", "lower_collective": "plan",
    "maybe_lower_collective": "plan", "lowering_fallback_counts": "plan",
    "MeshSpec": "spec", "ShardedTreeSpec": "spec",
    "flatten_tree": "spec", "unflatten_tree": "spec",
}


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module 'ray_tpu_torch.weights' has no "
                             f"attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f"ray_tpu_torch.weights.{mod}"),
                   name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))


__all__ = sorted(_EXPORTS)
