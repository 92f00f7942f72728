"""ray_tpu_torch.weights: mesh-aware sharded weight transfer and live
resharding, the port of ``ray_tpu.weights``.

The weight plane moves sharded model state between actors (learner ->
env-runners, train mesh -> serve replicas, old mesh -> re-formed elastic
mesh) without ever materializing a full array on one host; the checkpoint
plane reads its geometry (``spec``, ``plan``).

Public surface::

    from ray_tpu_torch import weights

    spec = weights.ShardedTreeSpec.from_tree(tree, mesh, parts={...})
    plan = weights.plan_reshard(src_spec, dst_spec)   # inspectable
    store = weights.WeightStore("policy")             # named, in the GCS
    v = store.publish(tree)                           # broadcast source
    weights.publish_host_shards(store, v2, spec, host, shards)  # mesh source
    tree = store.pull()                               # replicated consumer
    shards = store.pull_shards(dst_spec, host)        # sharded consumer
    sub = store.subscribe(); sub.poll(timeout=10)     # long-poll updates

``jax_reshard`` (the JAX package's in-process device tier) raises until its
port (ROADMAP.md).

Lazy exports (PEP 562): importing the package imports none of its modules.
"""

_EXPORTS = {
    "TransferEdge": "plan", "TransferPlan": "plan", "plan_reshard": "plan",
    "DcnCostModel": "plan", "RedistributionProgram": "plan",
    "ReshardLoweringError": "plan", "lower_collective": "plan",
    "maybe_lower_collective": "plan", "lowering_fallback_counts": "plan",
    "MeshSpec": "spec", "ShardedTreeSpec": "spec",
    "flatten_tree": "spec", "unflatten_tree": "spec",
    "WeightStore": "store", "WeightStoreActor": "store",
    "WeightSubscription": "store",
    "load_durable": "store", "durable_versions": "store",
    "collective_reshard": "transport", "jax_reshard": "transport",
    "local_shards_of": "transport", "publish_host_shards": "transport",
    "pull_with_locals": "transport", "redistribute": "transport",
    "reshard_lowering_stats": "transport",
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
