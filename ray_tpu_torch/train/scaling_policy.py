"""The weight-plane mesh of a worker group: ``mesh_spec_for``, the port of
``ray_tpu/train/scaling_policy.py:104-118``. The scaling policies that pick
the group's size need the train plane's config and come with its port."""

from __future__ import annotations


def mesh_spec_for(num_workers: int, axis: str = "data"):
    """The weight-plane mesh a worker group of this size forms: a 1-D mesh
    with one device per worker, host ids ``rank<i>``.

    This is the re-form contract for elastic resharding: an incarnation of
    size N saves its sharded state against ``mesh_spec_for(N)``; the
    re-formed incarnation of size M restores against ``mesh_spec_for(M)``
    and the planner moves only the shard slices that change hosts — no rank
    ever gathers the full state.
    """
    from ray_tpu_torch.weights.spec import MeshSpec

    return MeshSpec(shape=(num_workers,), axis_names=(axis,),
                    hosts=tuple(f"rank{i}" for i in range(num_workers)))
