"""Scaling policies: how the Train controller sizes the worker group, and the
weight-plane mesh of a group; the port of ``ray_tpu/train/scaling_policy.py``.

Reference: train/v2/_internal/execution/scaling_policy/scaling_policy.py:32
(the interface designed for elasticity) and fixed.py:13 (the fixed policy).

A ``torch.distributed`` process group cannot shrink in place, as a
``jax.distributed`` mesh cannot: elastic recovery kills the group and
re-forms FRESH processes at a smaller world size, and that size must be
mesh-shaped: a whole multiple of ``granularity=N`` or a power of two
(``granularity="pow2"``), never an arbitrary count.
"""

from __future__ import annotations

import logging
from dataclasses import replace
from typing import Dict, Optional

from ray_tpu_torch.train.config import ScalingConfig

logger = logging.getLogger("ray_tpu_torch.train")


class ScalingPolicy:
    """Decides worker-group sizes over the run's lifetime."""

    def initial_size(self, available: Dict[str, float]) -> int:
        raise NotImplementedError

    def size_after_failure(self, current: int,
                           available: Dict[str, float]) -> Optional[int]:
        """New group size after a failure, or None to give up resizing
        (the failure policy then counts it as a plain restart failure)."""
        raise NotImplementedError


class FixedScalingPolicy(ScalingPolicy):
    """Always the configured size (reference: scaling_policy/fixed.py:13)."""

    def __init__(self, scaling: ScalingConfig):
        self.scaling = scaling

    def initial_size(self, available):
        return self.scaling.num_workers

    def size_after_failure(self, current, available):
        return self.scaling.num_workers  # same shape, fresh processes


class ElasticScalingPolicy(ScalingPolicy):
    """Re-form at the largest mesh-shaped size the cluster can host.

    On worker loss the group restarts at
    ``min(num_workers, max feasible by available resources)`` rounded DOWN
    to the granularity (a whole multiple / power of two), bounded below by
    ``min_workers`` — e.g. losing 1 of 4 single-CPU workers on a shrunken
    cluster re-forms at 2, not 3. A worker's ``GPU`` counts as any other
    resource of its bundle.
    """

    def __init__(self, scaling: ScalingConfig):
        self.scaling = scaling
        self.min_workers = max(1, scaling.min_workers)

    def _max_feasible(self, available: Dict[str, float]) -> int:
        per = self.scaling.bundle()
        counts = [int(available.get(k, 0.0) // v)
                  for k, v in per.items() if v > 0]
        return min(counts) if counts else 0

    def _round_to_shape(self, n: int) -> int:
        g = self.scaling.elastic_granularity
        if g == "pow2":
            size = 1
            while size * 2 <= n:
                size *= 2
            return size if n >= 1 else 0
        step = max(1, int(g))
        return (n // step) * step

    def initial_size(self, available):
        feasible = min(self.scaling.num_workers,
                       self._max_feasible(available))
        size = self._round_to_shape(feasible)
        return max(size, 0)

    def size_after_failure(self, current, available):
        size = self._round_to_shape(
            min(self.scaling.num_workers, self._max_feasible(available)))
        if size < self.min_workers:
            return None  # cluster too small even for the floor
        if size != current:
            logger.warning(
                "elastic resize: worker group re-forming at %d (was %d)",
                size, current)
        return size


def make_scaling_policy(scaling: ScalingConfig) -> ScalingPolicy:
    if scaling.elastic:
        return ElasticScalingPolicy(scaling)
    return FixedScalingPolicy(scaling)


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


def sized(scaling: ScalingConfig, num_workers: int) -> ScalingConfig:
    return replace(scaling, num_workers=num_workers)
