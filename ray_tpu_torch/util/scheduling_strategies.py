"""Scheduling strategies, the port of ``ray_tpu/util/scheduling_strategies.py``
(reference: python/ray/util/scheduling_strategies.py).

``.options(scheduling_strategy=...)`` takes any of these on a task or an
actor; a ``PlacementGroupSchedulingStrategy`` also sets the options'
``placement_group`` and ``placement_group_bundle_index``."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict


@dataclass
class PlacementGroupSchedulingStrategy:
    placement_group: object
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False


@dataclass
class NodeAffinitySchedulingStrategy:
    node_id: str  # hex node id
    soft: bool = False


@dataclass
class NodeLabelSchedulingStrategy:
    """Schedule onto a node whose labels match (reference:
    src/ray/raylet/scheduling/policy/node_label_scheduling_policy.cc)."""

    hard: Dict[str, str] = field(default_factory=dict)
    soft: Dict[str, str] = field(default_factory=dict)


@dataclass
class SpreadSchedulingStrategy:
    pass


DEFAULT = "DEFAULT"
SPREAD = "SPREAD"
