"""Autoscaler cluster config (reference: cluster YAML schema
``python/ray/autoscaler/ray-schema.json`` — ``available_node_types`` with
per-type resources, min/max workers; TPU-first: a node type may describe a
whole TPU slice, which scales atomically at slice granularity the way
queued-resources provisioning does). The port of
``ray_tpu/autoscaler/config.py``: ``from_dict`` parses the same dict to the
same fields."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict


@dataclass
class NodeTypeConfig:
    name: str
    resources: Dict[str, float]
    labels: Dict[str, str] = field(default_factory=dict)
    min_workers: int = 0
    max_workers: int = 10
    # TPU slices scale as gangs: hosts_per_slice nodes are launched/terminated
    # together and share a generated slice-name label (reference:
    # _private/accelerators/tpu.py slice model + util/tpu.py reservation)
    hosts_per_slice: int = 1
    slice_label_key: str = "ray.io/tpu-slice-name"

    @property
    def is_slice(self) -> bool:
        return self.hosts_per_slice > 1


@dataclass
class ClusterConfig:
    node_types: Dict[str, NodeTypeConfig]
    # seconds a node must be idle before scale-down considers it
    idle_timeout_s: float = 60.0
    # max fraction of current size to add per round (>=1 node always allowed)
    upscaling_speed: float = 1.0
    max_total_nodes: int = 100

    @classmethod
    def from_dict(cls, d: dict) -> "ClusterConfig":
        types = {
            name: NodeTypeConfig(
                name=name,
                resources=dict(t.get("resources", {})),
                labels=dict(t.get("labels", {})),
                min_workers=int(t.get("min_workers", 0)),
                max_workers=int(t.get("max_workers", 10)),
                hosts_per_slice=int(t.get("hosts_per_slice", 1)),
            )
            for name, t in d.get("available_node_types", {}).items()
        }
        return cls(
            node_types=types,
            idle_timeout_s=float(d.get("idle_timeout_s", 60.0)),
            upscaling_speed=float(d.get("upscaling_speed", 1.0)),
            max_total_nodes=int(d.get("max_total_nodes", 100)),
        )
