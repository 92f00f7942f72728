"""Bin-packing of pending resource demands onto node types.

Reference: ``python/ray/autoscaler/_private/resource_demand_scheduler.py`` —
given (a) resource shapes the cluster cannot currently place, (b) existing
nodes, and (c) the node-type catalog, decide how many nodes of which types
to add, respecting min/max workers. Strict-spread placement-group shapes
count one node per bundle. TPU slice types are all-or-nothing gangs. The port of
``ray_tpu/autoscaler/resource_demand_scheduler.py``: the same decisions for
the same inputs."""

from __future__ import annotations

from typing import Dict, List, Tuple

from ray_tpu_torch._private.common import label_match
from ray_tpu_torch.autoscaler.config import ClusterConfig, NodeTypeConfig


def _fits(avail: Dict[str, float], shape: Dict[str, float],
          labels: Dict[str, str] = None, selector: Dict[str, str] = None) -> bool:
    if selector and not label_match(labels or {}, selector):
        return False
    return all(avail.get(k, 0.0) >= v for k, v in shape.items() if v > 0)


def _sub(avail: Dict[str, float], shape: Dict[str, float]) -> None:
    for k, v in shape.items():
        avail[k] = avail.get(k, 0.0) - v


def _norm_demand(d) -> Tuple[Dict[str, float], Dict[str, str]]:
    """Accepts a bare shape dict or {'shape':..., 'selector':...}."""
    if isinstance(d, dict) and "shape" in d:
        return dict(d["shape"]), dict(d.get("selector") or {})
    return dict(d), {}


def get_nodes_to_launch(
    config: ClusterConfig,
    existing_by_type: Dict[str, int],
    node_available: List,
    demands: List,
    strict_spread_shapes: List[List[Dict[str, float]]] = (),
) -> Dict[str, int]:
    """Returns {node_type: count} to launch.

    ``node_available`` holds per-node free-resource views of the live
    cluster — either bare dicts or {'available':..., 'labels':...};
    demands (bare shapes or {'shape','selector'}) that fit on it are
    dropped (they'll schedule without scaling). The rest are
    first-fit-decreasing packed onto virtual copies of node types, with
    label selectors honored against node/type labels."""
    to_launch: Dict[str, int] = {}

    # honor min_workers before anything else (exempt from the upscaling-speed
    # budget: a cluster below its floor always scales straight to it)
    min_launch: Dict[str, int] = {}
    for name, t in config.node_types.items():
        have = existing_by_type.get(name, 0)
        if have < t.min_workers:
            min_launch[name] = t.min_workers - have
            to_launch[name] = min_launch[name]

    free: List[Tuple[Dict[str, float], Dict[str, str]]] = []
    for a in node_available:
        if isinstance(a, dict) and "available" in a:
            free.append((dict(a["available"]), dict(a.get("labels") or {})))
        else:
            free.append((dict(a), {}))
    # virtual nodes created this round (free capacity still packable)
    virtual: List[Tuple[str, Dict[str, float], Dict[str, str]]] = []

    def _add_virtual(t: NodeTypeConfig):
        for _ in range(t.hosts_per_slice):
            virtual.append((t.name, dict(t.resources), dict(t.labels)))

    for name, n in to_launch.items():
        for _ in range(n):
            _add_virtual(config.node_types[name])

    norm = [_norm_demand(d) for d in demands]
    unmet: List[Tuple[Dict[str, float], Dict[str, str]]] = []
    order = sorted(norm, key=lambda d: -sum(d[0].values()))
    for shape, selector in order:
        placed = False
        for avail, labels in free:
            if _fits(avail, shape, labels, selector):
                _sub(avail, shape)
                placed = True
                break
        if not placed:
            for _, avail, labels in virtual:
                if _fits(avail, shape, labels, selector):
                    _sub(avail, shape)
                    placed = True
                    break
        if not placed:
            unmet.append((shape, selector))

    # pick node types for unmet shapes: smallest type that fits each shape
    # (first-fit-decreasing over a cost = sum of resources)
    types_by_cost = sorted(
        config.node_types.values(), key=lambda t: sum(t.resources.values()))
    for shape, selector in unmet:
        chosen = None
        for t in types_by_cost:
            if _fits(dict(t.resources), shape, t.labels, selector):
                chosen = t
                break
        if chosen is None:
            continue  # infeasible on any type; surface via status instead
        have = existing_by_type.get(chosen.name, 0) + to_launch.get(chosen.name, 0)
        if have >= chosen.max_workers:
            continue
        to_launch[chosen.name] = to_launch.get(chosen.name, 0) + 1
        _add_virtual(chosen)
        # retro-fit: this new node may absorb later shapes via `virtual`

    # strict-spread groups: each bundle needs a distinct node
    for bundles in strict_spread_shapes:
        nodes_needed = 0
        scratch = ([dict(a) for a, _ in free]
                   + [dict(a) for _, a, _ in virtual])
        used = [False] * len(scratch)
        for b in bundles:
            placed = False
            for i, avail in enumerate(scratch):
                if not used[i] and _fits(avail, b):
                    used[i] = True
                    _sub(avail, b)
                    placed = True
                    break
            if not placed:
                nodes_needed += 1
        if nodes_needed:
            # smallest type that fits the largest bundle
            biggest = max(bundles, key=lambda s: sum(s.values()))
            for t in types_by_cost:
                if _fits(dict(t.resources), biggest):
                    have = (existing_by_type.get(t.name, 0)
                            + to_launch.get(t.name, 0))
                    add = min(nodes_needed, max(0, t.max_workers - have))
                    if add:
                        to_launch[t.name] = to_launch.get(t.name, 0) + add
                    break

    # cap demand-driven launches by cluster size and upscaling speed
    # (min_workers launches bypass the speed budget, not the size cap)
    total_existing = sum(existing_by_type.values())
    budget = max(1, int(config.upscaling_speed * max(total_existing, 1)))
    capped: Dict[str, int] = {}
    room = max(0, config.max_total_nodes - total_existing)
    for name, n in to_launch.items():
        floor = min(min_launch.get(name, 0), n, room)
        extra = min(n - floor, budget, max(0, room - floor))
        take = floor + extra
        if take > 0:
            capped[name] = take
            budget -= extra
            room -= take * config.node_types[name].hosts_per_slice
    return capped


def get_nodes_to_terminate(
    config: ClusterConfig,
    nodes: List[dict],
) -> List[dict]:
    """Scale-down: idle (no used resources) longer than idle_timeout_s and
    above min_workers. ``nodes`` entries: {"node_type", "idle_s", "used"}.
    Slice gangs terminate only when every host of the slice is idle."""
    by_type: Dict[str, List[dict]] = {}
    for n in nodes:
        by_type.setdefault(n["node_type"], []).append(n)
    victims: List[dict] = []
    for name, members in by_type.items():
        t = config.node_types.get(name)
        if t is None:
            continue
        idle = [n for n in members
                if n["idle_s"] >= config.idle_timeout_s and not n["used"]]
        if t.is_slice:
            # group by slice; a slice is terminable only if all hosts idle
            slices: Dict[str, List[dict]] = {}
            for n in members:
                slices.setdefault(n.get("slice_name", ""), []).append(n)
            removable = []
            for sname, hosts in slices.items():
                if all(h in idle for h in hosts):
                    removable.append(hosts)
            keep = t.min_workers
            for hosts in removable[: max(0, len(removable) - keep)]:
                victims.extend(hosts)
        else:
            excess = len(members) - t.min_workers
            idle.sort(key=lambda n: -n["idle_s"])
            victims.extend(idle[: max(0, min(len(idle), excess))])
    return victims
