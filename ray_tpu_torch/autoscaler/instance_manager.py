"""Autoscaler v2: per-instance lifecycle state machine + reconciler.

Reference: python/ray/autoscaler/v2/instance_manager/ — v2 replaced v1's
launch-and-forget loop with an explicit per-instance state machine
(QUEUED → REQUESTED → ALLOCATED → RAY_RUNNING → RAY_STOPPING →
TERMINATING → TERMINATED, with ALLOCATION_FAILED retries), durable
instance storage, and a reconciler that converges instance states against
both the cloud provider's view and the GCS's live-node view. This build
keeps v1's demand scheduler (resource_demand_scheduler.py) for target
computation and adds the v2 lifecycle underneath it. The port of
``ray_tpu/autoscaler/instance_manager.py``: its ``dump()`` records restore
in either package.
"""

from __future__ import annotations

import logging
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

logger = logging.getLogger("ray_tpu_torch.autoscaler.v2")

# the label raylets carry to map GCS nodes back to provider nodes — import
# the real constant so the join cannot drift from what providers set
from ray_tpu_torch.autoscaler.autoscaler import PROVIDER_ID_LABEL

# lifecycle states (reference: instance_manager/common.py InstanceUtil)
QUEUED = "QUEUED"
REQUESTED = "REQUESTED"
ALLOCATED = "ALLOCATED"
RAY_RUNNING = "RAY_RUNNING"
RAY_STOPPING = "RAY_STOPPING"
TERMINATING = "TERMINATING"
TERMINATED = "TERMINATED"
ALLOCATION_FAILED = "ALLOCATION_FAILED"

_TRANSITIONS = {
    QUEUED: {REQUESTED, TERMINATED},
    REQUESTED: {ALLOCATED, ALLOCATION_FAILED, TERMINATING},
    ALLOCATED: {RAY_RUNNING, TERMINATING},
    RAY_RUNNING: {RAY_STOPPING, TERMINATING},
    RAY_STOPPING: {TERMINATING},
    TERMINATING: {TERMINATED},
    ALLOCATION_FAILED: {QUEUED, TERMINATED},
    TERMINATED: set(),
}

# states that count toward a node type's live capacity target
ACTIVE_STATES = (QUEUED, REQUESTED, ALLOCATED, RAY_RUNNING)


class InvalidTransition(RuntimeError):
    pass


@dataclass
class Instance:
    instance_id: str
    node_type: str
    state: str = QUEUED
    provider_node_id: str = ""
    raylet_node_id: str = ""
    slice_name: str = ""
    created_at: float = field(default_factory=time.time)
    state_since: float = field(default_factory=time.time)
    last_seen: float = 0.0  # last time the GCS reported the node alive
    retries: int = 0
    history: List[tuple] = field(default_factory=list)  # (ts, from, to, why)

    def dump(self) -> dict:
        return {k: getattr(self, k) for k in (
            "instance_id", "node_type", "state", "provider_node_id",
            "raylet_node_id", "slice_name", "created_at", "state_since",
            "last_seen", "retries")}

    @classmethod
    def restore(cls, d: dict) -> "Instance":
        inst = cls(instance_id=d["instance_id"], node_type=d["node_type"])
        for k, v in d.items():
            setattr(inst, k, v)
        return inst


class InstanceManager:
    """Owns every instance's lifecycle; persists through a pluggable
    store (dict-like: __setitem__/__delitem__/values) so a restarted
    autoscaler resumes mid-flight instances instead of double-launching."""

    def __init__(self, store: Optional[Any] = None,
                 request_timeout_s: float = 120.0,
                 ray_start_timeout_s: float = 300.0,
                 max_allocation_retries: int = 3,
                 retry_backoff_s: float = 5.0):
        self._store = store if store is not None else {}
        self.request_timeout_s = request_timeout_s
        self.ray_start_timeout_s = ray_start_timeout_s
        self.max_allocation_retries = max_allocation_retries
        self.retry_backoff_s = retry_backoff_s
        self.instances: Dict[str, Instance] = {}
        for d in list(self._store.values()):
            inst = Instance.restore(d)
            self.instances[inst.instance_id] = inst

    # -- state machine -------------------------------------------------

    def transition(self, inst: Instance, to: str, why: str = "") -> None:
        if to not in _TRANSITIONS[inst.state]:
            raise InvalidTransition(
                f"{inst.instance_id[:8]}: {inst.state} -> {to} ({why!r})")
        inst.history.append((time.time(), inst.state, to, why))
        logger.info("instance %s (%s): %s -> %s%s", inst.instance_id[:8],
                    inst.node_type, inst.state, to,
                    f" ({why})" if why else "")
        inst.state = to
        inst.state_since = time.time()
        if to == TERMINATED:
            self.instances.pop(inst.instance_id, None)
            try:
                del self._store[inst.instance_id]
            except KeyError:
                pass
        else:
            self._store[inst.instance_id] = inst.dump()

    def add(self, node_type: str) -> Instance:
        inst = Instance(instance_id=uuid.uuid4().hex, node_type=node_type)
        self.instances[inst.instance_id] = inst
        self._store[inst.instance_id] = inst.dump()
        return inst

    def by_state(self, *states: str) -> List[Instance]:
        return [i for i in self.instances.values() if i.state in states]

    def active_count(self, node_type: str) -> int:
        return sum(1 for i in self.instances.values()
                   if i.node_type == node_type and i.state in ACTIVE_STATES)

    # -- reconciliation ------------------------------------------------

    def set_targets(self, targets: Dict[str, int]) -> None:
        """Converge queued/surplus instances toward per-type targets."""
        for node_type, want in targets.items():
            have = self.active_count(node_type)
            for _ in range(max(0, want - have)):
                self.add(node_type)
        for node_type, want in targets.items():
            surplus = self.active_count(node_type) - want
            if surplus <= 0:
                continue
            # shed from the least-committed end first; every shed here
            # is an ACTIVE instance, so the surplus accounting stays true
            # (failed instances are not active and retire via step())
            shed_plan = ((QUEUED, TERMINATED), (REQUESTED, TERMINATING),
                         (ALLOCATED, TERMINATING), (RAY_RUNNING, RAY_STOPPING))
            for state, to in shed_plan:
                for inst in self.by_state(state):
                    if surplus <= 0:
                        break
                    if inst.node_type == node_type:
                        self.transition(inst, to, "target shrank")
                        surplus -= 1

    def step(self, provider, node_types: Dict[str, Any],
             gcs_nodes: Optional[List[dict]] = None,
             drain: Optional[Callable[[str], None]] = None) -> dict:
        """One reconcile pass against the provider + GCS views."""
        now = time.time()
        provider_nodes = {n.node_id: n for n in provider.non_terminated_nodes()}
        gcs_by_provider: Dict[str, dict] = {}
        for n in gcs_nodes or []:
            pid = n.get("labels", {}).get(PROVIDER_ID_LABEL, "")
            if pid:
                gcs_by_provider[pid] = n

        # QUEUED -> REQUESTED (respecting retry backoff)
        for inst in self.by_state(QUEUED):
            if inst.retries and now - inst.state_since < \
                    self.retry_backoff_s * (2 ** (inst.retries - 1)):
                continue
            t = node_types[inst.node_type]
            try:
                nodes = provider.create_nodes(t, 1)
            except Exception as e:
                self.transition(inst, REQUESTED, "launch call")
                self.transition(inst, ALLOCATION_FAILED, str(e))
                continue
            self.transition(inst, REQUESTED, "launch call")
            if nodes:
                inst.provider_node_id = nodes[0].node_id
                inst.slice_name = getattr(nodes[0], "slice_name", "")
                self.transition(inst, ALLOCATED, "provider returned node")
            # async providers return later; found via provider view below

        # REQUESTED -> ALLOCATED / ALLOCATION_FAILED (timeout). Async
        # providers return no node from create_nodes(): adopt an unclaimed
        # provider node of the right type from the view, so a late
        # provision is tracked instead of leaking while we re-launch.
        claimed = {i.provider_node_id for i in self.instances.values()
                   if i.provider_node_id}
        for inst in self.by_state(REQUESTED):
            if inst.provider_node_id and inst.provider_node_id in provider_nodes:
                self.transition(inst, ALLOCATED, "provider view")
                continue
            if not inst.provider_node_id:
                orphan = next(
                    (n for n in provider_nodes.values()
                     if n.node_id not in claimed
                     and getattr(n, "node_type", "") == inst.node_type), None)
                if orphan is not None:
                    inst.provider_node_id = orphan.node_id
                    inst.slice_name = getattr(orphan, "slice_name", "")
                    claimed.add(orphan.node_id)
                    self.transition(inst, ALLOCATED, "adopted provider node")
                    continue
            if now - inst.state_since > self.request_timeout_s:
                self.transition(inst, ALLOCATION_FAILED, "request timed out")

        # ALLOCATION_FAILED -> QUEUED (retry) or TERMINATED (gave up)
        for inst in self.by_state(ALLOCATION_FAILED):
            if inst.retries + 1 > self.max_allocation_retries:
                self.transition(inst, TERMINATED,
                                f"gave up after {inst.retries} retries")
            else:
                inst.retries += 1
                inst.provider_node_id = ""
                self.transition(inst, QUEUED,
                                f"retry {inst.retries}")

        # ALLOCATED -> RAY_RUNNING when its raylet registers; stuck -> kill
        for inst in self.by_state(ALLOCATED):
            g = gcs_by_provider.get(inst.provider_node_id)
            if g is not None and g.get("alive"):
                inst.raylet_node_id = g.get("node_id", "")
                inst.last_seen = now
                self.transition(inst, RAY_RUNNING, "raylet registered")
            elif now - inst.state_since > self.ray_start_timeout_s:
                self.transition(inst, TERMINATING, "raylet never registered")

        # RAY_RUNNING whose node died under us -> TERMINATING. A node
        # that VANISHED from the GCS view (entry evicted/tombstoned) is
        # dead too — after a grace window covering a missed poll.
        for inst in self.by_state(RAY_RUNNING):
            g = gcs_by_provider.get(inst.provider_node_id)
            if g is not None and g.get("alive", True):
                inst.last_seen = now
            elif g is not None:
                self.transition(inst, TERMINATING, "node died")
            elif gcs_nodes is not None and inst.last_seen                     and now - inst.last_seen > self.request_timeout_s:
                self.transition(inst, TERMINATING, "node vanished from GCS")

        # RAY_STOPPING: drain, then terminate
        for inst in self.by_state(RAY_STOPPING):
            if drain is not None and inst.raylet_node_id:
                try:
                    drain(inst.raylet_node_id)
                except Exception as e:
                    logger.debug("drain of %s failed (instance still "
                                 "terminates): %s", inst.instance_id, e)
            self.transition(inst, TERMINATING, "drained")

        # TERMINATING -> provider terminate -> TERMINATED
        for inst in self.by_state(TERMINATING):
            node = provider_nodes.get(inst.provider_node_id)
            if node is not None:
                try:
                    provider.terminate_node(node)
                except Exception as e:
                    logger.warning("terminate %s failed: %s",
                                   inst.provider_node_id, e)
                    continue
            self.transition(inst, TERMINATED, "provider terminated")

        by_state: Dict[str, int] = {}
        for inst in self.instances.values():
            by_state[inst.state] = by_state.get(inst.state, 0) + 1
        return {"instances": len(self.instances), "by_state": by_state}
