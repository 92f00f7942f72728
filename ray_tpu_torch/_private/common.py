"""Shared runtime datatypes: task/actor specs, resources, node info.

Equivalent of the reference's ``src/ray/common`` task/lease specifications
(``common/task/``, ``common/lease/``) and scheduling datatypes
(``common/scheduling/cluster_resource_data.h``, ``label_selector.h``) —
with ``GPU`` cards as a first-class resource (``num_gpus``, where the JAX
package's ``ray_tpu/_private/common.py`` has ``num_tpus`` and ``TPU``), and
node labels (the card's name among them) that the scheduler can select on.
"""

from __future__ import annotations

import os

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private.ids import ActorID, JobID, NodeID, ObjectID, PlacementGroupID, TaskID

# Well-known node label keys (reference: ray._raylet label constants).
LABEL_NODE_ID = "ray_tpu.io/node-id"
LABEL_ACCELERATOR_TYPE = "ray_tpu.io/accelerator-type"  # the card's name
LABEL_MARKET_TYPE = "ray_tpu.io/market-type"


def resources_ge(avail: Dict[str, float], need: Dict[str, float]) -> bool:
    return all(avail.get(k, 0.0) + 1e-9 >= v for k, v in need.items())


def resources_sub(avail: Dict[str, float], need: Dict[str, float]) -> None:
    for k, v in need.items():
        avail[k] = avail.get(k, 0.0) - v


def resources_add(avail: Dict[str, float], need: Dict[str, float]) -> None:
    for k, v in need.items():
        avail[k] = avail.get(k, 0.0) + v


def label_match(labels: Dict[str, str], selector: Dict[str, str]) -> bool:
    """Equality / negation ("!value") / "in" ("a|b") selector semantics.

    Reference: src/ray/common/scheduling/label_selector.h.
    """
    for key, want in selector.items():
        have = labels.get(key)
        if want.startswith("!"):
            if have == want[1:]:
                return False
        elif "|" in want:
            if have not in want.split("|"):
                return False
        elif have != want:
            return False
    return True


@dataclass
class NodeInfo:
    node_id: NodeID
    address: str  # raylet rpc address host:port
    object_store_address: str
    total_resources: Dict[str, float]
    labels: Dict[str, str] = field(default_factory=dict)
    alive: bool = True
    is_head: bool = False
    start_time: float = field(default_factory=time.time)

    def to_dict(self):
        return {
            "node_id": self.node_id.hex(),
            "address": self.address,
            "object_store_address": self.object_store_address,
            "total_resources": dict(self.total_resources),
            "labels": dict(self.labels),
            "alive": self.alive,
            "is_head": self.is_head,
        }


@dataclass
class TaskOptions:
    num_cpus: float = 1.0
    num_gpus: float = 0.0
    resources: Dict[str, float] = field(default_factory=dict)
    memory: Optional[float] = None
    num_returns: int = 1
    max_retries: int = -1  # -1 -> config default
    retry_exceptions: bool = False
    name: str = ""
    label_selector: Dict[str, str] = field(default_factory=dict)
    scheduling_strategy: Any = None  # see util/scheduling_strategies.py
    placement_group: Any = None
    placement_group_bundle_index: int = -1
    runtime_env: Optional[Dict[str, Any]] = None

    def required_resources(self) -> Dict[str, float]:
        req = dict(self.resources)
        if self.num_cpus:
            req["CPU"] = req.get("CPU", 0.0) + self.num_cpus
        if self.num_gpus:
            req["GPU"] = req.get("GPU", 0.0) + self.num_gpus
        if self.memory:
            req["memory"] = req.get("memory", 0.0) + self.memory
        return req


@dataclass
class ActorOptions(TaskOptions):
    num_cpus: float = 1.0
    max_restarts: int = 0
    max_task_retries: int = 0
    max_concurrency: int = 1
    max_pending_calls: int = -1
    lifetime: str = "ref_counted"  # "ref_counted" | "detached"
    namespace: str = "default"
    get_if_exists: bool = False


@dataclass
class TaskSpec:
    task_id: TaskID
    job_id: JobID
    function_key: str  # GCS KV key holding the pickled function / class
    args_blob: bytes  # serialized (args, kwargs) with ObjectRefs preserved
    num_returns: int
    options: TaskOptions
    owner_address: str = ""
    # actor-task fields
    actor_id: Optional[ActorID] = None
    method_name: str = ""
    seqno: int = -1
    # device-object transport tag (reference: @ray.method(tensor_transport))
    tensor_transport: str = ""
    # actor-creation fields
    is_actor_creation: bool = False
    actor_options: Optional[ActorOptions] = None
    attempt: int = 0
    # trace-context propagation (reference: TaskSpec's serialized OTel
    # context in tracing_helper.py): the submitting side stamps the caller's
    # active span so execution-side spans and nested submissions form one
    # cross-process trace tree. Empty when tracing is disabled.
    trace_id: str = ""
    parent_span_id: str = ""

    def return_ids(self) -> List[ObjectID]:
        return [ObjectID.for_task_return(self.task_id, i) for i in range(self.num_returns)]


@dataclass
class Bundle:
    resources: Dict[str, float]
    label_selector: Dict[str, str] = field(default_factory=dict)


@dataclass
class PlacementGroupSpec:
    pg_id: PlacementGroupID
    bundles: List[Bundle]
    strategy: str = "PACK"  # PACK | SPREAD | STRICT_PACK | STRICT_SPREAD
    name: str = ""
    lifetime: str = "ref_counted"
    creator_job: Optional[JobID] = None


@dataclass
class ActorState:  # raylint: disable=WIRE001 GCS-local bookkeeping record; never crosses RPC
    PENDING = "PENDING_CREATION"
    ALIVE = "ALIVE"
    RESTARTING = "RESTARTING"
    DEAD = "DEAD"


@dataclass
class WorkerLease:
    lease_id: str
    worker_address: str
    worker_pid: int
    node_id: NodeID
    resources: Dict[str, float]


# the JAX package's libraries that the runtime reaches and the port does not
# have yet, with the ROADMAP.md item that ports each
_NOT_PORTED = {
    "device channels":
        "queue 1 item 3, device channels and the XLA reshard tier "
        "(ray_tpu/dag/device_channel.py:IciTransfer)",
    "the XLA reshard tier":
        "queue 1 item 3, device channels and the XLA reshard tier "
        "(ray_tpu/weights/transport.py:jax_reshard)",
}


def not_ported(feature: str) -> NotImplementedError:
    """The error a runtime path raises where it would reach one of the JAX
    package's libraries that the port does not have yet."""
    return NotImplementedError(
        f"ray_tpu_torch does not port {feature} yet (ROADMAP.md "
        f"{_NOT_PORTED[feature]})")


def die_with_parent():
    """Bind this process's lifetime to its parent (PR_SET_PDEATHSIG).

    Called by the CHILD at startup instead of a Popen preexec_fn: a
    preexec_fn forces subprocess to fork() — which intermittently
    crashes/deadlocks when the parent is multithreaded (torch drivers are).
    Without preexec_fn, subprocess uses posix_spawn. The exec-to-call
    window can orphan a child if the parent dies in it; the session
    sweep reclaims those."""
    try:
        import ctypes
        import signal

        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        PR_SET_PDEATHSIG = 1
        libc.prctl(PR_SET_PDEATHSIG, signal.SIGKILL)
        # close the exec->arm window: the spawner records its pid in the
        # child env; a mismatch means the parent died (child reparented)
        # before we armed. Comparing against a literal init pid would
        # misfire when the supervisor legitimately IS pid 1 (containers).
        expected = os.environ.get("RAY_TPU_PARENT_PID")
        if expected and os.getppid() != int(expected):
            os._exit(0)
    except Exception:  # raylint: disable=EXC001 best-effort orphan check in child bootstrap; must never block worker start
        pass
