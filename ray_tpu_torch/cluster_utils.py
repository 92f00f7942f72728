"""Single-machine multi-node cluster harness for tests.

Reference: python/ray/cluster_utils.py (``Cluster`` at :135, ``add_node``
:202, ``remove_node`` :286) — boots one GCS plus N raylets as local
processes, each pretending to be a separate node with its own resources,
labels, and object store, so distributed behavior (node failure, object
transfer, scheduling over labelled nodes) is testable without a cluster.
The port of ``ray_tpu/cluster_utils.py``.
"""

from __future__ import annotations

import subprocess
import time
from typing import Dict, List, Optional

from ray_tpu_torch._private.node import NodeSupervisor


class ClusterNode:
    def __init__(self, proc: subprocess.Popen, address: str, node_index: int):
        self.process = proc
        self.address = address
        self.node_index = node_index

    @property
    def node_id(self) -> Optional[str]:
        return getattr(self, "_node_id", None)


class Cluster:
    def __init__(
        self,
        initialize_head: bool = True,
        head_node_args: Optional[dict] = None,
        connect: bool = False,
    ):
        self.supervisor: Optional[NodeSupervisor] = None
        self.nodes: List[ClusterNode] = []
        self.gcs_address: Optional[str] = None
        if initialize_head:
            head_args = head_node_args or {}
            self.supervisor = NodeSupervisor(
                resources=head_args.get("resources", {"CPU": 2.0}),
                labels=head_args.get("labels", {}),
                object_store_memory=head_args.get("object_store_memory"),
                gcs_fault_tolerance=head_args.get("gcs_fault_tolerance", False),
            )
            self.gcs_address = self.supervisor.start_head()
            self.nodes.append(ClusterNode(
                self.supervisor.processes[-1], self.supervisor.gcs_address, 0))
        if connect:
            import ray_tpu_torch

            ray_tpu_torch.init(address=self.gcs_address)

    @property
    def address(self) -> str:
        return self.gcs_address

    def add_node(
        self,
        resources: Optional[Dict[str, float]] = None,
        labels: Optional[Dict[str, str]] = None,
        num_cpus: Optional[float] = None,
        object_store_memory: Optional[int] = None,
    ) -> ClusterNode:
        res = dict(resources or {})
        if num_cpus is not None:
            res["CPU"] = float(num_cpus)
        addr = self.supervisor.start_raylet(
            resources=res, labels=labels, object_store_memory=object_store_memory)
        node = ClusterNode(self.supervisor.processes[-1], addr, len(self.nodes))
        self.nodes.append(node)
        return node

    def remove_node(self, node: ClusterNode, allow_graceful: bool = False):
        """Kill a raylet (SIGKILL): simulates node failure. Its workers die
        with it via PR_SET_PDEATHSIG."""
        try:
            if allow_graceful:
                node.process.terminate()
            else:
                node.process.kill()
            node.process.wait(timeout=10.0)
        except Exception:
            pass
        if node in self.nodes:
            self.nodes.remove(node)
        if self.supervisor and node.process in self.supervisor.processes:
            self.supervisor.processes.remove(node.process)

    def wait_for_nodes(self, num_nodes: Optional[int] = None, timeout: float = 30.0):
        """Block until the GCS sees the expected number of alive raylets."""
        import ray_tpu_torch
        from ray_tpu_torch._private import worker as worker_mod

        expect = num_nodes if num_nodes is not None else len(self.nodes)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if worker_mod.is_initialized():
                alive = [n for n in ray_tpu_torch.nodes() if n["alive"]]
                if len(alive) >= expect:
                    return
            time.sleep(0.1)
        raise TimeoutError(f"cluster did not reach {expect} nodes in {timeout}s")

    def kill_gcs(self):
        """Hard-kill the GCS process (requires gcs_fault_tolerance head arg)."""
        self.supervisor.kill_gcs()

    def restart_gcs(self) -> str:
        """Restart the GCS on the same address; it replays persisted tables."""
        return self.supervisor.restart_gcs()

    def shutdown(self):
        if self.supervisor is not None:
            self.supervisor.stop()
            self.supervisor = None
        self.nodes.clear()
