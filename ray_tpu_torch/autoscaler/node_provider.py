"""Cloud node providers (reference: python/ray/autoscaler/node_provider.py
interface + the fake_multi_node test provider that "launches" local
processes — ``autoscaler/_private/fake_multi_node/node_provider.py``).

A provider launches/terminates raw nodes; the raylet on each node registers
itself with the GCS. TPU slice types launch ``hosts_per_slice`` nodes as one
gang with a shared slice-name label (queued-resources semantics: all hosts
of a slice become available together).

The port of ``ray_tpu/autoscaler/node_provider.py``. A fake node whose type
names ``GPU`` starts a raylet that binds the host's cards from 0 up
(``_private/raylet.py:_detect_gpus``): two such nodes on a one-card host
would both hold card 0, so a caller there caps the type at one node."""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Dict, List

from ray_tpu_torch.autoscaler.config import NodeTypeConfig


@dataclass
class ProviderNode:
    node_id: str
    node_type: str
    created_at: float = field(default_factory=time.time)
    slice_name: str = ""
    # filled by providers that can map provider nodes to raylet node ids
    raylet_node_id: str = ""


class NodeProvider:
    """Interface for cloud plugins (aws/gcp/gke-tpu/... in the reference)."""

    def create_nodes(self, node_type: NodeTypeConfig, count: int) -> List[ProviderNode]:
        raise NotImplementedError

    def terminate_node(self, node: ProviderNode) -> None:
        raise NotImplementedError

    def non_terminated_nodes(self) -> List[ProviderNode]:
        raise NotImplementedError


class FakeMultiNodeProvider(NodeProvider):
    """Test provider: "launches" nodes as extra raylets of a local
    ``cluster_utils.Cluster`` (one process per fake node)."""

    def __init__(self, cluster):
        self._cluster = cluster
        self._nodes: Dict[str, ProviderNode] = {}
        self._handles: Dict[str, object] = {}
        self._lock = threading.Lock()

    def create_nodes(self, node_type: NodeTypeConfig, count: int) -> List[ProviderNode]:
        out = []
        for _ in range(count):
            slice_name = ""
            labels = dict(node_type.labels)
            gang = 1
            if node_type.is_slice:
                gang = node_type.hosts_per_slice
                slice_name = f"fake-slice-{uuid.uuid4().hex[:6]}"
                labels[node_type.slice_label_key] = slice_name
            for _h in range(gang):
                node = ProviderNode(
                    node_id=f"fake-{uuid.uuid4().hex[:8]}",
                    node_type=node_type.name,
                    slice_name=slice_name,
                )
                # the provider-id label is the join key the reconciler uses
                # to match GCS nodes to provider nodes
                host_labels = dict(labels)
                host_labels["ray.io/provider-node-id"] = node.node_id
                host_labels["ray.io/node-type"] = node_type.name
                handle = self._cluster.add_node(
                    resources=dict(node_type.resources), labels=host_labels)
                with self._lock:
                    self._nodes[node.node_id] = node
                    self._handles[node.node_id] = handle
                out.append(node)
        return out

    def terminate_node(self, node: ProviderNode) -> None:
        with self._lock:
            self._nodes.pop(node.node_id, None)
            handle = self._handles.pop(node.node_id, None)
        if handle is not None:
            self._cluster.remove_node(handle)

    def non_terminated_nodes(self) -> List[ProviderNode]:
        with self._lock:
            return list(self._nodes.values())
