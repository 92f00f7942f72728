from ray_tpu_torch.autoscaler.config import ClusterConfig, NodeTypeConfig
from ray_tpu_torch.autoscaler.autoscaler import Autoscaler
from ray_tpu_torch.autoscaler.node_provider import (
    FakeMultiNodeProvider,
    NodeProvider,
)
from ray_tpu_torch.autoscaler.sdk import request_resources

__all__ = [
    "Autoscaler",
    "ClusterConfig",
    "NodeTypeConfig",
    "NodeProvider",
    "FakeMultiNodeProvider",
    "request_resources",
]
