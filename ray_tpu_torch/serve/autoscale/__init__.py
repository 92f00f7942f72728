"""Serve autoscaling control plane: the port of ``ray_tpu/serve/autoscale``,
pure Python (the JAX package's modules, with this package's imports).

The closed serving loop: replicas report cumulative request counters ->
:class:`DeploymentMetricsWindow` turns them into sliding-window rates ->
:func:`policy.decide` prices replica demand (Little's law + hysteresis/
cooldown/SLO pressure) -> the serve controller reconciles the target and
emits structured scale events. Ingress admission (:class:`IngressHandle`)
and prefix routing (:class:`PrefixRouter`) complete the loop at the
handle tier.
"""

from ray_tpu_torch.serve.autoscale.ingress import (
    FairQueue,
    IngressHandle,
    LoadShedError,
    SLOConfig,
    build_ingress,
)
from ray_tpu_torch.serve.autoscale.policy import Decision, PolicyState, decide
from ray_tpu_torch.serve.autoscale.router import ConsistentHashRing, PrefixRouter
from ray_tpu_torch.serve.autoscale.window import DeploymentMetricsWindow

__all__ = [
    "DeploymentMetricsWindow",
    "Decision",
    "PolicyState",
    "decide",
    "FairQueue",
    "IngressHandle",
    "LoadShedError",
    "SLOConfig",
    "build_ingress",
    "ConsistentHashRing",
    "PrefixRouter",
]
