"""ray_tpu_torch.serve: model serving, the port of ``ray_tpu.serve``
(reference: ray.serve).

``serve.run`` -> a ``_ServeController`` actor reconciling deployment replica
sets (rolling updates, drain-aware scale-down, the demand-driven
autoscaler); requests enter through a ``DeploymentHandle`` whose router
picks a replica by power-of-two-choices on queue length, or by a
consistent-hash prefix ring; ``handle.broadcast`` calls a method on every
replica (the live weight-update primitive); an HTTP proxy actor on the
standard library's ``asyncio`` fronts handles; ``@serve.batch`` gives
dynamic batching inside replicas. ``serve/autoscale`` holds the pure-Python
control plane: rate windows, the scaling policy, SLO-aware fair ingress and
the prefix router.
"""

from ray_tpu_torch.serve.autoscale import (
    FairQueue,
    IngressHandle,
    LoadShedError,
    PrefixRouter,
    SLOConfig,
    build_ingress,
)
from ray_tpu_torch.serve.api import (
    Application,
    AutoscalingConfig,
    Deployment,
    DeploymentHandle,
    batch,
    delete,
    deployment,
    get_app_handle,
    run,
    shutdown,
    start_http_proxy,
    status,
)
from ray_tpu_torch.serve.multiplex import get_multiplexed_model_id, multiplexed

__all__ = [
    "deployment",
    "AutoscalingConfig",
    "multiplexed",
    "get_multiplexed_model_id",
    "Deployment",
    "Application",
    "DeploymentHandle",
    "run",
    "delete",
    "status",
    "shutdown",
    "get_app_handle",
    "batch",
    "start_http_proxy",
    "FairQueue",
    "IngressHandle",
    "LoadShedError",
    "PrefixRouter",
    "SLOConfig",
    "build_ingress",
]
