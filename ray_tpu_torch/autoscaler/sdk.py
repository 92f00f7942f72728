"""Programmatic autoscaler hints (reference:
python/ray/autoscaler/sdk.py ``request_resources``). The port of
``ray_tpu/autoscaler/sdk.py``; a ``ray-tpu://`` client's request goes
through its proxy."""

from __future__ import annotations

from typing import Dict, List, Optional

from ray_tpu_torch._private import wire


def request_resources(num_cpus: Optional[int] = None,
                      bundles: Optional[List[Dict[str, float]]] = None):
    """Ask the autoscaler to scale so these shapes could be placed
    immediately (does not run anything). Persisted in the GCS KV and read
    every reconcile round; overwrite with [] to clear."""
    shapes: List[Dict[str, float]] = []
    if num_cpus:
        shapes.append({"CPU": float(num_cpus)})
    if bundles:
        shapes.extend({k: float(v) for k, v in b.items()} for b in bundles)
    from ray_tpu_torch._private.worker import global_worker

    core = global_worker()
    if getattr(core, "mode", None) == "client":
        # a client holds no GCS connection: the proxy's driver writes it
        core.request_resources(shapes)
        return
    core._run(core._gcs_call("KVPut", {
        "ns": "autoscaler", "key": "request_resources",
        "value": wire.dumps(shapes)}))
