"""The autoscaler reconciler.

Reference: v1 ``StandardAutoscaler`` (autoscaler/_private/autoscaler.py)
driven by ``monitor.py`` on the head node, and the v2 reconciler
(``autoscaler/v2/autoscaler.py``) that diffs desired vs. actual instances
against the GCS cluster state. This implementation is reconciler-style:
each step polls the GCS for (nodes, idle info, unplaceable demands),
bin-packs the gap, and drives the NodeProvider. TPU slice types scale as
whole slices (queued-resources semantics). The port of
``ray_tpu/autoscaler/autoscaler.py``."""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional

from ray_tpu_torch._private import wire
from ray_tpu_torch._private.rpc import RetryingRpcClient
from ray_tpu_torch.autoscaler.config import ClusterConfig
from ray_tpu_torch.autoscaler.node_provider import NodeProvider, ProviderNode
from ray_tpu_torch.autoscaler.resource_demand_scheduler import (
    get_nodes_to_launch,
    get_nodes_to_terminate,
)

logger = logging.getLogger("ray_tpu_torch.autoscaler")

PROVIDER_ID_LABEL = "ray.io/provider-node-id"
NODE_TYPE_LABEL = "ray.io/node-type"


class Autoscaler:
    def __init__(self, config: ClusterConfig, provider: NodeProvider,
                 gcs_address: str):
        self.config = config
        self.provider = provider
        self.gcs_address = gcs_address
        self._client: Optional[RetryingRpcClient] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.last_status: dict = {}

    # -- GCS I/O -------------------------------------------------------

    def _gcs(self, method: str, req: dict) -> dict:
        import asyncio

        async def _call():
            client = RetryingRpcClient(self.gcs_address)
            try:
                return wire.loads(
                    await client.call(method, wire.dumps(req), timeout=10.0))
            finally:
                await client.close()

        return asyncio.run(_call())

    # -- one reconcile round -------------------------------------------

    def step(self) -> dict:
        """Poll state, launch/terminate, return a status summary."""
        status = self._gcs("GetClusterStatus", {})
        provider_nodes = {n.node_id: n for n in self.provider.non_terminated_nodes()}

        # join GCS nodes to provider nodes via the provider-id label
        gcs_by_provider_id: Dict[str, dict] = {}
        for n in status["nodes"]:
            pid = n["labels"].get(PROVIDER_ID_LABEL, "")
            if pid:
                gcs_by_provider_id[pid] = n

        existing_by_type: Dict[str, int] = {}
        for node in provider_nodes.values():
            existing_by_type[node.node_type] = existing_by_type.get(node.node_type, 0) + 1
        # slices count once per slice, not per host
        for name, t in self.config.node_types.items():
            if t.is_slice and name in existing_by_type:
                existing_by_type[name] = existing_by_type[name] // t.hosts_per_slice

        demands = [{"shape": d["shape"], "selector": d.get("selector", {})}
                   for d in status.get("demands", [])
                   for _ in range(d.get("count", 1))]
        demands += [dict(s) for s in self._request_resources_hints()]
        node_available = [{"available": n["available"], "labels": n["labels"]}
                          for n in status["nodes"] if n["alive"]]
        strict_spread = status.get("strict_spread", [])

        launch = get_nodes_to_launch(
            self.config, existing_by_type, node_available, demands, strict_spread)
        launched: List[ProviderNode] = []
        for name, count in launch.items():
            t = self.config.node_types[name]
            t = _with_provider_labels(t)
            launched.extend(self.provider.create_nodes(t, count))
            logger.info("autoscaler: launched %d x %s", count, name)

        # scale-down: idle beyond timeout and above min
        node_views = []
        for node in provider_nodes.values():
            g = gcs_by_provider_id.get(node.node_id)
            if g is None or not g["alive"]:
                continue
            node_views.append({
                "node_type": node.node_type,
                "idle_s": g.get("idle_s", 0.0),
                "used": g.get("used", False),
                "slice_name": node.slice_name,
                "_provider_node": node,
                "_gcs_node_id": g["node_id"],
            })
        victims = get_nodes_to_terminate(self.config, node_views)
        for v in victims:
            logger.info("autoscaler: terminating idle node %s (%s)",
                        v["_gcs_node_id"][:8], v["node_type"])
            try:
                self._gcs("DrainNode", {"node_id": _node_id_from_hex(v["_gcs_node_id"])})
            except Exception as e:
                logger.debug("DrainNode %s failed (retried next tick): %s",
                             v["_gcs_node_id"][:8], e)
            self.provider.terminate_node(v["_provider_node"])

        self.last_status = {
            "nodes": len(provider_nodes) + len(launched) - len(victims),
            "launched": {k: v for k, v in launch.items()},
            "terminated": len(victims),
            "pending_demands": len(demands),
        }
        return self.last_status

    def _request_resources_hints(self) -> List[Dict[str, float]]:
        """Explicit demand set via sdk.request_resources (kv-backed)."""
        try:
            reply = self._gcs("KVGet", {"ns": "autoscaler", "key": "request_resources"})
            blob = reply.get("value")
            return wire.loads(blob) if blob else []
        except Exception:
            return []

    # -- background loop ------------------------------------------------

    def start(self, interval_s: float = 1.0):
        def loop():
            while not self._stop.is_set():
                try:
                    self.step()
                except Exception:
                    logger.exception("autoscaler step failed")
                self._stop.wait(interval_s)

        self._thread = threading.Thread(target=loop, daemon=True, name="autoscaler")
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5.0)


def _with_provider_labels(t):
    import copy

    t = copy.deepcopy(t)
    t.labels[NODE_TYPE_LABEL] = t.name
    return t


def _node_id_from_hex(hex_str: str):
    from ray_tpu_torch._private.ids import NodeID

    return NodeID.from_hex(hex_str)


def main():
    import argparse
    import json

    from ray_tpu_torch._private.logs import setup_process_logging

    parser = argparse.ArgumentParser()
    parser.add_argument("--gcs-address", required=True)
    parser.add_argument("--config", required=True, help="path to cluster config JSON")
    parser.add_argument("--interval", type=float, default=5.0)
    parser.add_argument("--log-dir", default="")
    args = parser.parse_args()
    setup_process_logging("autoscaler", args.log_dir)
    with open(args.config) as f:
        ClusterConfig.from_dict(json.load(f))  # a malformed file fails here
    raise SystemExit(
        "standalone monitor requires a cloud NodeProvider plugin; "
        "see ray_tpu_torch.autoscaler.node_provider.NodeProvider")


if __name__ == "__main__":
    main()
