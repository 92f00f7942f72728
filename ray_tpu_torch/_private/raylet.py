"""Raylet: the per-node daemon.

Reference: ``src/ray/raylet`` — ``NodeManager`` (node_manager.h:133) handling
worker-lease requests (node_manager.cc:1820), the ``WorkerPool``
(worker_pool.h:276) that spawns/reuses worker processes, placement-group
bundle accounting (placement_group_resource_manager.cc), worker-death
detection, and the node object plane: it hosts the shared-memory object store
(plasma ``store_runner.cc``) and the pull/push transfer manager
(``object_manager/pull_manager.cc``).

Two-level scheduling (reference: cluster_lease_manager.cc:196 grant-or-
spillback at :421): plain lease requests go to the OWNER'S LOCAL raylet,
which grants from its pool or replies ``spillback`` with a peer chosen from
its synced cluster resource view — no per-lease GCS round trip. The view is
maintained by subscribing to the GCS ``resource_view`` delta stream
(reference: ray_syncer.h:89); placement-group and strategy-pinned leases
still resolve through the GCS (`PickNode`), as does the infeasible fallback
that feeds autoscaler demand.
"""

from __future__ import annotations

import asyncio
import logging
import math
import os
import pickle

from ray_tpu_torch._private import wire
from ray_tpu_torch.exceptions import RuntimeEnvSetupError
import signal
import subprocess
import sys
import time
import uuid
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch._private.common import (
    NodeInfo,
    label_match,
    resources_add,
    resources_ge,
    resources_sub,
)
from ray_tpu_torch._private.async_util import spawn
from ray_tpu_torch._private.config import RAY_CONFIG
from ray_tpu_torch._private.ids import NodeID
from ray_tpu_torch._private.object_store import ObjectStoreServer
from ray_tpu_torch._private.provisioner import WorkerProvisioner
from ray_tpu_torch._private.provisioner.pool import _obs as _pool_obs
from ray_tpu_torch._private.rpc import RpcError, RpcServer, RetryingRpcClient

logger = logging.getLogger("ray_tpu_torch.raylet")


class _PullRetry(Exception):
    """Internal: the chosen pull source had no usable copy; re-pick."""


class WorkerProc:
    def __init__(self, proc: subprocess.Popen, renv_hash: str = ""):
        self.proc = proc
        self.pid = proc.pid
        self.address = ""
        self.registered = asyncio.get_event_loop().create_future()
        self.job_hex: Optional[str] = None
        self.renv_hash = renv_hash  # workers are dedicated to one runtime env
        self.leases: Set[str] = set()
        self.idle_since = time.monotonic()
        self.started = time.monotonic()
        # refreshed on every lease grant: the OOM victim policy ranks by
        # work-assignment recency, not process age (reused workers are old
        # processes that may hold the newest work)
        self.last_assigned = time.monotonic()
        self.client: Optional[RetryingRpcClient] = None
        # card id -> share of that card this worker's GPU lease holds; a
        # worker bound to cards runs that one lease and then exits
        self.cards: Dict[str, float] = {}
        self.retired = False


class Raylet:
    def __init__(
        self,
        gcs_address: str,
        node_id: Optional[NodeID] = None,
        resources: Optional[Dict[str, float]] = None,
        labels: Optional[Dict[str, str]] = None,
        is_head: bool = False,
        host: str = "127.0.0.1",
        port: int = 0,
        log_dir: str = "",
        object_store_memory: Optional[int] = None,
    ):
        self.node_id = node_id or NodeID.from_random()
        self.gcs_address = gcs_address
        self.is_head = is_head
        self.log_dir = log_dir
        self.server = RpcServer(self._handle, host, port)
        self.gcs = RetryingRpcClient(gcs_address, on_push=self._on_gcs_push,
                                     on_reconnect=self._on_gcs_reconnect)
        # synced view of peer nodes (node_hex -> {address, available, total,
        # labels, alive}) fed by the GCS resource_view delta stream
        self.cluster_view: Dict[str, dict] = {}
        # parked lease shapes (req_id -> {resources, selector}) reported on
        # heartbeats as autoscaler demand
        self._parked: Dict[str, dict] = {}
        # OOM defense: workers killed by the memory monitor, so owners can
        # surface OutOfMemoryError instead of a generic worker death
        self.oom_kills: Dict[str, float] = {}  # worker_address -> kill ts
        self.total_resources = dict(resources or {})
        self.available = dict(self.total_resources)
        # card id -> free share of it, filled by _detect_gpus
        self.card_free: Dict[str, float] = {}
        self.labels = dict(labels or {})
        self.store = ObjectStoreServer(self.node_id.hex(), object_store_memory)
        self.workers: Dict[int, WorkerProc] = {}  # pid -> proc
        self.workers_by_addr: Dict[str, WorkerProc] = {}
        self.idle_workers: List[WorkerProc] = []
        self.leases: Dict[str, Tuple[WorkerProc, Dict[str, float], Optional[bytes]]] = {}
        # pg_id bytes -> bundle_idx -> (reserved, available)
        self.pg_reserved: Dict[bytes, Dict[int, Dict[str, float]]] = {}
        self.pg_available: Dict[bytes, Dict[int, Dict[str, float]]] = {}
        self.pg_committed: Set[bytes] = set()
        self._lease_waiters: List[asyncio.Future] = []
        self._pulls: Dict[bytes, asyncio.Task] = {}
        self._background: List[asyncio.Task] = []
        self._spawn_env = dict(os.environ)
        # children verify this at startup (die_with_parent window check)
        self._spawn_env["RAY_TPU_PARENT_PID"] = str(os.getpid())
        self._spawn_sem = asyncio.Semaphore(
            max(1, RAY_CONFIG.worker_startup_concurrency))
        # provisioning plane: zygote prefork pool + warm replenishment
        # (reference: worker_pool.h prestart/adoption)
        self.provisioner = WorkerProvisioner(self)
        # bounded concurrent inbound pulls (reference: pull_manager.cc's
        # prioritized admission; FIFO here — all pulls are one class)
        from ray_tpu_torch._private.pull_manager import PullQueue

        self._pull_queue = PullQueue(
            max(1, RAY_CONFIG.object_pull_concurrency),
            stale_ttl_s=RAY_CONFIG.object_pull_interest_ttl_s)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    async def start(self) -> str:
        addr = await self.server.start()
        if "CPU" not in self.total_resources:
            self.total_resources["CPU"] = float(os.cpu_count() or 1)
            self.available["CPU"] = self.total_resources["CPU"]
        self._detect_gpus()
        info = NodeInfo(
            node_id=self.node_id,
            address=addr,
            object_store_address=addr,
            total_resources=dict(self.total_resources),
            labels=dict(self.labels),
            is_head=self.is_head,
        )
        await self.gcs.call("RegisterNode", wire.dumps({"info": info}))
        await self._subscribe_view()
        # zygote boot (preimports the heavy stack) runs in the background:
        # the raylet must register + serve immediately; fork requests wait
        # for readiness inside the provisioner instead
        self._background.append(spawn(self.provisioner.start(),
                                      what="zygote start"))
        self._background.append(spawn(self._heartbeat_loop(),
                                      what="raylet heartbeat loop"))
        self._background.append(spawn(self._metrics_loop(),
                                      what="raylet metrics loop"))
        self._background.append(spawn(self._monitor_workers_loop(),
                                      what="worker monitor loop"))
        self._background.append(spawn(self._memory_monitor_loop(),
                                      what="memory monitor loop"))
        self._background.append(spawn(self._prestart_workers(),
                                      what="worker prestart"))
        self._background.append(spawn(self.provisioner.replenish_loop(),
                                      what="warm-pool replenish loop"))
        self._background.append(spawn(self._prewarm_store(),
                                      what="store prewarm"))
        if self.log_dir:
            self._background.append(spawn(self._log_monitor_loop(),
                                          what="log monitor loop"))
        logger.info("raylet %s on %s resources=%s", self.node_id.hex()[:8], addr,
                    self.total_resources)
        return addr

    def _detect_gpus(self):
        """GPU detection (``util/accelerators.py``); an explicit ``GPU``
        resource given at start wins. Its count takes the first detected
        card ids, or 0 to n - 1 where fewer cards were detected."""
        from ray_tpu_torch.util.accelerators import detect_gpu_ids

        ids, gpu_labels = detect_gpu_ids()
        if ids and "GPU" not in self.total_resources:
            self.total_resources["GPU"] = float(len(ids))
            self.available["GPU"] = float(len(ids))
        n = math.ceil(self.total_resources.get("GPU", 0))
        if len(ids) < n:
            ids = [str(i) for i in range(n)]
        self.card_free = {c: 1.0 for c in ids[:n]}
        for k, v in gpu_labels.items():
            self.labels.setdefault(k, v)

    def _take_cards(self, amount: float) -> Optional[Dict[str, float]]:
        """Book the cards a lease of ``amount`` GPUs runs on: whole free
        cards for 1 or more, else that share of the fullest card it fits
        (reference: the GPU instances of resource_instance_set.cc). None
        when the free shares do not fit, even where the node's ``GPU``
        total does."""
        if amount <= 0:
            return {}
        eps = 1e-9
        if amount >= 1:
            free = [c for c, f in self.card_free.items() if f >= 1 - eps]
            if len(free) < math.ceil(amount - eps):
                return None
            taken = {c: 1.0 for c in free[:math.ceil(amount - eps)]}
        else:
            fits = [c for c, f in self.card_free.items() if f >= amount - eps]
            if not fits:
                return None
            taken = {min(fits, key=self.card_free.get): amount}
        for c, share in taken.items():
            self.card_free[c] -= share
        return taken

    def _give_cards(self, taken: Dict[str, float]):
        for c, share in taken.items():
            self.card_free[c] = min(1.0, self.card_free[c] + share)

    async def stop(self):
        for t in self._background:
            t.cancel()
        await self.provisioner.close()
        for w in list(self.workers.values()):
            try:
                w.proc.kill()
            except Exception as e:
                logger.debug("kill of worker pid %s at stop failed: %s",
                             w.pid, e)
        self.store.shutdown()
        await self.server.stop()

    async def _subscribe_view(self, client=None):
        """Subscribe to the resource_view delta stream and seed the local
        cluster view (reference: ray_syncer snapshot + deltas). Re-run on
        every reconnect: deltas published during a disconnect are lost, and
        a node that died in that window never heartbeats again, so only a
        fresh snapshot can correct the view."""
        client = client or self.gcs
        await client.call("Subscribe", wire.dumps(
            {"channels": ["resource_view"]}))
        reply = wire.loads(await client.call("GetAllNodes", b""))
        for n in reply["nodes"]:
            self.cluster_view[n["node_id"]] = {
                "address": n["address"],
                "available": n.get("available", {}),
                "total": n["total_resources"],
                "labels": n.get("labels", {}),
                "alive": n.get("alive", True),
            }

    def _on_gcs_push(self, channel: str, payload: bytes):
        if channel != "resource_view":
            return
        msg = wire.loads(payload)
        # one publish per GCS tick carries every dirty node's latest view
        # ("views" batch); entries are idempotent last-writer-wins, so the
        # legacy single-entry form stays accepted
        for m in msg["views"] if "views" in msg else (msg,):
            # raylint: disable=RCE001 _on_gcs_push is registered as the client's push callback and always fires on this raylet's loop; the dynamic registration is invisible to the call graph, so it defaults to the caller thread
            self.cluster_view[m["node_id"]] = {
                "address": m["address"], "available": m["available"],
                "total": m["total"], "labels": m["labels"],
                "alive": m["alive"],
            }

    async def _on_gcs_reconnect(self, client):
        try:
            await self._subscribe_view(client)
        except Exception:
            logger.warning("resource_view re-subscribe failed", exc_info=True)

    def _pick_spill_node(self, resources, selector,
                         require_available: bool = True,
                         locality: Optional[Dict[str, int]] = None
                         ) -> Optional[str]:
        """Choose a peer raylet for spillback from the synced view (hybrid
        policy: pack onto the most-utilized feasible peer below the spread
        threshold, else the least utilized; reference:
        policy/hybrid_scheduling_policy.cc)."""
        me = self.node_id.hex()
        candidates = []
        for hex_id, v in self.cluster_view.items():
            if hex_id == me or not v["alive"]:
                continue
            if selector and not label_match(v.get("labels", {}), selector):
                continue
            pool = v["available"] if require_available else v["total"]
            if not resources_ge(pool, resources):
                continue
            fracs = [1.0 - v["available"].get(k, 0.0) / t
                     for k, t in v["total"].items() if t > 0]
            candidates.append((max(fracs) if fracs else 0.0, hex_id,
                               v["address"]))
        if not candidates:
            return None
        candidates.sort()
        threshold = RAY_CONFIG.scheduler_spread_threshold
        packed = [c for c in candidates if c[0] < threshold]
        if locality:
            # among below-threshold peers, prefer the one already holding
            # the most argument bytes (reference: locality-aware lease
            # policy, task_submission/lease_policy.cc): the pull it saves
            # usually dwarfs a small utilization difference
            pool = packed or candidates
            best = max(pool, key=lambda c: (locality.get(c[1], 0), c[0]))
            if locality.get(best[1], 0) > 0:
                return best[2]
        return (packed[-1] if packed else candidates[0])[2]

    async def _memory_monitor_loop(self):
        """OOM defense (reference: memory_monitor.h:52 + the group-by-owner
        worker killing policy): while node memory is above the threshold,
        kill the newest worker of the job with the most workers, record the
        kill so the owner can surface OutOfMemoryError, and repeat until
        back under — one worker dies, the node survives."""
        from ray_tpu_torch._private.memory_monitor import MemoryMonitor

        monitor = MemoryMonitor()
        period = RAY_CONFIG.memory_monitor_refresh_ms / 1000.0
        while True:
            await asyncio.sleep(period)
            try:
                pids = [w.pid for w in self.workers.values()]
                over, why = monitor.over_threshold(pids)
                if not over:
                    continue
                victim = MemoryMonitor.pick_victim([
                    {"pid": w.pid, "job": w.job_hex,
                     "started": w.last_assigned, "_w": w}
                    for w in self.workers.values()])
                if victim is None:
                    logger.warning("OOM pressure but no workers to kill: %s",
                                   why)
                    continue
                w = victim["_w"]
                logger.warning(
                    "OOM defense: killing worker pid=%d (job=%s, newest of "
                    "largest owner group) — %s", w.pid, w.job_hex, why)
                if w.address:
                    self.oom_kills[w.address] = time.monotonic()
                    if len(self.oom_kills) > 256:
                        oldest = min(self.oom_kills, key=self.oom_kills.get)
                        del self.oom_kills[oldest]
                try:
                    w.proc.kill()
                except Exception as e:
                    logger.debug("OOM kill of pid %s failed (already "
                                 "exited?): %s", w.pid, e)
            except Exception:
                logger.exception("memory monitor iteration failed")

    async def _heartbeat_loop(self):
        period = RAY_CONFIG.health_check_period_ms / 1000.0
        while True:
            try:
                reply = wire.loads(await self.gcs.call("Heartbeat", wire.dumps({
                    "node_id": self.node_id,
                    "available": dict(self.available),
                    # lease count keeps zero-resource actors visible to the
                    # autoscaler's idle detection
                    "num_leases": len(self.leases),
                    # parked lease shapes = autoscaler demand
                    "pending_shapes": [
                        {"resources": p["resources"],
                         "selector": p.get("selector", {}),
                         "waiter_id": rid}
                        for rid, p in list(self._parked.items())],
                }), timeout=5.0, retries=0))
                if reply.get("status") == "unknown_node":
                    info = NodeInfo(
                        node_id=self.node_id, address=self.server.address,
                        object_store_address=self.server.address,
                        total_resources=dict(self.total_resources),
                        labels=dict(self.labels), is_head=self.is_head)
                    await self.gcs.call("RegisterNode", wire.dumps({"info": info}))
            except (RpcError, asyncio.TimeoutError, OSError) as e:
                logger.debug("heartbeat/re-register to GCS failed "
                             "(will retry): %s", e)
            await asyncio.sleep(period)

    async def _metrics_loop(self):
        """Always-on raylet runtime metrics (reference: the raylet-side
        ray_* gauges in metric_defs.cc pushed through the metrics agent):
        lease-queue depth, object-store occupancy + spill counts, worker
        pool size, event-loop lag — set here and auto-published to the GCS
        metrics namespace so the dashboard's /metrics exposes them without
        any manual publish call."""
        from ray_tpu_torch.util.metrics import Gauge, scrape_metrics

        gauges = {
            "lease_queue": Gauge(
                "ray_tpu_raylet_lease_queue_depth",
                "granted-lease waiters parked at this raylet"),
            "parked": Gauge(
                "ray_tpu_raylet_parked_lease_shapes",
                "unplaceable lease shapes reported as autoscaler demand"),
            "leases": Gauge("ray_tpu_raylet_leases_held",
                            "currently granted worker leases"),
            "workers": Gauge("ray_tpu_raylet_workers",
                             "live worker processes on this node"),
            "store_bytes": Gauge("ray_tpu_object_store_bytes",
                                 "bytes resident in the local object store"),
            "store_objects": Gauge("ray_tpu_object_store_objects",
                                   "objects resident in the local store"),
            "spilled": Gauge("ray_tpu_object_store_spilled_objects",
                             "objects spilled to external storage (total)"),
            "restored": Gauge("ray_tpu_object_store_restored_objects",
                              "objects restored from external storage (total)"),
            "loop_lag": Gauge("ray_tpu_raylet_loop_lag_seconds",
                              "raylet event-loop scheduling delay"),
            "pool_warm": Gauge(
                "ray_tpu_worker_pool_warm",
                "registered default-env workers idle in the warm pool"),
            "pool_idle": Gauge("ray_tpu_worker_pool_idle",
                               "idle workers (any job/runtime-env)"),
            "zygote_up": Gauge("ray_tpu_worker_pool_zygote_alive",
                               "1 while the zygote fork server is serving"),
        }
        node_tag = {"node_id": self.node_id.hex()[:16]}
        for g in gauges.values():
            g.set_default_tags(node_tag)
        interval = RAY_CONFIG.metrics_flush_interval_s
        key = f"raylet_{self.node_id.hex()[:10]}"
        while True:
            before = time.monotonic()
            await asyncio.sleep(interval)
            lag = max(0.0, time.monotonic() - before - interval)
            try:
                gauges["loop_lag"].set(lag)
                gauges["lease_queue"].set(len(self._lease_waiters))
                gauges["parked"].set(len(self._parked))
                gauges["leases"].set(len(self.leases))
                gauges["workers"].set(len(self.workers))
                gauges["store_bytes"].set(self.store.used)
                gauges["store_objects"].set(len(self.store.objects))
                gauges["spilled"].set(self.store.num_spilled)
                gauges["restored"].set(self.store.num_restored)
                pool = self.provisioner.snapshot()
                gauges["pool_warm"].set(pool["warm_default_env"])
                gauges["pool_idle"].set(pool["idle_workers"])
                gauges["zygote_up"].set(1.0 if pool["zygote_alive"] else 0.0)
                payload = {"pid": os.getpid(), "time": time.time(),
                           "node": self.node_id.hex(),
                           "metrics": scrape_metrics()}
                # one batched KV round trip for both namespaces (metrics +
                # the /api/workers pool mirror)
                await self.gcs.call("KVMultiPut", wire.dumps({"items": [
                    {"ns": "metrics", "key": key,
                     "value": wire.dumps(payload)},
                    {"ns": "workers", "key": key,
                     "value": wire.dumps({
                         "node": self.node_id.hex(), "time": time.time(),
                         "pool": pool})},
                ]}), timeout=10.0, retries=0)
            except (RpcError, asyncio.TimeoutError, OSError) as e:
                logger.debug("raylet metrics publish failed (will retry): %s", e)
            except Exception:
                logger.exception("raylet metrics iteration failed")

    # ------------------------------------------------------------------
    # worker pool (reference: src/ray/raylet/worker_pool.h:276)
    # ------------------------------------------------------------------

    def _spawn_worker(self, renv: Optional[dict] = None,
                      renv_hash: str = "",
                      python_exe: Optional[str] = None) -> WorkerProc:
        cmd = [
            python_exe or sys.executable, "-m", "ray_tpu_torch._private.worker_main",
            "--raylet-address", self.server.address,
            "--gcs-address", self.gcs_address,
            "--node-id", self.node_id.hex(),
            "--log-dir", self.log_dir,
        ]
        env = self._spawn_env
        if python_exe:
            # pip/uv env: the worker runs on the venv interpreter
            venv_root = os.path.dirname(os.path.dirname(python_exe))
            env = dict(env, VIRTUAL_ENV=venv_root,
                       PATH=os.path.join(venv_root, "bin") + os.pathsep
                       + env.get("PATH", os.environ.get("PATH", "")))
        if renv:
            import base64 as _b64
            import json as _json

            cmd += ["--runtime-env",
                    _b64.b64encode(_json.dumps(renv).encode()).decode()]
            if renv.get("env_vars"):
                env = dict(env, **renv["env_vars"])
        proc = subprocess.Popen(
            cmd, env=env,
            stdout=self._log_file("worker_stdout"), stderr=subprocess.STDOUT,
        )
        w = WorkerProc(proc, renv_hash)
        self.workers[w.pid] = w
        return w

    async def _spawn_worker_async(self, renv: Optional[dict] = None,
                                  renv_hash: str = "",
                                  python_exe: Optional[str] = None
                                  ) -> WorkerProc:
        """Spawn-path router (reference: worker_pool StartWorkerProcess):
        fork from the zygote when possible — the child starts with the
        heavy stack already imported — else cold ``Popen``. pip/uv envs
        always cold-spawn (the venv has a different interpreter)."""
        if python_exe is None:
            pid = await self.provisioner.fork_worker(renv)
            if pid is not None:
                return self._register_forked(pid, renv_hash)
        self.provisioner.stats["cold_spawns"] += 1
        _pool_obs()["cold"].inc()
        return self._spawn_worker(renv, renv_hash, python_exe)

    def _register_forked(self, pid: int, renv_hash: str = "") -> WorkerProc:
        """Track a zygote-forked worker like any spawned one."""
        from ray_tpu_torch._private.provisioner.pool import ForkedProc

        w = WorkerProc(ForkedProc(pid, self.provisioner), renv_hash)
        self.workers[w.pid] = w
        return w

    def _scan_idle(self, job_hex: Optional[str],
                   renv_hash: str = "") -> Optional[WorkerProc]:
        """Non-blocking warm-pool pop: an idle worker compatible with this
        (job, runtime-env) pair, adopted without any spawn."""
        for i, w in enumerate(self.idle_workers):
            if (w.job_hex is None or w.job_hex == job_hex) \
                    and w.renv_hash == renv_hash:
                self.idle_workers.pop(i)
                w.job_hex = w.job_hex or job_hex
                return w
        return None

    def _log_file(self, name):
        if not self.log_dir:
            return subprocess.DEVNULL
        os.makedirs(self.log_dir, exist_ok=True)
        return open(os.path.join(self.log_dir, f"{name}_{self.node_id.hex()[:8]}.log"), "ab")

    async def _pop_worker(self, job_hex: Optional[str],
                          renv: Optional[dict] = None,
                          renv_hash: str = "",
                          cards: Optional[Dict[str, float]] = None
                          ) -> WorkerProc:
        """A worker for one lease. A lease on cards gets a new worker whose
        ``CUDA_VISIBLE_DEVICES`` names them before anything in it can
        touch CUDA; it never adopts an idle one, which may have made its
        CUDA context on other cards or hold their memory."""
        t0 = time.monotonic()
        while True:
            w = None if cards else self._scan_idle(job_hex, renv_hash)
            if w is not None:
                self.provisioner.stats["hits"] += 1
                _pool_obs()["hits"].inc()
                _pool_obs()["adoption"].observe(time.monotonic() - t0)
                return w
            # bound concurrent spawns: each new worker pays a full
            # interpreter+import start-up; a spawn storm starves the very
            # tasks the leases are for (reference: worker_pool.h's
            # maximum_startup_concurrency)
            async with self._spawn_sem:
                w = None if cards else self._scan_idle(job_hex, renv_hash)
                if w is not None:
                    self.provisioner.stats["hits"] += 1
                    _pool_obs()["hits"].inc()
                    _pool_obs()["adoption"].observe(time.monotonic() - t0)
                    return w
                self.provisioner.stats["misses"] += 1
                _pool_obs()["misses"].inc()
                python_exe = None
                if renv and "pip" in renv:
                    # venv build is blocking (pip install): off the loop.
                    # Raises RuntimeEnvSetupError to the lease path, which
                    # surfaces it to the owner as the task's error
                    # (reference: runtime-env agent failure handling)
                    from ray_tpu_torch._private.runtime_env import ensure_env_python

                    python_exe = await asyncio.get_event_loop()\
                        .run_in_executor(None, ensure_env_python, renv)
                spawn_renv = renv
                if cards:
                    spawn_renv = dict(renv or {}, env_vars=dict(
                        (renv or {}).get("env_vars") or {},
                        CUDA_VISIBLE_DEVICES=",".join(cards)))
                w = await self._spawn_worker_async(spawn_renv, renv_hash,
                                                   python_exe)
                if cards:
                    w.cards = dict(cards)
                try:
                    await asyncio.wait_for(w.registered,
                                           RAY_CONFIG.worker_start_timeout_s)
                except asyncio.TimeoutError:
                    if cards:  # the lease path gives the cards back
                        w.cards, w.retired = {}, True
                        w.proc.kill()
                    raise
                w.job_hex = job_hex
                _pool_obs()["adoption"].observe(time.monotonic() - t0)
                return w

    async def _rpc_RegisterWorker(self, req, conn):
        pid = req["pid"]
        w = self.workers.get(pid)
        if w is None:
            # worker started by someone else (e.g. driver-side tests); track it
            return {"status": "unknown"}
        w.address = req["address"]
        self.workers_by_addr[w.address] = w
        w.client = RetryingRpcClient(w.address)
        if not w.registered.done():
            w.registered.set_result(True)
        return {"status": "ok", "node_id": self.node_id.hex()}

    async def _log_monitor_loop(self):
        """Tail this node's worker stdout and publish new lines to the GCS
        "logs" channel so drivers can print remote worker output
        (reference: _private/log_monitor.py:117)."""
        path = os.path.join(
            self.log_dir, f"worker_stdout_{self.node_id.hex()[:8]}.log")
        pos = 0
        node = self.node_id.hex()[:8]
        while True:
            await asyncio.sleep(0.5)
            try:
                with open(path, "rb") as f:
                    f.seek(pos)
                    data = f.read()
                    pos = f.tell()
            except FileNotFoundError:
                continue
            if not data:
                continue
            lines = data.decode(errors="replace").splitlines()
            try:
                await self.gcs.call("Publish", wire.dumps({
                    "channel": "logs",
                    "message": {"node": node, "lines": lines[:200]},
                }), timeout=5.0, retries=0)
            except Exception as e:
                logger.debug("log publish to GCS failed (%d lines "
                             "dropped): %s", len(lines), e)

    async def _prewarm_store(self):
        """Pre-touch arena pages in the background so early large puts
        don't pay first-touch fault costs (chunked; yields the loop)."""
        offset = 0
        while True:
            nxt = self.store.prewarm_step(offset)
            if nxt is None:
                return
            offset = nxt
            await asyncio.sleep(0.02)

    async def _prestart_workers(self):
        """Warm the pool so first leases don't pay interpreter start-up
        (reference: worker_pool prestart). Forks from the zygote when it is
        up; the provisioner's replenish loop keeps the pool topped up after
        grants drain it."""
        for _ in range(max(0, RAY_CONFIG.prestart_workers)):
            try:
                async with self._spawn_sem:
                    w = await self._spawn_worker_async()
                    await asyncio.wait_for(
                        w.registered, RAY_CONFIG.worker_start_timeout_s)
                w.job_hex = None
                self.idle_workers.append(w)
            except Exception as e:
                logger.debug("prestart worker spawn failed; stopping "
                             "prestart: %s", e)
                return

    async def _monitor_workers_loop(self):
        while True:
            await asyncio.sleep(0.25)
            for pid, w in list(self.workers.items()):
                code = w.proc.poll()
                if code is None:
                    continue
                self.workers.pop(pid, None)
                self.workers_by_addr.pop(w.address, None)
                if w in self.idle_workers:
                    self.idle_workers.remove(w)
                for lease_id in list(w.leases):
                    self._release_lease(lease_id)
                if w.cards:
                    # a GPU lease's worker is gone, and with it whatever it
                    # held on its cards: only now may another lease get them
                    self._give_cards(w.cards)
                    w.cards = {}
                    self._wake_lease_waiters()
                if w.address:
                    reason = f"exit code {code}"
                    if w.retired:
                        reason = f"retired after its GPU lease ({reason})"
                    if w.address in self.oom_kills:
                        # attribute memory-monitor kills at the mechanism
                        # level: actor owners see the OOM cause too
                        reason = ("OOM-killed by the node memory monitor "
                                  f"({reason})")
                    (logger.info if w.retired else logger.warning)(
                        "worker %s (pid %d) exited: %s", w.address, pid,
                        reason)
                    try:
                        await self.gcs.call("WorkerDied", wire.dumps({
                            "worker_address": w.address,
                            "node_id": self.node_id.hex(),
                            "reason": reason,
                        }), retries=2)
                    except (RpcError, asyncio.TimeoutError, OSError) as e:
                        logger.debug("WorkerDied notify for %s failed: %s",
                                     w.address, e)

    # ------------------------------------------------------------------
    # leases (reference: node_manager.cc:1820 HandleRequestWorkerLease)
    # ------------------------------------------------------------------

    def _lease_pool(self, pg: Optional[bytes], bundle_index: int):
        """Resolve the resource pool a lease draws from / credits back to.

        Returns None for a PG-backed lease whose group (or bundle) is gone:
        grants must be refused (the reference fails tasks routed to removed
        groups, placement_group_resource_manager.cc), and returns must NOT
        credit the node pool — ReleasePGBundles already returned the whole
        bundle reserve, so crediting again leaks phantom capacity (+1 CPU
        per cached lease returning after group removal)."""
        if pg is None:
            return self.available
        bundles = self.pg_available.get(pg)
        if bundles is None:
            return None
        if bundle_index in bundles:
            return bundles[bundle_index]
        if bundle_index < 0 and bundles:
            return bundles[min(bundles.keys())]
        return None

    async def _rpc_RequestWorkerLease(self, req, conn):
        from ray_tpu_torch._private.runtime_env import env_hash

        resources = req["resources"]
        pg = req.get("pg")
        bundle_index = req.get("bundle_index", -1)
        selector = req.get("label_selector") or {}
        allow_spill = bool(req.get("allow_spillback"))
        locality = req.get("locality") or {}
        renv = req.get("runtime_env")
        renv_hash = env_hash(renv)
        gpu = float(resources.get("GPU", 0) or 0)
        job_hex = req["job_id"].hex() if req.get("job_id") is not None else None
        # renv-keyed warm pool: remember the hottest non-default env so the
        # replenish loop keeps warm workers forked for it too
        self.provisioner.note_renv(renv_hash, renv)
        deadline = time.monotonic() + RAY_CONFIG.worker_start_timeout_s
        # the two-level path sends plain leases here directly: this raylet
        # must check the label selector itself (the legacy GCS PickNode
        # path pre-filters, so selector-carrying requests it routed are
        # always satisfied and the check is a no-op for them)
        local_ok = pg is not None or (
            label_match(self.labels, selector)
            and resources_ge(self.total_resources, resources))
        if not local_ok:
            if allow_spill:
                alt = self._pick_spill_node(resources, selector,
                                            require_available=False,
                                            locality=locality)
                if alt:
                    return {"status": "spillback", "retry_at": alt}
            if pg is None and label_match(self.labels, selector):
                return {"status": "infeasible",
                        "total": dict(self.total_resources)}
            return {"status": "infeasible_cluster"}
        parked_id = None
        try:
            while True:
                pool = self._lease_pool(pg, bundle_index)
                if pool is None:
                    return {"status": "pg_removed"}
                cards = (self._take_cards(gpu)
                         if resources_ge(pool, resources) else None)
                if cards is not None:
                    resources_sub(pool, resources)
                    try:
                        w = await self._pop_worker(job_hex, renv, renv_hash,
                                                   cards)
                    except RuntimeEnvSetupError as e:
                        # deterministic env-build failure: a structured
                        # terminal status, not a retriable RPC error —
                        # the owner fails the task with the pip output
                        resources_add(pool, resources)
                        self._give_cards(cards)
                        return {"status": "runtime_env_failed",
                                "error": str(e)}
                    except (asyncio.TimeoutError, Exception):
                        resources_add(pool, resources)
                        self._give_cards(cards)
                        raise
                    grant = self._record_grant(w, resources, pg, bundle_index)
                    # batched multi-grant (reference: the pipelined lease
                    # requests this amortizes in normal_task_submitter.cc):
                    # the owner asked for up to `count` leases; warm
                    # registered workers are granted instantly, then the
                    # REMAINDER is forked from the zygote (spawn-backed
                    # top-up) so the batch no longer caps at whatever
                    # happened to be registered
                    extras = []
                    # a lease on cards is granted alone: each one needs
                    # a worker bound to its own cards
                    want = 1 if gpu else min(
                        int(req.get("count", 1)),
                        max(1, RAY_CONFIG.lease_max_grants))
                    while len(extras) + 1 < want:
                        xpool = self._lease_pool(pg, bundle_index)
                        if xpool is None or not resources_ge(xpool, resources):
                            break
                        w2 = self._scan_idle(job_hex, renv_hash)
                        if w2 is None:
                            break
                        resources_sub(xpool, resources)
                        self.provisioner.stats["hits"] += 1
                        _pool_obs()["hits"].inc()
                        extras.append(self._record_grant(
                            w2, resources, pg, bundle_index))
                    short = want - 1 - len(extras)
                    if short > 0 and not (renv and "pip" in renv):
                        extras.extend(await self._spawn_grant_topup(
                            short, job_hex, renv, renv_hash, resources,
                            pg, bundle_index, deadline))
                    _pool_obs()["grant_batch"].observe(1 + len(extras))
                    reply = dict(grant, status="granted",
                                 node_id=self.node_id.hex())
                    if extras:
                        reply["extra_grants"] = extras
                    return reply
                if allow_spill:
                    # busy here but a peer has capacity NOW: spill back
                    # (reference: cluster_lease_manager.cc:421)
                    alt = self._pick_spill_node(resources, selector,
                                                require_available=True)
                    if alt:
                        return {"status": "spillback", "retry_at": alt}
                if time.monotonic() > deadline:
                    return {"status": "busy"}
                if parked_id is None:
                    parked_id = uuid.uuid4().hex
                    self._parked[parked_id] = {"resources": dict(resources),
                                               "selector": dict(selector)}
                fut = asyncio.get_event_loop().create_future()
                self._lease_waiters.append(fut)
                try:
                    await asyncio.wait_for(fut, timeout=1.0)
                except asyncio.TimeoutError:
                    pass
        finally:
            if parked_id is not None:
                self._parked.pop(parked_id, None)

    async def _spawn_grant_topup(self, short: int, job_hex: Optional[str],
                                 renv: Optional[dict], renv_hash: str,
                                 resources: Dict[str, float],
                                 pg: Optional[bytes],
                                 bundle_index: int,
                                 deadline: float) -> List[dict]:
        """Fork the under-granted remainder of a multi-grant lease reply
        (grant warm now, fork the rest): a ``count=N`` request is served
        with N grants instead of capping at currently-registered workers.
        Doubles as the heterogeneous-shape fallback — a (job, runtime-env)
        shape with NO warm workers at all still receives its full batch,
        forked at the exact shape, rather than under-granting because the
        pool was warmed for a different shape. Resources are debited up
        front and credited back for forks that fail or miss the
        registration window.

        ``deadline`` is the enclosing lease request's deadline: every
        registration wait is bounded by the time remaining, so the reply
        ships before the OWNER's RPC timeout (worker_start_timeout_s + 30)
        — a reply that outlived it would trigger an owner retry and grant
        a second full batch, stranding the first batch's debited leases."""
        if not self.provisioner.zygote_alive \
                or time.monotonic() >= deadline:
            return []
        debited = 0
        for _ in range(short):
            if len(self.workers) + debited >= RAY_CONFIG.max_workers_per_node:
                break
            pool = self._lease_pool(pg, bundle_index)
            if pool is None or not resources_ge(pool, resources):
                break
            resources_sub(pool, resources)
            debited += 1
        if not debited:
            return []

        async def _one():
            try:
                budget = deadline - time.monotonic()
                if budget <= 0:
                    return None
                async with self._spawn_sem:
                    pid = await self.provisioner.fork_worker(renv)
                    if pid is None:
                        return None
                    w = self._register_forked(pid, renv_hash)
                    try:
                        await asyncio.wait_for(
                            w.registered,
                            max(0.05, deadline - time.monotonic()))
                    except asyncio.TimeoutError:
                        # kill + untrack: a late registrant would strand in
                        # self.workers without ever joining the idle pool
                        try:
                            w.proc.kill()
                        except Exception as e:
                            logger.debug("top-up reap of pid %d failed: %s",
                                         w.pid, e)
                        self.workers.pop(w.pid, None)
                        return None
                w.job_hex = job_hex
                self.provisioner.stats["misses"] += 1
                _pool_obs()["misses"].inc()
                return self._record_grant(w, resources, pg, bundle_index)
            except Exception:
                logger.warning("spawn-backed lease top-up failed",
                               exc_info=True)
                return None

        grants = [g for g in await asyncio.gather(
            *[_one() for _ in range(debited)]) if g is not None]
        for _ in range(debited - len(grants)):
            pool = self._lease_pool(pg, bundle_index)
            if pool is not None:
                resources_add(pool, resources)
        return grants

    def _record_grant(self, w: WorkerProc, resources: Dict[str, float],
                      pg: Optional[bytes], bundle_index: int) -> dict:
        """Book one lease on an acquired worker (resources already debited)
        and return its grant entry."""
        lease_id = uuid.uuid4().hex
        w.leases.add(lease_id)
        w.last_assigned = time.monotonic()
        # remember which pool to credit on release
        self.leases[lease_id] = (w, resources, wire.dumps((pg, bundle_index)))
        return {"lease_id": lease_id, "worker_address": w.address,
                "worker_pid": w.pid}

    def _release_lease(self, lease_id: str):
        entry = self.leases.pop(lease_id, None)
        if entry is None:
            return
        w, resources, pool_key = entry
        pg, bundle_index = wire.loads(pool_key)
        pool = self._lease_pool(pg, bundle_index)
        if pool is not None:
            resources_add(pool, resources)
        w.leases.discard(lease_id)
        if w.cards:
            # the lease's worker goes with it, as it may hold the cards'
            # memory (reference: max_calls=1 for GPU tasks); the cards go
            # back once it has exited (_monitor_workers_loop)
            w.retired = True
            try:
                w.proc.terminate()
            except Exception as e:
                logger.debug("retiring pid %s failed: %s", w.pid, e)
        elif w.pid in self.workers and not w.leases and not w.retired:
            w.idle_since = time.monotonic()
            if w not in self.idle_workers:
                self.idle_workers.append(w)
        self._wake_lease_waiters()

    def _wake_lease_waiters(self):
        for fut in self._lease_waiters:
            if not fut.done():
                fut.set_result(True)
        self._lease_waiters = [f for f in self._lease_waiters if not f.done()]

    async def _rpc_ReturnWorkerLease(self, req, conn):
        self._release_lease(req["lease_id"])
        return {"status": "ok"}

    async def _rpc_StoreWaitAny(self, req, conn):
        """Event-driven wait leg (reference: raylet/wait_manager.h): parks
        on the store's seal events until >= num_needed of the oids are
        local (or the bounded chunk expires); one RPC replaces the owner's
        per-ref per-tick StoreContains fan-out."""
        oids = req["oids"]
        need = max(1, req.get("num_needed", 1))
        deadline = time.monotonic() + min(req.get("timeout", 10.0), 30.0)
        while True:
            present = [o for o in oids if self.store.contains(o)]
            remaining = deadline - time.monotonic()
            if len(present) >= need or remaining <= 0:
                return {"present": present}
            present_set = set(present)
            absent = [o for o in oids if o not in present_set]
            tasks = [asyncio.ensure_future(
                self.store.wait_local(o, remaining)) for o in absent]
            try:
                await asyncio.wait(tasks,
                                   return_when=asyncio.FIRST_COMPLETED,
                                   timeout=remaining)
            finally:
                for t in tasks:
                    t.cancel()

    async def _rpc_WasWorkerOOM(self, req, conn):
        # owners ask after a push failure whether the memory monitor killed
        # the worker, to surface OutOfMemoryError instead of a generic death
        return {"oom": req["worker_address"] in self.oom_kills}

    async def _rpc_KillWorker(self, req, conn):
        w = self.workers_by_addr.get(req["worker_address"])
        if w is None:
            return {"status": "not_found"}
        try:
            w.proc.kill()
        except Exception as e:
            logger.debug("KillWorker pid %s failed (already exited?): %s",
                         w.pid, e)
        return {"status": "ok"}

    async def _rpc_GetNodeStats(self, req, conn):
        agent_stats = {}
        if req.get("agent"):
            # per-node agent sample (reference: dashboard agent reporter):
            # a /proc walk of every worker, off the loop
            if not hasattr(self, "_agent"):
                from ray_tpu_torch.dashboard.agent import NodeAgent

                self._agent = NodeAgent()
            agent_stats = await asyncio.get_event_loop().run_in_executor(
                None, self._agent.collect, list(self.workers.keys()))
        return {
            "agent": agent_stats,
            "node_id": self.node_id.hex(),
            "total_resources": dict(self.total_resources),
            "available": dict(self.available),
            "num_workers": len(self.workers),
            "num_idle": len(self.idle_workers),
            "num_leases": len(self.leases),
            "worker_pool": self.provisioner.snapshot(),
            "store": self.store.stats(),
            "labels": dict(self.labels),
            "cluster_view_size": sum(
                1 for v in self.cluster_view.values() if v["alive"]),
        }

    async def _rpc_ProfileWorker(self, req, conn):
        """Route a profiling request to one of this node's workers
        (reference: dashboard ReporterService.GetTraceback / py-spy RPC)."""
        pid = req.get("pid")
        w = self.workers.get(pid)
        if w is None or not w.address:
            return {"status": "not_found",
                    "pids": sorted(self.workers.keys())}
        method = "ProfileMemory" if req.get("kind") == "memory" \
            else "ProfileStacks"
        out = wire.loads(await w.client.call(
            method, wire.dumps(req.get("args") or {}),
            timeout=float(req.get("timeout", 60.0))))
        return {"status": "ok", "pid": pid, "profile": out}

    # ------------------------------------------------------------------
    # placement group bundles (reference: placement_group_resource_manager.cc)
    # ------------------------------------------------------------------

    async def _rpc_PreparePGBundles(self, req, conn):
        pg_id = req["pg_id"]
        # idempotent per-bundle: a 2PC retry (or a reschedule that re-plans
        # surviving bundles onto this node) reserves only indices not
        # already held — never double-subtracting, never no-op'ing away a
        # genuinely new bundle of the same group
        already = self.pg_reserved.get(pg_id, {})
        bundles: Dict[int, Dict[str, float]] = {
            i: r for i, r in req["bundles"].items() if i not in already}
        if not bundles:
            return {"status": "ok"}
        need: Dict[str, float] = {}
        for res in bundles.values():
            for k, v in res.items():
                need[k] = need.get(k, 0.0) + v
        if not resources_ge(self.available, need):
            return {"status": "insufficient"}
        resources_sub(self.available, need)
        self.pg_reserved.setdefault(pg_id, {}).update(
            {i: dict(r) for i, r in bundles.items()})
        self.pg_available.setdefault(pg_id, {}).update(
            {i: dict(r) for i, r in bundles.items()})
        return {"status": "ok"}

    async def _rpc_CommitPGBundles(self, req, conn):
        self.pg_committed.add(req["pg_id"])
        return {"status": "ok"}

    async def _rpc_ReleasePGBundles(self, req, conn):
        pg_id = req["pg_id"]
        reserved = self.pg_reserved.pop(pg_id, {})
        self.pg_available.pop(pg_id, None)
        self.pg_committed.discard(pg_id)
        back: Dict[str, float] = {}
        for res in reserved.values():
            for k, v in res.items():
                back[k] = back.get(k, 0.0) + v
        resources_add(self.available, back)
        for fut in self._lease_waiters:
            if not fut.done():
                fut.set_result(True)
        return {"status": "ok"}

    # ------------------------------------------------------------------
    # object store service + pull manager
    # ------------------------------------------------------------------

    async def _rpc_StoreCreate(self, req, conn):
        return self.store.create(req["oid"], req["size"],
                                 req.get("attempt", 0),
                                 owner=req.get("owner", ""))

    async def _rpc_StoreSeal(self, req, conn):
        attempt = req.get("attempt", 0)
        if not self.store.seal(req["oid"], attempt):
            return {"status": "stale_attempt"}
        spawn(self._announce([req["oid"]], attempt), what="object announce")
        return {"status": "ok"}

    # raylint: disable=WIRE002 store wire protocol kept for out-of-tree callers: the object-plane race tests (tests/test_object_plane_race.py) drive seal/attempt fencing through this method directly
    async def _rpc_StorePutInline(self, req, conn):
        attempt = req.get("attempt", 0)
        if not self.store.put_inline(req["oid"], req["blob"], attempt,
                                     owner=req.get("owner", "")):
            return {"status": "stale_attempt"}
        spawn(self._announce([req["oid"]], attempt), what="object announce")
        return {"status": "ok"}

    async def _rpc_StoreDeleteStale(self, req, conn):
        """Directory-driven cleanup: drop our copy if it is from an older
        execution epoch than the committed one (seal-once self-healing)."""
        if self.store.object_attempt(req["oid"]) < req["attempt"]:
            self.store.delete([req["oid"]])
            return {"deleted": True}
        return {"deleted": False}

    async def _announce(self, oids: List[bytes], attempt: int = 0):
        try:
            await self.gcs.call("ObjectLocAdd", wire.dumps(
                {"oids": oids, "node_id": self.node_id,
                 "sizes": {o: self.store.object_size(o) for o in oids},
                 "attempt": attempt}), retries=2)
        except (RpcError, asyncio.TimeoutError, OSError):
            logger.warning("failed to announce %d object locations", len(oids))
        # owner-resident directory (reference:
        # ownership_object_directory.cc): the owner serves location READS
        # for its objects, so pulls stop hammering the GCS; the GCS copy
        # above remains the durable fallback. One batched RPC per owner,
        # mirroring the batched GCS announce.
        by_owner: Dict[str, list] = {}
        for o in oids:
            owner = self.store.object_owner(o)
            if owner:
                by_owner.setdefault(owner, []).append(o)
        for owner, group in by_owner.items():
            spawn(self._notify_owner(owner, "ObjectLocAnnounce", {
                "oids": group, "node_id": self.node_id.hex(),
                "address": self.server.address,
                "sizes": {o: self.store.object_size(o) or 0 for o in group},
                "attempt": attempt}))

    async def _notify_owner(self, owner: str, method: str, msg: dict):
        try:
            await self._owner_client(owner).call(
                method, wire.dumps(msg), timeout=10.0, retries=1)
        except (RpcError, asyncio.TimeoutError, OSError) as e:
            # best-effort: the GCS directory still has it
            logger.debug("%s notify to owner %s failed: %s", method, owner, e)

    def _owner_client(self, addr: str) -> RetryingRpcClient:
        from collections import OrderedDict

        cache = getattr(self, "_owner_clients", None)
        if cache is None:
            cache = self._owner_clients = OrderedDict()
        client = cache.get(addr)
        if client is None:
            if len(cache) > 128:
                _, evicted = cache.popitem(last=False)  # LRU, not newest
                # grace before close: a concurrent notify/query may still
                # be awaiting on this client
                asyncio.get_event_loop().call_later(
                    30.0, lambda c=evicted: spawn(c.close(),
                                                  what="evicted-client close"))
            client = cache[addr] = RetryingRpcClient(addr)
        else:
            cache.move_to_end(addr)
        return client

    async def _rpc_StoreGet(self, req, conn):
        oid = req["oid"]
        timeout = req.get("timeout", RAY_CONFIG.object_pull_timeout_s)
        pulling = not self.store.contains(oid) and req.get("pull", True)
        if pulling:
            # priority class rides the request: 0 = blocked get, 1 = task
            # arg, 2 = background (reference: pull_manager.cc priorities)
            self._ensure_pull(oid, prio=int(req.get("prio", 1)),
                              owner=req.get("owner", ""))
            self._pull_queue.add_waiter(oid)
        try:
            ok = await self.store.wait_local(oid, timeout)
        finally:
            if pulling:
                self._pull_queue.remove_waiter(oid)
        if not ok:
            return {"status": "timeout"}
        return self.store.access(oid)

    # raylint: disable=WIRE002 store wire protocol kept for out-of-tree callers: the object-plane race tests probe spill/eviction state through this method directly
    async def _rpc_StoreContains(self, req, conn):
        return {"contains": self.store.contains(req["oid"])}

    async def _rpc_StoreMeta(self, req, conn):
        size = self.store.object_size(req["oid"])
        return {"size": size, "attempt": self.store.object_attempt(req["oid"]),
                "owner": self.store.object_owner(req["oid"])}

    async def _rpc_StoreFetchChunk(self, req, conn):
        data = self.store.read_chunk(req["oid"], req["offset"], req["length"],
                                     req.get("attempt"))
        return {"data": data}

    async def _rpc_StoreDelete(self, req, conn):
        owners = {o: self.store.object_owner(o) for o in req["oids"]}
        self.store.delete(req["oids"])
        try:
            await self.gcs.call("ObjectLocRemove", wire.dumps(
                {"oids": req["oids"], "node_id": self.node_id}), retries=1)
        except (RpcError, asyncio.TimeoutError, OSError) as e:
            logger.debug("ObjectLocRemove(%d oids) to GCS failed: %s",
                         len(req["oids"]), e)
        for o, owner in owners.items():
            if owner:  # keep the owner-resident view from going stale
                spawn(self._notify_owner(
                    owner, "ObjectLocDrop",
                    {"oid": o, "node_id": self.node_id.hex()}))
        return {"status": "ok"}

    async def _rpc_StoreStats(self, req, conn):
        return self.store.stats()

    def _ensure_pull(self, oid: bytes, prio: int = 1, owner: str = ""):
        self._pull_queue.request(oid, prio)  # registers or upgrades
        if oid in self._pulls and not self._pulls[oid].done():
            return
        self._pulls[oid] = asyncio.ensure_future(self._pull(oid, prio, owner))

    async def _pull(self, oid: bytes, prio: int = 1, owner: str = ""):
        """Chunked transfer from a remote node's store (reference:
        object_manager/pull_manager.cc + push_manager.cc). Bounded
        concurrency (FIFO through a semaphore) keeps a burst of pulls from
        monopolizing the loop and network, and the SOURCE is chosen at
        random among announced holders: since every completed pull
        announces a new location, an N-node broadcast forms an organic
        fan-out tree off the origin instead of an N-deep queue on it
        (reference: the 1 GiB / 50-node broadcast envelope)."""
        await self._pull_inner(oid, prio, owner)

    async def _pull_inner(self, oid: bytes, prio: int = 1, owner: str = ""):
        import random as _random

        deadline = time.monotonic() + RAY_CONFIG.object_pull_timeout_s
        chunk = RAY_CONFIG.object_chunk_bytes
        while time.monotonic() < deadline:
            if self.store.contains(oid):
                return
            reply = None
            if owner and owner != "gcs-only":
                # owner-resident directory read; an unreachable or empty
                # owner drops us to the GCS copy for the rest of this pull
                try:
                    reply = wire.loads(await self._owner_client(owner).call(
                        "ObjectLocQuery", wire.dumps({"oid": oid}),
                        timeout=10.0, retries=1))
                    if not reply.get("locations"):
                        reply = None
                        owner = "gcs-only"
                except (RpcError, asyncio.TimeoutError, OSError):
                    reply = None
                    owner = "gcs-only"
            if reply is None:
                try:
                    reply = wire.loads(await self.gcs.call(
                        "ObjectLocGet", wire.dumps({"oid": oid}), retries=2))
                except (RpcError, asyncio.TimeoutError, OSError):
                    await asyncio.sleep(0.2)
                    continue
            locations = [l for l in reply["locations"] if l["node_id"] != self.node_id.hex()]
            if not locations:
                # nothing usable this round (possibly a stale owner view
                # listing only us): consult the GCS copy from here on
                owner = "gcs-only"
                await asyncio.sleep(0.1)
                continue
            locations[0] = _random.choice(locations)
            src = RetryingRpcClient(locations[0]["address"])
            attempt = None  # set once meta arrives; guards the except path
            try:
                # the admission bound covers only the actual TRANSFER:
                # a slot must not be parked on location polling for an
                # object nobody has announced yet. Admission is by
                # (priority class, FIFO); False means the queued pull went
                # obsolete (every waiter left) and was cancelled
                if not await self._pull_queue.admit(oid):
                    logger.info("pull %s cancelled (no waiters)",
                                oid.hex()[:12])
                    return
                try:
                    if self.store.contains(oid):
                        return
                    await self._pull_transfer(oid, src, chunk)
                finally:
                    self._pull_queue.release(oid)
                return
            except _PullRetry:
                self._pull_queue.request(oid, prio)
                await asyncio.sleep(0.1)
            except (RpcError, asyncio.TimeoutError, OSError) as e:
                logger.warning("pull %s from %s failed: %s", oid.hex()[:12],
                               locations[0]["address"], e)
                # the copy the owner pointed us at is gone/unreachable;
                # the GCS may know a live secondary — stop re-asking the
                # owner for this pull
                owner = "gcs-only"
                self._pull_queue.request(oid, prio)
                await asyncio.sleep(0.2)
            finally:
                await src.close()
        logger.warning("pull %s timed out", oid.hex()[:12])

    async def _pull_transfer(self, oid: bytes, src, chunk: int):
        meta = wire.loads(await src.call("StoreMeta", wire.dumps({"oid": oid})))
        size = meta.get("size")
        if size is None:
            raise _PullRetry()
        attempt = meta.get("attempt", 0)
        # carry the owner onto the pulled copy: this node's seal announce
        # then reaches the owner too, so secondary replicas join the
        # owner-resident directory and broadcast trees fan out there as well
        created = self.store.create(oid, size, attempt,
                                    owner=meta.get("owner", ""))
        if created["status"] in ("exists", "stale_attempt"):
            return
        if created["status"] != "ok":
            logger.warning("pull %s: local store oom", oid.hex()[:12])
            return
        try:
            offset = 0
            while offset < size:
                n = min(chunk, size - offset)
                r = wire.loads(await src.call("StoreFetchChunk", wire.dumps(
                    {"oid": oid, "offset": offset, "length": n,
                     "attempt": attempt})))
                data = r.get("data")
                if data is None:
                    raise RpcError("source evicted or displaced object mid-pull")
                try:
                    self.store.write_chunk(oid, offset, data, attempt)
                except KeyError:
                    # displaced locally by a newer attempt: clean abort —
                    # the newer copy is (or will be) the committed one
                    return
                offset += n
            if self.store.seal(oid, attempt):
                await self._announce([oid], attempt)
        except (RpcError, asyncio.TimeoutError, OSError):
            # only clean up OUR partial copy — a newer attempt may have
            # displaced the entry mid-transfer and must not be deleted
            if self.store.object_attempt(oid) == attempt \
                    and not self.store.contains(oid):
                self.store.delete([oid])
            raise

    # ------------------------------------------------------------------

    async def _handle(self, method: str, payload: bytes, conn) -> bytes:
        fn = getattr(self, f"_rpc_{method}", None)
        if fn is None:
            raise RpcError(f"raylet: unknown method {method}")
        req = wire.loads(payload) if payload else {}
        resp = await fn(req, conn)
        return wire.dumps(resp)


def main():
    from ray_tpu_torch._private.common import die_with_parent

    die_with_parent()

    import argparse
    import json

    from ray_tpu_torch._private.logs import setup_process_logging

    parser = argparse.ArgumentParser()
    parser.add_argument("--gcs-address", required=True)
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--resources", default="{}")
    parser.add_argument("--labels", default="{}")
    parser.add_argument("--head", action="store_true")
    parser.add_argument("--node-id", default="")
    parser.add_argument("--log-dir", default="")
    parser.add_argument("--address-file", default="")
    parser.add_argument("--object-store-memory", type=int, default=0)
    args = parser.parse_args()
    setup_process_logging("raylet", args.log_dir)

    from ray_tpu_torch._private.object_store import sweep_stale_shm

    # sweep BEFORE the store arena is created, then construct the raylet in
    # sync context, before the event loop exists: ObjectStoreServer may
    # compile the native store (a g++ subprocess with a 120 s budget) and the
    # loop must never be parked behind it (ASY004). asyncio primitives
    # created in __init__ are loop-lazy on py>=3.10.
    swept = sweep_stale_shm()
    if swept:
        logger.info("swept %d stale shm segments", swept)
    raylet = Raylet(
        gcs_address=args.gcs_address,
        node_id=NodeID.from_hex(args.node_id) if args.node_id else None,
        resources=json.loads(args.resources),
        labels=json.loads(args.labels),
        is_head=args.head,
        port=args.port,
        log_dir=args.log_dir,
        object_store_memory=args.object_store_memory or None,
    )

    async def run():
        addr = await raylet.start()
        if args.address_file:
            tmp = args.address_file + ".tmp"
            with open(tmp, "w") as f:
                f.write(addr)
            os.replace(tmp, args.address_file)
        # graceful stop on SIGTERM/SIGINT so the store's shm arena and
        # per-object segments are unlinked (kill -9 leftovers are reclaimed
        # by sweep_stale_shm at the next node start)
        stop_ev = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, stop_ev.set)
        await stop_ev.wait()
        await raylet.stop()

    asyncio.run(run())


if __name__ == "__main__":
    main()
