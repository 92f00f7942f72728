"""GCS: the cluster control plane.

Reference: ``src/ray/gcs/gcs_server.cc`` (subsystem init at :266-294) — node
membership + health (``gcs_node_manager.cc``, ``gcs_health_check_manager.cc``),
resource view (``gcs_resource_manager.cc``), actor directory + fault tolerance
(``gcs_actor_manager.h``, ``gcs_actor_scheduler.cc``), placement groups with
2PC reserve/commit (``gcs_placement_group_manager.h``,
``gcs_placement_group_scheduler.h:115-118``), job table (``gcs_job_manager.cc``),
internal KV (``gcs_kv_manager.cc``), pubsub (``src/ray/pubsub``), and a
GCS-hosted object directory (deviation: the reference resolves object
locations via owners — ``ownership_object_directory.cc``; this runtime centralizes
the directory here and owners serve small objects directly).

Node resources carry the ``GPU`` cards the raylet detects and node labels,
and actor scheduling can select on them. The port of
``ray_tpu/_private/gcs.py``; its lazy hooks reach the port's
``util/tracing.py`` and ``ckpt/tier/sweeper.py``.
"""

from __future__ import annotations

import asyncio
import logging
import pickle
import threading

from ray_tpu_torch._private import wire
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from ray_tpu_torch._private.common import (
    Bundle,
    NodeInfo,
    PlacementGroupSpec,
    TaskSpec,
    label_match,
    resources_ge,
)
from ray_tpu_torch._private.config import RAY_CONFIG
from ray_tpu_torch._private.async_util import spawn
from ray_tpu_torch._private.task_events import RUNNING, TERMINAL_STATES
from ray_tpu_torch._private.ids import ActorID, JobID, NodeID, PlacementGroupID
from ray_tpu_torch._private.rpc import RpcError, RpcServer, RetryingRpcClient, ServerConnection
from ray_tpu_torch._private.store_client import make_store

logger = logging.getLogger("ray_tpu_torch.gcs")


class ActorRecord:
    def __init__(self, actor_id: ActorID, spec: TaskSpec):
        self.actor_id = actor_id
        self.spec = spec
        opts = spec.actor_options
        self.name = opts.name or ""
        self.namespace = opts.namespace or "default"
        self.lifetime = opts.lifetime
        self.max_restarts = opts.max_restarts
        self.restarts_used = 0
        self.state = "PENDING_CREATION"
        self.address = ""
        self.node_id: Optional[NodeID] = None
        self.job_id = spec.job_id
        self.death_cause = ""
        self.class_name = ""
        self.pending_kill = False
        self.lease_id = ""

    def dump(self) -> dict:
        """Durable form for the store client (replayed on GCS restart)."""
        return {
            "spec": self.spec,
            "state": self.state,
            "address": self.address,
            "node_id": self.node_id.binary() if self.node_id else None,
            "restarts_used": self.restarts_used,
            "death_cause": self.death_cause,
            "class_name": self.class_name,
            "pending_kill": self.pending_kill,
            "lease_id": self.lease_id,
        }

    @classmethod
    def restore(cls, data: dict) -> "ActorRecord":
        spec: TaskSpec = data["spec"]
        record = cls(spec.actor_id, spec)
        record.state = data["state"]
        record.address = data["address"]
        record.node_id = NodeID(data["node_id"]) if data["node_id"] else None
        record.restarts_used = data["restarts_used"]
        record.death_cause = data["death_cause"]
        record.class_name = data["class_name"]
        record.pending_kill = data["pending_kill"]
        record.lease_id = data.get("lease_id", "")
        return record

    def info(self) -> dict:
        return {
            "actor_id": self.actor_id.hex(),
            "state": self.state,
            "address": self.address,
            "node_id": self.node_id.hex() if self.node_id else "",
            "name": self.name,
            "namespace": self.namespace,
            "restarts_used": self.restarts_used,
            "max_restarts": self.max_restarts,
            "death_cause": self.death_cause,
            "class_name": self.class_name,
            "job_id": self.job_id.hex(),
            "lifetime": self.lifetime,
        }


class PGRecord:
    def __init__(self, spec: PlacementGroupSpec):
        self.spec = spec
        self.state = "PENDING"  # PENDING | CREATED | REMOVED | RESCHEDULING
        self.bundle_nodes: List[Optional[NodeID]] = [None] * len(spec.bundles)
        self.ready_event = asyncio.Event()

    def dump(self) -> dict:
        return {
            "spec": self.spec,
            "state": self.state,
            "bundle_nodes": [n.binary() if n else None for n in self.bundle_nodes],
        }

    @classmethod
    def restore(cls, data: dict) -> "PGRecord":
        pg = cls(data["spec"])
        pg.state = data["state"]
        pg.bundle_nodes = [NodeID(b) if b else None for b in data["bundle_nodes"]]
        if pg.state in ("CREATED", "REMOVED"):
            pg.ready_event.set()
        return pg


class GcsTaskManager:
    """Bounded per-job store of task lifecycle events.

    Reference: ``gcs/gcs_server/gcs_task_manager.cc`` — core workers flush
    batched state transitions here; the store keeps a bounded per-job ring
    (drop-oldest + a drop counter so truncation is visible, mirroring
    ``RAY_task_events_max_num_task_in_gcs``), merges owner-side and
    executor-side events by task id, and serves ``ray list tasks`` /
    ``ray summary tasks`` / the dashboard timeline."""

    def __init__(self, max_per_job: Optional[int] = None,
                 max_events_per_task: Optional[int] = None):
        self.max_per_job = max_per_job or RAY_CONFIG.gcs_task_events_max_per_job
        self.max_events_per_task = (max_events_per_task
                                    or RAY_CONFIG.task_events_max_per_task)
        # job_hex -> {task_id_hex: record}, insertion-ordered (dict) so the
        # oldest task evicts first when the ring is full
        self.jobs: Dict[str, Dict[str, dict]] = {}
        # flat id index: owner and executor flush independently (the
        # executor's RUNNING may even arrive first), and the lookup runs
        # once per event — it must be O(1), not a scan over every ring
        self._by_tid: Dict[str, dict] = {}
        self.dropped: Dict[str, int] = {}  # per-job: ring evictions +
        #                                    reporter-side buffer drops

    def add_events(self, events: List[dict], dropped: int = 0):
        for ev in events:
            tid = ev.get("task_id")
            if not tid:
                continue
            rec = self._by_tid.get(tid)
            if rec is None:
                job = ev.get("job_id") or "unknown"
                ring = self.jobs.setdefault(job, {})
                while len(ring) >= self.max_per_job:
                    oldest = next(iter(ring))
                    del ring[oldest]
                    self._by_tid.pop(oldest, None)
                    self.dropped[job] = self.dropped.get(job, 0) + 1
                rec = ring[tid] = self._by_tid[tid] = {
                    "task_id": tid, "job_id": job, "name": "", "state": "",
                    "attempt": 0, "error": "", "worker": "", "node": "",
                    "arg_bytes": 0, "ret_bytes": 0,
                    "span_id": "", "parent_span": "",
                    "events": [], "_last_ts": 0.0,
                }
            self._merge(rec, ev)
        if dropped:
            self.dropped["_reporter"] = self.dropped.get("_reporter", 0) + dropped

    def _find(self, tid: str) -> Optional[dict]:
        return self._by_tid.get(tid)

    def _merge(self, rec: dict, ev: dict):
        entry = {"state": ev["state"], "ts": ev["ts"],
                 "attempt": ev.get("attempt", 0)}
        if ev.get("error"):
            entry["error"] = ev["error"]
        events = rec["events"]
        events.append(entry)
        if len(events) > self.max_events_per_task:
            del events[: len(events) - self.max_events_per_task]
        if ev.get("name"):
            rec["name"] = ev["name"]
        # causal linkage for the timeline: the task's deterministic
        # execution-span id and the submitter's active span (latest
        # non-empty wins, so a retry's span supersedes attempt 0's)
        if ev.get("span_id"):
            rec["span_id"] = ev["span_id"]
        if ev.get("parent_span"):
            rec["parent_span"] = ev["parent_span"]
        if ev.get("worker"):
            rec["worker"] = ev["worker"]
        if ev.get("node"):
            rec["node"] = ev["node"]
        if ev.get("error"):
            rec["error"] = ev["error"]
        # object-size accounting: arg bytes ride SUBMITTED, return bytes
        # the terminal event; max() keeps the merge idempotent under
        # replays and retry re-submissions report their largest attempt
        if ev.get("arg_bytes"):
            rec["arg_bytes"] = max(rec["arg_bytes"], int(ev["arg_bytes"]))
        if ev.get("ret_bytes"):
            rec["ret_bytes"] = max(rec["ret_bytes"], int(ev["ret_bytes"]))
        rec["attempt"] = max(rec["attempt"], ev.get("attempt", 0))
        # latest-state resolution: owner and executor flush independently,
        # so events can arrive out of ts order; a terminal state is never
        # overridden by a late RUNNING
        if ev["state"] in TERMINAL_STATES or (
                rec["state"] not in TERMINAL_STATES
                and ev["ts"] >= rec["_last_ts"]):
            rec["state"] = ev["state"]
        rec["_last_ts"] = max(rec["_last_ts"], ev["ts"])

    @staticmethod
    def _dump(rec: dict) -> dict:
        events = sorted(rec["events"], key=lambda e: e["ts"])
        out = {k: v for k, v in rec.items() if not k.startswith("_")}
        out["events"] = events
        if events:
            out["start_ts"] = events[0]["ts"]
            out["end_ts"] = events[-1]["ts"]
            out["duration_s"] = events[-1]["ts"] - events[0]["ts"]
        return out

    def list_tasks(self, job_id: Optional[str] = None,
                   name: Optional[str] = None, state: Optional[str] = None,
                   limit: int = 200) -> List[dict]:
        out = []
        for job, ring in self.jobs.items():
            if job_id and job != job_id:
                continue
            for rec in ring.values():
                # substring match: function names are qualnames
                # ("mod.<locals>.fn"), exact equality would be unusable
                if name and name not in rec["name"]:
                    continue
                if state and rec["state"] != state:
                    continue
                out.append(self._dump(rec))
        out.sort(key=lambda r: r.get("start_ts", 0.0))
        return out[-int(limit):]

    def get_task(self, tid: str) -> Optional[dict]:
        rec = self._find(tid)
        return self._dump(rec) if rec is not None else None

    def summarize(self, job_id: Optional[str] = None) -> dict:
        """Per-function counts by lifecycle state (the ``ray summary
        tasks`` analog), plus per-function object-size accounting
        (summed serialized argument / returned-object bytes)."""
        per_fn: Dict[str, Dict[str, int]] = {}
        sizes: Dict[str, Dict[str, int]] = {}
        total = 0
        for job, ring in self.jobs.items():
            if job_id and job != job_id:
                continue
            for rec in ring.values():
                total += 1
                fn = rec["name"] or "<unknown>"
                by_state = per_fn.setdefault(fn, {})
                st = rec["state"] or "UNKNOWN"
                by_state[st] = by_state.get(st, 0) + 1
                sz = sizes.setdefault(fn, {"arg_bytes": 0, "ret_bytes": 0})
                sz["arg_bytes"] += rec.get("arg_bytes", 0)
                sz["ret_bytes"] += rec.get("ret_bytes", 0)
        return {"per_function": per_fn, "per_function_bytes": sizes,
                "total": total, "dropped": dict(self.dropped)}


class ShardedTaskEvents:
    """Sharded + pipelined front for ``GcsTaskManager``, with the merge
    work OFF the GCS event loop.

    5k+ tasks/s of lifecycle events must not serialize on one merge path:
    ``AddTaskEvents`` routes each event by task-id hash into one of
    ``gcs_task_event_shards`` bounded ingest queues and returns immediately.
    A dedicated merge THREAD (not an event-loop task — merging 20k queued
    events inline used to stall heartbeats and lease grants for the whole
    batch) owns the shard stores exclusively: it drains the queues, and
    read RPCs hand their query over as a closure (:meth:`read`) that the
    thread executes against its stores after everything already queued has
    merged. The handoff is lock-free — single-owner stores, thread-safe
    deques for the queues and the read requests, results resolved back
    onto the event loop via ``call_soon_threadsafe`` — so ``ListTasks`` /
    timeline scrapes never block ingest and ingest never blocks the loop.
    Per-shard rings keep the global per-job bound at
    ``gcs_task_events_max_per_job`` in aggregate."""

    def __init__(self, nshards: Optional[int] = None):
        n = max(1, nshards or RAY_CONFIG.gcs_task_event_shards)
        per_shard_cap = max(1, RAY_CONFIG.gcs_task_events_max_per_job // n)
        self.shards = [GcsTaskManager(max_per_job=per_shard_cap)
                       for _ in range(n)]
        # deque append/popleft are GIL-atomic: the event loop enqueues,
        # the merge thread dequeues, no lock needed
        self._queues: List[deque] = [deque() for _ in range(n)]
        self._reporter_drops: deque = deque()  # reporter-side drop counts
        self._reads: deque = deque()  # (closure, loop|None, future|Event)
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._thread_lock = threading.Lock()
        self._stopped = False
        self._qmax = max(256, RAY_CONFIG.gcs_task_event_ingest_max)
        self.ingest_dropped = 0  # queue-full drops (visible in summarize)
        self.batches = 0  # drained merge batches (pipelining evidence)

    def _shard_of(self, tid: str) -> int:
        # task ids are hex; the tail bytes are well distributed
        try:
            return int(tid[-4:], 16) % len(self.shards)
        except (ValueError, TypeError):
            return 0

    def ingest(self, events: List[dict], dropped: int = 0):
        """Handler-side: route + enqueue, no merging on the RPC path."""
        for ev in events:
            tid = ev.get("task_id")
            if not tid:
                continue
            q = self._queues[self._shard_of(tid)]
            if len(q) >= self._qmax:
                # drop-OLDEST, matching the store rings: the newest events
                # carry the terminal FINISHED/FAILED transitions that must
                # win the merge — shedding them would freeze tasks at
                # RUNNING forever in every surface
                q.popleft()
                self.ingest_dropped += 1
            q.append(ev)
        if dropped:
            self._reporter_drops.append(int(dropped))
        if events or dropped:
            self._ensure_thread()
            self._wake.set()

    # -- merge thread ---------------------------------------------------

    def _ensure_thread(self):
        t = self._thread
        if t is not None and t.is_alive():
            return
        with self._thread_lock:
            if self._thread is None or not self._thread.is_alive():
                self._stopped = False
                self._thread = threading.Thread(
                    target=self._merge_loop, name="gcs-task-event-merge",
                    daemon=True)
                self._thread.start()

    def stop(self):
        self._stopped = True
        self._wake.set()

    def _merge_loop(self):
        while True:
            self._wake.wait(timeout=0.5)
            # raylint: disable=RCE002 _wake is a threading.Event — itself the synchronization primitive; .clear() is misread as a container mutation, and a lost wakeup is bounded by the 0.5s poll
            self._wake.clear()
            try:
                self._drain_queues()
            except Exception:
                logger.exception("task-event merge iteration failed")
            self._serve_reads()
            if self._stopped:
                self._serve_reads()  # don't strand a late read forever
                return

    def _drain_queues(self):
        for i, q in enumerate(self._queues):
            while q:
                batch = []
                while q and len(batch) < 1024:
                    batch.append(q.popleft())
                self.shards[i].add_events(batch)
                # raylint: disable=RCE001 _drain_queues runs inline on a caller only when the merge thread is not alive (flush_sync checks); live-thread callers hand off through _reads instead, so two contexts never drain concurrently
                self.batches += 1
        while self._reporter_drops:
            self.shards[0].add_events([], self._reporter_drops.popleft())

    def _serve_reads(self):
        while self._reads:
            try:
                # read-your-writes: events enqueued BEFORE this read was
                # posted must be merged before it runs
                self._drain_queues()
            except Exception:
                logger.exception("task-event merge before read failed")
            fn, loop, fut = self._reads.popleft()
            try:
                result, err = fn(self), None
            except BaseException as e:
                result, err = None, e
            if loop is None:  # sync barrier (threading.Event)
                fut.set()
                continue

            def _resolve(fut=fut, result=result, err=err):
                if fut.cancelled():
                    return
                if err is not None:
                    fut.set_exception(err)
                else:
                    fut.set_result(result)

            try:
                loop.call_soon_threadsafe(_resolve)
            except RuntimeError as e:  # loop already closed (shutdown race)
                logger.debug("task-event read resolve dropped: %s", e)

    async def read(self, fn: Callable[["ShardedTaskEvents"], Any]):
        """Run ``fn(self)`` on the merge thread, after everything already
        enqueued has merged (read-your-writes), and await the result
        WITHOUT blocking the caller's event loop — heartbeats and ingest
        proceed while the merge thread works."""
        self._ensure_thread()
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self._reads.append((fn, loop, fut))
        self._wake.set()
        return await fut

    def flush_sync(self, max_events: int = 0):
        """Synchronous read barrier for callers OUTSIDE the GCS event loop
        (tests, tools): returns once everything currently queued has
        merged. With no merge thread running (directly-constructed stores
        in unit tests) the merge runs inline on the caller."""
        t = self._thread
        if t is None or not t.is_alive():
            self._drain_queues()
            return
        done = threading.Event()
        self._reads.append((lambda _tm: None, None, done))
        self._wake.set()
        done.wait(timeout=30.0)

    # -- reads fan out over the shards (call via read()/flush_sync) -----

    def add_events(self, events: List[dict], dropped: int = 0):
        """Synchronous compatibility path: enqueue + barrier (the shard
        stores belong to the merge thread; writing them directly from the
        caller would race it)."""
        self.ingest(events, dropped)
        self.flush_sync()

    def list_tasks(self, job_id=None, name=None, state=None,
                   limit: int = 200) -> List[dict]:
        out = []
        for shard in self.shards:
            out.extend(shard.list_tasks(job_id=job_id, name=name,
                                        state=state, limit=limit))
        out.sort(key=lambda r: r.get("start_ts", 0.0))
        return out[-int(limit):]

    def get_task(self, tid: str) -> Optional[dict]:
        return self.shards[self._shard_of(tid)].get_task(tid)

    def summarize(self, job_id=None) -> dict:
        per_fn: Dict[str, Dict[str, int]] = {}
        sizes: Dict[str, Dict[str, int]] = {}
        dropped: Dict[str, int] = {}
        total = 0
        for shard in self.shards:
            s = shard.summarize(job_id=job_id)
            total += s["total"]
            for fn, by_state in s["per_function"].items():
                agg = per_fn.setdefault(fn, {})
                for st, n in by_state.items():
                    agg[st] = agg.get(st, 0) + n
            for fn, sz in s["per_function_bytes"].items():
                agg_sz = sizes.setdefault(fn, {"arg_bytes": 0, "ret_bytes": 0})
                agg_sz["arg_bytes"] += sz["arg_bytes"]
                agg_sz["ret_bytes"] += sz["ret_bytes"]
            for k, v in s["dropped"].items():
                dropped[k] = dropped.get(k, 0) + v
        if self.ingest_dropped:
            dropped["_ingest_queue"] = self.ingest_dropped
        return {"per_function": per_fn, "per_function_bytes": sizes,
                "total": total, "dropped": dropped,
                "shards": len(self.shards), "merge_batches": self.batches}


class MetricsHistory:
    """Bounded two-tier time-series ring over the cluster's metric
    snapshots.

    The GCS already receives every process's registry snapshot (the
    core-worker/raylet auto-flush KV puts into ns ``metrics``); before
    this class, ``/metrics`` could only serve the LATEST values. Here the
    latest per-process payloads are aggregated cluster-wide on a sampling
    cadence into a raw ring (``metrics_history_interval_s``, default 5 s)
    and periodically rolled up into a coarser ring
    (``metrics_history_rollup_s``, default 60 s: avg/min/max for gauges,
    cumulative-last + rate for counters and histograms — histogram samples
    keep the full bucket vector so percentiles-over-time come from bucket
    deltas). Surfaced via the ``GetMetricsHistory`` RPC,
    ``util.state.metrics_history`` and ``GET /api/metrics/history``."""

    STALE_S = 120.0  # ignore process snapshots older than this

    def __init__(self, raw_interval_s: Optional[float] = None,
                 raw_points: Optional[int] = None,
                 rollup_interval_s: Optional[float] = None,
                 rollup_points: Optional[int] = None):
        self.raw_interval_s = (raw_interval_s
                               or RAY_CONFIG.metrics_history_interval_s)
        self.raw_points = raw_points or RAY_CONFIG.metrics_history_raw_points
        self.rollup_interval_s = (rollup_interval_s
                                  or RAY_CONFIG.metrics_history_rollup_s)
        self.rollup_points = (rollup_points
                              or RAY_CONFIG.metrics_history_rollup_points)
        self._procs: Dict[str, dict] = {}  # kv key -> latest proc payload
        self._raw: Dict[str, deque] = {}
        self._rollup: Dict[str, deque] = {}
        self._kinds: Dict[str, str] = {}
        self._last_rollup = 0.0
        self.samples = 0

    # -- ingestion ------------------------------------------------------

    def observe_payload(self, key: str, payload: dict):
        """Feed one process's registry snapshot (called on every KV put
        into the ``metrics`` namespace — no new reporting path)."""
        if isinstance(payload, dict) and "metrics" in payload:
            self._procs[key] = payload

    def _fresh_procs(self, now: float) -> List[dict]:
        stale = [k for k, p in self._procs.items()
                 if now - p.get("time", 0) > self.STALE_S]
        for k in stale:
            del self._procs[k]
        return list(self._procs.values())

    def latest_by_node(self, name: str) -> Dict[str, float]:
        """Latest per-node value of a gauge (max across a node's processes
        and tag sets) — the health monitor's straggler-outlier view."""
        out: Dict[str, float] = {}
        now = time.time()
        for p in self._fresh_procs(now):
            m = p.get("metrics", {}).get(name)
            if not m or m.get("kind") != "gauge":
                continue
            vals = [v for v in m.get("data", {}).values()
                    if isinstance(v, (int, float))]
            if not vals:
                continue
            node = str(p.get("node", ""))[:16]
            out[node] = max(out.get(node, float("-inf")), max(vals))
        return out

    # -- sampling -------------------------------------------------------

    def _aggregate(self, now: float) -> Dict[str, dict]:
        """Cluster-wide aggregate per metric name across all fresh process
        snapshots and tag sets: counters sum; gauges sum + max + process
        count; histograms sum counts/sums and element-wise bucket rows."""
        agg: Dict[str, dict] = {}
        for p in self._fresh_procs(now):
            for name, m in p.get("metrics", {}).items():
                kind = m.get("kind")
                data = m.get("data", {})
                self._kinds[name] = kind
                if kind == "counter":
                    s = agg.setdefault(name, {"value": 0.0})
                    s["value"] += sum(v for v in data.values()
                                      if isinstance(v, (int, float)))
                elif kind == "gauge":
                    vals = [v for v in data.values()
                            if isinstance(v, (int, float))]
                    if not vals:
                        continue
                    s = agg.setdefault(
                        name, {"value": 0.0, "max": float("-inf"), "n": 0})
                    s["value"] += sum(vals)
                    s["max"] = max(s["max"], max(vals))
                    s["n"] += 1
                elif kind == "histogram":
                    bounds = list(data.get("boundaries") or [])
                    s = agg.setdefault(name, {
                        "count": 0, "sum": 0.0,
                        "buckets": [0] * (len(bounds) + 1),
                        "boundaries": bounds})
                    for counts in data.get("counts", {}).values():
                        s["count"] += sum(counts)
                        if len(counts) == len(s["buckets"]):
                            for i, c in enumerate(counts):
                                s["buckets"][i] += c
                    s["sum"] += sum(v for v in data.get("sums", {}).values()
                                    if isinstance(v, (int, float)))
        return agg

    def sample(self, now: Optional[float] = None):
        """Append one raw-tier point per metric (called every
        ``raw_interval_s`` by the GCS sampling loop), rolling the coarse
        tier up when its interval has elapsed."""
        now = time.time() if now is None else now
        self.samples += 1
        for name, s in self._aggregate(now).items():
            ring = self._raw.get(name)
            if ring is None:
                ring = self._raw[name] = deque(maxlen=self.raw_points)
            ring.append({"ts": now, **s})
        if now - self._last_rollup >= self.rollup_interval_s:
            self._last_rollup = now
            self._roll(now)

    def _roll(self, now: float):
        for name, ring in self._raw.items():
            window = [p for p in ring
                      if p["ts"] > now - self.rollup_interval_s]
            if not window:
                continue
            kind = self._kinds.get(name, "gauge")
            first, last = window[0], window[-1]
            span = max(last["ts"] - first["ts"], 1e-9)
            point: Dict[str, Any] = {"ts": now, "n_raw": len(window)}
            if kind == "gauge":
                # avg/min/max of the cluster-summed series (raw samples'
                # per-process "max" is a different axis — mixing it in
                # would let max < value on multi-process gauges)
                vals = [p["value"] for p in window]
                point["value"] = sum(vals) / len(vals)
                point["min"] = min(vals)
                point["max"] = max(vals)
            elif kind == "counter":
                point["value"] = last["value"]
                # clamped at 0: the cluster value is a sum over the CURRENT
                # membership, so a process exiting (or stale-pruned) drops
                # its lifetime total from the series — that step down is a
                # membership change, not negative throughput
                point["rate"] = (max(0.0, last["value"] - first["value"])
                                 / span if len(window) > 1 else 0.0)
            else:  # histogram: cumulative last + observation rate
                point["count"] = last["count"]
                point["sum"] = last["sum"]
                point["buckets"] = list(last.get("buckets") or ())
                point["boundaries"] = list(last.get("boundaries") or ())
                point["rate"] = (max(0.0, last["count"] - first["count"])
                                 / span if len(window) > 1 else 0.0)
            ring2 = self._rollup.get(name)
            if ring2 is None:
                ring2 = self._rollup[name] = deque(maxlen=self.rollup_points)
            ring2.append(point)

    # -- reads ----------------------------------------------------------

    def names(self) -> List[str]:
        return sorted(self._raw.keys())

    def series(self, name: str, window_s: Optional[float] = None,
               tier: str = "auto", now: Optional[float] = None) -> dict:
        """One metric's time series. ``tier="auto"`` picks raw while the
        requested window still fits in the raw ring, else rollup."""
        now = time.time() if now is None else now
        if tier not in ("raw", "rollup", "auto"):
            tier = "auto"
        if tier == "auto":
            raw_span = self.raw_interval_s * self.raw_points
            tier = ("raw" if window_s is None or window_s <= raw_span
                    else "rollup")
        ring = (self._raw if tier == "raw" else self._rollup).get(name)
        points = list(ring) if ring else []
        if window_s:
            cutoff = now - window_s
            points = [p for p in points if p["ts"] >= cutoff]
        return {"name": name, "kind": self._kinds.get(name, ""),
                "tier": tier,
                "interval_s": (self.raw_interval_s if tier == "raw"
                               else self.rollup_interval_s),
                "points": points}


class GoodputLedger:
    """GCS-side per-job goodput aggregation (``util/goodput.py`` is the
    process-side half).

    Every process with an active ledger flushes a CUMULATIVE payload —
    bucket seconds, counters, wall time — into KV ns ``goodput`` on the
    metrics cadence; the same ``_observe_kv`` tap that feeds
    ``MetricsHistory`` lands them here. A job's view sums the latest
    payload of every process tagged with it, deriving
    ``goodput_fraction`` (step_compute share of summed wall). Finished
    jobs keep their final ledgers (bounded LRU) so ``/api/goodput`` can
    still explain a completed run; the health scanner's
    :meth:`findings` pass also maintains the per-job trailing windows
    behind the recompile-storm and goodput-regression findings."""

    STALE_S = 120.0       # a proc not flushing for this long is not fresh
    MAX_JOBS = 64         # finished-job LRU bound
    HISTORY_POINTS = 240  # per-job trailing-window ring (scan cadence)

    def __init__(self):
        # job -> proc kv-key -> latest cumulative payload
        self._jobs: Dict[str, Dict[str, dict]] = {}
        self._fraction_hist: Dict[str, deque] = {}
        self._recompile_hist: Dict[str, deque] = {}

    # -- ingestion ------------------------------------------------------

    def observe(self, key: str, payload: dict):
        if not isinstance(payload, dict) or "buckets" not in payload:
            return
        job = str(payload.get("job") or "") or "(untagged)"
        # a process belongs to one job at a time: a re-tagged worker's
        # old entry must not keep inflating the previous job
        for j, procs in self._jobs.items():
            if j != job:
                procs.pop(key, None)
        procs = self._jobs.pop(job, {})
        self._jobs[job] = procs  # move-to-end: dict order is the LRU
        procs[key] = payload
        while len(self._jobs) > self.MAX_JOBS:
            evicted = next(iter(self._jobs))
            del self._jobs[evicted]
            self._fraction_hist.pop(evicted, None)
            self._recompile_hist.pop(evicted, None)

    # -- reads ----------------------------------------------------------

    def _job_view(self, job: str, procs: Dict[str, dict],
                  now: float) -> dict:
        buckets: Dict[str, float] = {}
        counters: Dict[str, float] = {}
        wall = 0.0
        mfu = None
        nodes = set()
        fresh = 0
        last_update = 0.0
        for p in procs.values():
            for b, v in (p.get("buckets") or {}).items():
                if isinstance(v, (int, float)):
                    buckets[b] = buckets.get(b, 0.0) + float(v)
            for c, v in (p.get("counters") or {}).items():
                if isinstance(v, (int, float)):
                    counters[c] = counters.get(c, 0) + v
            wall += float(p.get("wall_s") or 0.0)
            if isinstance(p.get("mfu"), (int, float)):
                mfu = max(mfu if mfu is not None else 0.0, float(p["mfu"]))
            if p.get("node"):
                nodes.add(str(p["node"])[:16])
            ts = float(p.get("time") or 0.0)
            last_update = max(last_update, ts)
            if now - ts <= self.STALE_S:
                fresh += 1
        view = {
            "job": job, "wall_s": wall, "buckets": buckets,
            "counters": counters,
            "goodput_fraction": (buckets.get("step_compute", 0.0) / wall
                                 if wall > 0 else 0.0),
            "procs": len(procs), "fresh_procs": fresh,
            "nodes": sorted(nodes), "last_update": last_update,
        }
        if mfu is not None:
            view["mfu"] = mfu
        return view

    def jobs(self, now: Optional[float] = None) -> Dict[str, dict]:
        now = time.time() if now is None else now
        return {job: self._job_view(job, procs, now)
                for job, procs in self._jobs.items() if procs}

    # -- health findings ------------------------------------------------

    def findings(self, now: float, cfg) -> List[dict]:
        """One health-scan pass over every job with fresh reporters:
        recompile storms (recompile count within the trailing window),
        input-bound jobs (input_stall share of wall), checkpoint pauses
        over budget (mean pause per save), and goodput regression vs
        the job's OWN trailing-window mean. Also appends this scan's
        point to the per-job trailing rings."""
        out: List[dict] = []
        for job, view in self.jobs(now).items():
            if view["fresh_procs"] == 0:
                continue  # finished/stale job: freeze, never re-warn
            wall = view["wall_s"]
            buckets = view["buckets"]
            counters = view["counters"]
            fraction = view["goodput_fraction"]
            rc_hist = self._recompile_hist.setdefault(
                job, deque(maxlen=self.HISTORY_POINTS))
            fr_hist = self._fraction_hist.setdefault(
                job, deque(maxlen=self.HISTORY_POINTS))
            if wall >= cfg.goodput_min_wall_s:
                # recompile storm: recompiles accumulated inside the
                # window (vs the oldest in-window history point; with no
                # history yet the lifetime total is the window)
                recompiles = counters.get("recompiles", 0)
                cutoff = now - cfg.goodput_recompile_window_s
                base = next((v for ts, v in rc_hist if ts >= cutoff), None)
                recent = recompiles - base if base is not None else recompiles
                if recent >= cfg.goodput_recompile_storm_n:
                    out.append({
                        "kind": "recompile_storm", "severity": "warning",
                        "job": job, "recompiles_in_window": recent,
                        "window_s": cfg.goodput_recompile_window_s,
                        "compiles_total": counters.get("compiles", 0),
                        "compile_s": buckets.get("compile", 0.0)})
                stall_frac = buckets.get("input_stall", 0.0) / wall
                if stall_frac > cfg.goodput_input_bound_frac:
                    out.append({
                        "kind": "input_bound", "severity": "warning",
                        "job": job, "input_stall_fraction": stall_frac,
                        "threshold": cfg.goodput_input_bound_frac,
                        "input_stall_s": buckets.get("input_stall", 0.0)})
                saves = counters.get("ckpt_saves", 0)
                pause = buckets.get("ckpt_pause", 0.0)
                if saves > 0 and pause / saves > cfg.goodput_ckpt_budget_s:
                    out.append({
                        "kind": "ckpt_pause_over_budget",
                        "severity": "warning", "job": job,
                        "mean_pause_s": pause / saves, "saves": saves,
                        "budget_s": cfg.goodput_ckpt_budget_s})
                if len(fr_hist) >= cfg.goodput_regression_min_points:
                    trailing = sum(v for _, v in fr_hist) / len(fr_hist)
                    if trailing - fraction > cfg.goodput_regression_drop:
                        out.append({
                            "kind": "goodput_regression",
                            "severity": "warning", "job": job,
                            "goodput_fraction": fraction,
                            "trailing_mean": trailing,
                            "drop": trailing - fraction,
                            "threshold": cfg.goodput_regression_drop})
            rc_hist.append((now, counters.get("recompiles", 0)))
            fr_hist.append((now, fraction))
        return out


def build_timeline(records: List[dict], spans: Optional[List[dict]] = None,
                   start_ts: Optional[float] = None,
                   end_ts: Optional[float] = None) -> dict:
    """Render merged task-event records (+ optional span records) as a
    Perfetto-loadable chrome-trace JSON object.

    Tracks: one synthetic pid per node, one tid per worker (named via
    ``ph:"M"`` metadata). Each task renders as a ``pending:`` slice
    (SUBMITTED→RUNNING — scheduling latency is visible, not hidden) and an
    execution slice (RUNNING→terminal); parent→child task edges join on
    the span linkage the task events carry (``span_id``/``parent_span``)
    and render as flow arrows (``ph:"s"/"f"`` pairs). Span
    records (``tracing.profile()`` blocks, submit anchors) are appended
    through :func:`tracing.spans_to_chrome_events` so the built-in
    hot-path spans appear in the same trace."""
    events: List[dict] = []
    pids: Dict[str, int] = {}
    tids: Dict[Tuple[int, str], int] = {}

    def _pid(node: str) -> int:
        if node not in pids:
            pids[node] = len(pids) + 1
            events.append({"ph": "M", "name": "process_name",
                           "pid": pids[node], "tid": 0,
                           "args": {"name": f"node:{node[:12] or '?'}"}})
        return pids[node]

    def _tid(pid: int, worker: str) -> int:
        key = (pid, worker)
        if key not in tids:
            tids[key] = len(tids) + 1
            events.append({"ph": "M", "name": "thread_name",
                           "pid": pid, "tid": tids[key],
                           "args": {"name": f"worker:{worker or '?'}"}})
        return tids[key]

    slices: Dict[str, Tuple[int, int, float, float]] = {}
    kept: List[dict] = []
    for rec in records:
        evs = rec.get("events") or []
        if not evs:
            continue
        t0, t1 = rec.get("start_ts", evs[0]["ts"]), rec.get(
            "end_ts", evs[-1]["ts"])
        if start_ts is not None and t1 < start_ts:
            continue
        if end_ts is not None and t0 > end_ts:
            continue
        kept.append(rec)
        pid = _pid(rec.get("node", ""))
        tid = _tid(pid, rec.get("worker", ""))
        name = rec.get("name") or rec["task_id"][:12]
        run_ts = next((e["ts"] for e in evs if e["state"] == RUNNING), None)
        if run_ts is not None and run_ts > t0:
            events.append({
                "name": f"pending:{name}", "cat": "pending", "ph": "X",
                "ts": t0 * 1e6, "dur": (run_ts - t0) * 1e6,
                "pid": pid, "tid": tid,
                "args": {"task_id": rec["task_id"]}})
        exec_start = run_ts if run_ts is not None else t0
        events.append({
            "name": name, "cat": "task", "ph": "X",
            "ts": exec_start * 1e6,
            "dur": max(t1 - exec_start, 0.0) * 1e6,
            "pid": pid, "tid": tid,
            "args": {"task_id": rec["task_id"], "state": rec.get("state"),
                     "attempt": rec.get("attempt", 0),
                     "job_id": rec.get("job_id", "")}})
        if rec.get("span_id"):
            slices[rec["span_id"]] = (pid, tid, exec_start,
                                      max(t1 - exec_start, 0.0))
    flow_n = 0
    for rec in kept:
        parent = slices.get(rec.get("parent_span") or "")
        child = slices.get(rec.get("span_id") or "")
        if parent is None or child is None or parent is child:
            continue
        flow_n += 1
        ppid, ptid, pts, pdur = parent
        cpid, ctid, cts, _ = child
        # bind the arrow start inside the parent slice
        anchor = min(max(cts, pts), pts + pdur)
        events.append({"name": "task_flow", "cat": "flow", "ph": "s",
                       "id": flow_n, "ts": anchor * 1e6,
                       "pid": ppid, "tid": ptid})
        events.append({"name": "task_flow", "cat": "flow", "ph": "f",
                       "bp": "e", "id": flow_n, "ts": cts * 1e6,
                       "pid": cpid, "tid": ctid})
    if spans:
        from ray_tpu_torch.util.tracing import spans_to_chrome_events

        window = [s for s in spans
                  if (start_ts is None or s["ts"] + max(s.get("dur", 0.0), 0.0)
                      >= start_ts)
                  and (end_ts is None or s["ts"] <= end_ts)]
        # span flow ids live in their own range so they never collide with
        # the task-record arrows above
        events.extend(spans_to_chrome_events(window,
                                             flow_id_base=flow_n + 1_000_000))
    return {"traceEvents": events}


class GcsServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0, persist_dir: str = ""):
        self.store = make_store(persist_dir)
        self.server = RpcServer(self._handle, host, port)
        self.server.on_disconnect = self._on_disconnect
        self.nodes: Dict[NodeID, NodeInfo] = {}
        self.node_available: Dict[NodeID, Dict[str, float]] = {}
        # last availability broadcast per node (delta suppression for the
        # resource_view syncer stream; reference: ray_syncer.h:89), plus
        # the per-tick coalescing set: availability changes mark a node
        # dirty and ONE batched resource_view publish per GCS tick carries
        # the latest view of every dirty node — a 20k-task burst flapping
        # availability 50×/s per node costs one publish per tick, not one
        # per change (reference: the ray_syncer broadcast interval)
        self._last_view_pub: Dict[NodeID, Dict[str, float]] = {}
        self._view_dirty: Set[NodeID] = set()
        self.node_last_seen: Dict[NodeID, float] = {}
        self.node_clients: Dict[NodeID, RetryingRpcClient] = {}
        self.kv: Dict[Tuple[str, str], bytes] = {}
        self.actors: Dict[ActorID, ActorRecord] = {}
        self.named_actors: Dict[Tuple[str, str], ActorID] = {}
        self.pgs: Dict[PlacementGroupID, PGRecord] = {}
        self.jobs: Dict[JobID, dict] = {}
        self.job_counter = 0
        # oid -> {"attempt": committed execution epoch, "nodes": holders};
        # seal-once at cluster scope: only the newest attempt's copies are
        # visible, displaced copies are deleted at their nodes (reference:
        # plasma's seal-once, obj_lifecycle_mgr.cc)
        self.object_dir: Dict[bytes, dict] = {}
        self._freed_ring: "deque[bytes]" = deque()  # bounded tombstone FIFO
        self.subs: Dict[int, Tuple[ServerConnection, Set[str]]] = {}
        self.conn_jobs: Dict[int, JobID] = {}
        self._worker_clients: Dict[str, RetryingRpcClient] = {}
        # unplaceable demand shapes -> autoscaler (reference: the v2
        # gcs_autoscaler_state_manager.cc cluster-state view)
        self.pending_demands: Dict[tuple, dict] = {}
        self.node_last_used: Dict[NodeID, float] = {}
        self.node_num_leases: Dict[NodeID, int] = {}
        # structured event ring (reference: util/event.cc + export events
        # aggregated by the dashboard) — bounded, newest at the right
        self.events = deque(maxlen=1000)
        # task lifecycle events, sharded + pipelined (reference:
        # gcs_task_manager.cc; the sharding is ours — see ShardedTaskEvents)
        self.task_manager = ShardedTaskEvents()
        # cluster health plane: metrics time-series history + the
        # stuck/straggler scanner's latest report
        self.metrics_history = MetricsHistory()
        # per-job goodput aggregation over the workers' ledger payloads
        self.goodput_ledger = GoodputLedger()
        self._health: dict = {"ts": 0.0, "status": "unknown",
                              "findings": [], "scan_count": 0}
        self._health_warn_ts: Dict[tuple, float] = {}
        self._background: List[asyncio.Task] = []
        self.start_time = time.time()
        self._load_init_data()

    # ------------------------------------------------------------------
    # persistence (reference: gcs_init_data.cc replay + store_client/)
    # ------------------------------------------------------------------

    def _load_init_data(self):
        """Reload all durable tables from the store (no-op for a fresh
        in-memory store). Reference: GcsServer::Start loads GcsInitData
        before DoStart (gcs_server.cc:212)."""
        for key, blob in self.store.all("kv").items():
            ns, _, k = key.partition("\x00")
            self.kv[(ns, k)] = wire.loads(blob)
        for key, blob in self.store.all("nodes").items():
            info: NodeInfo = wire.loads(blob)
            self.nodes[info.node_id] = info
            if info.alive:
                self.node_available[info.node_id] = dict(info.total_resources)
                # grace period: raylets heartbeat in; health check reaps others
                self.node_last_seen[info.node_id] = time.monotonic()
                self.node_clients[info.node_id] = RetryingRpcClient(info.address)
        for key, blob in self.store.all("actors").items():
            record = ActorRecord.restore(wire.loads(blob))
            self.actors[record.actor_id] = record
            if record.name and record.state != "DEAD":
                self.named_actors[(record.namespace, record.name)] = record.actor_id
        for key, blob in self.store.all("pgs").items():
            pg = PGRecord.restore(wire.loads(blob))
            self.pgs[pg.spec.pg_id] = pg
        for key, blob in self.store.all("jobs").items():
            job = wire.loads(blob)
            self.jobs[JobID.from_hex(job["job_id"])] = job
        counter = self.store.get("meta", "job_counter")
        if counter is not None:
            self.job_counter = wire.loads(counter)
        if self.actors or self.nodes:
            logger.info(
                "GCS init data replayed: %d nodes, %d actors, %d pgs, %d jobs, %d kv",
                len(self.nodes), len(self.actors), len(self.pgs), len(self.jobs),
                len(self.kv))

    def _persist_kv(self, ns: str, key: str, value=None, delete: bool = False):
        skey = f"{ns}\x00{key}"
        if delete:
            self.store.delete("kv", skey)
        else:
            self.store.put("kv", skey, wire.dumps(value))

    def _persist_node(self, info: NodeInfo):
        if not info.alive:
            self.store.delete("nodes", info.node_id.hex())
        else:
            self.store.put("nodes", info.node_id.hex(), wire.dumps(info))

    def _persist_actor(self, record: ActorRecord):
        if record.state == "DEAD":
            # terminal: delete rather than replay-forever (the in-memory
            # record still serves info queries until the next restart)
            self.store.delete("actors", record.actor_id.hex())
        else:
            self.store.put("actors", record.actor_id.hex(),
                           wire.dumps(record.dump()))

    def _persist_pg(self, pg: PGRecord):
        if pg.state == "REMOVED":
            self.store.delete("pgs", pg.spec.pg_id.hex())
        else:
            self.store.put("pgs", pg.spec.pg_id.hex(), wire.dumps(pg.dump()))

    def _persist_job(self, job: dict):
        if job["state"] == "FINISHED":
            self.store.delete("jobs", job["job_id"])
        else:
            self.store.put("jobs", job["job_id"], wire.dumps(job))

    async def start(self) -> str:
        addr = await self.server.start()
        self._background.append(spawn(self._health_check_loop(),
                                      what="gcs health-check loop"))
        # merge thread for task-event ingest + read handoff (off-loop)
        self.task_manager._ensure_thread()
        self._background.append(spawn(self._metrics_history_loop(),
                                      what="gcs metrics-history sampler"))
        self._background.append(spawn(self._resource_view_flush_loop(),
                                      what="gcs resource-view flusher"))
        self._background.append(spawn(self._health_monitor_loop(),
                                      what="gcs health-monitor scanner"))
        self._background.append(spawn(self._ckpt_sweep_loop(),
                                      what="gcs ckpt retention sweeper"))
        # resume interrupted scheduling work from replayed init data
        for record in self.actors.values():
            if record.state in ("PENDING_CREATION", "RESTARTING"):
                if record.address:
                    # a creation was in flight when we died: probe before
                    # rescheduling so we never run two instances
                    spawn(self._recover_creating_actor(record),
                          what="actor creation recovery")
                else:
                    spawn(self._schedule_actor(record), what="actor scheduling")
        for job_id, job in list(self.jobs.items()):
            if job["state"] == "RUNNING":
                spawn(self._reap_job_if_driver_gone(job_id, job),
                      what="job reap probe")
        for pg in self.pgs.values():
            if pg.state in ("PENDING", "RESCHEDULING"):
                spawn(self._schedule_pg(pg), what="placement-group scheduling")
        logger.info("GCS listening on %s", addr)
        return addr

    async def stop(self):
        for t in self._background:
            t.cancel()
        self.task_manager.stop()
        await self.server.stop()
        self.store.close()

    # ------------------------------------------------------------------
    # dispatch
    # ------------------------------------------------------------------

    async def _handle(self, method: str, payload: bytes, conn) -> bytes:
        fn = getattr(self, f"_rpc_{method}", None)
        if fn is None:
            raise RpcError(f"GCS: unknown method {method}")
        req = wire.loads(payload) if payload else {}
        resp = await fn(req, conn)
        return wire.dumps(resp)

    def _publish(self, channel: str, message: dict):
        payload = wire.dumps(message)
        for conn, channels in list(self.subs.values()):
            if channel in channels:
                spawn(conn.push(channel, payload), what="pubsub push")

    async def _on_disconnect(self, conn: ServerConnection):
        self.subs.pop(conn.conn_id, None)
        job_id = self.conn_jobs.pop(conn.conn_id, None)
        if job_id is not None and job_id in self.jobs:
            await self._finish_job(job_id)

    # ------------------------------------------------------------------
    # nodes / health
    # ------------------------------------------------------------------

    async def _rpc_RegisterNode(self, req, conn):
        info: NodeInfo = req["info"]
        self.nodes[info.node_id] = info
        self.node_available[info.node_id] = dict(info.total_resources)
        self.node_last_seen[info.node_id] = time.monotonic()
        self.node_clients[info.node_id] = RetryingRpcClient(info.address)
        self._persist_node(info)
        logger.info("node %s registered: %s labels=%s", info.node_id.hex()[:8],
                    info.total_resources, info.labels)
        self._publish("nodes", {"event": "added", "node": info.to_dict()})
        # membership changes flush immediately (spillback views must learn
        # about a new peer now); coalescing is for availability flapping
        self._view_dirty.add(info.node_id)
        self._flush_resource_views()
        self._record_event("node", "INFO", "node registered",
                           node_id=info.node_id.hex(),
                           resources=dict(info.total_resources))
        return {"status": "ok"}

    async def _rpc_Heartbeat(self, req, conn):
        node_id: NodeID = req["node_id"]
        if node_id not in self.nodes:
            return {"status": "unknown_node"}  # raylet should re-register
        self.node_last_seen[node_id] = time.monotonic()
        self.node_available[node_id] = req["available"]
        self.node_num_leases[node_id] = req.get("num_leases", 0)
        if self._node_used(node_id) or node_id not in self.node_last_used:
            self.node_last_used[node_id] = time.monotonic()
        # syncer: broadcast availability DELTAS to subscribed raylets so
        # their local schedulers can spill leases peer-to-peer without a
        # per-lease GCS round trip (reference: ray_syncer.h:89 resource
        # views over bidi streams). Changes only mark the node dirty here;
        # the tick loop folds all dirty nodes into ONE batched publish
        # (delta suppression re-checked at flush: a value that flapped
        # back to the published view inside the tick publishes nothing)
        if self._last_view_pub.get(node_id) != req["available"]:
            self._view_dirty.add(node_id)
        # parked lease shapes feed the autoscaler's demand view (the
        # two-level path no longer touches PickNode for schedulable work)
        for shape in req.get("pending_shapes", ()):
            self._record_demand(shape["resources"], shape.get("selector", {}),
                                shape.get("waiter_id", ""))
        return {"status": "ok"}

    def _flush_resource_views(self):
        """Fold every dirty node into one batched ``resource_view`` publish
        carrying its LATEST view (subscribers apply entries idempotently,
        so intermediate states are safely elided). Delta suppression runs
        here, not at mark time: only views that still differ from the last
        broadcast actually ship."""
        if not self._view_dirty:
            return
        views = []
        for node_id in list(self._view_dirty):
            self._view_dirty.discard(node_id)
            info = self.nodes.get(node_id)
            if info is None:
                self._last_view_pub.pop(node_id, None)
                continue
            entry = self._view_entry(node_id)
            if not info.alive:
                self._last_view_pub.pop(node_id, None)
                views.append(entry)
                continue
            if self._last_view_pub.get(node_id) == entry["available"]:
                continue
            self._last_view_pub[node_id] = dict(entry["available"])
            views.append(entry)
        if views:
            self._publish("resource_view", {"views": views})

    async def _resource_view_flush_loop(self):
        tick = RAY_CONFIG.gcs_resource_view_tick_s
        while True:
            await asyncio.sleep(tick)
            try:
                self._flush_resource_views()
            except Exception:
                logger.exception("resource-view flush failed")

    def _view_entry(self, node_id: NodeID) -> dict:
        info = self.nodes[node_id]
        return {
            "node_id": node_id.hex(),
            "address": info.address,
            "available": dict(self.node_available.get(node_id, {})),
            "total": dict(info.total_resources),
            "labels": dict(info.labels),
            "alive": info.alive,
        }

    async def _rpc_GetAllNodes(self, req, conn):
        return {"nodes": [
            {**n.to_dict(),
             "available": dict(self.node_available.get(n.node_id, {}))}
            for n in self.nodes.values()]}

    async def _rpc_GetClusterResources(self, req, conn):
        total: Dict[str, float] = {}
        avail: Dict[str, float] = {}
        for nid, info in self.nodes.items():
            if not info.alive:
                continue
            for k, v in info.total_resources.items():
                total[k] = total.get(k, 0.0) + v
            for k, v in self.node_available.get(nid, {}).items():
                avail[k] = avail.get(k, 0.0) + v
        return {"total": total, "available": avail}

    async def _rpc_DrainNode(self, req, conn):
        node_id: NodeID = req["node_id"]
        await self._mark_node_dead(node_id, "drained")
        return {"status": "ok"}

    async def _health_check_loop(self):
        period = RAY_CONFIG.health_check_period_ms / 1000.0
        timeout = RAY_CONFIG.health_check_timeout_ms / 1000.0
        while True:
            await asyncio.sleep(period)
            now = time.monotonic()
            for node_id, info in list(self.nodes.items()):
                if info.alive and now - self.node_last_seen.get(node_id, now) > timeout:
                    await self._mark_node_dead(node_id, "health check timeout")

    async def _mark_node_dead(self, node_id: NodeID, reason: str):
        info = self.nodes.get(node_id)
        if info is None or not info.alive:
            return
        info.alive = False
        self.node_available.pop(node_id, None)
        self._persist_node(info)
        logger.warning("node %s dead: %s", node_id.hex()[:8], reason)
        self._publish("nodes", {"event": "removed", "node_id": node_id.hex(), "reason": reason})
        # death flushes immediately: spillback must stop targeting it now
        self._view_dirty.add(node_id)
        self._flush_resource_views()
        self._record_event("node", "ERROR", f"node dead: {reason}",
                           node_id=node_id.hex())
        # drop object locations on that node; keep the committed-attempt
        # tombstone so a partitioned zombie's stale announce can't
        # re-register an older epoch as current
        for oid, entry in list(self.object_dir.items()):
            entry["nodes"].discard(node_id)
        # fail over actors that lived there
        for record in list(self.actors.values()):
            if record.node_id == node_id and record.state in ("ALIVE", "PENDING_CREATION"):
                await self._on_actor_worker_lost(record, f"node died: {reason}")
        # reschedule placement groups with bundles there
        for pg in self.pgs.values():
            if pg.state == "CREATED" and any(n == node_id for n in pg.bundle_nodes):
                pg.state = "RESCHEDULING"
                spawn(self._schedule_pg(pg), what="placement-group scheduling")

    # ------------------------------------------------------------------
    # kv
    # ------------------------------------------------------------------

    async def _rpc_KVPut(self, req, conn):
        key = (req.get("ns", ""), req["key"])
        if not req.get("overwrite", True) and key in self.kv:
            return {"added": False}
        self.kv[key] = req["value"]
        self._persist_kv(key[0], key[1], req["value"])
        self._observe_kv(key[0], key[1], req["value"])
        return {"added": True}

    def _observe_kv(self, ns: str, key: str, value):
        """Tap metric-snapshot and goodput-ledger puts into their
        aggregators (the reporters keep their single KV write; history
        costs them nothing)."""
        if ns == "metrics":
            try:
                self.metrics_history.observe_payload(key, wire.loads(value))
            except Exception as e:
                logger.debug("undecodable metrics payload %s: %s", key, e)
        elif ns == "goodput":
            try:
                self.goodput_ledger.observe(key, wire.loads(value))
            except Exception as e:
                logger.debug("undecodable goodput payload %s: %s", key, e)

    async def _rpc_KVGet(self, req, conn):
        return {"value": self.kv.get((req.get("ns", ""), req["key"]))}

    async def _rpc_KVMultiPut(self, req, conn):
        """Batched puts: N keys (possibly across namespaces) in one round
        trip, so high-rate mirrors (metrics, pool stats, store stats) don't
        serialize one handler dispatch per key."""
        added = 0
        for item in req.get("items") or ():
            key = (item.get("ns", ""), item["key"])
            self.kv[key] = item["value"]
            self._persist_kv(key[0], key[1], item["value"])
            self._observe_kv(key[0], key[1], item["value"])
            added += 1
        return {"added": added}

    async def _rpc_KVMultiGet(self, req, conn):
        ns = req.get("ns", "")
        return {"values": {k: self.kv.get((ns, k))
                           for k in req.get("keys") or ()}}

    async def _rpc_KVDel(self, req, conn):
        prefix = req.get("prefix", False)
        ns = req.get("ns", "")
        if prefix:
            keys = [k for k in self.kv if k[0] == ns and k[1].startswith(req["key"])]
            for k in keys:
                del self.kv[k]
                self._persist_kv(k[0], k[1], delete=True)
            return {"deleted": len(keys)}
        if self.kv.pop((ns, req["key"]), None) is not None:
            self._persist_kv(ns, req["key"], delete=True)
            return {"deleted": 1}
        return {"deleted": 0}

    async def _rpc_KVKeys(self, req, conn):
        ns = req.get("ns", "")
        prefix = req.get("prefix", "")
        return {"keys": [k[1] for k in self.kv if k[0] == ns and k[1].startswith(prefix)]}

    # ------------------------------------------------------------------
    # jobs
    # ------------------------------------------------------------------

    async def _rpc_RegisterDriver(self, req, conn):
        self.job_counter += 1
        job_id = JobID.from_int(self.job_counter)
        self.jobs[job_id] = {
            "job_id": job_id.hex(),
            "driver_address": req.get("address", ""),
            "namespace": req.get("namespace", "default"),
            "start_time": time.time(),
            "state": "RUNNING",
            "entrypoint": req.get("entrypoint", ""),
        }
        self.conn_jobs[conn.conn_id] = job_id
        self.store.put("meta", "job_counter", wire.dumps(self.job_counter))
        self._persist_job(self.jobs[job_id])
        return {"job_id": job_id.binary()}

    async def _rpc_ReattachDriver(self, req, conn):
        """A driver re-binds its (new) connection to its existing job after a
        GCS restart, so driver-disconnect job cleanup keeps working."""
        job_id = JobID(req["job_id"])
        job = self.jobs.get(job_id)
        if job is not None and job["state"] == "RUNNING":
            self.conn_jobs[conn.conn_id] = job_id
            return {"status": "ok"}
        return {"status": "unknown_job"}

    async def _finish_job(self, job_id: JobID):
        job = self.jobs.get(job_id)
        if job is None or job["state"] == "FINISHED":
            return
        job["state"] = "FINISHED"
        job["end_time"] = time.time()
        self._persist_job(job)
        logger.info("job %s finished; reaping its actors", job_id.hex())
        for record in list(self.actors.values()):
            if record.job_id == job_id and record.lifetime != "detached" and record.state != "DEAD":
                await self._kill_actor(record, no_restart=True, reason="owning job finished")
        for pg in list(self.pgs.values()):
            if pg.spec.creator_job == job_id and pg.spec.lifetime != "detached":
                await self._remove_pg(pg)
        # purge the job's object-directory entries (incl. empty tombstones
        # kept for epoch fencing); ids embed the job id at the task-id tail
        from ray_tpu_torch._private.ids import TaskID

        jid = job_id.binary()
        for oid in [o for o in self.object_dir
                    if o[TaskID.SIZE - len(jid) : TaskID.SIZE] == jid]:
            del self.object_dir[oid]

    # ------------------------------------------------------------------
    # pubsub
    # ------------------------------------------------------------------

    def _record_event(self, source: str, severity: str, message: str,
                      **metadata):
        event = {"ts": time.time(), "source": source, "severity": severity,
                 "message": message, "metadata": metadata}
        self.events.append(event)
        self._publish("events", event)

    async def _rpc_ReportEvent(self, req, conn):
        ev = dict(req["event"])
        self.events.append(ev)
        self._publish("events", ev)
        return {"status": "ok"}

    async def _rpc_GetEvents(self, req, conn):
        out = list(self.events)
        if req.get("source"):
            out = [e for e in out if e.get("source") == req["source"]]
        if req.get("severity"):
            want = str(req["severity"]).upper()
            out = [e for e in out if e.get("severity") == want]
        return {"events": out[-int(req.get("limit") or 200):]}

    # -- task lifecycle events (reference: gcs_task_manager.cc RPCs) --

    async def _rpc_AddTaskEvents(self, req, conn):
        # enqueue-and-return: the per-shard drain tasks merge in the
        # background so a 5k tasks/s burst costs each reporter an enqueue,
        # not a synchronous merge on the shared handler path
        self.task_manager.ingest(req.get("events") or [],
                                 int(req.get("dropped") or 0))
        return {"status": "ok"}

    async def _rpc_ListTasks(self, req, conn):
        # read handoff: the merge thread runs the query after everything
        # already enqueued has merged — the GCS loop never pays the merge
        job_id, name = req.get("job_id"), req.get("name")
        state, limit = req.get("state"), int(req.get("limit") or 200)
        return {"tasks": await self.task_manager.read(
            lambda tm: tm.list_tasks(job_id=job_id, name=name, state=state,
                                     limit=limit))}

    async def _rpc_GetTask(self, req, conn):
        tid = req["task_id"]
        return {"task": await self.task_manager.read(
            lambda tm: tm.get_task(tid))}

    async def _rpc_SummarizeTasks(self, req, conn):
        job_id = req.get("job_id")
        return await self.task_manager.read(
            lambda tm: tm.summarize(job_id=job_id))

    async def _rpc_GetTimeline(self, req, conn):
        """Chrome-trace (Perfetto) JSON of the task flow graph, filterable
        by job and time window; span records from the trace table ride
        along so built-in hot-path spans land in the same trace. Built on
        the merge thread — a timeline scrape never stalls ingest."""
        job_id = req.get("job_id")
        start_ts, end_ts = req.get("start_ts"), req.get("end_ts")
        limit = int(req.get("limit") or 5000)
        blobs: List[bytes] = []
        if req.get("spans", True):
            # snapshot the blob list on the loop (self.kv belongs to it);
            # decode off-loop on the merge thread
            blobs = [v for (ns, k), v in self.kv.items()
                     if ns == "trace" and k.startswith("spans_") and v]

        def _build(tm):
            spans: List[dict] = []
            for blob in blobs:
                try:
                    spans.extend(wire.loads(blob))
                except Exception as e:
                    logger.debug("undecodable span blob skipped: %s", e)
            records = tm.list_tasks(job_id=job_id, limit=limit)
            return build_timeline(records, spans,
                                  start_ts=start_ts, end_ts=end_ts)

        return await self.task_manager.read(_build)

    async def _rpc_Subscribe(self, req, conn):
        channels = set(req["channels"])
        existing = self.subs.get(conn.conn_id)
        if existing:
            existing[1].update(channels)
        else:
            self.subs[conn.conn_id] = (conn, channels)
        return {"status": "ok"}

    async def _rpc_Publish(self, req, conn):
        self._publish(req["channel"], req["message"])
        return {"status": "ok"}

    # ------------------------------------------------------------------
    # object directory
    # ------------------------------------------------------------------

    async def _rpc_ObjectLocAdd(self, req, conn):
        node_id = req["node_id"]
        attempt = req.get("attempt", 0)
        sizes = req.get("sizes") or {}
        for oid in req["oids"]:
            size = sizes.get(oid, 0)
            entry = self.object_dir.get(oid)
            if entry is not None and size:
                entry["size"] = size
            if entry is None:
                self.object_dir[oid] = {"attempt": attempt, "nodes": {node_id},
                                        "size": size}
            elif attempt > entry["attempt"]:
                displaced = entry["nodes"] - {node_id}
                self.object_dir[oid] = {"attempt": attempt, "nodes": {node_id},
                                        "size": size or entry.get("size", 0)}
                if displaced:
                    spawn(self._delete_stale_copies(oid, attempt, displaced),
                          what="stale-copy delete")
            elif attempt == entry["attempt"]:
                entry["nodes"].add(node_id)
            else:
                # stale-epoch announce: reject, and tell that node to drop it
                spawn(self._delete_stale_copies(
                    oid, entry["attempt"], {node_id}), what="stale-copy delete")
        return {"status": "ok"}

    async def _delete_stale_copies(self, oid: bytes, attempt: int, nodes):
        for node_id in nodes:
            client = self.node_clients.get(node_id)
            info = self.nodes.get(node_id)
            if client is None or info is None or not info.alive:
                continue
            try:
                await client.call("StoreDeleteStale", wire.dumps(
                    {"oid": oid, "attempt": attempt}), timeout=10.0, retries=1)
            except (RpcError, asyncio.TimeoutError, OSError) as e:
                logger.debug("StoreDeleteStale(%s) to %s failed: %s",
                             oid.hex()[:8], node_id.hex()[:8], e)

    async def _rpc_ObjectLocRemove(self, req, conn):
        for oid in req["oids"]:
            entry = self.object_dir.get(oid)
            if entry:
                # keep the committed-attempt tombstone (empty node set) so a
                # stale-epoch announce can't re-register; purged at job end
                entry["nodes"].discard(req["node_id"])
        return {"status": "ok"}

    _FREED_EPOCH = 1 << 62  # tombstone attempt: beats any real epoch

    async def _rpc_ObjectFree(self, req, conn):
        """Owner-initiated cluster-wide free: zero references remain, so the
        copies on every holding node are deleted and the entry becomes a
        freed tombstone (reference: the owner's delete fan-out on ref-count
        zero). The tombstone's infinite epoch makes any late announce (e.g.
        a pull that completed mid-free) route into the stale-copy deletion
        path instead of resurrecting the object.

        Tombstones are BOUNDED: a FIFO ring of gcs_freed_tombstone_cap ids
        (oldest evicted first), not held until job end — a long-running job
        with high object churn would otherwise grow the directory without
        limit. Evicting a tombstone only re-opens the (already tiny) window
        for an announce delayed past tens of thousands of subsequent frees."""
        per_node: Dict[NodeID, List[bytes]] = {}
        for oid in req["oids"]:
            entry = self.object_dir.get(oid)
            if entry:
                for node_id in entry["nodes"]:
                    per_node.setdefault(node_id, []).append(oid)
            self.object_dir[oid] = {"attempt": self._FREED_EPOCH,
                                    "nodes": set()}
            self._freed_ring.append(oid)
        cap = RAY_CONFIG.gcs_freed_tombstone_cap
        while len(self._freed_ring) > cap:
            old = self._freed_ring.popleft()
            stale = self.object_dir.get(old)
            if stale is not None and stale["attempt"] == self._FREED_EPOCH:
                del self.object_dir[old]
        for node_id, oids in per_node.items():
            client = self.node_clients.get(node_id)
            info = self.nodes.get(node_id)
            if client is None or info is None or not info.alive:
                continue
            try:
                await client.call("StoreDelete", wire.dumps({"oids": oids}),
                                  timeout=10.0, retries=1)
            except (RpcError, asyncio.TimeoutError, OSError) as e:
                logger.debug("StoreDelete(%d oids) to %s failed: %s",
                             len(oids), node_id.hex()[:8], e)
        return {"status": "ok"}

    async def _rpc_ObjectLocGet(self, req, conn):
        out = []
        entry = self.object_dir.get(req["oid"])
        for node_id in (entry["nodes"] if entry else ()):  # alive nodes only
            info = self.nodes.get(node_id)
            if info is not None and info.alive:
                out.append({"node_id": node_id.hex(), "address": info.address})
        return {"locations": out, "attempt": entry["attempt"] if entry else 0,
                "size": entry.get("size", 0) if entry else 0}

    # ------------------------------------------------------------------
    # scheduling helpers
    # ------------------------------------------------------------------

    def _feasible_nodes(self, resources: Dict[str, float], selector: Dict[str, str],
                        check_available: bool = True) -> List[NodeID]:
        out = []
        for node_id, info in self.nodes.items():
            if not info.alive:
                continue
            if selector and not label_match(info.labels, selector):
                continue
            pool = self.node_available.get(node_id, {}) if check_available else info.total_resources
            if resources_ge(pool, resources):
                out.append(node_id)
        return out

    def _pick_node(self, resources: Dict[str, float], selector: Dict[str, str],
                   waiter_id: str = "") -> Optional[NodeID]:
        """Hybrid policy: pack onto the most-utilized feasible node below the
        spread threshold, else least-utilized (reference:
        raylet/scheduling/policy/hybrid_scheduling_policy.cc)."""
        feasible = self._feasible_nodes(resources, selector)
        if not feasible:
            # fall back to nodes that are feasible by total resources (queue there)
            feasible = self._feasible_nodes(resources, selector, check_available=False)
            if not feasible:
                self._record_demand(resources, selector, waiter_id)
                return None
        def utilization(nid):
            info = self.nodes[nid]
            avail = self.node_available.get(nid, {})
            fracs = [
                1.0 - avail.get(k, 0.0) / v
                for k, v in info.total_resources.items()
                if v > 0
            ]
            return max(fracs) if fracs else 0.0
        scored = sorted(feasible, key=lambda nid: (utilization(nid), nid.hex()))
        threshold = RAY_CONFIG.scheduler_spread_threshold
        packed = [nid for nid in scored if utilization(nid) < threshold]
        if packed:
            return packed[-1]  # most utilized below threshold -> pack
        return scored[0]  # least utilized -> spread

    async def _rpc_PickNode(self, req, conn):
        """Owner-side lease policy support: pick a node for a task's resource
        shape + label selector (reference: owner lease_policy.cc + raylet
        spillback; centralized here on the GCS resource view)."""
        strat = req.get("strategy")
        if strat == "SPREAD":
            feasible = self._feasible_nodes(req["resources"], req.get("selector", {}))
            if feasible:
                idx = req.get("spread_hint", 0) % len(feasible)
                nid = sorted(feasible, key=lambda n: n.hex())[idx]
                return {"node": self._node_addr(nid)}
        nid = self._pick_node(req["resources"], req.get("selector", {}),
                              waiter_id=req.get("waiter_id", ""))
        return {"node": self._node_addr(nid) if nid else None}

    def _node_addr(self, nid: NodeID) -> dict:
        info = self.nodes[nid]
        return {"node_id": nid.hex(), "address": info.address}

    # ------------------------------------------------------------------
    # actors
    # ------------------------------------------------------------------

    def _worker_client(self, address: str) -> RetryingRpcClient:
        client = self._worker_clients.get(address)
        if client is None:
            client = RetryingRpcClient(address)
            self._worker_clients[address] = client
        return client

    async def _rpc_CreateActor(self, req, conn):
        spec: TaskSpec = req["spec"]
        opts = spec.actor_options
        if opts.name:
            key = (opts.namespace or "default", opts.name)
            existing = self.named_actors.get(key)
            if existing is not None and self.actors[existing].state != "DEAD":
                if opts.get_if_exists:
                    return {"status": "exists", "info": self.actors[existing].info()}
                return {"status": "name_taken"}
        actor_id = spec.actor_id
        record = ActorRecord(actor_id, spec)
        record.class_name = req.get("class_name", "")
        self.actors[actor_id] = record
        if record.name:
            self.named_actors[(record.namespace, record.name)] = actor_id
        self._persist_actor(record)
        spawn(self._schedule_actor(record), what="actor scheduling")
        return {"status": "ok", "info": record.info()}

    async def _schedule_actor(self, record: ActorRecord):
        """Lease a worker on a feasible node and push the creation task.

        Reference: gcs_actor_scheduler.cc (lease-based actor scheduling).
        """
        spec = record.spec
        opts = spec.actor_options
        resources = opts.required_resources()
        deadline = time.monotonic() + 3600.0
        warned = False
        while record.state in ("PENDING_CREATION", "RESTARTING") and not record.pending_kill:
            node_id = None
            if opts.placement_group is not None:
                node_id = self._pg_bundle_node(opts)
            else:
                strat = opts.scheduling_strategy
                selector = dict(opts.label_selector)
                if strat is not None and hasattr(strat, "hard"):
                    selector.update(strat.hard)
                if strat is not None and hasattr(strat, "node_id"):
                    node_id = NodeID.from_hex(strat.node_id)
                    if getattr(strat, "soft", False) and (
                            node_id not in self.nodes
                            or not self.nodes[node_id].alive):
                        # soft affinity: preferred node gone — fall back to
                        # the normal pick instead of pinning to a corpse
                        node_id = self._pick_node(
                            resources, selector,
                            waiter_id=record.actor_id.hex())
                else:
                    node_id = self._pick_node(
                        resources, selector,
                        waiter_id=record.actor_id.hex())
            if node_id is None or node_id not in self.nodes or not self.nodes[node_id].alive:
                if not warned and time.monotonic() > deadline - 3590:
                    pass
                if not warned:
                    logger.warning(
                        "actor %s infeasible (resources=%s); waiting for nodes",
                        record.actor_id.hex()[:8], resources)
                    warned = True
                await asyncio.sleep(0.5)
                if time.monotonic() > deadline:
                    record.state = "DEAD"
                    record.death_cause = "scheduling timed out"
                    self._publish_actor(record)
                    return
                continue
            try:
                # optimistic view update: concurrent _schedule_actor loops
                # all read node_available, which only refreshes on 1 Hz
                # heartbeats — without this decrement a 100-actor burst
                # herds onto ONE node and the overflow parks at its raylet
                # for the whole worker_start_timeout while other nodes sit
                # empty (the next heartbeat corrects any drift)
                avail = self.node_available.get(node_id)
                if avail is not None:
                    for k, v in resources.items():
                        avail[k] = avail.get(k, 0.0) - v
                client = self.node_clients[node_id]
                reply = wire.loads(await client.call("RequestWorkerLease", wire.dumps({
                    "resources": resources,
                    "label_selector": opts.label_selector,
                    "job_id": spec.job_id,
                    "pg": (opts.placement_group.id.binary()
                           if opts.placement_group is not None else None),
                    "bundle_index": opts.placement_group_bundle_index,
                    "for_actor": record.actor_id.binary(),
                    "runtime_env": opts.runtime_env,
                }), timeout=RAY_CONFIG.worker_start_timeout_s + 30))
                if reply.get("status") != "granted":
                    await asyncio.sleep(0.2)
                    continue
                worker_addr = reply["worker_address"]
                # durably note the in-flight creation BEFORE pushing it, so a
                # GCS crash during creation can probe this worker instead of
                # scheduling a second instance (see _recover_creating_actor)
                record.address = worker_addr
                record.node_id = node_id
                record.lease_id = reply.get("lease_id", "")
                self._persist_actor(record)
                wreply = wire.loads(await self._worker_client(worker_addr).call(
                    "PushTask", wire.dumps({"spec": spec}), timeout=600.0))
                if wreply.get("status") != "ok":
                    logger.warning("actor %s creation failed on %s: %s",
                                   record.actor_id.hex()[:8], worker_addr,
                                   wreply.get("error", "")[:500])
                    record.state = "DEAD"
                    record.address = ""
                    record.node_id = None
                    record.death_cause = wreply.get("error", "creation task failed")
                    self._publish_actor(record)
                    return
                record.state = "ALIVE"
                record.address = worker_addr
                record.node_id = node_id
                self._publish_actor(record)
                return
            except (RpcError, asyncio.TimeoutError, OSError) as e:
                logger.warning("actor %s scheduling attempt failed: %s",
                               record.actor_id.hex()[:8], e)
                await asyncio.sleep(0.3)

    async def _recover_creating_actor(self, record: ActorRecord):
        """After an init-data replay, a PENDING_CREATION/RESTARTING record
        with an address means a creation push was in flight when we died.
        Probe the worker: if the actor is instantiated there, adopt it as
        ALIVE; otherwise release the orphaned lease and reschedule."""
        addr = record.address
        try:
            reply = wire.loads(await self._worker_client(addr).call(
                "CheckActor", wire.dumps({"actor_id": record.actor_id.binary()}),
                timeout=10.0, retries=1, connect_timeout=2.0, presend_retries=1))
            if reply.get("hosting"):
                record.state = "ALIVE"
                self._publish_actor(record)
                logger.info("actor %s adopted on %s after GCS restart",
                            record.actor_id.hex()[:8], addr)
                return
        except (RpcError, asyncio.TimeoutError, OSError) as e:
            logger.debug("actor %s adoption probe to %s failed: %s",
                         record.actor_id.hex()[:8], addr, e)
        # not there: give the lease back (if the raylet is still up), then
        # schedule from scratch
        if record.lease_id and record.node_id in self.node_clients:
            try:
                await self.node_clients[record.node_id].call(
                    "ReturnWorkerLease", wire.dumps({"lease_id": record.lease_id}),
                    timeout=5.0, retries=1)
            except (RpcError, asyncio.TimeoutError, OSError) as e:
                logger.debug("ReturnWorkerLease for actor %s failed: %s",
                             record.actor_id.hex()[:8], e)
        record.address = ""
        record.node_id = None
        record.lease_id = ""
        self._persist_actor(record)
        spawn(self._schedule_actor(record), what="actor scheduling")

    async def _reap_job_if_driver_gone(self, job_id: JobID, job: dict):
        """Replayed RUNNING jobs lost their connection binding when the GCS
        died; poll the driver until it either reattaches (conn binding
        restored) or turns out dead (job finished + actors reaped)."""
        grace = RAY_CONFIG.gcs_driver_reattach_grace_s
        while True:
            await asyncio.sleep(grace)
            if job_id not in self.jobs or self.jobs[job_id]["state"] != "RUNNING":
                return
            if any(j == job_id for j in self.conn_jobs.values()):
                return  # driver reattached; disconnect cleanup is armed again
            addr = job.get("driver_address", "")
            if addr:
                try:
                    await self._worker_client(addr).call(
                        "Ping", b"", timeout=5.0, retries=1,
                        connect_timeout=3.0, presend_retries=1)
                    continue  # driver alive but quiet; keep polling
                except (RpcError, asyncio.TimeoutError, OSError) as e:
                    logger.debug("driver ping %s failed (job cleanup "
                                 "candidate): %s", addr, e)
            logger.warning("job %s driver gone after GCS restart; finishing it",
                           job_id.hex())
            await self._finish_job(job_id)
            return

    def _pg_bundle_node(self, opts) -> Optional[NodeID]:
        pg_id = opts.placement_group.id
        pg = self.pgs.get(pg_id)
        if pg is None or pg.state != "CREATED":
            return None
        idx = opts.placement_group_bundle_index
        if idx < 0:
            idx = 0
        return pg.bundle_nodes[idx]

    def _publish_actor(self, record: ActorRecord):
        self._persist_actor(record)
        self._publish("actors", {"event": "state", "info": record.info()})

    async def _on_actor_worker_lost(self, record: ActorRecord, reason: str):
        if record.state == "DEAD":
            return
        if record.pending_kill or (record.max_restarts != -1
                                   and record.restarts_used >= record.max_restarts):
            record.state = "DEAD"
            record.death_cause = reason
            self._publish_actor(record)
            self._record_event("actor", "ERROR", f"actor dead: {reason}",
                               actor_id=record.actor_id.hex(),
                               class_name=record.class_name)
            return
        record.restarts_used += 1
        record.state = "RESTARTING"
        self._record_event("actor", "WARNING",
                           f"actor restarting ({reason})",
                           actor_id=record.actor_id.hex(),
                           restarts_used=record.restarts_used)
        record.address = ""
        record.node_id = None
        self._publish_actor(record)
        spawn(self._schedule_actor(record), what="actor scheduling")

    async def _rpc_GetActorInfo(self, req, conn):
        record = self.actors.get(ActorID(req["actor_id"]))
        return {"info": record.info() if record else None}

    async def _rpc_WaitActorReady(self, req, conn):
        actor_id = ActorID(req["actor_id"])
        deadline = time.monotonic() + req.get("timeout", 300.0)
        while time.monotonic() < deadline:
            record = self.actors.get(actor_id)
            if record is None:
                return {"info": None}
            if record.state in ("ALIVE", "DEAD"):
                return {"info": record.info()}
            await asyncio.sleep(0.05)
        return {"info": self.actors[actor_id].info() if actor_id in self.actors else None}

    async def _rpc_GetNamedActor(self, req, conn):
        key = (req.get("namespace", "default"), req["name"])
        actor_id = self.named_actors.get(key)
        if actor_id is None or self.actors[actor_id].state == "DEAD":
            return {"info": None}
        return {"info": self.actors[actor_id].info()}

    async def _rpc_ListActors(self, req, conn):
        return {"actors": [r.info() for r in self.actors.values()]}

    async def _rpc_KillActor(self, req, conn):
        record = self.actors.get(ActorID(req["actor_id"]))
        if record is None:
            return {"status": "not_found"}
        await self._kill_actor(record, req.get("no_restart", True), "ray_tpu.kill")
        return {"status": "ok"}

    async def _kill_actor(self, record: ActorRecord, no_restart: bool, reason: str):
        if no_restart:
            record.pending_kill = True
        address = record.address
        if record.state == "ALIVE" and record.node_id in self.node_clients and address:
            try:
                # best-effort: the raylet may already be dead (node loss not
                # yet detected) — fail FAST rather than burning the default
                # connect/presend retry budget per kill (a group shutdown
                # after node loss kills many actors back-to-back)
                await self.node_clients[record.node_id].call(
                    "KillWorker", wire.dumps({"worker_address": address}),
                    timeout=10.0, retries=0, connect_timeout=2.0,
                    presend_retries=0)
            except (RpcError, asyncio.TimeoutError, OSError) as e:
                logger.debug("KillWorker %s on %s failed (raylet likely "
                             "dead): %s", address, record.node_id.hex()[:8], e)
        if no_restart:
            record.state = "DEAD"
            record.death_cause = reason
            if (record.namespace, record.name) in self.named_actors:
                if self.named_actors[(record.namespace, record.name)] == record.actor_id:
                    del self.named_actors[(record.namespace, record.name)]
            self._publish_actor(record)
            self._record_event("actor", "INFO", f"actor killed: {reason}",
                               actor_id=record.actor_id.hex(),
                               class_name=record.class_name)

    async def _rpc_WorkerDied(self, req, conn):
        """Raylet tells us a worker process exited (reference: raylet→GCS
        worker failure report; owners learn via the `workers` channel)."""
        address = req["worker_address"]
        self._publish("workers", {"event": "died", "worker_address": address,
                                  "node_id": req.get("node_id")})
        reason = req.get("reason", "worker died")
        self._record_event(
            "worker", "ERROR" if "OOM" in reason else "WARNING",
            f"worker died: {reason}", worker_address=address,
            node_id=req.get("node_id"))
        for record in self.actors.values():
            if record.address == address and record.state == "ALIVE":
                await self._on_actor_worker_lost(record, reason)
        return {"status": "ok"}

    # ------------------------------------------------------------------
    # placement groups (2PC reserve/commit)
    # ------------------------------------------------------------------

    async def _rpc_CreatePlacementGroup(self, req, conn):
        spec: PlacementGroupSpec = req["spec"]
        pg = PGRecord(spec)
        self.pgs[spec.pg_id] = pg
        self._persist_pg(pg)
        spawn(self._schedule_pg(pg), what="placement-group scheduling")
        return {"status": "ok"}

    async def _rpc_WaitPlacementGroupReady(self, req, conn):
        pg = self.pgs.get(PlacementGroupID(req["pg_id"]))
        if pg is None:
            return {"status": "not_found"}
        try:
            await asyncio.wait_for(pg.ready_event.wait(), req.get("timeout", 300.0))
            return {"status": "ready" if pg.state == "CREATED" else pg.state,
                    "bundle_nodes": [n.hex() if n else "" for n in pg.bundle_nodes]}
        except asyncio.TimeoutError:
            return {"status": "timeout"}

    async def _rpc_GetPlacementGroup(self, req, conn):
        pg = self.pgs.get(PlacementGroupID(req["pg_id"]))
        if pg is None:
            return {"info": None}
        return {"info": {
            "pg_id": pg.spec.pg_id.hex(),
            "state": pg.state,
            "strategy": pg.spec.strategy,
            "name": pg.spec.name,
            "bundles": [dict(b.resources) for b in pg.spec.bundles],
            "bundle_nodes": [n.hex() if n else "" for n in pg.bundle_nodes],
        }}

    async def _rpc_RemovePlacementGroup(self, req, conn):
        pg = self.pgs.get(PlacementGroupID(req["pg_id"]))
        if pg is not None:
            await self._remove_pg(pg)
        return {"status": "ok"}

    async def _remove_pg(self, pg: PGRecord):
        pg.state = "REMOVED"
        self._persist_pg(pg)
        released: set = set()
        for idx, node_id in enumerate(pg.bundle_nodes):
            if node_id is None or node_id in released \
                    or node_id not in self.node_clients:
                continue
            released.add(node_id)  # one release per node, not per bundle
            info = self.nodes.get(node_id)
            if info is not None and not info.alive:
                continue  # dead node: nothing to release
            try:
                # one retry for LIVE nodes (a swallowed transient failure
                # would leak the bundle reservation until raylet restart);
                # dead raylets still fail fast via the 2s connect bound
                await self.node_clients[node_id].call("ReleasePGBundles", wire.dumps(
                    {"pg_id": pg.spec.pg_id.binary()}), timeout=10.0,
                    retries=1, connect_timeout=2.0, presend_retries=0)
            except (RpcError, asyncio.TimeoutError, OSError) as e:
                logger.debug("ReleasePGBundles pg=%s to %s failed: %s",
                             pg.spec.pg_id.hex()[:8], node_id.hex()[:8], e)
        pg.ready_event.set()

    def _plan_pg(self, pg: PGRecord) -> Optional[List[NodeID]]:
        """Assign each bundle a node per strategy, against a scratch view."""
        spec = pg.spec
        scratch: Dict[NodeID, Dict[str, float]] = {
            nid: dict(self.node_available.get(nid, {}))
            for nid, info in self.nodes.items() if info.alive
        }
        assignment: List[Optional[NodeID]] = [None] * len(spec.bundles)

        def fits(nid, bundle: Bundle):
            info = self.nodes[nid]
            if bundle.label_selector and not label_match(info.labels, bundle.label_selector):
                return False
            return resources_ge(scratch[nid], bundle.resources)

        order = sorted(scratch.keys(), key=lambda n: n.hex())
        if spec.strategy in ("PACK", "STRICT_PACK"):
            # try to land everything on one node first
            for nid in order:
                trial = dict(scratch[nid])
                ok = True
                for b in spec.bundles:
                    info = self.nodes[nid]
                    if (b.label_selector and not label_match(info.labels, b.label_selector)) \
                            or not resources_ge(trial, b.resources):
                        ok = False
                        break
                    for k, v in b.resources.items():
                        trial[k] = trial.get(k, 0.0) - v
                if ok:
                    return [nid] * len(spec.bundles)
            if spec.strategy == "STRICT_PACK":
                return None
        if spec.strategy == "STRICT_SPREAD":
            used: Set[NodeID] = set()
            for i, b in enumerate(spec.bundles):
                placed = False
                for nid in order:
                    if nid in used or not fits(nid, b):
                        continue
                    assignment[i] = nid
                    used.add(nid)
                    placed = True
                    break
                if not placed:
                    return None
            return assignment  # type: ignore[return-value]
        # PACK fallback / SPREAD: greedy, SPREAD rotates through nodes
        rotation = 0
        for i, b in enumerate(spec.bundles):
            placed = False
            candidates = order[rotation:] + order[:rotation] if spec.strategy == "SPREAD" else order
            for nid in candidates:
                if fits(nid, b):
                    assignment[i] = nid
                    for k, v in b.resources.items():
                        scratch[nid][k] = scratch[nid].get(k, 0.0) - v
                    placed = True
                    if spec.strategy == "SPREAD":
                        rotation = (order.index(nid) + 1) % len(order)
                    break
            if not placed:
                return None
        return assignment  # type: ignore[return-value]

    async def _schedule_pg(self, pg: PGRecord):
        """2PC: prepare (reserve) on every node, then commit; cancel on any
        failure (reference: gcs_placement_group_scheduler.h:115-118)."""
        while pg.state in ("PENDING", "RESCHEDULING"):
            plan = self._plan_pg(pg)
            if plan is None:
                # surface each bundle to the autoscaler (PACK/SPREAD gangs
                # scale up via ordinary shape demand; STRICT_SPREAD is also
                # exported whole so distinct-node needs are visible)
                for idx, b in enumerate(pg.spec.bundles):
                    self._record_demand(
                        b.resources, b.label_selector,
                        waiter_id=f"{pg.spec.pg_id.hex()}:{idx}")
                await asyncio.sleep(0.5)
                continue
            per_node: Dict[NodeID, List[int]] = {}
            for idx, nid in enumerate(plan):
                per_node.setdefault(nid, []).append(idx)
            prepared: List[NodeID] = []
            ok = True
            for nid, idxs in per_node.items():
                try:
                    reply = wire.loads(await self.node_clients[nid].call(
                        "PreparePGBundles", wire.dumps({
                            "pg_id": pg.spec.pg_id.binary(),
                            "bundles": {i: pg.spec.bundles[i].resources for i in idxs},
                        }), timeout=10.0))
                    if reply.get("status") != "ok":
                        ok = False
                        break
                    prepared.append(nid)
                except (RpcError, asyncio.TimeoutError, OSError):
                    ok = False
                    break
            if not ok:
                # release EVERY attempted node, not just acked ones: a
                # prepare that timed out may still have applied on the
                # raylet (releasing an unprepared pg is a no-op)
                for nid in per_node:
                    try:
                        await self.node_clients[nid].call("ReleasePGBundles", wire.dumps(
                            {"pg_id": pg.spec.pg_id.binary()}), timeout=10.0, retries=1)
                    except (RpcError, asyncio.TimeoutError, OSError) as e:
                        logger.debug("ReleasePGBundles pg=%s to %s failed: %s",
                                     pg.spec.pg_id.hex()[:8], nid.hex()[:8], e)
                await asyncio.sleep(0.3)
                continue
            for nid in per_node:
                try:
                    await self.node_clients[nid].call("CommitPGBundles", wire.dumps(
                        {"pg_id": pg.spec.pg_id.binary()}), timeout=10.0)
                except (RpcError, asyncio.TimeoutError, OSError) as e:
                    logger.debug("CommitPGBundles pg=%s to %s failed: %s",
                                 pg.spec.pg_id.hex()[:8], nid.hex()[:8], e)
            pg.bundle_nodes = list(plan)
            pg.state = "CREATED"
            self._persist_pg(pg)
            pg.ready_event.set()
            self._publish("pgs", {"event": "created", "pg_id": pg.spec.pg_id.hex()})
            return

    # ------------------------------------------------------------------
    # autoscaler support (reference: gcs_autoscaler_state_manager.cc)
    # ------------------------------------------------------------------

    def _record_demand(self, resources: Dict[str, float], selector: Dict[str, str],
                       waiter_id: str = ""):
        """Count DISTINCT waiters per shape (a task retrying PickNode every
        0.5s is one unit of demand, not one per retry)."""
        now = time.monotonic()
        key = (tuple(sorted(resources.items())), tuple(sorted(selector.items())))
        entry = self.pending_demands.get(key)
        if entry is None:
            entry = self.pending_demands[key] = {
                "shape": dict(resources), "selector": dict(selector),
                "waiters": {}, "last_ts": now}
        entry["waiters"][waiter_id or "_anon"] = now
        entry["last_ts"] = now
        self._prune_demands(now)

    def _prune_demands(self, now: float):
        ttl = RAY_CONFIG.autoscaler_demand_ttl_s
        for key in [k for k, v in self.pending_demands.items()
                    if now - v["last_ts"] > ttl]:
            del self.pending_demands[key]
        for v in self.pending_demands.values():
            stale = [w for w, ts in v["waiters"].items() if now - ts > ttl]
            for w in stale:
                del v["waiters"][w]

    def _node_used(self, node_id: NodeID) -> bool:
        """A node is in use if any resource is claimed OR any lease is held
        (zero-resource actors must not look idle to the autoscaler)."""
        info = self.nodes.get(node_id)
        if info is None:
            return False
        avail = self.node_available.get(node_id)
        if avail is None:
            return True  # no view yet: err on the busy side
        if any(avail.get(k, 0.0) < v - 1e-9
               for k, v in info.total_resources.items()):
            return True
        return self.node_num_leases.get(node_id, 0) > 0

    async def _rpc_GetClusterStatus(self, req, conn):
        """Everything the autoscaler reconciler needs in one poll: per-node
        resources + idle info and the unplaceable-demand shapes."""
        now = time.monotonic()
        self._prune_demands(now)
        nodes = []
        for nid, info in self.nodes.items():
            nodes.append({
                "node_id": nid.hex(),
                "alive": info.alive,
                "is_head": info.is_head,
                "labels": dict(info.labels),
                "total": dict(info.total_resources),
                "available": dict(self.node_available.get(nid, {})),
                "used": self._node_used(nid),
                "idle_s": now - self.node_last_used.get(nid, now),
            })
        demands = [
            {"shape": v["shape"], "selector": v["selector"],
             "count": min(len(v["waiters"]), 64)}
            for v in self.pending_demands.values() if v["waiters"]
        ]
        strict_spread = [
            [dict(b.resources) for b in pg.spec.bundles]
            for pg in self.pgs.values()
            if pg.state in ("PENDING", "RESCHEDULING")
            and pg.spec.strategy == "STRICT_SPREAD"
        ]
        return {"nodes": nodes, "demands": demands, "strict_spread": strict_spread}

    # ------------------------------------------------------------------
    # cluster health plane: metrics history + stuck/straggler monitor
    # ------------------------------------------------------------------

    async def _metrics_history_loop(self):
        """Sample the aggregated metric snapshots into the raw history
        ring every ``metrics_history_interval_s`` (the rollup tier fires
        from inside :meth:`MetricsHistory.sample`)."""
        interval = RAY_CONFIG.metrics_history_interval_s
        while True:
            await asyncio.sleep(interval)
            try:
                self.metrics_history.sample()
            except Exception:
                logger.exception("metrics-history sample failed")

    async def _rpc_GetMetricsHistory(self, req, conn):
        name = req.get("name")
        if not name:
            return {"names": self.metrics_history.names()}
        return {"history": self.metrics_history.series(
            name, window_s=req.get("window_s"),
            tier=req.get("tier") or "auto")}

    async def _ckpt_sweep_loop(self):
        """Cluster-side checkpoint retention (reference analog: the GCS
        owning GC instead of each driver): periodically sweep every
        checkpoint store whose KV stats mirror carries a ``sweep``
        policy. The filesystem/backend work runs off-loop in the default
        executor — a slow tier must not stall the control plane."""
        interval = RAY_CONFIG.ckpt_sweep_interval_s
        if not interval:
            return
        while True:
            await asyncio.sleep(interval)
            try:
                await self._ckpt_sweep()
            except Exception:
                logger.exception("ckpt retention sweep failed")

    async def _ckpt_sweep(self) -> list:
        """One cluster-wide retention pass over opted-in stores. Reports
        land in KV ns="ckpt_sweep" (state API / dashboard) and reap
        activity becomes ``ckpt_sweeper`` events."""
        entries = {}
        for (ns, key), blob in list(self.kv.items()):
            if ns != "ckpt":
                continue
            try:
                entries[key] = wire.loads(blob)
            except Exception:
                logger.debug("ckpt sweep: undecodable stats mirror for "
                             "store %r; skipping", key)
                continue
        if not entries:
            return []
        from ray_tpu_torch.ckpt.tier.sweeper import sweep_registered

        loop = asyncio.get_running_loop()
        reports = await loop.run_in_executor(None, sweep_registered, entries)
        for rep in reports:
            name = str(rep.get("name") or rep.get("root") or "?")
            blob = wire.dumps(rep)
            self.kv[("ckpt_sweep", name)] = blob
            self._persist_kv("ckpt_sweep", name, blob)
            if rep.get("error"):
                self._record_event(
                    "ckpt_sweeper", "WARNING",
                    f"retention sweep of store {name} failed: "
                    f"{rep['error']}", root=rep.get("root"))
            elif rep.get("dropped_manifests") or rep.get("dropped_bytes"):
                self._record_event(
                    "ckpt_sweeper", "INFO",
                    f"store {name}: reaped {rep['dropped_manifests']} "
                    f"manifests / {rep['dropped_bytes']} chunk bytes "
                    f"across tiers",
                    root=rep.get("root"), local=rep.get("local"),
                    remote=rep.get("remote"))
        return reports

    async def _rpc_CkptSweep(self, req, conn):
        """Force a cluster retention sweep now (tests, ``ray-tpu ckpt``)."""
        return {"reports": await self._ckpt_sweep()}

    async def _health_monitor_loop(self):
        interval = RAY_CONFIG.health_scan_interval_s
        while True:
            await asyncio.sleep(interval)
            try:
                await self._health_scan()
            except Exception:
                logger.exception("cluster health scan failed")

    async def _health_scan(self) -> dict:
        """One pass of the cluster health monitor: stuck tasks (RUNNING far
        past the per-function p99 of completed runs), straggler raylets
        (lease-queue / event-loop-lag outliers vs the cluster median, and
        lagging heartbeats), and provisioning-pool pathology (dead zygote,
        starved warm pool). The task scan runs on the task-event merge
        thread; findings surface via ``GetClusterHealth`` → ``/api/health``
        / ``util.state.cluster_health`` / ``ray-tpu health``, plus
        rate-limited warning logs."""
        now = time.time()
        cfg = RAY_CONFIG
        findings: List[dict] = []

        # -- stuck tasks ------------------------------------------------
        stuck_min = cfg.health_stuck_min_s
        stuck_factor = cfg.health_stuck_p99_factor
        stuck_fallback = cfg.health_stuck_fallback_s

        def _scan_stuck(tm) -> List[dict]:
            durations: Dict[str, List[float]] = {}
            running: List[Tuple[dict, float]] = []
            for rec in tm.list_tasks(limit=100_000):
                run_ts = next((e["ts"] for e in rec["events"]
                               if e["state"] == RUNNING), None)
                if run_ts is None:
                    continue
                if rec["state"] == "FINISHED":
                    durations.setdefault(rec["name"] or "?", []).append(
                        rec["end_ts"] - run_ts)
                elif rec["state"] == RUNNING:
                    running.append((rec, run_ts))
            out = []
            for rec, run_ts in running:
                fn = rec["name"] or "?"
                age = now - run_ts
                ds = sorted(durations.get(fn, ()))
                if ds:
                    p99 = ds[min(len(ds) - 1, int(0.99 * len(ds)))]
                    threshold = max(stuck_min, stuck_factor * p99)
                else:
                    p99 = None  # no completed sample yet: conservative
                    threshold = max(stuck_min, stuck_fallback)
                if age > threshold:
                    out.append({
                        "kind": "stuck_task", "severity": "warning",
                        "task_id": rec["task_id"], "name": fn,
                        "node": rec.get("node", ""),
                        "worker": rec.get("worker", ""),
                        "age_s": age, "threshold_s": threshold,
                        "p99_s": p99})
            return out

        findings.extend(await self.task_manager.read(_scan_stuck))

        # -- straggler raylets ------------------------------------------
        for metric, floor in (("ray_tpu_raylet_lease_queue_depth", 4.0),
                              ("ray_tpu_raylet_loop_lag_seconds", 0.2)):
            by_node = self.metrics_history.latest_by_node(metric)
            if len(by_node) < 2:
                continue
            vals = sorted(by_node.values())
            median = vals[len(vals) // 2]
            for node, v in by_node.items():
                if v > floor and v > cfg.health_straggler_factor * max(
                        median, 1e-9):
                    findings.append({
                        "kind": "straggler_node", "severity": "warning",
                        "node": node, "metric": metric, "value": v,
                        "cluster_median": median})
        timeout = RAY_CONFIG.health_check_timeout_ms / 1000.0
        mono = time.monotonic()
        for node_id, info in self.nodes.items():
            if not info.alive:
                continue
            lag = mono - self.node_last_seen.get(node_id, mono)
            if lag > timeout / 2:  # lagging but not yet declared dead
                findings.append({
                    "kind": "straggler_node", "severity": "warning",
                    "node": node_id.hex()[:16], "metric": "heartbeat_lag_s",
                    "value": lag, "cluster_median": 0.0})

        # -- provisioning pools -----------------------------------------
        for (ns, key), blob in list(self.kv.items()):
            if ns != "workers" or not blob:
                continue
            try:
                entry = wire.loads(blob)
            except Exception as e:
                logger.debug("undecodable workers entry %s: %s", key, e)
                continue
            pool = entry.get("pool") or {}
            node = str(entry.get("node", key))[:16]
            if pool.get("enabled") and not pool.get("zygote_alive"):
                findings.append({
                    "kind": "dead_zygote", "severity": "error",
                    "node": node,
                    "zygote_restarts": pool.get("zygote_restarts", 0)})
            elif (pool.get("warm_target", 0) > 0
                    and pool.get("warm_default_env", 0) == 0):
                findings.append({
                    "kind": "pool_starvation", "severity": "warning",
                    "node": node,
                    "warm_target": pool.get("warm_target", 0),
                    "misses": pool.get("misses", 0)})

        # -- serve SLOs -------------------------------------------------
        # the serve controller mirrors per-deployment autoscale state into
        # the ``serve`` KV namespace; deployments that registered SLO
        # targets get violation findings when the windowed rates breach
        for (ns, key), blob in list(self.kv.items()):
            if ns != "serve" or not blob:
                continue
            try:
                entry = wire.loads(blob)
            except Exception as e:
                logger.debug("undecodable serve entry %s: %s", key, e)
                continue
            slo = entry.get("slo") or {}
            rollup = entry.get("rollup") or {}
            dep = key.decode() if isinstance(key, bytes) else str(key)
            if entry.get("ts") and now - entry["ts"] > 60.0:
                continue  # stale mirror (controller gone): not a violation
            queue_target = slo.get("queue_target_s")
            queue_p99 = rollup.get("queue_p99_s")
            if (queue_target is not None and queue_p99 is not None
                    and queue_p99 > queue_target):
                findings.append({
                    "kind": "serve_slo_violation", "severity": "warning",
                    "deployment": dep, "metric": "queue_p99_s",
                    "value": queue_p99, "target": queue_target,
                    "replicas": entry.get("replicas"),
                    "replica_target": entry.get("target")})
            latency_budget = slo.get("latency_budget_s")
            exec_mean = rollup.get("execute_mean_s")
            if (latency_budget is not None and exec_mean is not None
                    and exec_mean > latency_budget):
                findings.append({
                    "kind": "serve_slo_violation", "severity": "warning",
                    "deployment": dep, "metric": "execute_mean_s",
                    "value": exec_mean, "target": latency_budget,
                    "replicas": entry.get("replicas"),
                    "replica_target": entry.get("target")})
            ttft_target = slo.get("ttft_target_s")
            ttft_p99 = rollup.get("ttft_p99_s")
            if (ttft_target is not None and ttft_p99 is not None
                    and ttft_p99 > ttft_target):
                findings.append({
                    "kind": "serve_slo_violation", "severity": "warning",
                    "deployment": dep, "metric": "ttft_p99_s",
                    "value": ttft_p99, "target": ttft_target,
                    "replicas": entry.get("replicas"),
                    "replica_target": entry.get("target")})

        # -- goodput ledger ---------------------------------------------
        # per-job wall-clock attribution pathologies: recompile storms,
        # input-bound steps, over-budget checkpoint pauses, and goodput
        # regression vs the job's own trailing window
        findings.extend(self.goodput_ledger.findings(now, cfg))

        status = "ok"
        if any(f["severity"] == "error" for f in findings):
            status = "error"
        elif findings:
            status = "warning"
        self._health = {
            "ts": now, "status": status, "findings": findings,
            "scan_count": self._health.get("scan_count", 0) + 1,
            "scan_interval_s": cfg.health_scan_interval_s,
            "nodes_alive": sum(1 for n in self.nodes.values() if n.alive),
        }
        # rate-limited warning logs + structured events (one per finding
        # identity per health_warn_interval_s, not one per scan)
        for f in findings:
            ident = (f["kind"], f.get("node", ""), f.get("task_id", ""),
                     f.get("deployment", ""), f.get("metric", ""),
                     f.get("job", ""))
            if now - self._health_warn_ts.get(ident, 0.0) \
                    < cfg.health_warn_interval_s:
                continue
            self._health_warn_ts[ident] = now
            detail = {k: v for k, v in f.items()
                      if k not in ("kind", "severity")}
            logger.warning("cluster health: %s %s", f["kind"], detail)
            self._record_event("health", f["severity"].upper(),
                               f"health finding: {f['kind']}", **detail)
        if len(self._health_warn_ts) > 10_000:  # bounded dedup memory
            cutoff = now - cfg.health_warn_interval_s
            self._health_warn_ts = {k: ts for k, ts
                                    in self._health_warn_ts.items()
                                    if ts >= cutoff}
        return self._health

    async def _rpc_GetClusterHealth(self, req, conn):
        if req.get("scan") or not self._health.get("scan_count"):
            await self._health_scan()
        return {"health": self._health}

    async def _rpc_GetGoodput(self, req, conn):
        """Per-job goodput ledgers (``/api/goodput`` /
        ``util.state.goodput()`` / ``ray-tpu goodput``)."""
        jobs = self.goodput_ledger.jobs()
        job = req.get("job")
        if job:
            jobs = {job: jobs[job]} if job in jobs else {}
        return {"jobs": jobs}

    # ------------------------------------------------------------------
    # debug / state api
    # ------------------------------------------------------------------

    async def _rpc_GetState(self, req, conn):
        return {
            "nodes": [n.to_dict() for n in self.nodes.values()],
            "actors": [r.info() for r in self.actors.values()],
            "jobs": list(self.jobs.values()),
            "num_objects_tracked": len(self.object_dir),
            "pgs": [
                {"pg_id": p.spec.pg_id.hex(), "state": p.state, "name": p.spec.name}
                for p in self.pgs.values()
            ],
            "uptime_s": time.time() - self.start_time,
        }


def main():
    from ray_tpu_torch._private.common import die_with_parent

    die_with_parent()

    import argparse

    from ray_tpu_torch._private.logs import setup_process_logging

    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--address-file", required=True)
    parser.add_argument("--log-dir", default="")
    parser.add_argument("--persist-dir", default="",
                        help="durable store directory enabling GCS fault tolerance")
    args = parser.parse_args()
    setup_process_logging("gcs", args.log_dir)

    async def run():
        gcs = GcsServer(args.host, args.port, persist_dir=args.persist_dir)
        addr = await gcs.start()
        tmp = args.address_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(addr)
        import os as _os

        _os.replace(tmp, args.address_file)
        await asyncio.Event().wait()

    asyncio.run(run())


if __name__ == "__main__":
    main()
