"""CoreWorker: the in-process runtime embedded in every driver and worker.

Reference: ``src/ray/core_worker`` — task submission with lease-then-push
(``task_submission/normal_task_submitter.cc:32``, lease reuse per scheduling
key), actor task submission with per-caller ordered queues
(``actor_task_submitter.cc``), task execution (``task_receiver.cc``), the
in-memory store for small results, the plasma provider for large ones, task
retries + lineage (``task_manager.cc``), and the gRPC service
(``HandlePushTask`` core_worker.cc:3360).

Round-1 deviations (documented; see SURVEY.md §7 hard parts):
- distributed refcounting is deferred: objects are freed explicitly or when
  the owning job exits (the store's LRU spill bounds memory meanwhile);
- object locations resolve via the GCS directory plus a direct owner fetch
  for small objects, rather than the reference's ownership directory.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import os
import pickle

from ray_tpu_torch._private import wire
import threading
import time
import traceback
import uuid
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private import task_events
from ray_tpu_torch._private.async_util import spawn
from ray_tpu_torch._private.common import ActorOptions, TaskOptions, TaskSpec
from ray_tpu_torch._private.config import RAY_CONFIG
from ray_tpu_torch._private.ids import ActorID, JobID, NodeID, ObjectID, TaskID, WorkerID
from ray_tpu_torch._private.object_store import SegmentCache, pack_blob, plan_layout, read_blob, write_blob, ShmSegment
from ray_tpu_torch._private.reference_counter import ReferenceCounter
from ray_tpu_torch._private.rpc import (
    RpcApplicationError,
    RpcError,
    RpcServer,
    RetryingRpcClient,
)
from ray_tpu_torch._private.serialization import deserialize, dumps, loads_trusted, serialize
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    ActorUnavailableError,
    GetTimeoutError,
    ObjectLostError,
    OutOfMemoryError,
    TaskError,
)
from ray_tpu_torch.object_ref import ObjectRef

logger = logging.getLogger("ray_tpu_torch.worker")

_LEASE_IDLE_S = 2.0

# cluster-unique metrics key tag (pids collide across nodes/restarts).
# Computed lazily AND per-pid: zygote-forked workers inherit this module
# already imported, so an import-time constant would make every forked
# worker publish to the same KV key, clobbering each other's metrics.
# Lock-guarded: the auto-flush loop and a manual publish_metrics() can race
# the first computation, and two tags for one process double-counts it.
_obs_proc_tag_cache: Optional[Tuple[int, str]] = None
_obs_proc_tag_lock = threading.Lock()


def _obs_proc_tag() -> str:
    global _obs_proc_tag_cache
    with _obs_proc_tag_lock:
        if _obs_proc_tag_cache is None \
                or _obs_proc_tag_cache[0] != os.getpid():
            _obs_proc_tag_cache = (os.getpid(), uuid.uuid4().hex[:10])
        return _obs_proc_tag_cache[1]

_LATENCY_BOUNDS = [0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 60.0]

_obs_instruments = None


def _obs():
    """Built-in always-on instruments (reference: the core worker's
    ray_task_* opencensus metrics in metric_defs.cc), created lazily so
    merely importing this module registers nothing."""
    global _obs_instruments
    if _obs_instruments is None:
        from ray_tpu_torch.util.metrics import Gauge, Histogram

        _obs_instruments = {
            "e2e": Histogram(
                "ray_tpu_task_e2e_seconds",
                "end-to-end task latency: submit to completion at the owner",
                boundaries=_LATENCY_BOUNDS, tag_keys=("function",)),
            "exec": Histogram(
                "ray_tpu_task_exec_seconds",
                "task execution latency on the worker",
                boundaries=_LATENCY_BOUNDS, tag_keys=("function",)),
            "loop_lag": Gauge(
                "ray_tpu_event_loop_lag_seconds",
                "io event-loop scheduling delay (sleep-drift sampled)"),
        }
    return _obs_instruments


def _task_span_id(spec: TaskSpec) -> str:
    """Deterministic execution-span id: the submitter never learns it, yet
    children submitted DURING execution and the span recorded AFTER it must
    agree on the id (retries get distinct spans per attempt)."""
    return f"{spec.task_id.hex()[:12]}a{spec.attempt}"


def _freeze(d: Dict[str, float]) -> tuple:
    return tuple(sorted(d.items()))


class _ActorView:
    """Owner-side view of one actor (reference: actor_task_submitter.cc)."""

    def __init__(self, actor_id: ActorID):
        self.actor_id = actor_id
        self.state = "PENDING_CREATION"
        self.address = ""
        self.seqno = 0
        self.client: Optional[RetryingRpcClient] = None
        self.state_changed = asyncio.Event()
        self.max_task_retries = 0
        self.death_cause = ""


class _LeasePool:
    """Per-scheduling-key task queue + worker lease pool (reference: the
    SchedulingKey queues in normal_task_submitter.cc — pipelined lease
    requests capped at max_pending_lease_requests, granted workers reused
    for queued tasks of the same shape, returned after an idle timeout).

    Throughput design for the asyncio tier: one *pusher* coroutine per
    granted lease pops queued task records and ships them in BATCHES over a
    single ``PushTaskBatch`` RPC, amortizing the per-call framing/event-loop
    overhead that otherwise dominates small-task throughput."""

    BATCH = 16  # base batch per push round trip (also the lease-count unit)
    BATCH_MAX = 128  # queue-depth-scaled ceiling (see _batch_cap)
    BATCH_MAX_BYTES = 1 << 20  # serialized-arg byte bound per push

    def __init__(self, core: "CoreWorker", key, opts, resources):
        from collections import deque

        self.core = core
        self.key = key
        self.opts = opts
        self.resources = resources
        self.pending = deque()  # task records awaiting a pusher
        self.pushers = 0
        self.active_leases = 0  # pushers currently holding a granted lease
        self.busy = 0  # pushers blocked inside a PushTaskBatch round trip
        self._work = asyncio.Event()  # set while pending is non-empty
        # owner-side lease cache: extra grants from a batched
        # RequestWorkerLease reply, consumed by sibling pushers without
        # another raylet round trip (dropped when the queue drains)
        self.spare_grants = deque()
        # grants currently being asked for by in-flight lease RPCs: without
        # this, N concurrent pushers each request the full batch for the
        # same queue and the raylet over-grants N-fold
        self.requesting = 0
        # EWMA of the push round trip, feeding the micro-batch hold-off
        # (see _pusher): long RTTs earn proportionally longer accumulation.
        # rtt_measured gates the short-task regime below: until a round
        # trip has actually completed, the pool could be running hour-long
        # tasks and must keep the conservative share division.
        self.rtt_ewma = 0.005
        self.rtt_measured = False
        # burst detector: consecutive submits with sub-300µs inter-arrival
        # (a `.remote()` loop runs at ~10µs-100µs/call; chains and trickle
        # traffic arrive at >= one push RTT apart and never trip this)
        self._burst_n = 0
        self._last_submit = 0.0

    def submit(self, record: dict):
        now = time.monotonic()
        if now - self._last_submit < 0.0003:
            self._burst_n += 1
        else:
            self._burst_n = 0
        self._last_submit = now
        self.pending.append(record)
        self._work.set()
        self._ensure_pushers()

    def _batch_cap(self) -> int:
        """Queue-depth-adaptive batch size (same spirit as plan_buckets:
        amortize per-item overhead into per-batch overhead up to a bound):
        deep backlogs earn bigger batches so a 20k-task burst pays ~1/128th
        of the per-push framing, while shallow queues keep small batches —
        one push can't hold the lease hostage. The byte bound is applied by
        the pusher while it pops (args ride the push payload)."""
        return min(self.BATCH_MAX, max(self.BATCH, len(self.pending) // 8))

    def _ensure_pushers(self):
        cap = RAY_CONFIG.max_pending_lease_requests
        # one AVAILABLE pusher per pending task up to the cap (reference:
        # pipelined lease requests in normal_task_submitter.cc) —
        # parallelism first; pushers blocked mid-push on a long task don't
        # count, or staggered long-task arrivals would serialize behind
        # them. Tiny tasks still batch because whichever pusher is granted
        # first drains a share of the queue per round trip.
        want = min(max(1, len(self.pending)), cap)
        while self.pushers - self.busy < want:
            self.pushers += 1
            spawn(self._pusher(), what="lease-pool pusher")

    async def _pusher(self):
        """Acquire one lease, then drain the queue in batches until idle."""
        try:
            try:
                lease = await self._do_request()
                if lease is None:
                    return  # queue drained by concurrent pushers
            except Exception as e:
                # a lease is unobtainable — and since busy nodes are waited
                # out (not errored), this means the shape stayed infeasible
                # for the whole window (or every raylet was unreachable).
                # If no sibling pusher holds a working lease, fail everything
                # queued NOW with the scheduling error; with a live lease the
                # failure is node-local (e.g. one raylet's stale PG view) and
                # the healthy pushers keep draining the queue.
                if self.active_leases == 0:
                    tb = traceback.format_exc()
                    while self.pending:
                        record = self.pending.popleft()
                        self.core._complete_error(record, TaskError(
                            f"scheduling failed for {record['name']}: {e}", tb))
                elif self.pending:
                    # a sibling lease survives, so queued tasks will drain
                    # onto it eventually — don't error them, but don't be
                    # silent either: the shape is currently unschedulable
                    # anywhere else (reference: infeasible-task warnings in
                    # cluster_task_manager.cc)
                    logger.warning(
                        "cannot acquire another lease for %s (%s); %d queued "
                        "task(s) remain behind %d existing lease(s)",
                        self.key, e, len(self.pending), self.active_leases)
                return
            idle_deadline = None
            self.active_leases += 1
            try:
                while True:
                    # divide the queue across ALL pushers (not just granted
                    # leases): soon-to-be-granted pushers must find work
                    # left, or long tasks serialize onto the first lease.
                    # On a saturated cluster this degrades to small batches,
                    # where push round trips are not the bottleneck anyway.
                    if len(self.pending) < self.BATCH and self._burst_n >= 4:
                        # Nagle-style micro-batching: the submit stream is
                        # BURSTING (consecutive sub-300µs inter-arrivals —
                        # a `.remote()` loop), so new arrivals can afford
                        # to accumulate for a fraction of the push round
                        # trip instead of paying a whole push per task.
                        # Chains and trickle traffic arrive >= one RTT
                        # apart, never trip the detector, and keep their
                        # first-push latency untouched.
                        deadline = time.monotonic() + min(
                            0.008, max(0.001, self.rtt_ewma / 4))
                        last = len(self.pending)
                        while last < self.BATCH \
                                and time.monotonic() < deadline:
                            await asyncio.sleep(0.001)
                            if len(self.pending) == last:
                                break  # burst ended; stop paying latency
                            last = len(self.pending)
                        # fall through: an empty queue parks below as usual
                    share = -(-len(self.pending) // max(1, self.pushers))
                    if self.rtt_measured and self.rtt_ewma < 0.1:
                        # short-task regime (sub-100ms push round trips):
                        # batch aggressively instead of dividing the queue
                        # across every live pusher — under a burst dozens
                        # of pushers are mid-flight, the share pins at 1-2
                        # and per-push framing dominates the owner loop.
                        # Long-task pools keep the share division so
                        # staggered arrivals don't serialize onto one
                        # lease (there the round trip IS the task).
                        share = len(self.pending)
                    take = max(1, min(self._batch_cap(), share))
                    batch = []
                    nbytes = 0
                    while self.pending and len(batch) < take:
                        r = self.pending.popleft()
                        batch.append(r)
                        nbytes += r.get("bytes", 0)
                        if nbytes >= self.BATCH_MAX_BYTES:
                            break
                    if not batch:
                        self._work.clear()
                        if self.pending:  # a submit raced the clear
                            continue
                        if idle_deadline is None:
                            idle_deadline = time.monotonic() + _LEASE_IDLE_S
                        remaining = idle_deadline - time.monotonic()
                        if remaining <= 0:
                            await self.core._drop_lease(lease)
                            return
                        try:
                            await asyncio.wait_for(self._work.wait(), remaining)
                        except asyncio.TimeoutError:
                            pass
                        continue
                    idle_deadline = None
                    self.busy += 1
                    try:
                        ok = await self._push_batch(lease, batch)
                    except Exception as e:
                        # a non-RPC failure (encoding bug, cancelled loop):
                        # deterministic, so retrying would loop — fail the
                        # batch loudly instead of stranding its futures
                        tb = traceback.format_exc()
                        for record in batch:
                            self.core._complete_error(record, TaskError(
                                f"task submission failed for "
                                f"{record['name']}: {e}", tb))
                        await self.core._drop_lease(lease)
                        return
                    finally:
                        self.busy -= 1
                    if not ok:
                        await self.core._drop_lease(lease)
                        return
            finally:
                self.active_leases -= 1
        finally:
            self.pushers -= 1
            if self.pending:
                self._work.set()
                self._ensure_pushers()
            elif self.pushers == 0:
                self._drop_spares()

    def _drop_spares(self):
        """Return cached-but-unused grants to their raylets (the queue
        drained before any pusher needed them)."""
        while self.spare_grants:
            spawn(self.core._drop_lease(self.spare_grants.popleft()),
                  what="spare-lease return")

    def _desired_count(self) -> int:
        """How many leases this request should ask for in one round trip:
        enough pushers to drain the queue a batch each, minus grants
        already held, cached, or being requested by sibling pushers,
        capped by the raylet's multi-grant bound."""
        want = -(-len(self.pending) // self.BATCH)
        want = min(want, RAY_CONFIG.max_pending_lease_requests)
        have = self.active_leases + len(self.spare_grants) + self.requesting
        return max(1, min(RAY_CONFIG.lease_max_grants, want - have))

    def _stash_extras(self, reply: dict, raylet_address: str):
        for g in reply.get("extra_grants") or ():
            self.spare_grants.append({
                "key": self.key, "lease_id": g["lease_id"],
                "worker_address": g["worker_address"],
                "raylet_address": raylet_address,
                "last_used": time.monotonic()})
        if self.spare_grants and self.pending:
            self._ensure_pushers()

    async def _push_batch(self, lease: dict, batch: List[dict]) -> bool:
        """Ship a batch to the leased worker. Returns False if the lease
        died (records are retried/failed individually)."""
        from ray_tpu_torch.exceptions import TaskCancelledError

        core = self.core
        batch = [r for r in batch if not self._drop_if_cancelled(r)]
        if not batch:
            return True
        events_on = task_events.enabled()
        for record in batch:
            record["epoch"] = record.get("epoch", -1) + 1
            record["spec"].attempt = record["epoch"]
            record["_pushed_to"] = lease["worker_address"]
            if events_on:
                task_events.record(
                    record["spec"].task_id.hex(), task_events.SCHEDULED,
                    attempt=record["epoch"],
                    worker=lease["worker_address"],
                    job_id=record.get("_job_hex", ""))
        # template-aware framing: records from the submit warm path carry a
        # preserialized spec template blob — ship each distinct template
        # ONCE per batch plus (task_id, args, attempt) triples, instead of
        # re-encoding every full spec (options, selectors, runtime env)
        templates: List[bytes] = []
        tmpl_index: Dict[int, int] = {}
        items: List[tuple] = []
        for r in batch:
            tmpl = r.get("_tmpl")
            if tmpl is None:
                items.append(("s", r["spec"]))
            else:
                ix = tmpl_index.get(id(tmpl))
                if ix is None:
                    ix = tmpl_index[id(tmpl)] = len(templates)
                    templates.append(tmpl)
                spec = r["spec"]
                items.append(("t", ix, spec.task_id, spec.args_blob,
                              spec.attempt))
        payload = wire.dumps({"templates": templates, "items": items})
        stats = core._submit_stats
        stats["push_batches"] += 1
        stats["push_tasks"] += len(batch)
        push_t0 = time.perf_counter()
        try:
            reply = wire.loads(await core._worker_client(
                lease["worker_address"]).call(
                    "PushTaskBatch", payload, timeout=86400.0, retries=0))
        except (RpcError, asyncio.TimeoutError, OSError) as e:
            stats["push_s"] += time.perf_counter() - push_t0
            # requeue retriable records FIRST: the OOM probe below can take
            # seconds against a dead raylet and is only needed when some
            # record is about to surface a terminal error
            exhausted = []
            for record in batch:
                if record.get("_cancelled"):
                    # force-cancel kills the worker: deliver the
                    # cancellation, never a retry
                    core._complete_error(record, TaskCancelledError())
                    continue
                record["attempts"] += 1
                if record["attempts"] > record["max_retries"]:
                    exhausted.append(record)
                else:
                    logger.warning("retrying task %s (attempt %d): %s",
                                   record["name"], record["attempts"], e)
                    task_events.record(
                        record["spec"].task_id.hex(), task_events.RETRYING,
                        attempt=record["attempts"], error=f"worker died: {e}",
                        job_id=record.get("_job_hex", ""))
                    self._reset_stream_for_retry(record)
                    self.pending.append(record)
            if exhausted:
                oom = await self._was_oom(lease)
                for record in exhausted:
                    if oom:
                        core._complete_error(record, OutOfMemoryError(
                            f"worker running {record['name']} was killed by "
                            f"the node memory monitor (after "
                            f"{record['attempts']} attempts)", ""))
                    else:
                        core._complete_error(record, TaskError(
                            f"worker died running {record['name']} "
                            f"(after {record['attempts']} attempts): {e}", ""))
            return False
        rtt = time.perf_counter() - push_t0
        stats["push_s"] += rtt
        self.rtt_ewma = 0.8 * self.rtt_ewma + 0.2 * rtt
        self.rtt_measured = True
        for record, res in zip(batch, reply["results"]):
            if res["status"] == "ok":
                core._process_reply_refs(res, lease["worker_address"])
                core._complete_ok(record, res["results"],
                                  stream_count=res.get("stream_count"))
            else:
                err: TaskError = loads_trusted(res["error"])
                opts = record["spec"].options
                from ray_tpu_torch.exceptions import StrayInterrupt

                stray = isinstance(getattr(err, "cause", None), StrayInterrupt)
                if (opts.retry_exceptions or stray) \
                        and not isinstance(err, TaskCancelledError) \
                        and record["attempts"] < record["max_retries"]:
                    record["attempts"] += 1
                    task_events.record(
                        record["spec"].task_id.hex(), task_events.RETRYING,
                        attempt=record["attempts"], error=str(err),
                        job_id=record.get("_job_hex", ""))
                    self._reset_stream_for_retry(record)
                    self.pending.append(record)
                else:
                    core._complete_error(record, err)
        return True

    def _reset_stream_for_retry(self, record: dict):
        """A retried streaming task replays from index 0 under a new
        attempt: unconsumed indices must wait for the retry's values
        instead of serving a dead attempt's partial output."""
        if record["spec"].num_returns != -1:
            return
        st = self.core._streams.get(record["spec"].task_id.binary())
        if st is not None:
            st["produced"] = 0

    def _drop_if_cancelled(self, record: dict) -> bool:
        if not record.get("_cancelled"):
            return False
        from ray_tpu_torch.exceptions import TaskCancelledError

        self.core._complete_error(record, TaskCancelledError())
        return True

    async def _was_oom(self, lease: dict) -> bool:
        """After a push failure, ask the granting raylet whether the memory
        monitor killed the worker (surfaces OutOfMemoryError to the user)."""
        try:
            reply = wire.loads(await self.core._raylet_client(
                lease["raylet_address"]).call(
                    "WasWorkerOOM", wire.dumps(
                        {"worker_address": lease["worker_address"]}),
                    timeout=5.0, retries=0))
            return bool(reply.get("oom"))
        except (RpcError, asyncio.TimeoutError, OSError):
            return False

    async def _do_request(self) -> Optional[dict]:
        """Acquire one lease. Busy nodes are waited out for as long as the
        shape stays feasible-by-totals (the reference queues leases at the
        raylet, cluster_lease_manager.cc — a saturated cluster must queue,
        not error); only a shape no node can EVER satisfy (PickNode exhausts
        infeasible_task_timeout_s) or a cluster-wide unreachability raises.

        Two-level fast path (reference: lease_policy.cc + raylet
        spillback): plain leases go straight to the LOCAL raylet, which
        grants or redirects via its synced resource view — no GCS round
        trip. PG- and strategy-pinned leases, and the infeasible fallback
        (which records autoscaler demand), resolve through GCS PickNode."""
        if self.spare_grants:
            # owner-side lease cache: a sibling's batched request already
            # granted a worker for this key — adopt it, zero round trips
            return self.spare_grants.popleft()
        opts, resources = self.opts, self.resources
        req = {
            "resources": resources,
            "label_selector": opts.label_selector,
            "job_id": self.core.job_id,
            "pg": opts.placement_group.id.binary() if opts.placement_group else None,
            "bundle_index": opts.placement_group_bundle_index,
            "runtime_env": opts.runtime_env,
        }
        if opts.placement_group is None and opts.scheduling_strategy is None:
            start_addr = None
            if self.pending:
                # locality-aware lease targeting: start the chain at the
                # raylet holding the most argument bytes, so the task runs
                # next to its data instead of pulling it (reference:
                # lease_policy.cc). Spillback tie-breaks on the same map.
                loc, start_addr = await self.core._arg_locality(
                    self.pending[0])
                if loc:
                    req = dict(req, locality=loc)
            out = await self._request_two_level(req, start_addr)
            if out != "fallback":
                return out  # a lease, or None (queue drained: stand down)
            # cluster-wide infeasible / local raylet gone: fall through to
            # the GCS path, which records demand (autoscaler) and waits
            # out the infeasible window
        node = await self.core._pick_node(opts, resources)
        if node is None:
            raise RuntimeError(f"no feasible node for resources={resources} "
                               f"selector={opts.label_selector}")
        raylet = self.core._raylet_client(node["address"])
        unreachable_deadline = None
        infeasible_since = None
        busy_delay = 0.1
        while True:
            if not self.pending:
                # the queue drained while we were acquiring (other pushers
                # served it): stand down instead of spinning and emitting
                # phantom autoscaler demand for work that no longer exists
                return None
            try:
                req["count"] = n = self._desired_count()
                self.requesting += n
                try:
                    reply = wire.loads(await raylet.call(
                        "RequestWorkerLease", wire.dumps(req),
                        timeout=RAY_CONFIG.worker_start_timeout_s + 30,
                        connect_timeout=5.0, retries=1))
                finally:
                    self.requesting -= n
            except (RpcError, asyncio.TimeoutError, OSError) as e:
                # raylet unreachable (node died between pick and lease):
                # re-pick a node until the GCS view catches up
                if unreachable_deadline is None:
                    unreachable_deadline = (
                        time.monotonic() + RAY_CONFIG.worker_start_timeout_s * 4)
                if time.monotonic() > unreachable_deadline:
                    raise RuntimeError(f"lease request kept failing: {e}")
                await asyncio.sleep(0.5)
                node2 = await self.core._pick_node(opts, resources)
                if node2 is not None:
                    node = node2
                    raylet = self.core._raylet_client(node["address"])
                continue
            unreachable_deadline = None
            if reply["status"] == "runtime_env_failed":
                raise RuntimeError(
                    f"runtime_env setup failed: {reply.get('error', '')}")
            if reply["status"] == "granted":
                self._stash_extras(reply, node["address"])
                return {"key": self.key, "lease_id": reply["lease_id"],
                        "worker_address": reply["worker_address"],
                        "raylet_address": node["address"],
                        "last_used": time.monotonic()}
            if reply["status"] == "pg_removed":
                # the raylet has no live reserve for this group. Confirm
                # against GCS truth before failing: a stale raylet view
                # (restart, mid-reschedule) must retry bounded like
                # "infeasible", while a genuine removal fails queued tasks
                # now (reference: tasks routed to a removed PG error, they
                # never reroute to node capacity)
                pg_info = None
                try:
                    pg_info = (await self.core._gcs_call(
                        "GetPlacementGroup",
                        {"pg_id": req["pg"]}))["info"]
                except (RpcError, asyncio.TimeoutError, OSError) as e:
                    logger.debug("GetPlacementGroup(%s) failed; treating "
                                 "PG as gone: %s", req["pg"], e)
                if pg_info is None or pg_info.get("state") == "REMOVED":
                    raise RuntimeError(
                        "placement group was removed; queued tasks against "
                        "its bundles cannot be scheduled")
                if infeasible_since is None:
                    infeasible_since = time.monotonic()
                elif time.monotonic() - infeasible_since > \
                        RAY_CONFIG.infeasible_task_timeout_s:
                    raise RuntimeError(
                        "raylet persistently reports no reserve for a live "
                        "placement group (stale bundle view?)")
                # re-pick: a reschedule may have moved the bundle
                node2 = await self.core._pick_node(opts, resources)
                if node2 is not None:
                    node = node2
                    raylet = self.core._raylet_client(node["address"])
                await asyncio.sleep(busy_delay)
                busy_delay = min(busy_delay * 1.5, 2.0)
                continue
            if reply["status"] == "infeasible":
                # the raylet's totals reject a shape the GCS view accepts
                # (e.g. stale PG bundle after a raylet restart): bounded —
                # a permanent disagreement must error, not loop forever
                if infeasible_since is None:
                    infeasible_since = time.monotonic()
                elif time.monotonic() - infeasible_since > \
                        RAY_CONFIG.infeasible_task_timeout_s:
                    raise RuntimeError(
                        f"raylet reports resources={resources} infeasible")
            else:
                infeasible_since = None
            if reply["status"] in ("busy", "infeasible", "infeasible_cluster"):
                # re-pick; a transient None (PG/affinity nodes briefly
                # absent from the GCS view) keeps the current raylet —
                # persistent disagreement is bounded by infeasible_since.
                # Backoff: saturation can last hours; 16 pushers polling at
                # 10 Hz each would hammer the GCS for nothing (the raylet
                # lease call itself already parks ~worker_start_timeout_s)
                node2 = await self.core._pick_node(opts, resources)
                if node2 is not None and node2["address"] != node["address"]:
                    node = node2
                    raylet = self.core._raylet_client(node["address"])
                await asyncio.sleep(busy_delay)
                busy_delay = min(busy_delay * 1.5, 2.0)
            else:
                busy_delay = 0.1

    async def _request_two_level(self, base_req: dict,
                                 start_addr: Optional[str] = None):
        """Lease via the local raylet + spillback chain (reference:
        normal_task_submitter going to the lease policy's raylet, raylet
        spillback at cluster_lease_manager.cc:421). Returns a lease dict,
        None when the queue drained (stand down), or "fallback" when the
        cluster has no feasible node / the local raylet is unreachable —
        the caller then uses the GCS path, which records autoscaler demand."""
        core = self.core
        addr = start_addr or core.raylet_address
        req = dict(base_req, allow_spillback=True)
        max_hops = RAY_CONFIG.lease_spillback_max_hops
        hops = 0
        unreachable = 0
        busy_delay = 0.1
        while True:
            if not self.pending:
                return None
            if self.spare_grants:
                return self.spare_grants.popleft()
            try:
                req["count"] = n = self._desired_count()
                self.requesting += n
                try:
                    reply = wire.loads(await core._raylet_client(addr).call(
                        "RequestWorkerLease", wire.dumps(req),
                        timeout=RAY_CONFIG.worker_start_timeout_s + 30,
                        connect_timeout=5.0, retries=1))
                finally:
                    self.requesting -= n
            except (RpcError, asyncio.TimeoutError, OSError):
                unreachable += 1
                if addr != core.raylet_address:
                    # the spill target died mid-chain: restart locally
                    addr = core.raylet_address
                    hops = 0
                    continue
                if unreachable >= 6:
                    return "fallback"  # local raylet gone: let GCS decide
                await asyncio.sleep(0.5)
                continue
            unreachable = 0
            status = reply["status"]
            if status == "runtime_env_failed":
                raise RuntimeError(
                    f"runtime_env setup failed: {reply.get('error', '')}")
            if status == "granted":
                self._stash_extras(reply, addr)
                return {"key": self.key, "lease_id": reply["lease_id"],
                        "worker_address": reply["worker_address"],
                        "raylet_address": addr,
                        "last_used": time.monotonic()}
            if status == "spillback":
                hops += 1
                addr = reply["retry_at"]
                if hops >= max_hops:
                    # stop chasing: park at the hop-limit raylet (its local
                    # queue serves us when capacity frees)
                    req["allow_spillback"] = False
                continue
            if status == "busy":
                # parked a full window without a grant: views may have
                # changed — re-enable spillback and keep queueing
                hops = 0
                req["allow_spillback"] = True
                await asyncio.sleep(busy_delay)
                busy_delay = min(busy_delay * 1.5, 2.0)
                continue
            # "infeasible" / "infeasible_cluster" / unknown
            return "fallback"


class CoreWorker:
    """One instance per process; drives all cluster interaction."""

    mode = "cluster"

    def __init__(
        self,
        gcs_address: str,
        raylet_address: Optional[str],
        node_id: Optional[NodeID],
        is_driver: bool,
        namespace: str = "default",
        loop: Optional[asyncio.AbstractEventLoop] = None,
        session_dir: str = "",
    ):
        self.gcs_address = gcs_address
        self.raylet_address = raylet_address
        # owner-resident object directory (locations of objects this
        # worker owns, fed by raylet seal announcements)
        self._obj_locations: Dict[bytes, dict] = {}
        self.node_id = node_id
        self.is_driver = is_driver
        self.namespace = namespace
        self.worker_id = WorkerID.from_random()
        self.session_dir = session_dir
        self.job_id: JobID = JobID.nil()
        self._owned_loop = loop is None
        self.loop = loop or asyncio.new_event_loop()
        self._loop_thread: Optional[threading.Thread] = None
        self.server: Optional[RpcServer] = None
        self.address = ""
        self.gcs: Optional[RetryingRpcClient] = None
        self.raylet: Optional[RetryingRpcClient] = None
        self._raylet_clients: Dict[str, RetryingRpcClient] = {}
        self._worker_clients: Dict[str, RetryingRpcClient] = {}
        # owner state
        self.memory_store: Dict[ObjectID, Any] = {}
        self._result_futures: Dict[ObjectID, asyncio.Future] = {}
        # return ids whose producing task is in flight but whose result
        # future has not been demanded yet: futures are allocated lazily on
        # the first get/await (submit only marks pendency — a dict insert)
        self._pending_returns: Dict[ObjectID, bool] = {}
        self._in_store: Dict[ObjectID, bool] = {}
        self._tasks: Dict[TaskID, dict] = {}  # lineage / retry records
        self._actor_inflight: Dict[TaskID, dict] = {}  # for cancel()
        self._lineage_bytes = 0
        # ownership refcounting (reference: reference_counter.h:44)
        self.ref_counter = ReferenceCounter(lambda: self.address)
        self._free_pending: set = set()
        # batched zero-ref intake: __del__-side ref drops append here (a
        # GIL-atomic deque op) and the 0.2s refcount sweep drains it —
        # replacing a per-object call_soon_threadsafe self-pipe write,
        # which at 20k frees/s was a visible slice of the io loop
        from collections import deque as _fdeque

        self._free_zero_q: "Any" = _fdeque()
        self._free_grace_q: "Any" = _fdeque()  # (deadline, oid) FIFO
        # owner-initiated borrow tracking (reference: WaitForRefRemoved in
        # reference_counter.cc): per borrower address, {oid: generation}
        # being watched by a long-poll loop — the generation fences stale
        # done-replies against concurrent re-registrations
        self._borrow_watch_sets: Dict[str, Dict[bytes, int]] = {}
        self._borrow_watch_active: set = set()
        self._lease_cache: Dict[tuple, List[dict]] = {}
        self._renv_prepared: Dict[str, dict] = {}
        self.job_runtime_env: Optional[dict] = None
        self._actors: Dict[ActorID, _ActorView] = {}
        self._actor_name_cache: Dict[ActorID, tuple] = {}
        self._pushed_functions: set = set()
        self._fn_key_cache: Dict[int, tuple] = {}
        # submit fast path (reference: the owner hot loop in
        # normal_task_submitter.cc): per-RemoteFunction cache of the
        # preserialized TaskSpec template (everything invariant across
        # `.remote()` calls of one function+options pair), the resolved
        # function key / prepared options, and the lease pool — so a warm
        # submit fills only task_id + args instead of re-framing the whole
        # spec through wire.dumps. Keyed by id() WITH a strong ref (slot 0)
        # so a recycled id can never alias a different function.
        self._spec_template_cache: Dict[int, tuple] = {}
        # per-submit cost accounting (drives the STRESS_r* µs breakdown and
        # the fast-path regression tests); plain counters, no locks — all
        # writers hold the GIL per op and precision loss is acceptable
        self._submit_stats: Dict[str, float] = {
            "count": 0, "serialize_s": 0.0, "events_s": 0.0,
            "kickoff_s": 0.0, "push_s": 0.0, "push_tasks": 0,
            "push_batches": 0, "spec_frames": 0, "kickoff_wakeups": 0,
            "fast_path": 0, "pack_pool_hits": 0, "pack_pool_misses": 0,
            "wait_vector_polls": 0, "result_future_batches": 0,
            "result_futures_batched": 0}
        self._put_index = 0
        self._spread_hint = 0
        self.segments = SegmentCache()
        # executor state
        self._fn_cache: Dict[str, Any] = {}
        # cancellation: running task_id -> executing thread ident, plus
        # cancels that arrived before their task started, plus every tid a
        # cancel was requested for (stray async-exc detection)
        self._running_tasks: Dict[bytes, int] = {}
        self._running_async_tasks: Dict[bytes, asyncio.Task] = {}
        self._cancelled_pending: set = set()
        self._cancel_requested: set = set()
        # streaming generators: task_id -> {produced, total, error, event}
        # (reference: task_manager.cc dynamic return handling)
        self._streams: Dict[bytes, dict] = {}
        # cross-host channel mailboxes (reader-hosted; reference:
        # experimental_mutable_object_provider.cc cross-node channel legs):
        # name -> {"q": deque, "data": Event, "space": Event, "cap": int}
        self._chan_mail: Dict[str, dict] = {}
        self._chan_closed: set = set()  # torn-down mailboxes drop pushes
        self.actor_instance = None
        self.actor_id: Optional[ActorID] = None
        # device-object transport (reference: per-actor GPUObjectStore):
        # values produced by tensor_transport-marked methods stay here
        self.device_store: Dict[bytes, Any] = {}
        self._device_fetch_cache: Dict[bytes, Any] = {}
        # this process's pulls from holders: count, blob bytes, seconds
        self.device_pull_stats = {"pulls": 0, "bytes": 0, "seconds": 0.0}
        self._actor_async = False
        self._exec_pool = None
        self._exec_lock = threading.Lock()
        # submit-side kickoff batching: one loop wakeup per BURST of
        # .remote() calls, not one per call (call_soon_threadsafe writes
        # the loop's self-pipe — ~50us each on a small host)
        from collections import deque as _deque

        self._kickoff_q: "Any" = _deque()
        self._kickoff_scheduled = False
        self._order_buf: Dict[str, dict] = {}
        self._tls = threading.local()
        self._shutdown = False
        self.node_hex = node_id.hex() if node_id else ""

    # ------------------------------------------------------------------
    # loop plumbing
    # ------------------------------------------------------------------

    def _queue_kickoff(self, fn):
        """Enqueue a submit-side continuation; ONE loop wakeup per burst of
        `.remote()` calls (call_soon_threadsafe writes the loop's self-pipe,
        ~50us each on a small host — per-task it would dominate the submit
        hot loop)."""
        self._kickoff_q.append(fn)
        if not self._kickoff_scheduled:
            self._kickoff_scheduled = True
            self._submit_stats["kickoff_wakeups"] += 1
            self.loop.call_soon_threadsafe(self._drain_kickoffs)

    def _drain_kickoffs(self):
        """Drain the whole queue, THEN clear the scheduled flag: submits
        landing mid-drain ride this drain instead of paying another
        self-pipe write. The post-clear recheck closes the race where a
        producer appended between our empty pop and the flag clear (it saw
        the flag still set and skipped its wakeup)."""
        while True:
            try:
                fn = self._kickoff_q.popleft()
            except IndexError:
                # raylint: disable=RCE001 benign-race flag protocol: the post-clear recheck below closes the lost-wakeup window (see docstring); a lock here would put the submit hot loop behind the drain
                self._kickoff_scheduled = False
                if self._kickoff_q:
                    self._kickoff_scheduled = True
                    self.loop.call_soon(self._drain_kickoffs)
                return
            try:
                fn()
            except Exception:
                logger.exception("task kickoff failed")

    def _return_pending(self, oid: ObjectID) -> bool:
        """Is a locally-owned task still producing this return id?"""
        if oid in self._pending_returns:
            return True
        fut = self._result_futures.get(oid)
        return fut is not None and not fut.done()

    def _ensure_result_future(self, oid: ObjectID):
        """Result future on demand (loop thread only): submit marks
        pendency in ``_pending_returns`` — a dict insert — and the FIRST
        get/await allocates the future. Tasks whose results are consumed
        via wait/stream/store paths never pay the per-submit allocation."""
        fut = self._result_futures.get(oid)
        if fut is None and oid in self._pending_returns:
            fut = self._result_futures[oid] = self.loop.create_future()
        return fut

    def _ensure_result_futures(self, oids: set) -> int:
        """Batched ``_ensure_result_future`` (loop thread only): ONE
        C-level set intersection against the pending-return index finds
        every ref whose future is demanded but unallocated, then one pass
        allocates them — the first wait()/get() poll over a k-ref window
        stops paying k separate dict-probe chains. Returns the number of
        futures created."""
        want = self._pending_returns.keys() & oids
        created = 0
        for oid in want:
            if oid not in self._result_futures:
                self._result_futures[oid] = self.loop.create_future()
                created += 1
        if created:
            # raylint: disable=RCE001 plain diagnostic counters, deliberately unlocked (see _submit_stats init): each += is one dict-slot RMW under the GIL and a lost increment only skews a stat
            self._submit_stats["result_future_batches"] += 1
            self._submit_stats["result_futures_batched"] += created
        return created

    def _start_loop(self):
        if self._loop_thread is not None or not self._owned_loop:
            return
        self._loop_thread = threading.Thread(
            target=self.loop.run_forever, name="ray_tpu_torch-io", daemon=True
        )
        self._loop_thread.start()

    def _run(self, coro, timeout=None):
        """Run a coroutine on the io loop from any user thread."""
        if threading.current_thread() is self._loop_thread:
            raise RuntimeError("blocking call on the io loop")
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        return fut.result(timeout)

    # ------------------------------------------------------------------
    # connect
    # ------------------------------------------------------------------

    def connect(self):
        self._start_loop()
        self._run(self._connect())
        if RAY_CONFIG.distributed_refcounting:
            from ray_tpu_torch import object_ref as object_ref_mod

            self.ref_counter.on_owned_zero = self._on_owned_zero
            self.ref_counter.on_borrow_first = self._on_borrow_first
            object_ref_mod.set_ref_counter(self.ref_counter)
            # periodic drain of the __del__-safe deletion queue (refs dropped
            # while the process is otherwise idle must still free)
            self._sweep_fut = asyncio.run_coroutine_threadsafe(
                self._refcount_sweep(), self.loop)
        # always-on observability: task-event flush + periodic metrics
        # publish + loop-lag sampling (reference: the core worker's
        # task_event_buffer flush timer + metrics agent push)
        self._obs_fut = asyncio.run_coroutine_threadsafe(
            self._obs_flush_loop(), self.loop)
        return self

    async def _obs_flush_loop(self):
        """Ship buffered task lifecycle events every
        ``task_events_flush_interval_s`` and auto-publish this process's
        metrics registry every ``metrics_flush_interval_s`` (replacing the
        manual ``publish_metrics()``). The sleep's drift doubles as the
        event-loop lag sample."""
        interval = RAY_CONFIG.task_events_flush_interval_s
        metrics_every = RAY_CONFIG.metrics_flush_interval_s
        last_metrics = 0.0
        while not self._shutdown:
            before = time.monotonic()
            await asyncio.sleep(interval)
            lag = max(0.0, time.monotonic() - before - interval)
            try:
                _obs()["loop_lag"].set(lag)
                events, dropped = task_events.drain()
                if events or dropped:
                    try:
                        await self._gcs_call("AddTaskEvents", {
                            "events": events, "dropped": dropped})
                    except (RpcError, asyncio.TimeoutError, OSError) as e:
                        task_events.rebuffer(events, dropped)
                        logger.debug("task-event flush failed "
                                     "(will retry): %s", e)
                now = time.monotonic()
                if now - last_metrics >= metrics_every:
                    last_metrics = now
                    await self._publish_metrics()
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.debug("observability flush iteration failed",
                             exc_info=True)

    async def _publish_metrics(self):
        """Push this process's metrics registry to the GCS KV (metrics
        namespace); the dashboard's /metrics aggregates all processes.
        The goodput ledger rides the same cadence into ns="goodput" (and
        the flush itself is billed to the ledger's overhead bucket)."""
        from ray_tpu_torch.util import goodput
        from ray_tpu_torch.util.metrics import scrape_metrics

        t0 = time.perf_counter()
        # the ledger flush first: flush_payload() mirrors the derived
        # gauges onto the registry, so the scrape below carries them
        gp = goodput.flush_payload(node=self.node_hex)
        if gp is not None:
            try:
                await self._gcs_call("KVPut", {
                    "ns": "goodput", "key": f"proc_{_obs_proc_tag()}",
                    "value": wire.dumps(gp)})
            except (RpcError, asyncio.TimeoutError, OSError) as e:
                logger.debug("goodput publish failed (will retry): %s", e)
        snap = scrape_metrics()
        if snap:
            payload = {"pid": os.getpid(), "time": time.time(),
                       "node": self.node_hex, "metrics": snap}
            try:
                await self._gcs_call("KVPut", {
                    "ns": "metrics", "key": f"proc_{_obs_proc_tag()}",
                    "value": wire.dumps(payload)})
            except (RpcError, asyncio.TimeoutError, OSError) as e:
                logger.debug("metrics publish failed (will retry): %s", e)
        if gp is not None:
            # observability's own cost, attributed only while a ledger is
            # active (an idle util proc should not anchor one just for
            # its flush loop)
            goodput.add("overhead", time.perf_counter() - t0)

    async def _refcount_sweep(self):
        last_reassert = time.monotonic()
        while not self._shutdown:
            try:
                self.ref_counter.flush_deletes()
                while self._free_zero_q:
                    self._schedule_free(self._free_zero_q.popleft())
                now = time.monotonic()
                while self._free_grace_q and self._free_grace_q[0][0] <= now:
                    _, oid = self._free_grace_q.popleft()
                    spawn(self._free_owned(oid), what="owned-object free")
                if time.monotonic() - last_reassert > 30.0:
                    last_reassert = time.monotonic()
                    # fire-and-track: an unreachable owner (10s timeout
                    # each) must not stall the 0.2s flush cadence
                    spawn(self._reassert_borrows(), what="borrow re-assert")
            except Exception:
                logger.exception("refcount sweep failed")
            await asyncio.sleep(0.2)

    async def _reassert_borrows(self):
        """Periodically re-register still-held foreign borrows with their
        owners (bulk, idempotent): heals an owner that wrongly reclaimed a
        live borrower after a transient partition."""
        by_owner: Dict[str, list] = {}
        for oid, owner in self.ref_counter.borrowed_held():
            by_owner.setdefault(owner, []).append(oid)

        async def _one(owner, oids):
            try:
                await self._worker_client(owner).call(
                    "AddBorrowers", wire.dumps(
                        {"oids": oids, "address": self.address}),
                    timeout=10.0, retries=1)
            except (RpcError, asyncio.TimeoutError, OSError) as e:
                # next sweep retries; the owner may simply be gone
                logger.debug("AddBorrowers to %s failed: %s", owner, e)

        # concurrent: one slow/dead owner must not delay re-asserts to the
        # reachable ones while their death-timeout clocks run
        await asyncio.gather(*[_one(o, oids) for o, oids in by_owner.items()])

    async def _connect(self):
        self.server = RpcServer(self._handle_rpc)
        self.address = await self.server.start()
        self.gcs = RetryingRpcClient(
            self.gcs_address, on_push=self._on_push, on_reconnect=self._on_gcs_reconnect
        )
        if self.is_driver:
            reply = wire.loads(await self.gcs.call("RegisterDriver", wire.dumps({
                "address": self.address,
                "namespace": self.namespace,
                "entrypoint": " ".join(os.sys.argv[:2]),
            })))
            self.job_id = JobID(reply["job_id"])
        channels = ["actors"]
        if self.is_driver and getattr(self, "log_to_driver", False):
            channels.append("logs")
        await self.gcs.call("Subscribe", wire.dumps({"channels": channels}))
        if self.raylet_address:
            self.raylet = RetryingRpcClient(self.raylet_address)
        else:
            # pick the head node's raylet as our local raylet
            nodes = wire.loads(await self.gcs.call("GetAllNodes", b""))["nodes"]
            head = next((n for n in nodes if n["is_head"]), nodes[0] if nodes else None)
            if head is None:
                raise RuntimeError("no raylets registered with the GCS")
            self.raylet_address = head["address"]
            self.node_hex = head["node_id"]
            self.raylet = RetryingRpcClient(self.raylet_address)

    async def _on_gcs_reconnect(self, client):
        try:
            channels = ["actors"]
            if self.is_driver and getattr(self, "log_to_driver", False):
                channels.append("logs")
            await client.call("Subscribe", wire.dumps({"channels": channels}))
        except Exception:
            logger.warning("GCS reconnect: re-subscribe failed", exc_info=True)
        if self.is_driver and not self.job_id.is_nil():
            # re-bind this connection to our job after a GCS restart so
            # driver-disconnect cleanup still fires (GCS FT)
            for _ in range(3):
                try:
                    await client.call("ReattachDriver", wire.dumps(
                        {"job_id": self.job_id.binary()}))
                    break
                except Exception:
                    logger.warning("GCS reconnect: ReattachDriver failed",
                                   exc_info=True)
                    await asyncio.sleep(0.2)

    def _on_push(self, channel: str, payload: bytes):
        msg = wire.loads(payload)
        if channel == "logs":
            import sys as _sys

            node = msg.get("node", "?")
            for line in msg.get("lines", []):
                print(f"\x1b[2m({node})\x1b[0m {line}", file=_sys.stderr)
            return
        if channel == "actors":
            info = msg.get("info", {})
            aid = ActorID.from_hex(info["actor_id"])
            view = self._actors.get(aid)
            if view is not None:
                if info["address"] != view.address:
                    view.seqno = 0  # new incarnation
                view.state = info["state"]
                view.address = info["address"]
                view.death_cause = info.get("death_cause", "")
                view.client = None
                ev, view.state_changed = view.state_changed, asyncio.Event()
                ev.set()

    # ------------------------------------------------------------------
    # clients
    # ------------------------------------------------------------------

    def _raylet_client(self, address: str) -> RetryingRpcClient:
        if address == self.raylet_address:
            return self.raylet
        c = self._raylet_clients.get(address)
        if c is None:
            c = RetryingRpcClient(address)
            self._raylet_clients[address] = c
        return c

    def _worker_client(self, address: str) -> RetryingRpcClient:
        c = self._worker_clients.get(address)
        if c is None:
            c = RetryingRpcClient(address)
            self._worker_clients[address] = c
        return c

    async def _gcs_call(self, method: str, req: dict, timeout=None) -> dict:
        return wire.loads(await self.gcs.call(method, wire.dumps(req), timeout=timeout))

    # ------------------------------------------------------------------
    # function / class table
    # ------------------------------------------------------------------

    async def _prepare_runtime_env(self, renv):
        """Normalize + upload runtime-env packages once (driver side;
        reference: runtime_env/working_dir.py upload + uri_cache.py)."""
        import json as _json

        from ray_tpu_torch._private import runtime_env as renv_mod

        if renv is None:
            renv = getattr(self, "job_runtime_env", None)
        renv = renv_mod.normalize(renv)
        if not renv:
            return None
        cache_key = _json.dumps(renv, sort_keys=True)
        cached = self._renv_prepared.get(cache_key)
        if cached is not None:
            return cached
        out = dict(renv)

        async def upload(path):
            if isinstance(path, dict):  # already a KV reference
                return path
            sha, blob, base = renv_mod.package_dir(path)
            key = f"pkg:{sha}"
            reply = await self._gcs_call("KVGet", {"ns": "renv", "key": key})
            if reply["value"] is None:
                await self._gcs_call("KVPut", {"ns": "renv", "key": key,
                                               "value": blob})
            return {"kv_key": key, "sha": sha, "base": base}

        if "working_dir" in out:
            out["working_dir"] = await upload(out["working_dir"])
        if "py_modules" in out:
            out["py_modules"] = [await upload(p) for p in out["py_modules"]]
        self._renv_prepared[cache_key] = out
        return out

    async def _push_function(self, obj) -> str:
        cached = self._fn_key_cache.get(id(obj))
        if cached is not None and cached[0] is obj:
            return cached[1]
        blob = dumps(obj)
        key = hashlib.sha1(blob).hexdigest()
        if key not in self._pushed_functions:
            await self._gcs_call("KVPut", {"ns": "fn", "key": key, "value": blob,
                                           "overwrite": False})
            self._pushed_functions.add(key)
        # keyed by identity WITH a strong ref so a recycled id can't alias
        self._fn_key_cache[id(obj)] = (obj, key)
        return key

    async def _fetch_function(self, key: str):
        fn = self._fn_cache.get(key)
        if fn is None:
            reply = await self._gcs_call("KVGet", {"ns": "fn", "key": key})
            if reply["value"] is None:
                raise RuntimeError(f"function {key} not found in GCS")
            fn = loads_trusted(reply["value"])
            self._fn_cache[key] = fn
        return fn

    # ------------------------------------------------------------------
    # objects: put / get / wait
    # ------------------------------------------------------------------

    def _next_put_id(self) -> ObjectID:
        self._put_index += 1
        base = TaskID(self.worker_id.binary()[: TaskID.SIZE - 4] + self.job_id.binary())
        return ObjectID.from_put(base, self._put_index % 0x7FFF)

    def put(self, value: Any) -> ObjectRef:
        oid = self._next_put_id()
        self._run(self._put_value(oid, value))
        return ObjectRef(oid, self.address)

    async def _put_value(self, oid: ObjectID, value: Any):
        from ray_tpu_torch.object_ref import collect_serialized_refs

        with collect_serialized_refs() as inner:
            inband, buffers = serialize(value)
        total = len(inband) + sum(b.nbytes for b in buffers)
        if total < RAY_CONFIG.object_inline_max_bytes:
            self.memory_store[oid] = value
            return
        await self._store_blob(oid, inband, buffers)
        self._in_store[oid] = True
        # a stored blob holds refs only as bytes: pin them for its lifetime
        self.ref_counter.pin_nested(oid.binary(), inner)

    async def _store_blob(self, oid: ObjectID, inband: bytes, buffers,
                          attempt: int = 0, owner: str = ""):
        total, offsets = plan_layout(inband, buffers)
        reply = wire.loads(await self.raylet.call("StoreCreate", wire.dumps(
            {"oid": oid.binary(), "size": total, "attempt": attempt,
             "owner": owner or self.address})))
        if reply["status"] in ("exists", "stale_attempt"):
            # seal-once: the id is already (or about to be) bound to a value
            # for this or a newer execution epoch; this writer stands down
            return
        if reply["status"] != "ok":
            raise ObjectLostError(f"object store rejected {oid.hex()}: {reply}")
        if "arena_name" in reply:
            # native arena backend: write into the shared arena at the offset
            seg = self.segments.open(reply["arena_name"])
            off = reply["offset"]
            region = memoryview(seg.buf)[off : off + total]
            write_blob(region, inband, buffers, offsets)
        else:
            seg = ShmSegment(reply["shm_name"])
            try:
                write_blob(seg.buf, inband, buffers, offsets)
            finally:
                seg.close()
        await self.raylet.call("StoreSeal", wire.dumps(
            {"oid": oid.binary(), "attempt": attempt}))

    async def _read_local_store(self, oid: ObjectID, timeout: float, pull=True,
                                prio: int = 0, owner: str = ""):
        reply = wire.loads(await self.raylet.call("StoreGet", wire.dumps(
            {"oid": oid.binary(), "timeout": timeout, "pull": pull,
             "prio": prio, "owner": owner}),
            timeout=timeout + 10.0))
        status = reply["status"]
        if status == "inline":
            inband, buffers = read_blob(reply["blob"])
            return True, deserialize(inband, buffers)
        if status == "shm":
            seg = self.segments.open(reply["shm_name"])
            inband, buffers = read_blob(seg.buf)
            return True, deserialize(inband, buffers)
        if status == "shm_arena":
            seg = self.segments.open(reply["arena_name"])
            off, size = reply["offset"], reply["size"]
            region = memoryview(seg.buf)[off : off + size]
            inband, buffers = read_blob(region)
            return True, deserialize(inband, buffers)
        return False, None

    async def _get_one(self, ref: ObjectRef, deadline: float,
                       prio: int = 0) -> Any:
        oid = ref.id
        lost_hint = False
        while True:
            # 1. local memory store (own small results)
            if oid in self.memory_store:
                return self.memory_store[oid]
            # 2. a pending local task will produce it
            fut = self._ensure_result_future(oid)
            if fut is not None and not fut.done():
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    raise GetTimeoutError(f"timed out waiting for {oid.hex()}")
                try:
                    await asyncio.wait_for(asyncio.shield(fut), timeout)
                except asyncio.TimeoutError:
                    raise GetTimeoutError(f"timed out waiting for {oid.hex()}")
                continue
            # 3. known to live in the distributed store
            if self._in_store.get(oid):
                ok, value = await self._read_local_store(
                    oid, max(0.1, deadline - time.monotonic()), prio=prio,
                    owner=ref.owner_address())
                if ok:
                    return value
                # lost from the store (e.g. the holding node died):
                # reconstruct from lineage by re-executing the producer
                self._in_store.pop(oid, None)
                if await self._recover_object(oid):
                    continue
                raise ObjectLostError(f"object {oid.hex()} lost from store "
                                      f"and not reconstructable")
            # 4. remote owner fetch (small objects / long-poll for pending)
            owner = ref.owner_address()
            if owner and owner != self.address:
                value, in_store = await self._fetch_from_owner(
                    ref, deadline, lost=lost_hint)
                lost_hint = False
                if in_store:
                    ok, value = await self._read_local_store(
                        oid, max(0.1, deadline - time.monotonic()), prio=prio,
                        owner=ref.owner_address())
                    if ok:
                        return value
                    # tell the owner on the next round so it can verify and
                    # trigger lineage reconstruction
                    lost_hint = True
                    continue
                return value
            # 5. last resort: the store via directory pull
            ok, value = await self._read_local_store(
                oid, max(0.1, min(deadline - time.monotonic(), 5.0)),
                prio=prio, owner=ref.owner_address())
            if ok:
                return value
            if time.monotonic() > deadline:
                raise GetTimeoutError(f"timed out resolving {oid.hex()}")

    async def _fetch_from_owner(self, ref: ObjectRef, deadline: float,
                                lost: bool = False):
        client = self._worker_client(ref.owner_address())
        while True:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                raise GetTimeoutError(f"timed out fetching {ref.hex()} from owner")
            try:
                reply = wire.loads(await client.call("GetOwnedObject", wire.dumps(
                    {"oid": ref.binary(), "timeout": min(timeout, 10.0),
                     "lost": lost}),
                    timeout=min(timeout, 10.0) + 5.0, retries=1))
                lost = False
            except (RpcError, asyncio.TimeoutError) as e:
                raise ObjectLostError(
                    f"owner {ref.owner_address()} of {ref.hex()} unreachable: {e}")
            status = reply["status"]
            if status == "value":
                inband, buffers = read_blob(reply["blob"])
                value = deserialize(inband, buffers)
                if isinstance(value, TaskError):
                    raise value
                return value, False
            if status == "in_store":
                return None, True
            if status == "error":
                raise loads_trusted(reply["error"])
            # pending: loop

    async def _maybe_pull_device(self, value, deadline):
        """Resolve a DeviceObjectMarker by pulling from the holder worker
        (the held value itself when this worker IS the holder). Reference:
        gpu_object_manager orchestrating p2p pulls between actors. The
        pull is host-mediated: the holder serializes the value as the
        object plane would (a CUDA tensor copied to the host) and it
        arrives here as a CPU tensor."""
        from ray_tpu_torch.experimental.device_objects import DeviceObjectMarker

        if not isinstance(value, DeviceObjectMarker):
            return value
        if value.address == self.address:
            if value.oid in self.device_store:
                return self.device_store[value.oid]
            raise ObjectLostError(
                f"device object {value.oid.hex()[:12]} was freed")
        cached = self._device_fetch_cache.get(value.oid)
        if cached is not None:
            return cached
        timeout = max(1.0, min(deadline - time.monotonic(), 300.0))
        t0 = time.perf_counter()
        try:
            reply = wire.loads(await self._worker_client(value.address).call(
                "GetDeviceObject", wire.dumps({"oid": value.oid}),
                timeout=timeout, retries=1, connect_timeout=5.0))
        except (RpcError, asyncio.TimeoutError) as e:
            raise ObjectLostError(
                f"holder {value.address} of device object "
                f"{value.oid.hex()[:12]} unreachable: {e}")
        if reply["status"] != "ok":
            self._device_fetch_cache.pop(value.oid, None)
            raise ObjectLostError(
                f"device object {value.oid.hex()[:12]} gone from holder "
                f"{value.address} (freed or actor restarted)")
        inband, buffers = read_blob(reply["blob"])
        fetched = deserialize(inband, buffers)
        stats = self.device_pull_stats
        stats["pulls"] += 1
        stats["bytes"] += len(reply["blob"])
        stats["seconds"] += time.perf_counter() - t0
        if len(self._device_fetch_cache) > 32:
            self._device_fetch_cache.pop(next(iter(self._device_fetch_cache)))
        self._device_fetch_cache[value.oid] = fetched
        return fetched

    def get(self, refs, timeout: Optional[float] = None):
        single = isinstance(refs, ObjectRef)
        if single:
            refs = [refs]
        deadline = time.monotonic() + (timeout if timeout is not None else 86400.0)

        async def _get_all():
            # batched lazy-future setup up front: one pass instead of one
            # _ensure_result_future probe chain per ref inside _get_one
            self._ensure_result_futures({r.id for r in refs})
            out = []
            for ref in refs:
                value = await self._get_one(ref, deadline)
                if isinstance(value, TaskError):
                    raise value
                out.append(await self._maybe_pull_device(value, deadline))
            return out

        values = self._run(_get_all())
        return values[0] if single else values

    def wait(self, refs, num_returns=1, timeout=None, fetch_local=True):
        """Event-driven wait (reference: raylet/wait_manager.h): locally-
        owned pending refs ride their result futures; store-resident refs
        ride ONE StoreWaitAny long-poll at the raylet (which hooks the
        store's seal events) — no per-ref per-tick RPC fan-out."""

        async def _wait():
            deadline = time.monotonic() + (timeout if timeout is not None
                                           else 86400.0)
            oid_set = {r.id for r in refs}
            while True:
                # vectorized ready partition: one pair of C-level set
                # intersections against the store indexes per poll instead
                # of two dict probes per ref per tick (visible on 1000-ref
                # wait windows). _in_store values are only ever True, so
                # key membership IS store-residency.
                ready_now = self.memory_store.keys() & oid_set
                ready_now |= self._in_store.keys() & oid_set
                self._submit_stats["wait_vector_polls"] += 1
                # batched lazy-future setup: allocate every still-pending
                # ref's result future in one pass (first poll does all the
                # work; later polls find the intersection empty)
                self._ensure_result_futures(oid_set - ready_now)
                ready, fut_pending, store_pending = [], [], []
                for r in refs:
                    oid = r.id
                    if oid in ready_now:
                        ready.append(r)
                        continue
                    fut = self._result_futures.get(oid)
                    if fut is None:
                        store_pending.append(r)
                    elif fut.done():
                        ready.append(r)
                    else:
                        fut_pending.append(fut)
                if len(ready) >= num_returns or time.monotonic() >= deadline:
                    ready = ready[:num_returns]
                    # identity filter: ready elements ARE elements of refs,
                    # so id() membership avoids the O(n*m) ObjectRef __eq__
                    # scan (visible on 1000-ref wait windows)
                    ready_ids = {id(r) for r in ready}
                    return ready, [r for r in refs if id(r) not in ready_ids]
                chunk = max(0.05, min(10.0, deadline - time.monotonic()))
                waiters = []
                if fut_pending:
                    waiters.append(asyncio.ensure_future(asyncio.wait(
                        fut_pending, return_when=asyncio.FIRST_COMPLETED)))
                if store_pending:
                    waiters.append(asyncio.ensure_future(self.raylet.call(
                        "StoreWaitAny", wire.dumps({
                            "oids": [r.binary() for r in store_pending],
                            "num_needed": 1, "timeout": chunk}),
                        timeout=chunk + 10.0, retries=0)))
                if not waiters:
                    await asyncio.sleep(0.01)
                    continue
                done, pend = await asyncio.wait(
                    waiters, return_when=asyncio.FIRST_COMPLETED,
                    timeout=chunk)
                for t in pend:
                    t.cancel()
                failed = False
                for t in done:
                    # retrieve exceptions (a StoreWaitAny to a restarting
                    # raylet fails) — unretrieved task errors spam logs
                    if not t.cancelled() and t.exception() is not None:
                        failed = True
                if failed:
                    await asyncio.sleep(0.2)  # backoff, don't churn RPCs

        return self._run(_wait())

    def as_future(self, ref):
        import concurrent.futures

        out: "concurrent.futures.Future" = concurrent.futures.Future()

        def _done(task):
            try:
                value = task.result()
                if isinstance(value, TaskError):
                    out.set_exception(value)
                else:
                    out.set_result(value)
            except Exception as e:
                out.set_exception(e)

        def _schedule():
            t = asyncio.ensure_future(self.await_ref(ref))
            t.add_done_callback(_done)

        self.loop.call_soon_threadsafe(_schedule)
        return out

    async def await_ref(self, ref):
        deadline = time.monotonic() + 86400.0
        value = await self._get_one(ref, deadline)
        if isinstance(value, TaskError):
            raise value
        return await self._maybe_pull_device(value, deadline)

    def free_objects(self, refs: List[ObjectRef]):
        async def _free():
            oids = []
            freed_in_store = []
            for r in refs:
                # a marker in the memory store points at a device-held value:
                # release that too, or it would be orphaned forever
                await self._maybe_free_device_marker(self.memory_store.get(r.id))
                self.memory_store.pop(r.id, None)
                if self._in_store.pop(r.id, None):
                    freed_in_store.append(r.binary())
                self.ref_counter.release_nested(r.binary())
                oids.append(r.binary())
            for ob in oids:
                self._obj_locations.pop(ob, None)
            if freed_in_store:
                try:
                    await self._gcs_call("ObjectFree", {"oids": freed_in_store})
                except (RpcError, asyncio.TimeoutError, OSError) as e:
                    logger.debug("ObjectFree(%d oids) to GCS failed: %s",
                                 len(freed_in_store), e)
            await self.raylet.call("StoreDelete", wire.dumps({"oids": oids}))

        self._run(_free())

    # ------------------------------------------------------------------
    # ownership refcounting + lineage (reference: reference_counter.cc,
    # task_manager.cc, object_recovery_manager.cc)
    # ------------------------------------------------------------------

    def _on_owned_zero(self, oid: bytes):
        """All local refs/pins/borrowers of an owned object released.
        Batched: the oid rides a plain deque the refcount sweep drains on
        its next 0.2s tick — no per-object loop wakeup (the grace delay
        below dwarfs the added sweep latency anyway)."""
        if self._shutdown:
            return
        self._free_zero_q.append(oid)

    def _schedule_free(self, oid: bytes):
        """Queue an owned object for freeing after the grace window (loop
        thread only). One FIFO + the sweep loop replace a per-object
        call_later timer: deadlines are appended in monotonic order, so
        the sweep pops due entries from the left."""
        if not RAY_CONFIG.distributed_refcounting or oid in self._free_pending:
            return
        self._free_pending.add(oid)
        # grace delay absorbs in-flight AddBorrower registrations
        self._free_grace_q.append(
            (time.monotonic() + RAY_CONFIG.free_grace_s, oid))

    async def _free_owned(self, oid_bytes: bytes):
        self._free_pending.discard(oid_bytes)
        rc = self.ref_counter
        if not rc.freeable(oid_bytes):
            return
        oid = ObjectID(oid_bytes)
        if self._return_pending(oid):
            return  # production in flight; completion re-checks
        is_put = bool(oid.return_index() & 0x8000)
        if rc.lineage_count(oid_bytes) > 0 and is_put:
            # a retained downstream task's args need this value and a put
            # cannot be reconstructed: keep it until the lineage releases
            return
        value = self.memory_store.pop(oid, None)
        await self._maybe_free_device_marker(value)
        self._result_futures.pop(oid, None)
        self._pending_returns.pop(oid, None)
        in_store = self._in_store.pop(oid, None)
        rc.release_nested(oid_bytes)
        self._obj_locations.pop(oid_bytes, None)
        if in_store:
            try:
                await self._gcs_call("ObjectFree", {"oids": [oid_bytes]})
            except (RpcError, asyncio.TimeoutError, OSError) as e:
                logger.debug("ObjectFree(%s) to GCS failed: %s",
                             oid_bytes.hex()[:8], e)
        if rc.lineage_count(oid_bytes) == 0:
            rc.drop(oid_bytes)
        self._maybe_drop_record(oid.task_id())

    async def _maybe_free_device_marker(self, value):
        """A marker's last reference is gone: release the value it points
        at, here or on its holder."""
        from ray_tpu_torch.experimental.device_objects import DeviceObjectMarker

        if not isinstance(value, DeviceObjectMarker):
            return
        self._device_fetch_cache.pop(value.oid, None)
        if value.address == self.address:
            self.device_store.pop(value.oid, None)
        else:
            try:
                await self._worker_client(value.address).call(
                    "FreeDeviceObject", wire.dumps({"oid": value.oid}),
                    timeout=10.0, retries=1)
            except (RpcError, asyncio.TimeoutError, OSError) as e:
                logger.debug("FreeDeviceObject to %s failed: %s",
                             value.address, e)

    def _on_borrow_first(self, oid: bytes, owner: str):
        """First local handle to a foreign-owned object: register as a
        borrower with the owner (debounced to skip transient handles)."""
        if self._shutdown or not owner:
            return

        def _later():
            self.loop.call_later(
                RAY_CONFIG.borrow_debounce_s,
                lambda: spawn(self._register_borrow(oid, owner),
                              what="borrow registration"))

        try:
            self.loop.call_soon_threadsafe(_later)
        except RuntimeError:  # raylint: disable=EXC001 loop already closed during shutdown; borrow is moot
            pass

    async def _register_borrow(self, oid: bytes, owner: str):
        """Tell the owner we hold a borrow. Retries until acked (never a
        silent drop — a lost registration means the owner frees an object a
        live borrower still needs); removal is owner-initiated via the
        WaitBorrowsDone watch, so there is no add/remove ordering race."""
        rc = self.ref_counter
        delay = 0.1
        for _ in range(8):
            if rc.held_count(oid) <= 0 or self._shutdown:
                return
            try:
                await self._worker_client(owner).call("AddBorrower", wire.dumps(
                    {"oid": oid, "address": self.address}),
                    timeout=10.0, retries=1)
                return
            except (RpcError, asyncio.TimeoutError, OSError):
                await asyncio.sleep(delay)
                delay = min(delay * 2, 5.0)
        logger.warning("borrow registration for %s with owner %s kept "
                       "failing; object may be freed under us",
                       ObjectID(oid).hex()[:12], owner)

    # -- owner side: borrow lifetime watches (reference: WaitForRefRemoved,
    # reference_counter.cc — the owner subscribes to each borrower and drops
    # the borrow when the borrower reports release OR becomes unreachable) --

    def _watch_borrower(self, oid: bytes, addr: str):
        if not addr or addr == self.address or self._shutdown:
            return
        watch = self._borrow_watch_sets.setdefault(addr, {})
        watch[oid] = watch.get(oid, 0) + 1  # new registration generation
        if addr not in self._borrow_watch_active:
            self._borrow_watch_active.add(addr)
            spawn(self._borrow_watch_loop(addr), what="borrow watch loop")

    async def _borrow_watch_loop(self, addr: str):
        """One long-poll loop per borrower address covering all its borrowed
        oids; a dead borrower (sustained unreachability, ~1 min of strikes)
        releases everything. Borrowers also periodically re-assert held
        borrows (_reassert_borrows), so a wrongly-reclaimed live borrower
        re-registers unless the object was already freed in the gap."""
        failing_since = None
        delay = 1.0
        try:
            while not self._shutdown:
                snap = dict(self._borrow_watch_sets.get(addr, {}))
                if not snap:
                    return
                try:
                    reply = wire.loads(await self._worker_client(addr).call(
                        "WaitBorrowsDone",
                        wire.dumps({"oids": list(snap)}),
                        timeout=40.0, retries=0, connect_timeout=5.0))
                    failing_since = None
                    delay = 1.0
                    done = reply["done"]
                except RpcApplicationError:
                    # the borrower REPLIED (it is alive) — a handler error
                    # is not a death signal; keep watching
                    await asyncio.sleep(1.0)
                    continue
                except (RpcError, asyncio.TimeoutError, OSError):
                    now = time.monotonic()
                    if failing_since is None:
                        failing_since = now
                    if now - failing_since < RAY_CONFIG.borrower_death_timeout_s:
                        await asyncio.sleep(delay)
                        delay = min(delay * 2, 10.0)
                        continue
                    done = list(snap)  # borrower dead: reclaim its borrows
                watch = self._borrow_watch_sets.get(addr, {})
                for oid in done:
                    if watch.get(oid) != snap.get(oid):
                        continue  # re-registered while the probe was out
                    watch.pop(oid, None)
                    self.ref_counter.remove_borrower(oid, addr)
        finally:
            self._borrow_watch_active.discard(addr)
            rest = self._borrow_watch_sets.get(addr)
            if not rest:
                self._borrow_watch_sets.pop(addr, None)
            elif not self._shutdown:
                # respawn covers exceptions / adds that raced the exit;
                # re-assert the existing generation rather than minting one
                self._borrow_watch_active.add(addr)
                spawn(self._borrow_watch_loop(addr), what="borrow watch loop")

    def _register_lineage(self, task_id: TaskID, record: dict):
        """Retain the task record for reconstruction while its outputs are
        referenced; cap total retained bytes (reference: task_manager.h:183
        max_lineage_bytes)."""
        self._tasks[task_id] = record
        for oid, _owner in record.get("arg_refs", ()):
            self.ref_counter.lineage_add(oid)
        self._lineage_bytes += record.get("bytes", 0)
        cap = RAY_CONFIG.max_lineage_bytes
        if self._lineage_bytes <= cap:
            return
        for tid, rec in list(self._tasks.items()):
            if self._lineage_bytes <= cap:
                break
            if rec is record or rec.get("_recover_event") is not None:
                continue
            fut_pending = any(self._return_pending(rid)
                              for rid in rec.get("return_ids", ()))
            if fut_pending:
                continue
            self._drop_record(tid, rec)  # outputs become non-reconstructable

    def _maybe_drop_record(self, task_id: TaskID):
        rec = self._tasks.get(task_id)
        if rec is None or rec.get("_recover_event") is not None:
            return
        rc = self.ref_counter
        for rid in rec.get("return_ids", ()):
            b = rid.binary()
            if not rc.freeable(b) or rc.lineage_count(b) > 0:
                return
            if self._return_pending(rid):
                return
        self._drop_record(task_id, rec)

    def _drop_record(self, task_id: TaskID, rec: dict):
        self._tasks.pop(task_id, None)
        self.stream_release(task_id)
        self._lineage_bytes -= rec.get("bytes", 0)
        rc = self.ref_counter
        for rid in rec.get("return_ids", ()):
            if rc.lineage_count(rid.binary()) == 0 and rc.freeable(rid.binary()):
                rc.drop(rid.binary())
        for oid, owner in rec.get("arg_refs", ()):
            rc.lineage_remove(oid)
            if not owner or owner == self.address:
                # the arg may now be fully releasable (cascades up the DAG)
                if rc.freeable(oid) and rc.lineage_count(oid) == 0:
                    self._schedule_free(oid)
                self._maybe_drop_record(ObjectID(oid).task_id())

    def _release_task_pins(self, record: dict):
        if record.pop("_pinned", None):
            for oid, _owner in record.get("arg_refs", ()):
                self.ref_counter.unpin(oid)

    def _process_reply_refs(self, reply: dict, executor_addr: str):
        """Handle borrow/nested-ref reports carried on a task reply (the
        reliable registration leg; removal is owner-initiated via watches)."""
        for oid, owner in reply.get("borrows", ()):
            if not owner or owner == self.address:
                self.ref_counter.add_borrower(oid, executor_addr)
                self._watch_borrower(oid, executor_addr)
            else:
                spawn(self._forward_borrow(owner, oid, executor_addr),
                      what="borrow forward")
        nested = reply.get("nested") or {}
        for ret_oid, inner in nested.items():
            self.ref_counter.pin_nested(ret_oid, list(inner))
            for oid, owner in inner:
                if owner and owner != self.address:
                    spawn(self._forward_borrow(owner, oid, self.address),
                          what="borrow forward")

    async def _forward_borrow(self, owner: str, oid: bytes, borrower: str):
        try:
            await self._worker_client(owner).call("AddBorrower", wire.dumps(
                {"oid": oid, "address": borrower}), timeout=10.0, retries=1)
        except (RpcError, asyncio.TimeoutError, OSError) as e:
            logger.debug("AddBorrower(%s) forward to owner %s failed: %s",
                         oid.hex()[:8], owner, e)

    async def _recover_object(self, oid: ObjectID) -> bool:
        """Lineage reconstruction: re-execute the producing task (reference:
        object_recovery_manager.h:41). Returns True if a re-execution was
        run (caller re-checks the object)."""
        rec = self._tasks.get(oid.task_id())
        if rec is None:
            return False
        ev = rec.get("_recover_event")
        if ev is not None:
            await ev.wait()
            return True
        if rec.get("_recoveries", 0) >= RAY_CONFIG.max_object_reconstructions:
            return False
        rec["_recoveries"] = rec.get("_recoveries", 0) + 1
        rec["_recover_event"] = ev = asyncio.Event()
        logger.warning("object %s lost; reconstructing via lineage re-execution "
                       "of %s (recovery %d)", oid.hex()[:12], rec["name"],
                       rec["_recoveries"])
        try:
            for rid in rec["return_ids"]:
                self._in_store.pop(rid, None)
                self.memory_store.pop(rid, None)
                old = self._result_futures.get(rid)
                if old is not None and old.done():
                    self._result_futures.pop(rid, None)
                # re-mark pendency; a waiter re-allocates the future lazily
                self._pending_returns[rid] = True
            rec["attempts"] = 0  # fresh retry budget for the recovery run
            for ob, ow in rec.get("arg_refs", ()):
                self.ref_counter.pin(ob, ow)
            rec["_pinned"] = True
            await self._drive_task(rec)
        finally:
            rec.pop("_recover_event", None)
            ev.set()
        return True

    # ------------------------------------------------------------------
    # task submission (owner side)
    # ------------------------------------------------------------------

    def submit_task(self, remote_fn, args, kwargs, opts: TaskOptions):
        """Non-blocking submission: everything cheap happens on the caller
        thread; the drive coroutine is kicked off fire-and-forget so batched
        ``.remote()`` loops pipeline instead of paying a cross-thread round
        trip per call (reference: the owner-side submit path is the tasks/s
        hot loop, normal_task_submitter.cc).

        Warm path (template cached for this RemoteFunction, tracing off):
        the spec reuses the resolved function key + prepared options and
        carries a preserialized template blob, so the per-submit work is
        arg serialization + bookkeeping inserts — the spec is never
        re-framed through ``wire.dumps``, no future/coroutine is allocated,
        and the batch pusher ships ``(task_id, args, attempt)`` against the
        template."""
        from ray_tpu_torch.util import tracing

        stats = self._submit_stats
        stats["count"] += 1
        task_id = TaskID.of(self.job_id)
        streaming = opts.num_returns == "streaming"
        nret = 0 if streaming else opts.num_returns
        refs = [ObjectRef(ObjectID.for_task_return(task_id, i), self.address)
                for i in range(nret)]
        t0 = time.perf_counter()
        args_blob, arg_refs = self._pack_args(args, kwargs)
        stats["serialize_s"] += time.perf_counter() - t0
        cached = self._spec_template_cache.get(id(remote_fn))
        fast = (cached is not None and cached[0] is remote_fn
                and not tracing.enabled())
        if fast:
            _rf, fn_key, popts, pool, tmpl_blob = cached
            opts = popts
        else:
            fn_key, pool, tmpl_blob = "", None, None
        spec = TaskSpec(
            task_id=task_id,
            job_id=self.job_id,
            function_key=fn_key,  # empty -> filled by _drive_task_prepared
            args_blob=args_blob,
            num_returns=-1 if streaming else nret,
            options=opts,
            owner_address=self.address,
        )
        max_retries = opts.max_retries if opts.max_retries >= 0 else RAY_CONFIG.task_max_retries
        record = {"spec": spec, "attempts": 0, "max_retries": max_retries,
                  "return_ids": [ref.id for ref in refs],
                  "arg_refs": arg_refs, "bytes": len(args_blob) + 512,
                  "name": remote_fn.function_name,
                  "_submit_ts": time.time()}
        if tmpl_blob is not None:
            record["_tmpl"] = tmpl_blob
        if not fast:
            self._stamp_trace(spec, record["name"])
        if task_events.enabled():
            record["_job_hex"] = jh = self.job_id.hex()
            t1 = time.perf_counter()
            task_events.record_submitted(
                task_id.hex(), record["_submit_ts"], record["name"], jh,
                len(args_blob), _task_span_id(spec), self._submitter_span())
            stats["events_s"] += time.perf_counter() - t1
        for oid, owner in arg_refs:
            self.ref_counter.pin(oid, owner)
        record["_pinned"] = True
        for ref in refs:
            # marked off-loop so a get() racing the kickoff sees pendency;
            # the future itself is allocated lazily on first get/await
            # raylint: disable=RCE001 dict stores are single-bytecode and the loop-side recovery write is the same idempotent True — the off-loop marking is the point (see comment above)
            self._pending_returns[ref.id] = True
        if streaming:
            # per-stream state the executor's StreamTaskReturn RPCs fill
            self._streams[task_id.binary()] = {
                "produced": 0, "total": None, "error": None,
                "event": asyncio.Event()}
        t2 = time.perf_counter()
        if fast:
            stats["fast_path"] += 1

            def _kickoff():
                self._register_lineage(task_id, record)
                if record.get("_cancelled") \
                        or self._has_pending_local_deps(record):
                    spawn(self._drive_task(record, wait=False),
                          what="task drive")
                    return
                if task_events.enabled():
                    task_events.record(
                        task_id.hex(), task_events.LEASE_REQUESTED,
                        attempt=spec.attempt,
                        job_id=record.get("_job_hex", ""))
                pool.submit(record)
        else:
            def _kickoff():
                self._register_lineage(task_id, record)
                spawn(self._drive_task_prepared(remote_fn, record),
                      what="task drive")

        self._queue_kickoff(_kickoff)
        stats["kickoff_s"] += time.perf_counter() - t2
        if streaming:
            from ray_tpu_torch.object_ref import ObjectRefGenerator

            return ObjectRefGenerator(self, task_id, self.address)
        return refs[0] if nret == 1 else refs

    def _has_pending_local_deps(self, record: dict) -> bool:
        """Sync form of _resolve_dependencies' wait condition: does any
        locally-owned ref arg still have its producer in flight?"""
        for oid_b, owner in record.get("arg_refs", ()):
            if (not owner or owner == self.address) \
                    and self._return_pending(ObjectID(oid_b)):
                return True
        return False

    def submit_stats(self) -> dict:
        """Per-submit cost breakdown (µs, amortized over all submits so
        far): the serialize/events/kickoff legs are caller-thread wall
        time; push_rtt is the PushTaskBatch round trip INCLUDING remote
        execution, amortized per task (round trips overlap across pushers,
        so it is an upper bound on the owner-side push cost)."""
        s = dict(self._submit_stats)
        n = max(1, s["count"])
        s["per_submit_us"] = {
            "serialize": round(s["serialize_s"] / n * 1e6, 2),
            "events": round(s["events_s"] / n * 1e6, 2),
            "kickoff": round(s["kickoff_s"] / n * 1e6, 2),
            "push_rtt": round(s["push_s"] / max(1, s["push_tasks"]) * 1e6, 2),
        }
        return s

    def _submitter_span(self) -> str:
        """The submitter's active span id (the enclosing task's execution
        span, or a user ``profile()`` block) — rides the SUBMITTED task
        event so the GCS timeline can join parent→child task records into
        flow arrows without reading the span table. Empty when tracing is
        off (arrows are a tracing feature; slices still render)."""
        from ray_tpu_torch.util import tracing

        ctx = tracing.current_context()
        return ctx[1] if ctx is not None else ""

    def _stamp_trace(self, spec: TaskSpec, name: str):
        """Propagate the caller's trace context into the spec (reference:
        tracing_helper.py injecting the OTel context into the TaskSpec).
        Records a zero-width ``submit`` span as the flow-arrow anchor: the
        driver (or enclosing task) side of the driver→worker edge. No-op
        unless tracing is enabled."""
        from ray_tpu_torch.util import tracing

        if not tracing.enabled():
            return
        ctx = tracing.current_context()
        trace_id = ctx[0] if ctx is not None else tracing.new_trace_id()
        span_id = tracing.new_span_id()
        now = time.time()
        tracing.record_span(
            f"submit:{name}", now, now, category="submit",
            trace_id=trace_id, span_id=span_id,
            parent_id=ctx[1] if ctx is not None else None,
            task_id=spec.task_id.hex())
        spec.trace_id = trace_id
        spec.parent_span_id = span_id

    async def _drive_task_prepared(self, remote_fn, record: dict):
        """Resolve the (cached) function key + runtime env, then drive."""
        spec: TaskSpec = record["spec"]
        try:
            if spec.options.runtime_env or self.job_runtime_env:
                spec.options.runtime_env = await self._prepare_runtime_env(
                    spec.options.runtime_env)
            spec.function_key = await self._push_function(remote_fn.function)
        except Exception as e:
            self._complete_error(record, TaskError(
                f"submission failed for {record['name']}: {e}",
                traceback.format_exc()))
            return
        self._cache_spec_template(remote_fn, spec)
        # fire-and-forget: completion flows through the result futures; only
        # recovery re-execution needs to await the record (saves a coroutine
        # suspension+wake per task on the submit hot path)
        await self._drive_task(record, wait=False)

    def _cache_spec_template(self, remote_fn, spec: TaskSpec):
        """Frame the invariant part of this (function, options) pair's spec
        ONCE: later submits reuse the blob (see submit_task's warm path)
        and the pusher ships only (task_id, args_blob, attempt) against it.
        The prepared options (runtime env uploaded, function key resolved)
        and the lease pool ride along so the warm path does no awaits."""
        import copy as _copy

        cached = self._spec_template_cache.get(id(remote_fn))
        if cached is not None and cached[0] is remote_fn:
            return
        if len(self._spec_template_cache) >= 1024:
            # bound the cache: `f.options(...).remote()` mints a NEW
            # RemoteFunction per call, so without eviction a submit loop
            # over one-shot options objects grows this (and the strong
            # refs in slot 0) without limit. A full clear is fine — live
            # functions re-frame once each (counted in spec_frames).
            self._spec_template_cache.clear()
        tmpl = _copy.copy(spec)
        tmpl.task_id = TaskID.nil()
        tmpl.args_blob = b""
        tmpl.attempt = 0
        tmpl.trace_id = ""
        tmpl.parent_span_id = ""
        blob = wire.dumps(tmpl)
        self._submit_stats["spec_frames"] += 1
        pool = self._lease_pool_for(spec.options,
                                    spec.options.required_resources())
        self._spec_template_cache[id(remote_fn)] = (
            remote_fn, spec.function_key, spec.options, pool, blob)

    # pooled-scratch ceiling: args bigger than this pack into a one-shot
    # buffer instead of pinning multi-MB scratch per submitting thread
    _PACK_SCRATCH_MAX = 4 << 20

    def _pack_args(self, args, kwargs):
        # inline small owned values so the executor need not call back
        def _inline(v):
            if isinstance(v, ObjectRef) and v.id in self.memory_store:
                value = self.memory_store[v.id]
                if not isinstance(value, TaskError):
                    return value
            return v

        from ray_tpu_torch.object_ref import collect_serialized_refs

        args = tuple(_inline(a) for a in args)
        kwargs = {k: _inline(v) for k, v in kwargs.items()}
        with collect_serialized_refs() as arg_refs:
            inband, buffers = serialize((args, kwargs))
        # pooled serialization scratch (per submitting thread — submits
        # come from user threads as well as the loop): pack into a reused
        # bytearray and snapshot once, instead of pack_blob's
        # alloc-bytearray + copy-to-bytes per call. At ~31 µs/submit the
        # per-driver ceiling is arg-serialization-bound;
        # killing the large-allocation churn is the cheap half of that.
        stats = self._submit_stats
        total, offsets = plan_layout(inband, buffers)
        scratch = getattr(self._tls, "pack_scratch", None)
        if scratch is not None and len(scratch) >= total:
            stats["pack_pool_hits"] += 1
        else:
            stats["pack_pool_misses"] += 1
            size = min(max(total, 64 << 10), self._PACK_SCRATCH_MAX)
            if total <= self._PACK_SCRATCH_MAX:
                scratch = self._tls.pack_scratch = bytearray(size)
            else:  # oversized: one-shot buffer, never pooled
                scratch = bytearray(total)
        write_blob(scratch, inband, buffers, offsets)
        # pack_blob's fresh bytearray had zeroed alignment gaps; the
        # reused scratch keeps a PRIOR submit's bytes there — zero the
        # gaps (each <64 B) so blobs stay deterministic and never leak
        # another task's argument fragments to the executor
        mv = memoryview(scratch)
        prev_end = 16 + 16 * len(buffers) + len(inband)
        for b, off in zip(buffers, offsets):
            if off > prev_end:
                mv[prev_end:off] = bytes(off - prev_end)
            prev_end = off + b.nbytes
        if total > prev_end:
            mv[prev_end:total] = bytes(total - prev_end)
        blob = bytes(mv[:total])
        return blob, arg_refs

    async def _resolve_dependencies(self, record: dict):
        """Wait for locally-owned ref args to finish producing before the
        task becomes push-eligible (reference: dependency_resolver.cc, used
        by normal_task_submitter.cc:32). This keeps batched pushes
        dependency-safe: a task can never ride the same PushTaskBatch as its
        own producer, whose result would otherwise be trapped in the batch's
        unreturned reply."""
        for oid_b, owner in record.get("arg_refs", ()):
            if owner and owner != self.address:
                continue  # foreign-owned: the executor resolves via that owner
            fut = self._ensure_result_future(ObjectID(oid_b))
            if fut is not None and not fut.done():
                await asyncio.shield(fut)

    async def _drive_task(self, record: dict, wait: bool = True):
        """Queue onto the scheduling-key pool (lease reuse + batched pushes;
        reference: normal_task_submitter.cc + task_manager.cc). Retries on
        worker failure happen inside the pool; ``wait`` is only needed by
        recovery re-execution (normal completion flows through futures)."""
        spec: TaskSpec = record["spec"]
        opts: TaskOptions = spec.options
        await self._resolve_dependencies(record)
        if record.get("_cancelled"):
            from ray_tpu_torch.exceptions import TaskCancelledError

            self._complete_error(record, TaskCancelledError())
            return
        if task_events.enabled():
            task_events.record(spec.task_id.hex(), task_events.LEASE_REQUESTED,
                               attempt=spec.attempt,
                               job_id=record.get("_job_hex", ""))
        pool = self._lease_pool_for(opts, opts.required_resources())
        if wait:
            # only recovery re-execution blocks on the record; the normal
            # path skips the per-task Event allocation entirely
            record["_done"] = asyncio.Event()
        pool.submit(record)
        if wait:
            await record["_done"].wait()

    def _observe_complete(self, record, err: Optional[TaskError],
                          ret_bytes: int = 0):
        """Terminal lifecycle event + end-to-end latency histogram (the
        always-on half of observability: costs one histogram observe and,
        when task events are on, a buffered append)."""
        submit_ts = record.get("_submit_ts")
        if submit_ts is not None and record.get("name"):
            try:
                _obs()["e2e"].observe(time.time() - submit_ts,
                                      tags={"function": record["name"]})
            except Exception:  # raylint: disable=EXC001 metrics must never fail a task completion
                pass
        if task_events.enabled():
            spec = record["spec"]
            task_events.record(
                spec.task_id.hex(),
                task_events.FAILED if err is not None else task_events.FINISHED,
                attempt=max(record.get("attempts", 0),
                            record.get("epoch", 0) or 0),
                error=str(err) if err is not None else "",
                job_id=record.get("_job_hex", ""),
                ret_bytes=ret_bytes)

    @staticmethod
    def _result_nbytes(results) -> int:
        """Serialized return-payload bytes of a completed task: inline
        results carry their blob, store-resident ones ride the executor's
        size annotation (the payload slot of a ``("store", nbytes)``
        result tuple)."""
        total = 0
        for kind, payload in results:
            if kind == "inline":
                total += len(payload)
            elif isinstance(payload, int):
                total += payload
        return total

    def _complete_ok(self, record, results, stream_count=None):
        record["_completed"] = True
        self._observe_complete(record, None,
                               ret_bytes=self._result_nbytes(results))
        if record["spec"].num_returns == -1:
            st = self._streams.get(record["spec"].task_id.binary())
            if st is not None:
                st["total"] = stream_count if stream_count is not None \
                    else st["produced"]
                ev, st["event"] = st["event"], asyncio.Event()
                ev.set()
        for oid, (kind, payload) in zip(record["return_ids"], results):
            if kind == "inline":
                inband, buffers = read_blob(payload)
                self.memory_store[oid] = deserialize(inband, buffers)
            else:  # stored in the distributed object store
                self._in_store[oid] = True
            self._pending_returns.pop(oid, None)
            fut = self._result_futures.get(oid)
            if fut is not None and not fut.done():
                fut.set_result(True)
        self._release_task_pins(record)
        done = record.get("_done")
        if done is not None:
            done.set()
        for oid in record["return_ids"]:
            if self.ref_counter.freeable(oid.binary()):
                self._schedule_free(oid.binary())

    def _complete_error(self, record, err: TaskError):
        record["_completed"] = True
        self._observe_complete(record, err)
        streaming = record["spec"].num_returns == -1
        if streaming:
            st = self._streams.get(record["spec"].task_id.binary())
            if st is not None:
                st["error"] = err
                ev, st["event"] = st["event"], asyncio.Event()
                ev.set()
        for oid in record["return_ids"]:
            if streaming and (oid in self.memory_store
                              or self._in_store.get(oid)):
                self._pending_returns.pop(oid, None)
                continue  # already-yielded items stay readable
            self.memory_store[oid] = err
            self._pending_returns.pop(oid, None)
            fut = self._result_futures.get(oid)
            if fut is not None and not fut.done():
                fut.set_result(True)
        self._release_task_pins(record)
        done = record.get("_done")
        if done is not None:
            done.set()
        # re-schedule frees that _free_owned deferred while production was
        # in flight (same re-check _complete_ok does): without it an error
        # object whose refs were all dropped mid-flight stays in
        # memory_store forever
        for oid in record["return_ids"]:
            if self.ref_counter.freeable(oid.binary()):
                self._schedule_free(oid.binary())

    # -- leases --

    def _lease_pool_for(self, opts: TaskOptions, resources) -> _LeasePool:
        from ray_tpu_torch._private.runtime_env import env_hash

        key = (_freeze(resources), _freeze(opts.label_selector),
               opts.placement_group.id.binary() if opts.placement_group else None,
               opts.placement_group_bundle_index,
               env_hash(opts.runtime_env))
        pool = self._lease_cache.get(key)
        if pool is None:
            pool = _LeasePool(self, key, opts, resources)
            self._lease_cache[key] = pool
        return pool

    async def _arg_locality(self, record: dict):
        """Byte-weighted argument locations for a task (reference:
        task_submission/lease_policy.cc LocalityAwareLeasePolicy): returns
        ({node_hex: bytes}, best_address) using the GCS object directory
        (sizes ride the location announcements), briefly cached per oid.
        None when args are inline/small — locality cannot beat the local
        start then."""
        arg_refs = record.get("arg_refs") or ()
        if not arg_refs:
            return None, None
        if not hasattr(self, "_loc_cache"):
            self._loc_cache = {}
        by_node: Dict[str, int] = {}
        addr_of: Dict[str, str] = {}
        now = time.monotonic()
        for oid, _owner in arg_refs:
            key = oid.binary() if hasattr(oid, "binary") else oid
            own = self._obj_locations.get(key)
            if own is not None:
                # owner-resident: this worker owns the object — its own
                # table answers without any directory RPC
                size = own.get("size", 0) or 0
                for n, a in own["nodes"].items():
                    by_node[n] = by_node.get(n, 0) + size
                    addr_of[n] = a
                continue
            hit = self._loc_cache.get(key)
            if hit is not None and now - hit[0] < 5.0:
                reply = hit[1]
            else:
                try:
                    reply = await self._gcs_call(
                        "ObjectLocGet", {"oid": key}, timeout=5.0)
                except Exception as e:
                    logger.debug("ObjectLocGet(%s) failed; skipping this "
                                 "pull round: %s", key.hex()[:8], e)
                    continue
                if len(self._loc_cache) > 4096:
                    self._loc_cache.clear()
                self._loc_cache[key] = (now, reply)
            size = reply.get("size") or 0  # None: deleted-before-announce
            for loc in reply.get("locations", ()):
                by_node[loc["node_id"]] = by_node.get(loc["node_id"], 0) + size
                addr_of[loc["node_id"]] = loc["address"]
        if not by_node:
            return None, None
        best = max(by_node, key=by_node.get)
        if by_node[best] < RAY_CONFIG.locality_min_arg_bytes:
            return by_node, None
        return by_node, addr_of.get(best)

    async def _pick_node(self, opts: TaskOptions, resources) -> Optional[dict]:
        strat = opts.scheduling_strategy
        if opts.placement_group is not None:
            reply = await self._gcs_call("GetPlacementGroup",
                                         {"pg_id": opts.placement_group.id.binary()})
            info = reply["info"]
            if info is None or info["state"] != "CREATED":
                # wait for the pg
                await self._gcs_call("WaitPlacementGroupReady", {
                    "pg_id": opts.placement_group.id.binary(), "timeout": 300.0},
                    timeout=310.0)
                reply = await self._gcs_call("GetPlacementGroup",
                                             {"pg_id": opts.placement_group.id.binary()})
                info = reply["info"]
                if info is None:
                    return None
            idx = max(opts.placement_group_bundle_index, 0)
            node_hex = info["bundle_nodes"][idx]
            nodes = (await self._gcs_call("GetAllNodes", {}))["nodes"]
            for n in nodes:
                if n["node_id"] == node_hex:
                    return {"node_id": node_hex, "address": n["address"]}
            return None
        selector = dict(opts.label_selector)
        req: Dict[str, Any] = {"resources": resources, "selector": selector}
        if strat is not None:
            if hasattr(strat, "node_id"):
                nodes = (await self._gcs_call("GetAllNodes", {}))["nodes"]
                for n in nodes:
                    if n["node_id"] == strat.node_id and n.get("alive", True):
                        return {"node_id": strat.node_id, "address": n["address"]}
                if not getattr(strat, "soft", False):
                    return None
                # soft affinity: fall through to the normal pick
            if hasattr(strat, "hard"):
                selector.update(strat.hard)
                req["selector"] = selector
            if type(strat).__name__ == "SpreadSchedulingStrategy" or strat == "SPREAD":
                self._spread_hint += 1
                req["strategy"] = "SPREAD"
                req["spread_hint"] = self._spread_hint
        deadline = time.monotonic() + RAY_CONFIG.infeasible_task_timeout_s
        warned = False
        # one demand unit per concurrent pick, stable across its retries, so
        # the GCS autoscaler view counts waiters rather than poll attempts
        req.setdefault("waiter_id", uuid.uuid4().hex)
        while True:
            reply = await self._gcs_call("PickNode", req)
            if reply["node"] is not None:
                return reply["node"]
            if not warned:
                logger.warning("no feasible node yet for resources=%s selector=%s; waiting",
                               resources, selector)
                warned = True
            if time.monotonic() > deadline:
                return None
            await asyncio.sleep(0.5)

    async def _drop_lease(self, lease: dict):
        try:
            await self._raylet_client(lease["raylet_address"]).call(
                "ReturnWorkerLease", wire.dumps({"lease_id": lease["lease_id"]}),
                timeout=5.0, retries=1)
        except (RpcError, asyncio.TimeoutError, OSError) as e:
            logger.debug("ReturnWorkerLease to %s failed: %s",
                         lease["raylet_address"], e)

    # ------------------------------------------------------------------
    # actors (owner side)
    # ------------------------------------------------------------------

    def create_actor(self, actor_cls, args, kwargs, opts: ActorOptions):
        from ray_tpu_torch.actor import ActorHandle

        actor_id = ActorID.of(self.job_id)
        info = self._run(self._create_actor_async(actor_cls, args, kwargs, opts, actor_id))
        aid = ActorID.from_hex(info["actor_id"])
        view = self._actors.setdefault(aid, _ActorView(aid))
        view.state = info["state"]
        view.address = info["address"]
        view.max_task_retries = opts.max_task_retries
        return ActorHandle(aid, actor_cls.method_names(), actor_cls.class_name,
                           opts.max_task_retries)

    async def _create_actor_async(self, actor_cls, args, kwargs, opts, actor_id):
        opts.runtime_env = await self._prepare_runtime_env(opts.runtime_env)
        function_key = await self._push_function(actor_cls.cls)
        task_id = TaskID.of(self.job_id)
        args_blob, arg_refs = self._pack_args(args, kwargs)
        # creation args may carry refs; pin them for the actor's lifetime
        # (restarts re-resolve them from this owner)
        for oid, owner in arg_refs:
            self.ref_counter.pin(oid, owner)
        spec = TaskSpec(
            task_id=task_id,
            job_id=self.job_id,
            function_key=function_key,
            args_blob=args_blob,
            num_returns=0,
            options=opts,
            owner_address=self.address,
            actor_id=actor_id,
            is_actor_creation=True,
            actor_options=opts,
        )
        reply = await self._gcs_call("CreateActor", {
            "spec": spec, "class_name": actor_cls.class_name})
        if reply["status"] == "name_taken":
            raise ValueError(f"actor name {opts.name!r} already taken")
        return reply["info"]

    def _actor_view(self, actor_id: ActorID) -> _ActorView:
        view = self._actors.get(actor_id)
        if view is None:
            view = _ActorView(actor_id)
            self._actors[actor_id] = view
            # seed state from GCS
            async def _seed():
                reply = await self._gcs_call("GetActorInfo", {"actor_id": actor_id.binary()})
                info = reply["info"]
                if info is not None and view.state == "PENDING_CREATION":
                    view.state = info["state"]
                    view.address = info["address"]
            asyncio.run_coroutine_threadsafe(_seed(), self.loop)
        return view

    def submit_actor_task(self, handle, method_name, args, kwargs, num_returns=1,
                          tensor_transport=""):
        """Non-blocking (see submit_task): actor calls pipeline without a
        per-call cross-thread round trip."""
        task_id = TaskID.of(self.job_id)
        streaming = num_returns == "streaming"
        nret = 0 if streaming else num_returns
        refs = [ObjectRef(ObjectID.for_task_return(task_id, i), self.address)
                for i in range(nret)]
        args_blob, arg_refs = self._pack_args(args, kwargs)
        spec = TaskSpec(
            task_id=task_id,
            job_id=self.job_id,
            function_key="",
            args_blob=args_blob,
            num_returns=-1 if streaming else nret,
            options=TaskOptions(num_returns=-1 if streaming else nret),
            owner_address=self.address,
            actor_id=handle.actor_id,
            method_name=method_name,
            tensor_transport=tensor_transport,
        )
        if streaming:
            # same owner-side stream state as task generators; the
            # executor's StreamTaskReturn RPCs fill it (reference: the
            # dynamic-returns protocol works identically for actor tasks)
            self._streams[task_id.binary()] = {
                "produced": 0, "total": None, "error": None,
                "event": asyncio.Event()}
        record = {"spec": spec, "attempts": 0,
                  "max_retries": handle._max_task_retries,
                  "return_ids": [ref.id for ref in refs],
                  "arg_refs": arg_refs,
                  "name": f"{handle._class_name}.{method_name}",
                  "_submit_ts": time.time()}
        self._stamp_trace(spec, record["name"])
        if task_events.enabled():
            record["_job_hex"] = jh = self.job_id.hex()
            task_events.record_submitted(
                task_id.hex(), record["_submit_ts"], record["name"], jh,
                len(args_blob), _task_span_id(spec), self._submitter_span())
        for oid, owner in arg_refs:
            self.ref_counter.pin(oid, owner)
        record["_pinned"] = True
        for ref in refs:
            # lazy result futures, same as submit_task
            self._pending_returns[ref.id] = True

        def _kickoff():
            view = self._actor_view(handle.actor_id)
            self._actor_inflight[task_id] = record
            spawn(self._drive_actor_task(view, record), what="actor-task drive")

        self._queue_kickoff(_kickoff)
        if streaming:
            from ray_tpu_torch.object_ref import ObjectRefGenerator

            return ObjectRefGenerator(self, task_id, self.address)
        return refs[0] if nret == 1 else refs

    async def _drive_actor_task(self, view: _ActorView, record: dict):
        try:
            await self._drive_actor_task_inner(view, record)
        finally:
            self._actor_inflight.pop(record["spec"].task_id, None)

    async def _drive_actor_task_inner(self, view: _ActorView, record: dict):
        from ray_tpu_torch.exceptions import TaskCancelledError

        spec: TaskSpec = record["spec"]
        deadline = time.monotonic() + 3600.0
        while True:
            if record.get("_cancelled") and not record.get("_pushed_to"):
                # cancelled while waiting for the actor: never push
                self._complete_error(record, TaskCancelledError())
                return
            if view.state == "DEAD":
                self._complete_error(record, TaskError(
                    f"ActorDiedError: actor {view.actor_id.hex()[:12]} is dead "
                    f"({view.death_cause})", "", ActorDiedError(view.death_cause)))
                return
            if view.state != "ALIVE" or not view.address:
                # wait for restart / creation (reference: actor_task_submitter
                # queues calls while the actor is restarting)
                reply = await self._gcs_call("WaitActorReady", {
                    "actor_id": view.actor_id.binary(), "timeout": 60.0}, timeout=70.0)
                info = reply["info"]
                if info is None:
                    self._complete_error(record, TaskError(
                        "ActorDiedError: actor record missing", ""))
                    return
                if info["address"] != view.address:
                    # new incarnation: per-caller ordering restarts at 1
                    view.seqno = 0
                view.state, view.address = info["state"], info["address"]
                if time.monotonic() > deadline:
                    self._complete_error(record, TaskError(
                        "ActorUnavailableError: timed out waiting for actor", ""))
                    return
                continue
            try:
                # seqno is assigned at push time so ordering is per-incarnation
                # (a restarted actor's queue starts over at 1)
                view.seqno += 1
                spec.seqno = view.seqno
                record["epoch"] = record.get("epoch", -1) + 1
                spec.attempt = record["epoch"]
                record["_pushed_to"] = view.address
                if task_events.enabled():
                    task_events.record(
                        spec.task_id.hex(), task_events.SCHEDULED,
                        attempt=record["epoch"], worker=view.address,
                        job_id=record.get("_job_hex", ""))
                # short connect timeout + one blind reconnect: the address came
                # from an ALIVE view, so an unreachable peer means the view is
                # stale — fail fast into the GCS recheck below (the real retry
                # loop) rather than camping on connect; the single presend
                # round covers the connect-then-instant-RST race on live peers
                reply = wire.loads(await self._worker_client(view.address).call(
                    "PushTask", wire.dumps({"spec": spec}), timeout=86400.0,
                    retries=0, connect_timeout=2.0, presend_retries=1))
            except (RpcError, asyncio.TimeoutError, OSError) as e:
                view.state = "UNKNOWN"
                record.pop("_pushed_to", None)  # not running anywhere now
                if record.get("_cancelled"):
                    # cancelled + push failed: never re-push to the next
                    # incarnation (the normal-task path's :215 recheck)
                    self._complete_error(record, TaskCancelledError())
                    return
                await asyncio.sleep(0.2)
                record["attempts"] += 1
                if record["attempts"] > max(record["max_retries"], 0):
                    self._complete_error(record, TaskError(
                        f"ActorUnavailableError: {record['name']} failed: {e}", "",
                        ActorUnavailableError(str(e))))
                    return
                task_events.record(
                    spec.task_id.hex(), task_events.RETRYING,
                    attempt=record["attempts"], error=f"actor push failed: {e}",
                    job_id=record.get("_job_hex", ""))
                continue
            if reply["status"] == "ok":
                self._process_reply_refs(reply, view.address)
                self._complete_ok(record, reply["results"],
                                  stream_count=reply.get("stream_count"))
            else:
                self._complete_error(record, loads_trusted(reply["error"]))
            return

    def stream_next(self, task_id: TaskID, index: int,
                    timeout: float = 3600.0):
        """Blocking wait for the index-th streamed return of a generator
        task; returns its ObjectRef, or raises StopIteration/the error."""
        tid_b = task_id.binary()

        async def _wait():
            deadline = time.monotonic() + timeout
            while True:
                st = self._streams.get(tid_b)
                if st is None:
                    return "stopped"
                if index < st["produced"]:
                    return "item"
                if st["error"] is not None:
                    return st["error"]
                if st["total"] is not None and index >= st["total"]:
                    return "stopped"
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise GetTimeoutError(
                        f"timed out waiting for streamed return {index}")
                try:
                    await asyncio.wait_for(
                        asyncio.shield(st["event"].wait()), remaining)
                except asyncio.TimeoutError:
                    pass

        out = self._run(_wait())
        if out == "item":
            oid = ObjectID.for_task_return(task_id, index)
            ref = ObjectRef(oid, self.address)
            # the ref now carries the count: hand over the arrival pin
            st = self._streams.get(tid_b)
            if st is not None and oid.binary() in st.get("pinned", set()):
                st["pinned"].discard(oid.binary())
                self.ref_counter.unpin(oid.binary())
            return ref
        if out == "stopped":
            raise StopIteration
        raise out  # the task's error

    def _chan_mailbox(self, name: str) -> dict:
        from collections import deque as _deque

        box = self._chan_mail.get(name)
        if box is None:
            box = self._chan_mail[name] = {
                "q": _deque(), "data": asyncio.Event(),
                "space": asyncio.Event(), "cap": 2, "last_seq": -1}
        return box

    def chan_pop(self, name: str, timeout: float = 300.0) -> bytes:
        """Reader side of a cross-host channel mailbox (blocking; called
        from the dag-loop/driver thread, never the io loop)."""
        async def _pop():
            box = self._chan_mailbox(name)
            deadline = time.monotonic() + timeout
            while not box["q"]:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"channel {name}: no value")
                try:
                    await asyncio.wait_for(box["data"].wait(),
                                           min(remaining, 5.0))
                except asyncio.TimeoutError:
                    pass
            blob = box["q"].popleft()
            ev, box["space"] = box["space"], asyncio.Event()
            ev.set()
            return blob

        return self._run(_pop(), timeout + 10.0)

    def chan_close(self, name: str):
        self._chan_mail.pop(name, None)
        self._chan_closed.add(name)
        if len(self._chan_closed) > 4096:
            self._chan_closed.pop()

    def stream_release(self, task_id: TaskID):
        """Generator handle dropped: release arrival pins for unconsumed
        items and forget the stream. Runs ON the io loop (scheduled from
        GC threads) so it cannot race the StreamTaskReturn handler's
        check-then-pin sequence and strand a pin forever."""
        def _do():
            st = self._streams.pop(task_id.binary(), None)
            if not st:
                return
            for oid_b in st.get("pinned", ()):
                try:
                    self.ref_counter.unpin(oid_b)
                except Exception as e:
                    logger.debug("stream unpin(%s) failed: %s",
                                 oid_b.hex()[:8], e)
            st["pinned"] = set()

        if threading.current_thread() is self._loop_thread:
            _do()
            return
        try:
            self.loop.call_soon_threadsafe(_do)
        except RuntimeError:
            _do()  # loop gone (shutdown): no handler left to race

    def get_actor(self, name: str, namespace: Optional[str] = None):
        from ray_tpu_torch.actor import ActorHandle

        reply = self._run(self._gcs_call("GetNamedActor", {
            "name": name, "namespace": namespace or self.namespace}))
        info = reply["info"]
        if info is None:
            raise ValueError(f"no actor named {name!r}")
        aid = ActorID.from_hex(info["actor_id"])
        view = self._actor_view(aid)
        view.state, view.address = info["state"], info["address"]
        return ActorHandle(aid, (), info.get("class_name", ""))

    def get_actor_handle(self, actor_id: ActorID):
        from ray_tpu_torch.actor import ActorHandle

        return ActorHandle(actor_id, (), "")

    def kill_actor(self, handle, no_restart=True):
        self._run(self._gcs_call("KillActor", {
            "actor_id": handle.actor_id.binary(), "no_restart": no_restart}))

    def cancel(self, ref, force=False, recursive=True):
        """Cancel a task (reference: CoreWorker::CancelTask paths in
        core_worker.cc). A still-queued task completes immediately with
        TaskCancelledError; a running task gets TaskCancelledError raised
        into its thread (cooperative), or its worker killed with
        force=True. Finished tasks are a no-op. Actor tasks: queued calls
        are dropped, running ASYNC calls are asyncio-cancelled, running
        sync calls get the cooperative async-exc; force=True is refused
        (matching the reference — it would kill the actor).
        ``recursive`` is accepted for API parity; this runtime does not
        track child-task trees. Accepts an ObjectRef or an
        ObjectRefGenerator (streaming task)."""
        from ray_tpu_torch.object_ref import ObjectRefGenerator

        if isinstance(ref, ObjectRefGenerator):
            task_id = ref._task_id
        else:
            task_id = ref.id.task_id()
        self._run(self._cancel_async(task_id, force))

    async def _cancel_async(self, task_id: TaskID, force: bool):
        from ray_tpu_torch.exceptions import TaskCancelledError

        rec = self._tasks.get(task_id) or self._actor_inflight.get(task_id)
        if rec is None:
            return  # finished-and-released or unknown: no-op
        if rec["spec"].actor_id is not None:
            # reference: CancelTask's actor path — queued calls are dropped,
            # running ASYNC calls are cancelled cooperatively; force-kill is
            # refused (it would take the whole actor down)
            if force:
                raise ValueError(
                    "force=True is not supported for actor tasks (it would "
                    "kill the actor); use ray_tpu.kill(actor) for that")
            if rec.get("_completed"):
                return
            rec["_cancelled"] = True
            addr = rec.get("_pushed_to")
            if addr:
                try:
                    await self._worker_client(addr).call(
                        "CancelTask", wire.dumps(
                            {"task_id": rec["spec"].task_id.binary(),
                             "force": False}), timeout=10.0, retries=1)
                except (RpcError, asyncio.TimeoutError, OSError) as e:
                    # actor death completes the call by itself
                    logger.debug("CancelTask to %s failed: %s", addr, e)
            return
        if rec.get("_completed"):
            return  # finished: never signal (or force-kill!) its worker
        rec["_cancelled"] = True
        # still queued in a lease pool: complete it right here
        for pool in self._lease_cache.values():
            if rec in pool.pending:
                try:
                    pool.pending.remove(rec)
                except ValueError:  # raylint: disable=EXC001 a concurrent grant already dequeued it; cancellation continues via the push path
                    break
                self._complete_error(rec, TaskCancelledError())
                return
        addr = rec.get("_pushed_to")
        if addr:
            try:
                await self._worker_client(addr).call(
                    "CancelTask", wire.dumps(
                        {"task_id": rec["spec"].task_id.binary(),
                         "force": force}), timeout=10.0, retries=1)
            except (RpcError, asyncio.TimeoutError, OSError) as e:
                # worker already gone: the push failure completes it
                logger.debug("CancelTask(force=%s) to %s failed: %s",
                             force, addr, e)
        # else: awaiting dependency resolution — the resolver checks the
        # flag before the record can become push-eligible

    # ------------------------------------------------------------------
    # cluster info
    # ------------------------------------------------------------------

    def cluster_resources(self):
        return self._run(self._gcs_call("GetClusterResources", {}))["total"]

    def available_resources(self):
        return self._run(self._gcs_call("GetClusterResources", {}))["available"]

    def nodes(self):
        return self._run(self._gcs_call("GetAllNodes", {}))["nodes"]

    def get_state(self):
        return self._run(self._gcs_call("GetState", {}))

    # ------------------------------------------------------------------
    # executor side (reference: task_execution/task_receiver.cc)
    # ------------------------------------------------------------------

    async def _handle_rpc(self, method: str, payload: bytes, conn) -> bytes:
        if method == "PushTask":
            req = wire.loads(payload)
            return await self._handle_push_task(req["spec"])
        if method == "PushTaskBatch":
            import copy as _copy

            req = wire.loads(payload)
            if "items" in req:
                # template framing (owner warm path): decode each distinct
                # spec template once, then stamp per-task fields onto
                # shallow copies. The options object is shared across the
                # batch — execution only reads it.
                tmpls = [wire.loads(b) for b in req.get("templates", ())]
                specs = []
                for it in req["items"]:
                    if it[0] == "s":
                        specs.append(it[1])
                    else:
                        spec = _copy.copy(tmpls[it[1]])
                        spec.task_id = it[2]
                        spec.args_blob = it[3]
                        spec.attempt = it[4]
                        specs.append(spec)
            else:
                specs = req["specs"]
            results = []
            run: List[TaskSpec] = []  # consecutive plain tasks, fused

            async def _flush_run():
                if run:
                    results.extend(await self._exec_normal_batch(run))
                    run.clear()

            for spec in specs:
                if spec.actor_id is None and not spec.is_actor_creation \
                        and spec.num_returns != -1:
                    run.append(spec)
                else:
                    await _flush_run()
                    results.append(
                        wire.loads(await self._handle_push_task(spec)))
            await _flush_run()
            return wire.dumps({"results": results})
        if method == "GetOwnedObject":
            return await self._handle_get_owned(wire.loads(payload))
        if method == "ObjectLocAnnounce":
            # owner-resident directory write (reference:
            # ownership_object_directory.cc): raylets report seals of
            # objects this worker owns — batched per announce, same
            # attempt-fencing as the GCS directory. Best-effort: the GCS
            # keeps the durable copy.
            req = wire.loads(payload)
            tab = self._obj_locations
            attempt = req.get("attempt", 0)
            sizes = req.get("sizes") or {}
            node, addr = req["node_id"], req["address"]
            for ob in req["oids"]:
                entry = tab.get(ob)
                size = sizes.get(ob, 0) or 0
                if entry is None or attempt > entry["attempt"]:
                    tab[ob] = {"attempt": attempt, "size": size,
                               "nodes": {node: addr}}
                    if len(tab) > 65536:  # safety bound; GCS is fallback
                        tab.pop(next(iter(tab)))
                elif attempt == entry["attempt"]:
                    entry["nodes"][node] = addr
                    if size:
                        entry["size"] = size
            return wire.dumps({"status": "ok"})
        if method == "ObjectLocDrop":
            req = wire.loads(payload)
            entry = self._obj_locations.get(req["oid"])
            if entry is not None:
                entry["nodes"].pop(req["node_id"], None)
                if not entry["nodes"]:
                    self._obj_locations.pop(req["oid"], None)
            return wire.dumps({"status": "ok"})
        if method == "ObjectLocQuery":
            # owner-resident directory read: the pulling raylet asks the
            # owner, not the GCS (falls back there if we have nothing)
            req = wire.loads(payload)
            entry = self._obj_locations.get(req["oid"])
            if entry is None:
                return wire.dumps({"locations": [], "attempt": 0, "size": 0})
            return wire.dumps({
                "locations": [{"node_id": n, "address": a}
                              for n, a in entry["nodes"].items()],
                "attempt": entry["attempt"], "size": entry.get("size", 0)})
        if method == "AddBorrower":
            req = wire.loads(payload)
            self.ref_counter.add_borrower(req["oid"], req["address"])
            self._watch_borrower(req["oid"], req["address"])
            return wire.dumps({"status": "ok"})
        if method == "AddBorrowers":
            # bulk re-assert from a borrower's periodic sweep
            req = wire.loads(payload)
            for oid in req["oids"]:
                self.ref_counter.add_borrower(oid, req["address"])
                self._watch_borrower(oid, req["address"])
            return wire.dumps({"status": "ok"})
        if method == "WaitBorrowsDone":
            # borrower side of the owner's watch: long-poll until any of
            # the probed oids is fully released here
            req = wire.loads(payload)
            deadline = time.monotonic() + 25.0
            while True:
                self.ref_counter.flush_deletes()
                done = [o for o in req["oids"]
                        if self.ref_counter.held_count(o) <= 0]
                if done or self._shutdown or time.monotonic() > deadline:
                    return wire.dumps({"done": done})
                await asyncio.sleep(0.2)
        if method == "StreamTaskReturn":
            # executor pushing one streamed yield (reference: the dynamic
            # return objects a generator task reports to its owner)
            req = wire.loads(payload)
            tid_b = req["task_id"]
            rec = self._tasks.get(TaskID(tid_b))
            if rec is None:
                # actor streaming records live in the actor-inflight table
                rec = self._actor_inflight.get(TaskID(tid_b))
            if rec is not None and req.get("attempt", 0) != rec.get("epoch", 0):
                # zombie attempt: a retry superseded this execution — its
                # items must not interleave into the current stream
                return wire.dumps({"status": "stale_attempt"})
            oid = ObjectID.for_task_return(TaskID(tid_b), req["index"])
            if req["kind"] == "inline":
                inband, buffers = read_blob(req["blob"])
                self.memory_store[oid] = deserialize(inband, buffers)
            else:
                self._in_store[oid] = True
            if rec is not None and oid not in rec["return_ids"]:
                rec["return_ids"].append(oid)
            st = self._streams.get(tid_b)
            if st is not None:
                if oid.binary() not in st.setdefault("pinned", set()):
                    # pin until the consumer mints the ref (or the
                    # generator is released): completion must not free
                    # items the consumer has not reached yet
                    st["pinned"].add(oid.binary())
                    self.ref_counter.pin(oid.binary())
                st["produced"] = max(st["produced"], req["index"] + 1)
                ev, st["event"] = st["event"], asyncio.Event()
                ev.set()
            return wire.dumps({"status": "ok"})
        if method == "ChanPush":
            # cross-host channel leg: the WRITER pushes into a mailbox
            # hosted by this (reader) worker; a full mailbox parks the
            # push — that await IS the channel's backpressure
            req = wire.loads(payload)
            if req["name"] in self._chan_closed:
                # torn-down reader: drop the value instead of resurrecting
                # a mailbox nothing will ever pop again
                return wire.dumps({"status": "closed"})
            box = self._chan_mailbox(req["name"])
            seq = req.get("seq")
            if seq is not None and seq <= box["last_seq"]:
                # idempotent retry: the writer re-pushes after an ambiguous
                # RPC failure; a sequence it already delivered is acked
                # without enqueueing (never double-delivers)
                return wire.dumps({"status": "ok", "dup": True})
            deadline = time.monotonic() + 300.0
            while len(box["q"]) >= box["cap"]:
                if time.monotonic() > deadline or self._shutdown \
                        or req["name"] in self._chan_closed:
                    raise RpcError(f"channel {req['name']} reader stalled")
                try:
                    await asyncio.wait_for(box["space"].wait(), 5.0)
                except asyncio.TimeoutError:
                    pass
            if seq is not None:
                if seq <= box["last_seq"]:
                    # re-check after parking: a timed-out original and its
                    # retry can park concurrently on a full mailbox
                    return wire.dumps({"status": "ok", "dup": True})
                box["last_seq"] = seq
            box["q"].append(req["blob"])
            ev, box["data"] = box["data"], asyncio.Event()
            ev.set()
            return wire.dumps({"status": "ok"})
        if method == "CancelTask":
            # reference: HandleCancelTask — cooperative raise into the
            # executing thread, or force-exit the worker process
            req = wire.loads(payload)
            if req.get("force"):
                logger.warning("force-cancel: worker exiting")
                self.loop.call_later(0.05, os._exit, 1)
                return wire.dumps({"status": "ok"})
            from ray_tpu_torch.exceptions import TaskCancelledError

            self._cancel_requested.add(req["task_id"])
            if len(self._cancel_requested) > 1024:
                self._cancel_requested.pop()
            atask = self._running_async_tasks.get(req["task_id"])
            if atask is not None:
                if not atask.done():
                    atask.cancel()
                return wire.dumps({"status": "ok"})
            ident = self._running_tasks.get(req["task_id"])
            if ident is not None:
                import ctypes

                n = ctypes.pythonapi.PyThreadState_SetAsyncExc(
                    ctypes.c_long(ident), ctypes.py_object(TaskCancelledError))
                if n != 1:  # thread already gone: fall back to the flag
                    logger.warning("cancel async-exc hit %d threads", n)
                    self._cancelled_pending.add(req["task_id"])
            else:
                self._cancelled_pending.add(req["task_id"])
            return wire.dumps({"status": "ok"})
        if method == "ProfileStacks":
            # py-spy-role stack sampling (dashboard/agent.py); runs in a
            # thread so the event loop keeps serving while sampling
            req = wire.loads(payload) or {}
            from ray_tpu_torch.dashboard.agent import sample_stacks

            out = await asyncio.get_event_loop().run_in_executor(
                None, sample_stacks,
                float(req.get("duration_s", 2.0)),
                float(req.get("interval_ms", 10.0)))
            return wire.dumps(out)
        if method == "ProfileMemory":
            req = wire.loads(payload) or {}
            if not hasattr(self, "_mem_profiler"):
                from ray_tpu_torch.dashboard.agent import MemoryProfiler

                self._mem_profiler = MemoryProfiler()
            action = req.get("action", "snapshot")
            if action == "start":
                out = self._mem_profiler.start(int(req.get("frames", 16)))
            elif action == "stop":
                out = self._mem_profiler.stop()
            else:
                out = self._mem_profiler.snapshot(int(req.get("top", 25)))
            return wire.dumps(out)
        if method == "Ping":
            return wire.dumps({"status": "ok", "pid": os.getpid()})
        if method == "GetDeviceObject":
            req = wire.loads(payload)
            value = self.device_store.get(req["oid"])
            if value is None and req["oid"] not in self.device_store:
                return wire.dumps({"status": "gone"})
            # large device->host copies must not stall the event loop
            self._ensure_pool(1)
            inband, buffers = await self.loop.run_in_executor(
                self._exec_pool, serialize, value)
            return wire.dumps({"status": "ok",
                               "blob": pack_blob(inband, buffers)})
        if method == "FreeDeviceObject":
            req = wire.loads(payload)
            freed = self.device_store.pop(req["oid"], None) is not None
            return wire.dumps({"freed": freed})
        if method == "CheckActor":
            # GCS restart recovery probe: is the given actor instantiated
            # here? (dedups in-flight creations after an init-data replay)
            req = wire.loads(payload)
            hosting = (self.actor_instance is not None
                       and self.actor_id is not None
                       and self.actor_id.binary() == req["actor_id"])
            return wire.dumps({"hosting": hosting})
        raise RpcError(f"core worker: unknown method {method}")

    async def _handle_get_owned(self, req) -> bytes:
        oid = ObjectID(req["oid"])
        deadline = time.monotonic() + req.get("timeout", 10.0)
        if req.get("lost") and self._in_store.get(oid):
            # a borrower failed to pull a copy: verify against the directory
            # and reconstruct from lineage if it is really gone
            try:
                locs = await self._gcs_call("ObjectLocGet", {"oid": oid.binary()})
            except (RpcError, asyncio.TimeoutError, OSError):
                locs = {"locations": [None]}  # can't verify: assume alive
            if not locs["locations"]:
                self._in_store.pop(oid, None)
                if not await self._recover_object(oid):
                    err = ObjectLostError(
                        f"object {oid.hex()} lost and not reconstructable")
                    return wire.dumps({"status": "error",
                                         "error": pickle.dumps(err)})
        while True:
            if oid in self.memory_store:
                value = self.memory_store[oid]
                if isinstance(value, TaskError):
                    return wire.dumps({"status": "error", "error": pickle.dumps(value)})
                return wire.dumps({"status": "value",
                                     "blob": pack_blob(*serialize(value))})
            if self._in_store.get(oid):
                return wire.dumps({"status": "in_store"})
            fut = self._ensure_result_future(oid)
            if fut is not None and not fut.done() and time.monotonic() < deadline:
                try:
                    await asyncio.wait_for(asyncio.shield(fut),
                                           deadline - time.monotonic())
                except asyncio.TimeoutError:
                    pass
                continue
            if fut is None:
                # unknown everywhere: the object was freed (refs+borrowers
                # hit zero) or never existed — error beats an eternal poll
                err = ObjectLostError(
                    f"object {oid.hex()} was freed by its owner")
                return wire.dumps({"status": "error",
                                     "error": pickle.dumps(err)})
            return wire.dumps({"status": "pending"})

    async def _handle_push_task(self, spec: TaskSpec) -> bytes:
        if spec.is_actor_creation:
            return await self._exec_actor_creation(spec)
        if spec.actor_id is not None:
            return await self._exec_actor_task(spec)
        if spec.num_returns == -1:
            return await self._exec_streaming_task(spec)
        return await self._exec_normal_task(spec)

    def _ensure_pool(self, size: int, replace: bool = False):
        from concurrent.futures import ThreadPoolExecutor

        if self._exec_pool is None or (
                replace and self._exec_pool._max_workers < size):
            # a reused worker may carry a smaller pool from its task-executing
            # past; an actor with max_concurrency needs the full width
            self._exec_pool = ThreadPoolExecutor(max_workers=size,
                                                 thread_name_prefix="ray_tpu_torch-exec")

    async def _exec_normal_task(self, spec: TaskSpec) -> bytes:
        if self.job_id.is_nil():
            self.job_id = spec.job_id
        fn = await self._fetch_function(spec.function_key)
        args, kwargs, seen_refs = await self._resolve_args(spec.args_blob)
        self._ensure_pool(1)
        t0 = time.time()
        result, err = await self.loop.run_in_executor(
            self._exec_pool, self._call_user_fn, fn, args, kwargs, spec)
        self._trace_task(spec, getattr(fn, "__name__", "task"), t0, err)
        del args, kwargs  # drop our handles before computing borrows
        return wire.dumps(await self._pack_results(
            spec, result, err, borrows=self._surviving_borrows(seen_refs)))

    async def _exec_normal_batch(self, specs: List[TaskSpec]) -> List[dict]:
        """Execute a run of plain tasks with ONE thread-pool hop. The
        per-task run_in_executor queue/GIL handoff costs ~0.5 ms on a
        small host — dominating trivial tasks — and the batch executes
        sequentially on the pool thread anyway (reference: leased workers
        run tasks serially, task_receiver.cc)."""
        if self.job_id.is_nil():
            self.job_id = specs[0].job_id
        prepared: List[tuple] = []  # (spec, fn, args, kwargs, seen) | (spec, TaskError)
        for spec in specs:
            try:
                fn = await self._fetch_function(spec.function_key)
                args, kwargs, seen = await self._resolve_args(spec.args_blob)
                prepared.append((spec, fn, args, kwargs, seen))
            except TaskError as e:
                # a PRODUCER's application error: deterministic, propagate
                # to this dependent as its own app error (no retry value)
                prepared.append((spec, e))
            # transient infra errors (object lost, owner unreachable, ...)
            # propagate and fail the whole RPC — the owner retries against
            # max_retries exactly like the unbatched path; nothing has
            # executed yet (prepare runs before _run_all), so no task
            # re-executes because of a batch-mate's infrastructure failure
        self._ensure_pool(1)

        def _run_all():
            out = []
            for i, entry in enumerate(prepared):
                if len(entry) == 2:
                    out.append(None)
                    continue
                spec, fn, args, kwargs, _seen = entry
                t0 = time.time()
                result, err = self._call_user_fn(fn, args, kwargs, spec)
                out.append((result, err, t0, time.time()))
                # drop the arg handles as each task finishes so its
                # surviving-borrow report below sees only real survivors
                prepared[i] = (spec, fn, None, None, _seen)
            return out

        outcomes = await self.loop.run_in_executor(self._exec_pool, _run_all)
        replies = []
        for entry, outcome in zip(prepared, outcomes):
            if outcome is None:
                replies.append({"status": "app_error",
                                "error": pickle.dumps(entry[1])})
                continue
            spec, fn, _a, _k, seen = entry
            result, err, t0, t1 = outcome
            self._trace_task(spec, getattr(fn, "__name__", "task"), t0, err,
                             t1=t1)
            replies.append(await self._pack_results(
                spec, result, err, borrows=self._surviving_borrows(seen)))
        return replies

    async def _exec_streaming_task(self, spec: TaskSpec) -> bytes:
        """num_returns="streaming": run the user generator, shipping each
        yield to the owner AS PRODUCED via StreamTaskReturn (awaited, so
        the stream is naturally 1-deep backpressured); the final reply
        carries the total count. Reference: the dynamic-returns generator
        protocol in task_manager.cc + generator_waiter.cc."""
        from ray_tpu_torch.exceptions import TaskCancelledError

        if self.job_id.is_nil():
            self.job_id = spec.job_id
        fn = await self._fetch_function(spec.function_key)
        args, kwargs, seen_refs = await self._resolve_args(spec.args_blob)
        self._ensure_pool(1)
        owner = self._worker_client(spec.owner_address)
        tid_b = spec.task_id.binary()
        t0 = time.time()

        def _start():
            # cancellation registration is scoped to user-code execution
            # only (here and in _step): between steps this worker thread
            # runs OTHER work, and an async-exc into an ident not running
            # this task would cancel a stranger or kill the pool thread
            if tid_b in self._cancelled_pending:
                # raylint: disable=RCE001 set ops are single-bytecode; a cancel landing between the check and the discard is re-delivered via _cancel_requested's async-exc path
                self._cancelled_pending.discard(tid_b)
                return None, TaskCancelledError(
                    "TaskCancelledError: cancelled before execution", "")
            # raylint: disable=RCE002 dict set/get are single-bytecode; CancelTask missing a not-yet-registered ident falls back to _cancelled_pending, so a stale read only defers the cancel
            self._running_tasks[tid_b] = threading.get_ident()
            token = self._obs_task_start(spec)
            try:
                return fn(*args, **kwargs), None
            except Exception as e:
                return None, TaskError(repr(e), traceback.format_exc())
            finally:
                self._obs_task_end(token)
                self._running_tasks.pop(tid_b, None)

        gen, err = await self.loop.run_in_executor(self._exec_pool, _start)
        if err is None and not hasattr(gen, "__next__"):
            err = TaskError(
                f"num_returns='streaming' task {spec.function_key[:12]} did "
                f"not return a generator (got {type(gen).__name__})", "")
        index = 0
        while err is None:
            def _step():
                if tid_b in self._cancelled_pending:
                    self._cancelled_pending.discard(tid_b)
                    return None, True, TaskCancelledError()
                self._running_tasks[tid_b] = threading.get_ident()
                token = self._install_trace(spec)
                try:
                    return next(gen), False, None
                except StopIteration:
                    return None, True, None
                except TaskCancelledError as e:
                    return None, True, e
                except Exception as e:
                    return None, True, TaskError(repr(e),
                                                 traceback.format_exc())
                finally:
                    self._obs_task_end(token)
                    self._running_tasks.pop(tid_b, None)
            value, done, err = await self.loop.run_in_executor(
                self._exec_pool, _step)
            if done:
                break
            oid = ObjectID.for_task_return(spec.task_id, index)
            inband, buffers = serialize(value)
            total = len(inband) + sum(b.nbytes for b in buffers)
            if total < RAY_CONFIG.object_inline_max_bytes:
                payload = {"task_id": tid_b, "index": index,
                           "kind": "inline", "attempt": spec.attempt,
                           "blob": pack_blob(inband, buffers)}
            else:
                await self._store_blob(oid, inband, buffers, spec.attempt,
                                       owner=spec.owner_address)
                payload = {"task_id": tid_b, "index": index,
                           "kind": "store", "attempt": spec.attempt}
            await owner.call("StreamTaskReturn", wire.dumps(payload),
                             timeout=60.0, retries=2)
            index += 1
        self._trace_task(spec, getattr(fn, "__name__", "stream"), t0, err)
        del args, kwargs, gen
        if err is not None:
            return wire.dumps({"status": "app_error",
                                 "error": pickle.dumps(err)})
        reply = await self._pack_results(
            spec, None, None, borrows=self._surviving_borrows(seen_refs))
        reply["stream_count"] = index
        return wire.dumps(reply)

    async def _exec_actor_streaming(self, spec: TaskSpec, method, args,
                                    kwargs, seen_refs) -> bytes:
        """Streaming actor method (num_returns="streaming"): same yield-by-
        yield StreamTaskReturn protocol as task generators, for sync AND
        async generator methods — async generators stream straight off the
        actor's event loop under the concurrency semaphore (the shape LLM
        token streaming needs). Reference: dynamic returns for actor tasks
        in task_manager.cc + serve's streaming replica handlers."""
        import inspect

        from ray_tpu_torch.exceptions import TaskCancelledError

        owner = self._worker_client(spec.owner_address)
        tid_b = spec.task_id.binary()
        t0 = time.time()
        index = 0
        err = None

        async def _ship(value, index):
            oid = ObjectID.for_task_return(spec.task_id, index)
            inband, buffers = serialize(value)
            total = len(inband) + sum(b.nbytes for b in buffers)
            if total < RAY_CONFIG.object_inline_max_bytes:
                payload = {"task_id": tid_b, "index": index,
                           "kind": "inline", "attempt": spec.attempt,
                           "blob": pack_blob(inband, buffers)}
            else:
                await self._store_blob(oid, inband, buffers, spec.attempt,
                                       owner=spec.owner_address)
                payload = {"task_id": tid_b, "index": index,
                           "kind": "store", "attempt": spec.attempt}
            await owner.call("StreamTaskReturn", wire.dumps(payload),
                             timeout=60.0, retries=2)

        if inspect.isasyncgenfunction(method):
            async with self._actor_sem:
                obs_token = self._obs_task_start(spec)
                try:
                    agen = method(*args, **kwargs)
                    async for value in agen:
                        if tid_b in self._cancelled_pending:
                            self._cancelled_pending.discard(tid_b)
                            err = TaskCancelledError()
                            await agen.aclose()
                            break
                        await _ship(value, index)
                        index += 1
                except TaskCancelledError as e:
                    err = e
                except Exception as e:
                    err = TaskError(repr(e), traceback.format_exc())
                finally:
                    self._obs_task_end(obs_token)
        else:
            self._ensure_pool(1)

            def _start():
                token = self._obs_task_start(spec)
                try:
                    out = method(*args, **kwargs)
                    if not hasattr(out, "__next__"):
                        return None, TaskError(
                            f"streaming actor method {spec.method_name} did "
                            f"not return a generator "
                            f"(got {type(out).__name__})", "")
                    return out, None
                except Exception as e:
                    return None, TaskError(repr(e), traceback.format_exc())
                finally:
                    self._obs_task_end(token)

            gen, err = await self.loop.run_in_executor(self._exec_pool, _start)
            while err is None:
                def _step():
                    if tid_b in self._cancelled_pending:
                        self._cancelled_pending.discard(tid_b)
                        return None, True, TaskCancelledError()
                    token = self._install_trace(spec)
                    try:
                        return next(gen), False, None
                    except StopIteration:
                        return None, True, None
                    except Exception as e:
                        return None, True, TaskError(repr(e),
                                                     traceback.format_exc())
                    finally:
                        self._obs_task_end(token)

                value, done, err = await self.loop.run_in_executor(
                    self._exec_pool, _step)
                if done:
                    break
                await _ship(value, index)
                index += 1
            del gen
        self._trace_task(spec, spec.method_name, t0, err)
        del args, kwargs
        if err is not None:
            return wire.dumps({"status": "app_error",
                               "error": pickle.dumps(err)})
        reply = await self._pack_results(
            spec, None, None, borrows=self._surviving_borrows(seen_refs))
        reply["stream_count"] = index
        return wire.dumps(reply)

    def _install_trace(self, spec: TaskSpec):
        """Install this task's span as the active trace context (so nested
        ``.remote()`` calls and ``tracing.profile()`` blocks parent onto
        it); returns a reset token, or None when tracing is off."""
        from ray_tpu_torch.util import tracing

        if not tracing.enabled() or not spec.trace_id:
            return None
        return tracing.set_context(spec.trace_id, _task_span_id(spec))

    def _obs_task_start(self, spec: TaskSpec):
        """Execution-start observability: a RUNNING lifecycle event plus
        trace-context install. Returns the trace token for _obs_task_end."""
        if task_events.enabled():
            task_events.record(
                spec.task_id.hex(), task_events.RUNNING,
                attempt=spec.attempt, job_id=spec.job_id.hex(),
                worker=self.address, node=self.node_hex,
                span_id=_task_span_id(spec))
        return self._install_trace(spec)

    def _obs_task_end(self, token):
        if token is not None:
            from ray_tpu_torch.util import tracing

            tracing.reset_context(token)

    def _trace_task(self, spec: TaskSpec, name: str, t0: float, err,
                    t1: Optional[float] = None):
        """Per-executed-task exec-latency metric (always on) + trace span
        (reference: profile_event.cc into the task event buffer); the span
        carries the task's causal ids so export_chrome_trace can draw the
        submit→execute flow arrow."""
        end = t1 if t1 is not None else time.time()
        if spec.actor_id is not None and spec.method_name:
            name = f"{type(self.actor_instance).__name__}.{spec.method_name}"                 if self.actor_instance is not None else spec.method_name
        try:
            _obs()["exec"].observe(end - t0, tags={"function": name})
        except Exception:  # raylint: disable=EXC001 metrics must never fail task execution
            pass
        from ray_tpu_torch.util import tracing

        if not tracing.enabled():
            return
        extra = {}
        if spec.trace_id:
            extra = {"trace_id": spec.trace_id,
                     "span_id": _task_span_id(spec),
                     "parent_id": spec.parent_span_id or None}
        tracing.record_span(
            name, t0, end,
            category="actor_task" if spec.actor_id is not None else "task",
            task_id=spec.task_id.hex(), ok=err is None, **extra)

    def _call_user_fn(self, fn, args, kwargs, spec: TaskSpec):
        from ray_tpu_torch.exceptions import TaskCancelledError

        tid_b = spec.task_id.binary()
        if tid_b in self._cancelled_pending:
            self._cancelled_pending.discard(tid_b)
            return None, TaskCancelledError(
                "TaskCancelledError: cancelled before execution started", "")
        self._running_tasks[tid_b] = threading.get_ident()
        self._tls.task_id = spec.task_id
        obs_token = self._obs_task_start(spec)
        try:
            result = fn(*args, **kwargs)
            if asyncio.iscoroutine(result):
                result = asyncio.run(result)
            return result, None
        except TaskCancelledError as e:
            if tid_b not in self._cancel_requested:
                # an async-exc aimed at the PREVIOUS task on this thread
                # landed late (delivery is deferred to a bytecode check):
                # this task is an innocent victim — report it as a worker-
                # side interruption the owner retries, not a cancellation
                from ray_tpu_torch.exceptions import StrayInterrupt

                logger.warning("stray cancellation landed in task %s",
                               spec.task_id.hex()[:12])
                return None, TaskError(
                    "task interrupted by a stray cancellation "
                    "(async-exc delivery race); retryable", "",
                    cause=StrayInterrupt())
            # raylint: disable=RCE001 set add/discard are single-bytecode; the cancel handshake tolerates either ordering (a late cancel is absorbed by the stray-interrupt retry path above)
            self._cancel_requested.discard(tid_b)
            return None, e
        except Exception as e:
            return None, TaskError(repr(e), traceback.format_exc())
        finally:
            self._obs_task_end(obs_token)
            self._running_tasks.pop(tid_b, None)
            self._tls.task_id = None

    async def _resolve_args(self, args_blob: bytes):
        from ray_tpu_torch.object_ref import collect_deserialized_refs

        inband, buffers = read_blob(args_blob)
        with collect_deserialized_refs() as seen_refs:
            args, kwargs = deserialize(inband, buffers)

        async def _resolve(v):
            if isinstance(v, ObjectRef):
                # task-arg pulls rank below blocked gets at the raylet's
                # pull admission (reference: pull_manager.cc classes)
                value = await self._get_one(
                    v, time.monotonic() + RAY_CONFIG.object_pull_timeout_s,
                    prio=1)
                if isinstance(value, TaskError):
                    raise value
                return await self._maybe_pull_device(
                    value, time.monotonic() + RAY_CONFIG.object_pull_timeout_s)
            return v

        args = [await _resolve(a) for a in args]
        kwargs = {k: await _resolve(v) for k, v in kwargs.items()}
        return args, kwargs, seen_refs

    def _surviving_borrows(self, seen_refs):
        """Foreign refs from the args that are still held in this process
        after execution — reported on the reply so the owner registers this
        worker as a borrower (reference: GetAndClearBorrowedRefs)."""
        # the `del args, kwargs` decrements are still queued on the __del__-
        # safe deletion queue: flush them first, or every arg ref would
        # report as still held and pin its object on the owner forever
        self.ref_counter.flush_deletes()
        out = []
        for oid, owner in {(o, w) for o, w in seen_refs}:
            if owner and owner != self.address \
                    and self.ref_counter.held_count(oid) > 0:
                out.append((oid, owner))
        return out

    async def _pack_results(self, spec: TaskSpec, result, err,
                            transport: str = "", borrows=()) -> dict:
        """Build one task's reply dict (callers pickle it, or embed it
        directly in a batch reply — no per-task double pickling)."""
        if err is not None:
            return {"status": "app_error", "error": pickle.dumps(err)}
        values: List[Any]
        if spec.num_returns <= 0:  # 0 returns, or -1 = streaming (items
            values = []            # already shipped via StreamTaskReturn)
        elif spec.num_returns == 1:
            values = [result]
        else:
            values = list(result)
            if len(values) != spec.num_returns:
                err = TaskError(
                    f"task declared num_returns={spec.num_returns} but returned "
                    f"{len(values)} values", "")
                return {"status": "app_error", "error": pickle.dumps(err)}
        from ray_tpu_torch.object_ref import collect_serialized_refs

        results = []
        nested: Dict[bytes, list] = {}
        for i, value in enumerate(values):
            oid = ObjectID.for_task_return(spec.task_id, i)
            if transport:
                # the value stays resident here; ship a small marker instead
                from ray_tpu_torch.experimental.device_objects import DeviceObjectMarker

                self.device_store[oid.binary()] = value
                value = DeviceObjectMarker(oid.binary(), self.address, transport)
            with collect_serialized_refs() as inner:
                inband, buffers = serialize(value)
            total = len(inband) + sum(b.nbytes for b in buffers)
            if total < RAY_CONFIG.object_inline_max_bytes:
                results.append(("inline", pack_blob(inband, buffers)))
                # inline values are rehydrated in the owner's memory store;
                # the live inner refs there carry the counts
            else:
                await self._store_blob(oid, inband, buffers, spec.attempt,
                                       owner=spec.owner_address)
                # the size annotation feeds the owner's per-task
                # returned-object-bytes accounting (task events)
                results.append(("store", total))
                if inner:
                    # stored blobs hold refs only as bytes: the owner must
                    # pin them for the blob's lifetime
                    nested[oid.binary()] = inner
        return {"status": "ok", "results": results,
                "borrows": list(borrows), "nested": nested}

    async def _exec_actor_creation(self, spec: TaskSpec) -> bytes:
        if self.job_id.is_nil():
            self.job_id = spec.job_id
        cls = await self._fetch_function(spec.function_key)
        args, kwargs, _seen = await self._resolve_args(spec.args_blob)
        opts = spec.actor_options
        self._ensure_pool(max(1, opts.max_concurrency), replace=True)
        self.actor_id = spec.actor_id

        def _create():
            try:
                # raylint: disable=RCE002 CheckActor tolerates a stale None (reports not-ready); task dispatch reads only after the creation reply, ordered by run_in_executor's future
                self.actor_instance = cls(*args, **kwargs)
                return None
            except Exception as e:
                return TaskError(repr(e), traceback.format_exc())

        err = await self.loop.run_in_executor(self._exec_pool, _create)
        if err is not None:
            return wire.dumps({"status": "app_error", "error": pickle.dumps(err)})
        self._actor_async = any(
            asyncio.iscoroutinefunction(getattr(self.actor_instance, n, None))
            for n in dir(self.actor_instance) if not n.startswith("__"))
        self._actor_sem = asyncio.Semaphore(max(1, opts.max_concurrency))
        return wire.dumps({"status": "ok", "results": []})

    async def _wait_for_turn(self, spec: TaskSpec):
        """Per-caller seqno ordering (reference: actor_scheduling_queue.cc):
        start tasks in submission order. A missing seqno (failed send)
        stalls successors only for a bounded grace period, after which the
        gap is ABANDONED: a predecessor arriving later is rejected as
        stale (the owner retries it under a fresh seqno) rather than
        silently executed out of order."""
        from ray_tpu_torch.exceptions import TaskError as _TaskError

        state = self._order_buf.setdefault(
            spec.owner_address, {"expected": 1, "events": {}})
        if spec.seqno < state["expected"]:
            raise _TaskError(
                f"stale actor-task seqno {spec.seqno} (queue already at "
                f"{state['expected']}): an abandoned ordering gap — "
                f"resubmit under a fresh seqno", "")
        if spec.seqno > state["expected"]:
            ev = state["events"].setdefault(spec.seqno, asyncio.Event())
            try:
                # bounded grace: a gap (lost predecessor) must not wedge
                # the queue forever
                await asyncio.wait_for(ev.wait(), timeout=30.0)
            except asyncio.TimeoutError:
                logger.warning(
                    "actor queue abandoning ordering gap before seqno %d "
                    "(predecessor lost?)", spec.seqno)
        state["expected"] = max(state["expected"], spec.seqno + 1)
        nxt = state["events"].pop(state["expected"], None)
        if nxt is not None:
            nxt.set()

    async def _run_actor_coro(self, method, args, kwargs, spec: TaskSpec):
        """Async actor method under this task's observability context: the
        RUNNING event and trace install happen inside the child task, so the
        contextvar scope dies with it and never leaks onto the loop."""
        token = self._obs_task_start(spec)
        try:
            return await method(*args, **kwargs)
        finally:
            self._obs_task_end(token)

    async def _exec_actor_task(self, spec: TaskSpec) -> bytes:
        if self.actor_instance is None:
            err = TaskError("ActorUnavailableError: actor instance not initialized", "")
            return wire.dumps({"status": "app_error", "error": pickle.dumps(err)})
        if spec.seqno > 0:
            await self._wait_for_turn(spec)
        if spec.method_name == "__rtpu_dag_loop__":
            # compiled-graph data plane: install this actor's static schedule
            # and run it on a dedicated thread — no further control-plane
            # traffic per iteration (reference: dag_node_operation.py:704)
            from ray_tpu_torch.dag.executor import DagLoopRunner

            args, kwargs, _seen = await self._resolve_args(spec.args_blob)
            try:
                runner = DagLoopRunner(self.actor_instance, args[0])
                runner.start()
                self._dag_runner = runner  # keep alive with the actor
            except Exception as e:
                err = TaskError(repr(e), traceback.format_exc())
                return wire.dumps({"status": "app_error",
                                   "error": pickle.dumps(err)})
            return wire.dumps({"status": "ok", "results": [
                ("inline", pack_blob(*serialize("started")))]})
        method = getattr(self.actor_instance, spec.method_name, None)
        if method is None:
            err = TaskError(f"AttributeError: no method {spec.method_name}", "")
            return wire.dumps({"status": "app_error", "error": pickle.dumps(err)})
        # per-call options win over the decorator; "object" forces the
        # plain object-plane return (reference: ray.method override order)
        transport = (getattr(spec, "tensor_transport", "")
                     or getattr(method, "__ray_tpu_tensor_transport__", ""))
        if transport == "object":
            transport = ""
        args, kwargs, seen_refs = await self._resolve_args(spec.args_blob)
        if spec.num_returns == -1:
            return await self._exec_actor_streaming(
                spec, method, args, kwargs, seen_refs)
        t0 = time.time()
        if asyncio.iscoroutinefunction(method):
            from ray_tpu_torch.exceptions import TaskCancelledError

            tid_b = spec.task_id.binary()
            async with self._actor_sem:
                if tid_b in self._cancelled_pending:
                    # cancelled while queued behind the concurrency cap
                    self._cancelled_pending.discard(tid_b)
                    result, err = None, TaskCancelledError(
                        "TaskCancelledError: cancelled before execution", "")
                else:
                    # run as a child task so CancelTask can .cancel() it
                    # without touching this RPC handler (reference:
                    # async-actor cooperative cancellation)
                    atask = asyncio.ensure_future(
                        self._run_actor_coro(method, args, kwargs, spec))
                    self._running_async_tasks[tid_b] = atask
                    try:
                        result, err = await atask, None
                    except asyncio.CancelledError:
                        result, err = None, TaskCancelledError()
                    except Exception as e:
                        result, err = None, TaskError(repr(e),
                                                      traceback.format_exc())
                    finally:
                        self._running_async_tasks.pop(tid_b, None)
        else:
            result, err = await self.loop.run_in_executor(
                self._exec_pool, self._call_user_fn, method, args, kwargs, spec)
        self._trace_task(spec, spec.method_name, t0, err)
        del args, kwargs  # drop our handles before computing borrows
        return wire.dumps(await self._pack_results(
            spec, result, err, transport=transport,
            borrows=self._surviving_borrows(seen_refs)))

    # ------------------------------------------------------------------
    # shutdown
    # ------------------------------------------------------------------

    def shutdown(self):
        if self._shutdown:
            return
        self._shutdown = True
        from ray_tpu_torch import object_ref as object_ref_mod

        if getattr(object_ref_mod, "_ref_counter", None) is self.ref_counter:
            object_ref_mod.set_ref_counter(None)
        try:
            from ray_tpu_torch.util import tracing

            if tracing.enabled():
                tracing.flush()
        except Exception as e:
            logger.debug("tracing flush at shutdown failed: %s", e)
        try:
            # tail-event protection: events recorded since the last flush
            # interval must not die with the process
            task_events.flush()
        except Exception as e:
            logger.debug("task-event flush at shutdown failed: %s", e)
        for fut_name in ("_obs_fut", "_sweep_fut"):
            fut = getattr(self, fut_name, None)
            if fut is not None:
                fut.cancel()

        async def _close():
            if self.server:
                await self.server.stop()
            if self.gcs:
                await self.gcs.close()
            for c in list(self._raylet_clients.values()) + list(self._worker_clients.values()):
                await c.close()
            if self.raylet:
                await self.raylet.close()

        try:
            self._run(_close(), timeout=10.0)
        except Exception as e:
            logger.debug("rpc client close at shutdown failed: %s", e)
        if self._owned_loop:
            self.loop.call_soon_threadsafe(self.loop.stop)
            if self._loop_thread:
                self._loop_thread.join(timeout=5.0)
        self.segments.clear()


# ---------------------------------------------------------------------------
# driver bootstrap
# ---------------------------------------------------------------------------


class DriverWorker(CoreWorker):
    """Driver facade: also owns the locally-started cluster, if any."""

    def __init__(self, *args, node_supervisor=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.node_supervisor = node_supervisor
        self.current_task_id = None
        self.current_actor_id = None

    def shutdown(self):
        super().shutdown()
        if self.node_supervisor is not None:
            self.node_supervisor.stop()
            self.node_supervisor = None


def connect_driver(address, num_cpus, num_gpus, resources, labels, namespace,
                   object_store_memory, log_to_driver,
                   include_dashboard=False, dashboard_port=None):
    supervisor = None
    dashboard_address = ""
    if address is None:
        from ray_tpu_torch._private.node import NodeSupervisor

        node_res = dict(resources or {})
        if num_cpus is not None:
            node_res["CPU"] = float(num_cpus)
        if num_gpus is not None:
            node_res["GPU"] = float(num_gpus)
        supervisor = NodeSupervisor(resources=node_res, labels=labels,
                                    object_store_memory=object_store_memory)
        address = supervisor.start_head()
        if include_dashboard:
            dashboard_address = supervisor.start_dashboard(port=dashboard_port)
            logger.info("dashboard at http://%s", dashboard_address)
    elif include_dashboard:
        logger.warning(
            "include_dashboard=True is ignored when connecting to an "
            "existing cluster (%s); start one on the head node with "
            "`ray-tpu start --include-dashboard` instead", address)
    worker = DriverWorker(
        gcs_address=address,
        raylet_address=None,
        node_id=None,
        is_driver=True,
        namespace=namespace,
        node_supervisor=supervisor,
    )
    worker.dashboard_address = dashboard_address
    worker.log_to_driver = bool(log_to_driver)
    worker.connect()
    return worker
