"""State API: inspect cluster state, the port of ``ray_tpu/util/state.py``
(reference: python/ray/util/state/api.py list_* :790-1304, backed by the
GCS instead of a dashboard process).

Every function the port's GCS or its KV backs is here; the per-node agent
(``get_node_stats(agent=True)``, ``profile_worker``) is the dashboard's,
``dashboard/agent.py``, hosted by the raylet and the workers."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import wire


def _state() -> Dict[str, Any]:
    from ray_tpu_torch._private import worker as worker_mod

    return worker_mod.global_worker().get_state()


def list_nodes() -> List[Dict[str, Any]]:
    return _state()["nodes"]


def list_actors(state_filter: Optional[str] = None) -> List[Dict[str, Any]]:
    actors = _state()["actors"]
    if state_filter:
        actors = [a for a in actors if a["state"] == state_filter]
    return actors


def list_jobs() -> List[Dict[str, Any]]:
    return _state()["jobs"]


def list_placement_groups() -> List[Dict[str, Any]]:
    return _state()["pgs"]


def _core():
    from ray_tpu_torch._private import worker as worker_mod

    return worker_mod.global_worker()


def list_tasks(job_id: Optional[str] = None, name: Optional[str] = None,
               state_filter: Optional[str] = None,
               limit: int = 200) -> List[Dict[str, Any]]:
    """Task lifecycle records from the GCS task manager (reference:
    ``ray list tasks`` backed by GcsTaskManager). Each record carries the
    full timestamped state-transition history (SUBMITTED →
    LEASE_REQUESTED → SCHEDULED → RUNNING → FINISHED/FAILED, plus RETRYING
    entries with attempt count and error summary)."""
    core = _core()
    if getattr(core, "mode", "") == "local":
        return []  # local mode executes inline; there is no lifecycle
    return core._run(core._gcs_call("ListTasks", {
        "job_id": job_id, "name": name, "state": state_filter,
        "limit": limit}), 30.0)["tasks"]


def get_task(task_id: str) -> Optional[Dict[str, Any]]:
    """One task's lifecycle record by hex task id (``ray get tasks``)."""
    core = _core()
    if getattr(core, "mode", "") == "local":
        return None
    return core._run(core._gcs_call("GetTask", {"task_id": task_id}),
                     30.0)["task"]


def summarize_tasks(job_id: Optional[str] = None) -> Dict[str, Any]:
    """Per-function counts by lifecycle state — the ``ray summary tasks``
    analog. Includes per-function object-size accounting
    (``per_function_bytes``: summed serialized arg bytes from SUBMITTED
    events and returned-object bytes from terminal events) and the
    GCS-side drop counters so ring truncation is visible."""
    core = _core()
    if getattr(core, "mode", "") == "local":
        return {"per_function": {}, "per_function_bytes": {}, "total": 0,
                "dropped": {}}
    return core._run(core._gcs_call("SummarizeTasks", {"job_id": job_id}),
                     30.0)


def metrics_history(name: Optional[str] = None,
                    window_s: Optional[float] = None,
                    tier: str = "auto") -> Any:
    """Metric time-series from the GCS history ring (reference surface:
    the dashboard's ``/api/metrics/history``). Without ``name``, returns
    the list of recorded metric names. With it, returns ``{"name",
    "kind", "tier", "interval_s", "points"}`` — ``tier="raw"`` is the
    fine ring (default 5 s cadence), ``"rollup"`` the coarse one (default
    60 s: avg/min/max for gauges, cumulative + rate for counters and
    histograms), ``"auto"`` picks raw while the window fits in it."""
    core = _core()
    if not name:
        return core._run(core._gcs_call("GetMetricsHistory", {}),
                         30.0)["names"]
    return core._run(core._gcs_call("GetMetricsHistory", {
        "name": name, "window_s": window_s, "tier": tier}), 30.0)["history"]


def cluster_health(scan: bool = False) -> Dict[str, Any]:
    """Latest cluster-health report from the GCS monitor: stuck tasks
    (RUNNING far past the per-function p99), straggler raylets
    (lease-queue/loop-lag outliers, lagging heartbeats), and
    provisioning-pool pathology (dead zygote, starved warm pool).
    ``scan=True`` forces a scan now instead of returning the last
    periodic one (``health_scan_interval_s``)."""
    core = _core()
    return core._run(core._gcs_call("GetClusterHealth", {"scan": scan}),
                     60.0)["health"]


def goodput(job: Optional[str] = None) -> Dict[str, Any]:
    """Per-job goodput ledgers from the GCS (``/api/goodput`` surface):
    cumulative wall-clock attribution buckets (``step_compute``,
    ``collective_wait``, ``input_stall``, ``ckpt_pause``, ``compile``,
    ``reform_downtime``, ``bubble``, ``overhead``, ``idle``) summed over
    the job's processes, plus counters (steps, compiles, RE-compiles,
    ckpt saves, reforms) and the derived ``goodput_fraction``
    (step_compute share of wall). ``job`` filters to one run name."""
    core = _core()
    req: Dict[str, Any] = {}
    if job:
        req["job"] = job
    return core._run(core._gcs_call("GetGoodput", req), 30.0)["jobs"]


def get_timeline(job_id: Optional[str] = None,
                 start_ts: Optional[float] = None,
                 end_ts: Optional[float] = None,
                 spans: bool = True, limit: int = 5000) -> Dict[str, Any]:
    """Perfetto-loadable chrome-trace JSON of the task flow graph from the
    GCS task-event ring (+ built-in spans) — the ``/api/timeline``
    surface, callable from a driver. Dump it with ``json.dump`` and open
    in ui.perfetto.dev."""
    core = _core()
    req: Dict[str, Any] = {"job_id": job_id, "spans": spans, "limit": limit}
    if start_ts is not None:
        req["start_ts"] = start_ts
    if end_ts is not None:
        req["end_ts"] = end_ts
    return core._run(core._gcs_call("GetTimeline", req), 60.0)


def get_node_stats(node_address: str, agent: bool = False) -> Dict[str, Any]:
    """Raylet-side stats; agent=True adds the per-node agent sample (node
    cpu/mem/load + per-worker cpu/rss, reference: dashboard
    modules/reporter)."""
    from ray_tpu_torch._private import worker as worker_mod

    core = worker_mod.global_worker()
    client = core._raylet_client(node_address)

    async def _call():
        return wire.loads(await client.call(
            "GetNodeStats", wire.dumps({"agent": agent}), timeout=30.0))

    return core._run(_call())


def profile_worker(node_address: str, pid: int, kind: str = "stacks",
                   **args) -> Dict[str, Any]:
    """Profile one worker process on a node (reference: `ray stack` /
    dashboard py-spy + memray integration). kind="stacks" samples folded
    call stacks; kind="memory" drives the tracemalloc profiler with
    args={"action": "start"|"snapshot"|"stop", ...}."""
    from ray_tpu_torch._private import worker as worker_mod

    core = worker_mod.global_worker()
    client = core._raylet_client(node_address)
    timeout = float(args.pop("timeout", 60.0))

    async def _call():
        return wire.loads(await client.call("ProfileWorker", wire.dumps({
            "pid": pid, "kind": kind, "args": args, "timeout": timeout,
        }), timeout=timeout + 10.0))

    return core._run(_call(), timeout + 15.0)


def list_dataset_stats() -> List[Dict[str, Any]]:
    """Per-op runtime metrics of recent Dataset executions (reference:
    data stats surfaced in the dashboard; populated by
    Dataset._publish_stats via GCS KV ns="data_stats")."""
    from ray_tpu_torch._private import worker as worker_mod

    core = worker_mod.global_worker()
    keys = core._run(core._gcs_call(
        "KVKeys", {"ns": "data_stats", "prefix": ""}))["keys"]
    out = []
    for k in keys:
        blob = core._run(core._gcs_call(
            "KVGet", {"ns": "data_stats", "key": k}))["value"]
        if blob is not None:
            entry = wire.loads(blob)
            entry["dataset"] = k
            out.append(entry)
    out.sort(key=lambda e: e.get("ts", 0))
    return out


def _kv_namespace_dump(ns: str) -> Dict[str, Any]:
    """All wire-decoded values of one GCS KV namespace, keyed by KV key —
    the shared read shape of every stats mirror (weights, ckpt, workers,
    ...). One batched KVMultiGet, not a round trip per key."""
    core = _core()
    keys = core._run(core._gcs_call(
        "KVKeys", {"ns": ns, "prefix": ""}), 30.0)["keys"]
    values = core._run(core._gcs_call(
        "KVMultiGet", {"ns": ns, "keys": keys}), 30.0)["values"]
    return {k: wire.loads(blob) for k, blob in values.items()
            if blob is not None}


def list_weight_stores() -> Dict[str, Any]:
    """Weight-plane transfer stats per store (reference surface: the
    dashboard's /api/weights): per-version bytes published/pulled, chunk
    counts, commit timestamps — mirrored to GCS KV ns="weights" by
    WeightStoreActor (ray_tpu_torch/weights/store.py) on every commit/pull."""
    return _kv_namespace_dump("weights")


def list_checkpoints() -> Dict[str, Any]:
    """Checkpoint-plane stores registered with the GCS (reference surface:
    the dashboard's /api/checkpoints): per-store latest/pinned checkpoint
    ids, per-checkpoint step/bytes/dedup stats, retention drop counters
    and — for tiered stores (ray_tpu_torch/ckpt/tier) — per-checkpoint
    residency (local/mirroring/remote/evicted), the remote backend
    descriptor and mirror IO counters. Mirrored to GCS KV ns="ckpt" by
    CheckpointStore/TieredStore on every commit/pin/retention/mirror."""
    return _kv_namespace_dump("ckpt")


def ckpt_sweeps() -> Dict[str, Any]:
    """Latest per-store retention-sweep reports from the GCS-side
    checkpoint sweeper (ns="ckpt_sweep"): dropped manifest/chunk/byte
    counts per tier, the applied policy, and errors. Populated every
    ``ckpt_sweep_interval_s`` for stores that registered a sweep policy."""
    return _kv_namespace_dump("ckpt_sweep")


def serve_state() -> Dict[str, Any]:
    """Serve autoscale plane per deployment (reference surface: the
    dashboard's /api/serve): replica target vs live count, windowed rate
    rollup (arrival rate, queue p99, execute mean), registered SLO
    targets and recent scale transitions — mirrored to GCS KV ns="serve"
    by the serve controller every autoscale tick
    (ray_tpu_torch/serve/api.py _publish_autoscale)."""
    return _kv_namespace_dump("serve")


def list_worker_pools() -> Dict[str, Any]:
    """Per-raylet worker-pool / provisioning-plane stats (reference
    surface: the dashboard's /api/workers): zygote liveness, warm-pool
    size, adoption hit/miss and fork/cold-spawn counters — mirrored to
    GCS KV ns="workers" by each raylet's metrics loop."""
    return _kv_namespace_dump("workers")


def summarize_cluster() -> Dict[str, Any]:
    state = _state()
    actors_by_state: Dict[str, int] = {}
    for a in state["actors"]:
        actors_by_state[a["state"]] = actors_by_state.get(a["state"], 0) + 1
    return {
        "num_nodes": sum(1 for n in state["nodes"] if n["alive"]),
        "num_actors": len(state["actors"]),
        "actors_by_state": actors_by_state,
        "num_jobs": len(state["jobs"]),
        "num_placement_groups": len(state["pgs"]),
        "uptime_s": state.get("uptime_s", 0.0),
    }
