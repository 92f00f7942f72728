"""The port's cluster health plane, a mirror of ``tests/test_health_plane.py``
on ``ray_tpu_torch``: metrics time-series history (two downsample tiers),
the GCS task timeline (Perfetto golden), the stuck/straggler health
monitor, built-in hot-path spans (train step + serve request with ZERO
manual instrumentation), obs fork-safety, and the off-loop task-event read
handoff, the dashboard's ``/metrics``, ``/api/timeline``, ``/api/health``
(with the CLI's ``health``) and ``/api/metrics/history``."""

import asyncio
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

import ray_tpu_torch
from ray_tpu_torch._private import task_events
from ray_tpu_torch.util import state, tracing

# fast cadences for the cluster-backed tests: both history tiers fill and
# the health monitor scans within seconds (must be set before the fixture
# spawns the GCS — children inherit the env)
_FAST_ENV = {
    "RAY_TPU_ENABLE_TRACING": "1",
    "RAY_TPU_METRICS_HISTORY_INTERVAL_S": "0.5",
    "RAY_TPU_METRICS_HISTORY_ROLLUP_S": "2.0",
    "RAY_TPU_HEALTH_SCAN_INTERVAL_S": "1.0",
    "RAY_TPU_METRICS_FLUSH_INTERVAL_S": "2.0",
}


@pytest.fixture(scope="module")
def health_cluster():
    ray_tpu_torch.shutdown()
    old = {k: os.environ.get(k) for k in _FAST_ENV}
    os.environ.update(_FAST_ENV)
    tracing._enabled = None  # re-read the flag
    worker = ray_tpu_torch.init(num_cpus=4, include_dashboard=True,
                                device="cpu")
    yield worker
    ray_tpu_torch.shutdown()
    for k, v in old.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    tracing._enabled = None


def _wait_for(predicate, timeout=30, interval=0.5):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = predicate()
        if out:
            return out
        time.sleep(interval)
    return predicate()


def _http_json(address, path):
    with urllib.request.urlopen(f"http://{address}{path}", timeout=30) as r:
        return json.loads(r.read().decode())


def _payload(t, node, metrics):
    return {"pid": 1, "time": t, "node": node, "metrics": metrics}


def test_metrics_history_two_tiers_and_rollup():
    from ray_tpu_torch._private.gcs import MetricsHistory

    h = MetricsHistory(raw_interval_s=5.0, raw_points=8,
                       rollup_interval_s=60.0, rollup_points=4)
    t0 = time.time()
    for i in range(25):
        t = t0 + i * 5
        h.observe_payload("procA", _payload(t, "n1", {
            "ray_tpu_g": {"kind": "gauge", "description": "d",
                          "data": {"{}": float(i)}},
            "ray_tpu_c": {"kind": "counter", "description": "d",
                          "data": {"{}": 10.0 * i}},
            "ray_tpu_h": {"kind": "histogram", "description": "d",
                          "data": {"counts": {"{}": [i, 2 * i, 0]},
                                   "sums": {"{}": 0.5 * i},
                                   "boundaries": [0.1, 1.0]}},
        }))
        # a second process contributes too: gauges sum across processes
        h.observe_payload("procB", _payload(t, "n2", {
            "ray_tpu_g": {"kind": "gauge", "description": "d",
                          "data": {"{}": 100.0}}}))
        h.sample(now=t)

    # raw tier: bounded ring at the 5 s cadence
    raw = h.series("ray_tpu_g", tier="raw", now=t0 + 24 * 5)
    assert raw["tier"] == "raw" and raw["interval_s"] == 5.0
    assert len(raw["points"]) == 8  # ring bound
    assert raw["points"][-1]["value"] == 24.0 + 100.0  # cross-process sum
    assert raw["points"][-1]["max"] == 100.0

    # rollup tier: avg/min/max over the raw points of each 60 s window
    roll = h.series("ray_tpu_g", tier="rollup", now=t0 + 24 * 5)
    assert roll["tier"] == "rollup" and roll["interval_s"] == 60.0
    assert len(roll["points"]) >= 2
    last = roll["points"][-1]
    # last rollup at t0+120 over the raw points still in the 8-deep ring
    # AND inside the 60 s window: samples i=17..24 -> values 117..124
    contributing = [i + 100.0 for i in range(17, 25)]
    assert last["value"] == pytest.approx(sum(contributing)
                                          / len(contributing))
    assert last["min"] == pytest.approx(min(contributing))

    # counters: cumulative last + rate; histograms keep bucket vectors
    c_last = h.series("ray_tpu_c", tier="rollup")["points"][-1]
    assert c_last["value"] == 240.0
    assert c_last["rate"] == pytest.approx(10.0 / 5.0)  # +10 every 5 s
    h_last = h.series("ray_tpu_h", tier="rollup")["points"][-1]
    assert h_last["count"] == 24 + 48
    assert h_last["buckets"] == [24, 48, 0]
    assert h_last["boundaries"] == [0.1, 1.0]
    assert set(h.names()) == {"ray_tpu_c", "ray_tpu_g", "ray_tpu_h"}

    # auto tier: a window wider than the raw ring escalates to rollup
    assert h.series("ray_tpu_g", window_s=30.0)["tier"] == "raw"
    assert h.series("ray_tpu_g", window_s=3600.0)["tier"] == "rollup"


def test_metrics_history_stale_process_pruned():
    from ray_tpu_torch._private.gcs import MetricsHistory

    h = MetricsHistory(raw_interval_s=5.0, raw_points=8,
                       rollup_interval_s=60.0, rollup_points=4)
    now = time.time()
    h.observe_payload("dead", _payload(now - 600, "n1", {
        "ray_tpu_g": {"kind": "gauge", "description": "d",
                      "data": {"{}": 7.0}}}))
    h.sample(now=now)
    assert h.series("ray_tpu_g", tier="raw")["points"] == []
    assert h.latest_by_node("ray_tpu_g") == {}


# ---------------------------------------------------------------------------
# timeline golden (unit)
# ---------------------------------------------------------------------------


def _mk_records():
    from ray_tpu_torch._private.gcs import GcsTaskManager

    mgr = GcsTaskManager(max_per_job=64)
    t0 = 1000.0
    mgr.add_events([
        {"task_id": "p1", "job_id": "j", "state": "SUBMITTED", "ts": t0,
         "name": "parent_fn", "span_id": "spanP"},
        {"task_id": "p1", "job_id": "j", "state": "RUNNING", "ts": t0 + 0.2,
         "worker": "w1", "node": "nodeA", "span_id": "spanP"},
        {"task_id": "c1", "job_id": "j", "state": "SUBMITTED",
         "ts": t0 + 0.3, "name": "child_fn", "span_id": "spanC",
         "parent_span": "spanP"},
        {"task_id": "c1", "job_id": "j", "state": "RUNNING", "ts": t0 + 0.5,
         "worker": "w2", "node": "nodeB"},
        {"task_id": "c1", "job_id": "j", "state": "FINISHED", "ts": t0 + 0.9},
        {"task_id": "p1", "job_id": "j", "state": "FINISHED", "ts": t0 + 1.0},
        # an old task outside the query window
        {"task_id": "old", "job_id": "j", "state": "FINISHED", "ts": 10.0,
         "name": "ancient"},
    ])
    return mgr.list_tasks(limit=100)


def test_build_timeline_golden_perfetto():
    from ray_tpu_torch._private.gcs import build_timeline

    trace = build_timeline(_mk_records(), spans=[
        {"name": "train.step", "cat": "train", "ts": 1000.4, "dur": 0.1,
         "pid": 42, "tid": 7, "span_id": "s1"}])
    # Perfetto golden: round-trips through JSON with a traceEvents list
    trace = json.loads(json.dumps(trace))
    events = trace["traceEvents"]
    assert isinstance(events, list) and events

    slices = [e for e in events if e.get("ph") == "X"]
    for e in slices:  # chrome-trace required slice keys
        assert {"name", "ph", "ts", "pid", "tid", "dur"} <= set(e)
    names = {e["name"] for e in slices}
    assert {"parent_fn", "child_fn", "pending:child_fn",
            "train.step"} <= names

    # track metadata: one process per node, threads named per worker
    procs = [e for e in events if e.get("name") == "process_name"]
    assert {p["args"]["name"] for p in procs} >= {"node:nodeA", "node:nodeB"}

    # flow arrows: the parent->child task edge renders as a matched
    # s/f pair binding inside the parent slice
    starts = [e for e in events if e.get("ph") == "s"]
    finishes = [e for e in events if e.get("ph") == "f"]
    assert {e["id"] for e in starts} == {e["id"] for e in finishes}
    assert len(starts) >= 1
    parent_slice = next(e for e in slices if e["name"] == "parent_fn")
    s0 = starts[0]
    assert parent_slice["ts"] <= s0["ts"] <= \
        parent_slice["ts"] + parent_slice["dur"]

    # time-window filter drops the ancient task but keeps the fresh pair
    windowed = build_timeline(_mk_records(), start_ts=999.0, end_ts=1002.0)
    wnames = {e["name"] for e in windowed["traceEvents"]
              if e.get("ph") == "X"}
    assert "ancient" not in wnames and "parent_fn" in wnames


# ---------------------------------------------------------------------------
# health monitor (unit, against a bare GcsServer)
# ---------------------------------------------------------------------------


def test_health_scan_flags_stuck_straggler_and_pool():
    from ray_tpu_torch._private import wire
    from ray_tpu_torch._private.gcs import GcsServer

    gcs = GcsServer()
    now = time.time()
    # per-function history: 5 quick FINISHED runs of stuck_fn, then one
    # RUNNING for 120 s (>> p99 and the 30 s floor)
    events = []
    for i in range(5):
        t = now - 300 + i
        events += [
            {"task_id": f"ok{i}", "job_id": "j", "state": "RUNNING",
             "ts": t, "name": "stuck_fn"},
            {"task_id": f"ok{i}", "job_id": "j", "state": "FINISHED",
             "ts": t + 0.1, "name": "stuck_fn"},
        ]
    events.append({"task_id": "victim", "job_id": "j", "state": "RUNNING",
                   "ts": now - 120, "name": "stuck_fn", "node": "nodeX",
                   "worker": "w9"})
    # a fresh RUNNING task must NOT be flagged
    events.append({"task_id": "fresh", "job_id": "j", "state": "RUNNING",
                   "ts": now - 1, "name": "stuck_fn"})
    gcs.task_manager.ingest(events)

    # straggler: node n3's lease queue is an outlier vs the median
    for node, depth in (("n1", 0.0), ("n2", 1.0), ("n3", 50.0)):
        gcs.metrics_history.observe_payload(f"raylet_{node}", _payload(
            now, node, {"ray_tpu_raylet_lease_queue_depth": {
                "kind": "gauge", "description": "d",
                "data": {"{}": depth}}}))

    # provisioning pathology: a dead zygote and a starved warm pool
    gcs.kv[("workers", "raylet_n4")] = wire.dumps(
        {"node": "n4", "time": now,
         "pool": {"enabled": True, "zygote_alive": False,
                  "zygote_restarts": 3}})
    gcs.kv[("workers", "raylet_n5")] = wire.dumps(
        {"node": "n5", "time": now,
         "pool": {"enabled": True, "zygote_alive": True, "warm_target": 2,
                  "warm_default_env": 0, "misses": 10}})

    report = asyncio.run(gcs._health_scan())
    gcs.task_manager.stop()

    kinds = {}
    for f in report["findings"]:
        kinds.setdefault(f["kind"], []).append(f)
    assert report["status"] == "error"  # dead zygote is an error
    stuck = kinds["stuck_task"]
    assert [f["task_id"] for f in stuck] == ["victim"]
    assert stuck[0]["age_s"] > stuck[0]["threshold_s"]
    assert stuck[0]["p99_s"] == pytest.approx(0.1, abs=0.05)
    stragglers = kinds["straggler_node"]
    assert [f["node"] for f in stragglers] == ["n3"]
    assert stragglers[0]["metric"] == "ray_tpu_raylet_lease_queue_depth"
    assert [f["node"] for f in kinds["dead_zygote"]] == ["n4"]
    assert [f["node"] for f in kinds["pool_starvation"]] == ["n5"]


def test_health_warnings_are_rate_limited(caplog):
    import logging

    from ray_tpu_torch._private.gcs import GcsServer

    gcs = GcsServer()
    now = time.time()
    gcs.task_manager.ingest([
        {"task_id": "victim", "job_id": "j", "state": "RUNNING",
         "ts": now - 10_000, "name": "lonely_fn"}])
    with caplog.at_level(logging.WARNING, logger="ray_tpu_torch.gcs"):
        asyncio.run(gcs._health_scan())
        asyncio.run(gcs._health_scan())  # same finding, inside the window
    gcs.task_manager.stop()
    warned = [r for r in caplog.records if "stuck_task" in r.getMessage()]
    assert len(warned) == 1  # once per health_warn_interval_s, not per scan


# ---------------------------------------------------------------------------
# task-event read handoff runs off the event loop (unit)
# ---------------------------------------------------------------------------


def test_read_handoff_merges_and_runs_off_loop():
    from ray_tpu_torch._private.gcs import ShardedTaskEvents

    tm = ShardedTaskEvents(nshards=4)
    tm.ingest([{"task_id": f"t{i:04x}", "job_id": "j", "state": "FINISHED",
                "ts": float(i), "name": "fn"} for i in range(500)])

    async def main():
        loop_thread = threading.get_ident()
        seen = {}

        def closure(t):
            seen["thread"] = threading.get_ident()
            return t.summarize()

        summ = await tm.read(closure)
        return loop_thread, seen["thread"], summ

    loop_thread, merge_thread, summ = asyncio.run(main())
    tm.stop()
    assert merge_thread != loop_thread  # query ran on the merge thread
    assert summ["total"] == 500  # read-your-writes: everything enqueued


# ---------------------------------------------------------------------------
# fork safety (unit): a forked worker never re-emits inherited buffers
# ---------------------------------------------------------------------------


@pytest.mark.skipif(not hasattr(os, "fork"), reason="fork-less platform")
def test_fork_resets_inherited_obs_buffers():
    from ray_tpu_torch.util.metrics import Counter

    task_events.set_enabled(True)
    task_events.record("deadbeef", task_events.SUBMITTED, name="fork_probe")
    old_enabled = tracing._enabled
    tracing._enabled = True
    tracing.record_span("fork_parent_span", time.time(), time.time())
    old_tag = tracing._proc_tag
    counter = Counter("ray_tpu_fork_probe_total", "fork-safety probe")
    counter.inc(5)

    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:  # child: the zygote fork path's reset, then introspect
        code = 1
        try:
            os.close(r)
            from ray_tpu_torch._private.worker_main import (
                reset_observability_after_fork)

            reset_observability_after_fork()
            events, dropped = task_events.drain()
            with tracing._lock:
                n_spans = len(tracing._buffer)
            os.write(w, json.dumps({
                "events": len(events), "dropped": dropped,
                "spans": n_spans,
                "tag_changed": tracing._proc_tag != old_tag,
                "counter": sum(counter.snapshot().values()),
            }).encode())
            code = 0
        finally:
            os._exit(code)
    os.close(w)
    try:
        chunks = b""
        while True:
            chunk = os.read(r, 65536)
            if not chunk:
                break
            chunks += chunk
        _, status = os.waitpid(pid, 0)
        assert os.waitstatus_to_exitcode(status) == 0
        out = json.loads(chunks.decode())
        # the child re-emits NOTHING of the parent's buffers, and flushes
        # under its own proc tag (no clobbering the parent's GCS keys)
        assert out == {"events": 0, "dropped": 0, "spans": 0,
                       "tag_changed": True, "counter": 0}
        # the parent's buffers are untouched
        events, _ = task_events.drain()
        assert [e["task_id"] for e in events] == ["deadbeef"]
    finally:
        os.close(r)
        tracing._enabled = old_enabled
        task_events.set_enabled(None)
        with tracing._lock:
            tracing._buffer.clear()


# ---------------------------------------------------------------------------
# cluster: built-in hot-path spans (the acceptance tier-1 test)
# ---------------------------------------------------------------------------


def test_train_and_serve_builtin_spans(health_cluster, tmp_path):
    """One train step + one serve request, ZERO manual instrumentation:
    the built-in spans and histograms must land in /metrics and the
    chrome trace."""
    tracing.clear()

    # --- one REAL train step through the library path ---
    import numpy as np

    from ray_tpu_torch.models import CONFIGS
    from ray_tpu_torch.parallel import TrainStepBundle

    bundle = TrainStepBundle(CONFIGS["tiny"], device="cpu")
    params, opt_state = bundle.init(0)
    batch = bundle.make_batch(np.random.default_rng(0), 2, 64)
    params, opt_state, loss = bundle.step(params, opt_state, batch)
    assert float(loss) > 0

    # --- one REAL serve request through a handle ---
    from ray_tpu_torch import serve

    @serve.deployment(name="span_echo", num_replicas=1)
    class Echo:
        def __call__(self, x):
            return x * 2

    handle = serve.run(Echo.bind(), name="span_echo")
    assert ray_tpu_torch.get(handle.remote(21), timeout=120) == 42

    # spans: train phases from this process, serve phases cluster-wide
    def _spans():
        spans = tracing.get_spans()
        names = {s["name"] for s in spans}
        want = {"train.step", "train.fwd_bwd", "train.optimizer",
                "serve.route", "serve.queue", "serve.execute"}
        return spans if want <= names else None

    spans = _wait_for(_spans, timeout=30)
    assert spans is not None, {s["name"] for s in tracing.get_spans()}
    by_name = {s["name"]: s for s in spans}
    # the phase spans tree up under train.step
    assert by_name["train.fwd_bwd"]["parent_id"] == \
        by_name["train.step"]["span_id"]

    # chrome trace: the built-in spans render as slices
    out = str(tmp_path / "trace.json")
    tracing.export_chrome_trace(out)
    names = {e["name"] for e in json.load(open(out))["traceEvents"]}
    assert {"train.step", "serve.execute"} <= names

    # /metrics: the built-in histograms ship via the auto-flush loops
    # (train histograms live in THIS driver process: force one publish
    # instead of waiting out the flush interval)
    from ray_tpu_torch.util.metrics import publish_metrics

    publish_metrics()
    address = health_cluster.node_supervisor.dashboard_address

    def _metrics():
        with urllib.request.urlopen(f"http://{address}/metrics",
                                    timeout=30) as r:
            body = r.read().decode()
        want = ("ray_tpu_train_step_seconds_bucket",
                "ray_tpu_train_fwd_bwd_seconds_count",
                "ray_tpu_serve_execute_seconds_bucket",
                "ray_tpu_serve_queue_seconds_count",
                "ray_tpu_serve_requests")
        return body if all(w in body for w in want) else None

    body = _wait_for(_metrics, timeout=40)
    assert body is not None, "built-in hot-path histograms missing"

    # /api/timeline: the same spans and the task slices in ONE trace
    def _timeline():
        trace = _http_json(address, "/api/timeline")
        names = {e["name"] for e in trace["traceEvents"]}
        return trace if "train.step" in names else None

    trace = _wait_for(_timeline, timeout=30)
    assert trace is not None
    events = trace["traceEvents"]
    assert any(e.get("cat") == "task" for e in events)  # task slices
    serve.shutdown()


# ---------------------------------------------------------------------------
# cluster: health endpoint + CLI flag injected pathologies
# ---------------------------------------------------------------------------


def test_health_endpoint_and_cli_flag_injected_pathology(health_cluster):
    from ray_tpu_torch._private import worker as worker_mod

    core = worker_mod.global_worker()
    now = time.time()
    events = []
    for i in range(5):
        t = now - 300 + i
        events += [
            {"task_id": f"hok{i:02d}", "job_id": "healthj",
             "state": "RUNNING", "ts": t, "name": "inject_stuck_fn"},
            {"task_id": f"hok{i:02d}", "job_id": "healthj",
             "state": "FINISHED", "ts": t + 0.1, "name": "inject_stuck_fn"},
        ]
    events.append({"task_id": "hvictim", "job_id": "healthj",
                   "state": "RUNNING", "ts": now - 300,
                   "name": "inject_stuck_fn", "node": "nodeS"})
    core._run(core._gcs_call("AddTaskEvents", {"events": events}))

    # straggler raylet: synthetic per-node metric snapshots (one outlier)
    from ray_tpu_torch._private import wire

    for node, lag in (("fakeA", 0.01), ("fakeB", 0.02), ("fakeC", 9.0)):
        core._run(core._gcs_call("KVPut", {
            "ns": "metrics", "key": f"proc_fake_{node}",
            "value": wire.dumps(_payload(time.time(), node, {
                "ray_tpu_raylet_loop_lag_seconds": {
                    "kind": "gauge", "description": "d",
                    "data": {"{}": lag}}}))}))

    address = health_cluster.node_supervisor.dashboard_address
    # flagged within one scan interval (1 s here); ?scan=1 forces one NOW
    health = _http_json(address, "/api/health?scan=1")
    kinds = {f["kind"]: f for f in health["findings"]}
    assert health["status"] in ("warning", "error")
    assert "stuck_task" in kinds, health
    assert kinds["stuck_task"]["name"] == "inject_stuck_fn"
    assert "straggler_node" in kinds, health
    assert kinds["straggler_node"]["node"] == "fakeC"

    # the periodic scanner also picks it up without ?scan (one interval)
    periodic = _wait_for(
        lambda: (lambda h: h if h["findings"] else None)(
            _http_json(address, "/api/health")), timeout=15)
    assert periodic and periodic["scan_count"] >= 1

    # util.state surface
    health2 = state.cluster_health()
    assert any(f["kind"] == "stuck_task" for f in health2["findings"])

    # ray-tpu health CLI (a real subprocess driver)
    gcs_address = health_cluster.node_supervisor.gcs_address
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "--address",
         gcs_address, "health", "--scan"],
        capture_output=True, text=True, timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "stuck_task" in out.stdout
    assert "straggler_node" in out.stdout


# ---------------------------------------------------------------------------
# cluster: metrics history endpoint serves both tiers
# ---------------------------------------------------------------------------


def test_metrics_history_endpoint_two_tiers(health_cluster):
    address = health_cluster.node_supervisor.dashboard_address

    # raylet gauges flush every 2 s here; the 0.5 s sampler then has
    # points, and the 2 s rollup tier fills shortly after
    def _names():
        names = _http_json(address, "/api/metrics/history")
        return names if "ray_tpu_raylet_lease_queue_depth" in names else None

    assert _wait_for(_names, timeout=40), "no metric names recorded"

    def _raw():
        h = _http_json(
            address, "/api/metrics/history"
                     "?name=ray_tpu_raylet_lease_queue_depth&tier=raw")
        return h if len(h["points"]) >= 2 else None

    raw = _wait_for(_raw, timeout=30)
    assert raw and raw["tier"] == "raw"
    assert all("value" in p and "ts" in p for p in raw["points"])

    def _rollup():
        h = _http_json(
            address, "/api/metrics/history"
                     "?name=ray_tpu_raylet_lease_queue_depth&tier=rollup")
        return h if h["points"] else None

    roll = _wait_for(_rollup, timeout=30)
    assert roll and roll["tier"] == "rollup"
    assert {"value", "min", "max", "n_raw"} <= set(roll["points"][-1])

    # the window parameter picks the tier automatically
    auto = _http_json(
        address, "/api/metrics/history"
                 "?name=ray_tpu_raylet_lease_queue_depth&window=86400")
    assert auto["tier"] == "rollup"

    # util.state surface reads the same series
    assert "ray_tpu_raylet_lease_queue_depth" in state.metrics_history()
    s = state.metrics_history("ray_tpu_raylet_lease_queue_depth",
                              tier="raw")
    assert s["points"]
