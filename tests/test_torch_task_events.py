"""The port's task-event pipeline and causal tracing, a mirror of
``tests/test_task_events.py`` on ``ray_tpu_torch`` (reference tier:
task_event_buffer.cc -> GcsTaskManager -> `ray summary tasks`;
trace-context propagation through the TaskSpec), and a worker's spans
shipped to the GCS: the driver's ``get_spans()`` and the GCS timeline hold
an actor's span; the always-on metrics flusher read through the
dashboard's ``/metrics``, and its ``/api/tasks`` endpoints."""

import json
import os
import time
import urllib.request

import pytest

import ray_tpu_torch
from ray_tpu_torch.util import state, tracing


@pytest.fixture(scope="module")
def traced_cluster():
    ray_tpu_torch.shutdown()
    os.environ["RAY_TPU_ENABLE_TRACING"] = "1"
    tracing._enabled = None  # re-read the flag
    worker = ray_tpu_torch.init(num_cpus=4, include_dashboard=True,
                                device="cpu")
    yield worker
    ray_tpu_torch.shutdown()
    os.environ.pop("RAY_TPU_ENABLE_TRACING", None)
    tracing._enabled = None


def _wait_for(predicate, timeout=30, interval=0.5):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = predicate()
        if out:
            return out
        time.sleep(interval)
    return predicate()


# ---------------------------------------------------------------------------
# lifecycle golden
# ---------------------------------------------------------------------------


def test_lifecycle_states_recorded(traced_cluster):
    @ray_tpu_torch.remote
    def lifecycle_probe(x):
        return x + 1

    assert ray_tpu_torch.get(lifecycle_probe.remote(1), timeout=60) == 2

    def _done():
        # owner-side (FINISHED) and executor-side (RUNNING) events flush
        # independently: wait for the fully-merged record
        recs = [t for t in state.list_tasks(name="lifecycle_probe")
                if t["state"] == "FINISHED"
                and any(e["state"] == "RUNNING" for e in t["events"])]
        return recs or None

    recs = _wait_for(_done)
    assert recs, state.list_tasks()
    rec = recs[-1]
    # >= 4 timestamped transitions, in nominal lifecycle order
    states = [e["state"] for e in rec["events"]]
    assert len(rec["events"]) >= 4, rec
    for expected in ("SUBMITTED", "SCHEDULED", "RUNNING", "FINISHED"):
        assert expected in states, states
    order = [s for s in states
             if s in ("SUBMITTED", "LEASE_REQUESTED", "SCHEDULED",
                      "RUNNING", "FINISHED")]
    assert order == sorted(
        order, key=("SUBMITTED", "LEASE_REQUESTED", "SCHEDULED", "RUNNING",
                    "FINISHED").index), states
    ts = [e["ts"] for e in rec["events"]]
    assert ts == sorted(ts)
    assert rec["duration_s"] >= 0
    # the executing worker reported itself
    assert rec["worker"] and rec["node"]

    # get_task round-trips the same record
    got = state.get_task(rec["task_id"])
    assert got is not None and got["task_id"] == rec["task_id"]

    # summarize_tasks: the `ray summary tasks` analog
    summ = state.summarize_tasks()
    probe_counts = next((v for k, v in summ["per_function"].items()
                         if k.endswith("lifecycle_probe")), {})
    assert probe_counts.get("FINISHED", 0) >= 1, summ


def test_failed_then_retried_task_records_retry(traced_cluster, tmp_path):
    marker = str(tmp_path / "retry_marker")

    @ray_tpu_torch.remote(max_retries=2, retry_exceptions=True)
    def flaky(path):
        if not os.path.exists(path):
            with open(path, "w") as f:
                f.write("x")
            raise ValueError("first attempt goes bang")
        return "recovered"

    assert ray_tpu_torch.get(flaky.remote(marker), timeout=60) == "recovered"

    def _done():
        recs = [t for t in state.list_tasks(name="flaky")
                if t["state"] == "FINISHED" and t["attempt"] >= 1]
        return recs or None

    recs = _wait_for(_done)
    assert recs, state.list_tasks(name="flaky")
    rec = recs[-1]
    states = [e["state"] for e in rec["events"]]
    assert "RETRYING" in states, states
    assert rec["attempt"] >= 1
    # error summary of the failed attempt survives on the record
    assert "first attempt goes bang" in rec["error"], rec


def test_failed_task_is_terminal_failed(traced_cluster):
    @ray_tpu_torch.remote(max_retries=0)
    def doomed():
        raise RuntimeError("persistent failure")

    with pytest.raises(Exception):
        ray_tpu_torch.get(doomed.remote(), timeout=60)

    def _done():
        recs = [t for t in state.list_tasks(name="doomed")
                if t["state"] == "FAILED"]
        return recs or None

    recs = _wait_for(_done)
    assert recs
    assert "persistent failure" in recs[-1]["error"]


# ---------------------------------------------------------------------------
# trace tree + chrome flow events
# ---------------------------------------------------------------------------


def test_trace_tree_driver_actor_nested(traced_cluster, tmp_path):
    tracing.clear()

    @ray_tpu_torch.remote
    def leaf_task(x):
        return x * 2

    @ray_tpu_torch.remote
    class Middle:
        def relay(self, x):
            with tracing.profile("relay_inner"):
                return ray_tpu_torch.get(leaf_task.remote(x))

    a = Middle.options(num_cpus=0.1).remote()
    assert ray_tpu_torch.get(a.relay.remote(3), timeout=60) == 6

    # (cat, name-suffix) — function names are qualnames under pytest
    chain_keys = [("submit", "Middle.relay"), ("actor_task", "Middle.relay"),
                  ("user", "relay_inner"), ("submit", "leaf_task"),
                  ("task", "leaf_task")]

    def _find(spans, cat, suffix):
        return next((s for s in spans
                     if s.get("cat") == cat and s["name"].endswith(suffix)),
                    None)

    def _spans():
        spans = tracing.get_spans()
        if all(_find(spans, c, n) is not None for c, n in chain_keys):
            return spans
        return None

    spans = _wait_for(_spans)
    assert spans is not None, [(s.get("cat"), s["name"])
                               for s in tracing.get_spans()]
    chain = [_find(spans, c, n) for c, n in chain_keys]

    # one trace id covers driver -> actor -> nested task
    tids = {s["trace_id"] for s in chain}
    assert len(tids) == 1, [(s["name"], s.get("trace_id")) for s in chain]

    # parent links form the tree
    for child, parent in zip(chain[1:], chain[:-1]):
        assert child["parent_id"] == parent["span_id"], (child, parent)

    # chrome export renders the causality as flow-event pairs
    out = str(tmp_path / "trace.json")
    tracing.export_chrome_trace(out)
    events = json.load(open(out))["traceEvents"]
    starts = {e["id"] for e in events if e.get("ph") == "s"}
    finishes = {e["id"] for e in events if e.get("ph") == "f"}
    assert starts and starts == finishes
    # at least the two cross-process submit->execute edges flow
    assert len(starts) >= 2


# ---------------------------------------------------------------------------
# bounded GCS ring
# ---------------------------------------------------------------------------


def test_task_manager_ring_drop_oldest():
    from ray_tpu_torch._private.gcs import GcsTaskManager

    mgr = GcsTaskManager(max_per_job=8, max_events_per_task=4)
    for i in range(50):
        mgr.add_events([{"task_id": f"t{i:04d}", "job_id": "job1",
                         "state": "SUBMITTED", "ts": float(i),
                         "name": "flood"}])
    assert len(mgr.jobs["job1"]) == 8
    # oldest dropped, newest kept, and the truncation is counted
    assert "t0000" not in mgr.jobs["job1"]
    assert "t0049" in mgr.jobs["job1"]
    assert mgr.dropped["job1"] == 42

    # per-task event list is bounded too
    for j in range(20):
        mgr.add_events([{"task_id": "t0049", "job_id": "job1",
                         "state": "RUNNING", "ts": 100.0 + j}])
    assert len(mgr.jobs["job1"]["t0049"]["events"]) == 4

    # reporter-side drops surface in the summary
    mgr.add_events([], dropped=7)
    summ = mgr.summarize()
    assert summ["dropped"]["_reporter"] == 7
    assert summ["dropped"]["job1"] == 42


def test_task_manager_merges_out_of_order_terminal():
    from ray_tpu_torch._private.gcs import GcsTaskManager

    mgr = GcsTaskManager(max_per_job=8)
    mgr.add_events([
        {"task_id": "t1", "job_id": "j", "state": "FINISHED", "ts": 10.0},
        # late executor-side RUNNING must not resurrect the task
        {"task_id": "t1", "job_id": "j", "state": "RUNNING", "ts": 9.0},
    ])
    rec = mgr.get_task("t1")
    assert rec["state"] == "FINISHED"
    # but the record keeps the full (ts-sorted) history
    assert [e["state"] for e in rec["events"]] == ["RUNNING", "FINISHED"]


# ---------------------------------------------------------------------------
# span shipping: a worker's spans reach the driver and the GCS timeline
# ---------------------------------------------------------------------------


def test_actor_span_reaches_driver_spans_and_timeline(traced_cluster):
    """A span recorded inside an actor ships to the GCS ``trace`` table:
    the driver's ``get_spans()`` and the GCS timeline both hold it."""
    tracing.clear()

    @ray_tpu_torch.remote
    class Spanner:
        def work(self):
            with tracing.profile("actor_side_span", tag="probe"):
                time.sleep(0.01)
            return os.getpid()

    a = Spanner.options(num_cpus=0.1).remote()
    pid = ray_tpu_torch.get(a.work.remote(), timeout=60)
    assert pid != os.getpid()

    def _span():
        return [s for s in tracing.get_spans()
                if s["name"] == "actor_side_span"] or None

    spans = _wait_for(_span)
    assert spans, [s["name"] for s in tracing.get_spans()]
    assert spans[0]["pid"] == pid and spans[0]["tag"] == "probe"

    def _timeline():
        events = state.get_timeline()["traceEvents"]
        return [e for e in events if e["name"] == "actor_side_span"] or None

    events = _wait_for(_timeline)
    assert events and events[0]["pid"] == pid
    assert events[0]["args"]["tag"] == "probe"
    ray_tpu_torch.kill(a)


# ---------------------------------------------------------------------------
# always-on metrics flusher
# ---------------------------------------------------------------------------


def test_metrics_autoflush_to_dashboard(traced_cluster):
    from ray_tpu_torch.util.metrics import Counter

    c = Counter("obs_autoflush_probe", "test counter")
    c.inc(3.0)

    address = traced_cluster.node_supervisor.dashboard_address
    assert address

    def _scrape():
        with urllib.request.urlopen(f"http://{address}/metrics",
                                    timeout=30) as r:
            body = r.read().decode()
        return body if "obs_autoflush_probe" in body else None

    # no publish_metrics() call anywhere: the flusher loop ships it
    body = _wait_for(_scrape, timeout=40)
    assert body is not None, "registry never appeared in /metrics"
    assert "obs_autoflush_probe 3.0" in body or \
        'obs_autoflush_probe{' in body

    # built-in instruments ride along: task latency histograms (tasks ran
    # in earlier tests of this module) with proper bucket series
    assert "ray_tpu_task_e2e_seconds" in body
    assert "ray_tpu_task_exec_seconds_bucket" in body
    assert 'le="+Inf"' in body
    # raylet-side gauges are flushed by the raylet's own loop
    assert "ray_tpu_object_store_bytes" in body
    assert "ray_tpu_raylet_lease_queue_depth" in body


def test_dashboard_tasks_endpoints(traced_cluster):
    @ray_tpu_torch.remote
    def dash_probe():
        return 1

    assert ray_tpu_torch.get(dash_probe.remote(), timeout=60) == 1
    address = traced_cluster.node_supervisor.dashboard_address

    def _tasks():
        with urllib.request.urlopen(
                f"http://{address}/api/tasks?name=dash_probe",
                timeout=30) as r:
            out = json.loads(r.read().decode())
        return out if any(t["state"] == "FINISHED" for t in out) else None

    tasks = _wait_for(_tasks)
    assert tasks, "no FINISHED dash_probe in /api/tasks"
    with urllib.request.urlopen(f"http://{address}/api/tasks/summary",
                                timeout=30) as r:
        summ = json.loads(r.read().decode())
    probe_counts = next((v for k, v in summ["per_function"].items()
                         if k.endswith("dash_probe")), {})
    assert probe_counts.get("FINISHED", 0) >= 1, summ


def test_set_enabled_override_survives_racing_env_read():
    """Regression (raylint RCE001, single-site lazy init): a set_enabled()
    override issued while another thread is mid-way through enabled()'s
    first env read must not be clobbered by that thread's stale result.
    Pre-fix, the unlocked check-then-act in enabled() lost exactly this
    update; the double-checked lock orders the override after the read."""
    import os as real_os
    import threading

    from ray_tpu_torch._private import task_events

    entered = threading.Event()
    release = threading.Event()

    class SlowEnviron:
        def get(self, key, default=None):
            if key == "RAY_TPU_TASK_EVENTS":
                entered.set()
                release.wait(10)
            return real_os.environ.get(key, default)

    class FakeOS:
        environ = SlowEnviron()

    task_events.set_enabled(None)  # force the lazy env re-read
    task_events.os = FakeOS()  # only task_events' view of os.environ
    try:
        reader = threading.Thread(target=task_events.enabled)
        reader.start()
        assert entered.wait(10), "reader never reached the env read"
        overrider = threading.Thread(
            target=task_events.set_enabled, args=(False,))
        overrider.start()
        time.sleep(0.1)  # let the override reach (and block on) _lock
        release.set()
        reader.join(10)
        overrider.join(10)
        assert not reader.is_alive() and not overrider.is_alive()
        assert task_events.enabled() is False
    finally:
        task_events.os = real_os
        task_events.set_enabled(None)
