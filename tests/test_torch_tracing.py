"""The port's observability modules (``ray_tpu_torch/util``) against the JAX
package's (``ray_tpu/util``), fed the same calls in one process:

- ``metrics``: counters, gauges and histograms give equal snapshots, and
  ``scrape_metrics`` the same entries;
- ``tracing``: nested ``profile`` blocks, a span recorded by hand and one
  recorded on another thread under a parent handed to it give span trees
  equal in names, categories, parent links and extra fields, and chrome
  events equal up to ids and times (the flow pair of the cross-thread edge
  included); without the runtime the JAX module keeps its spans in its
  buffer, which is read here;
- ``goodput``: exclusive regions, ``add``, ``count`` and ``note_mfu`` give
  the same buckets and counters, each ledger with ``sum(buckets) + idle ==
  wall``; ``flush_payload`` sets the same gauges; ``CompileWatch`` gives
  the same first and recompile sequence for the same keys;
- ``events``: in each package's local mode the same records give the same
  events under every filter, severities normalised alike.
"""

import math
import threading
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch.util import goodput, metrics, tracing


def _jax_util():
    # the JAX reference; the card's machine lacks flax
    pytest.importorskip("flax")
    from ray_tpu.util import goodput as jax_goodput
    from ray_tpu.util import metrics as jax_metrics
    from ray_tpu.util import tracing as jax_tracing

    return jax_metrics, jax_tracing, jax_goodput


# -- metrics --------------------------------------------------------------------


def _feed_metrics(mod, tag: str):
    hist = mod.Histogram(f"test.{tag}.hist", "a histogram",
                         boundaries=[0.001, 0.01, 0.1, 1, 10],
                         tag_keys=("phase",))
    for v in (0.0005, 0.001, 0.02, 0.5, 3.0, 50.0, 0.01):
        hist.observe(v)
        hist.observe(2 * v, tags={"phase": "b"})
    default = mod.Histogram(f"test.{tag}.default")
    default.observe(0.05)
    counter = mod.Counter(f"test.{tag}.counter", "a counter",
                          tag_keys=("kind",)).set_default_tags({"kind": "x"})
    counter.inc()
    counter.inc(2.5, tags={"kind": "y"})
    gauge = mod.Gauge(f"test.{tag}.gauge", "a gauge")
    gauge.set(3)
    gauge.set(7.5)
    return hist, default, counter, gauge


def test_metrics_snapshots_equal_the_jax_modules():
    jax_metrics, _, _ = _jax_util()
    ours = _feed_metrics(metrics, "port")
    theirs = _feed_metrics(jax_metrics, "port")
    for a, b in zip(ours, theirs):
        assert a.kind == b.kind
        assert a.snapshot() == b.snapshot()
    scraped = metrics.scrape_metrics()
    want = jax_metrics.scrape_metrics()
    for name in ("hist", "default", "counter", "gauge"):
        key = f"test.port.{name}"
        assert scraped[key] == want[key]
    # bucket i counts values <= boundaries[i] above the previous boundary
    assert ours[0].snapshot()["counts"]["{}"] == [2, 1, 1, 1, 1, 1]


# -- tracing --------------------------------------------------------------------


@pytest.fixture
def traced():
    """Tracing on in both modules, their spans cleared before and after."""
    _, jax_tracing, _ = _jax_util()

    def clear_jax():
        with jax_tracing._lock:
            timer, jax_tracing._timer = jax_tracing._timer, None
        if timer is not None:  # its flush would move the buffer about
            timer.cancel()
            timer.join()
        with jax_tracing._lock:
            jax_tracing._buffer.clear()

    was = tracing.enabled(), jax_tracing.enabled()
    tracing.enable()
    jax_tracing.enable()
    tracing.clear()
    clear_jax()
    try:
        yield jax_tracing, clear_jax
    finally:
        tracing.clear()
        clear_jax()
        if not was[0]:
            tracing.disable()
        if not was[1]:
            jax_tracing._enabled = False


def _record(mod):
    """The same calls into either tracing module."""
    with mod.profile("train.step", category="train", step=3):
        with mod.profile("train.fwd_bwd", category="train", buckets=2):
            ctx = mod.current_context()

            def worker():  # a reducer thread: its parent is handed to it
                t0 = time.time()
                mod.record_span("train.bucket_allreduce", t0, t0 + 1e-3,
                                category="train", trace_id=ctx[0],
                                span_id=mod.new_span_id(),
                                parent_id=ctx[1], bucket=0, nbytes=64)

            thread = threading.Thread(target=worker)
            thread.start()
            thread.join(timeout=30)
            assert not thread.is_alive()
        with mod.profile("train.optimizer", category="train"):
            pass
    with mod.profile("user.block"):
        mod.record_span("manual", 1.0, 2.5, category="task", foo=1)
    mod.record_span("orphan", 3.0, 3.5)


def _tree(spans):
    """Each span as (name, cat, parent's name, extra fields), in record
    order."""
    by_id = {s["span_id"]: s["name"] for s in spans if s.get("span_id")}
    ids = ("trace_id", "span_id", "parent_id")
    meta = ("name", "cat", "ts", "dur", "pid", "tid")
    return [(s["name"], s["cat"], by_id.get(s.get("parent_id")),
             {k: v for k, v in s.items() if k not in ids + meta})
            for s in spans]


def test_span_trees_equal_the_jax_modules(traced):
    jax_tracing, _ = traced
    _record(tracing)
    _record(jax_tracing)
    ours = tracing.get_spans()
    with jax_tracing._lock:
        theirs = sorted(jax_tracing._buffer, key=lambda s: s["ts"])
    assert len(ours) == len(theirs) == 7
    assert _tree(ours) == _tree(theirs)
    tree = {s["name"]: s for s in ours}
    step = tree["train.step"]
    assert step["parent_id"] is None
    assert tree["train.fwd_bwd"]["parent_id"] == step["span_id"]
    assert tree["train.bucket_allreduce"]["parent_id"] == \
        tree["train.fwd_bwd"]["span_id"]
    assert len({s["trace_id"] for s in ours if s["name"].startswith(
        "train.")}) == 1
    # the thread's span lies on another track
    assert tree["train.bucket_allreduce"]["tid"] != step["tid"]


def _events(spans, mod):
    """Chrome events without ids and times."""
    out = []
    for e in mod.spans_to_chrome_events(spans, flow_id_base=5):
        e = {k: v for k, v in e.items() if k not in ("ts", "dur", "pid",
                                                     "tid", "id")}
        if "args" in e:
            e["args"] = {k: v for k, v in e["args"].items()
                         if k not in ("trace_id", "span_id", "parent_id")}
        out.append(e)
    return out


def test_chrome_events_equal_the_jax_modules(traced, tmp_path):
    jax_tracing, _ = traced
    _record(tracing)
    _record(jax_tracing)
    ours = tracing.get_spans()
    with jax_tracing._lock:
        theirs = sorted(jax_tracing._buffer, key=lambda s: s["ts"])
    got, want = _events(ours, tracing), _events(theirs, jax_tracing)
    assert got == want
    flows = [e for e in got if e["cat"] == "flow"]
    assert [e["ph"] for e in flows] == ["s", "f"]  # the one cross-thread edge
    events = tracing.spans_to_chrome_events(ours, flow_id_base=5)
    flow_ids = {e["id"] for e in events if e["cat"] == "flow"}
    assert flow_ids == {6}
    start = next(e for e in events if e.get("ph") == "s")
    parent = next(e for e in events if e["name"] == "train.fwd_bwd")
    assert parent["ts"] <= start["ts"] <= parent["ts"] + parent["dur"]
    path = tmp_path / "trace.json"
    assert tracing.export_chrome_trace(str(path)) == len(events)
    import json

    with open(path) as f:
        assert len(json.load(f)["traceEvents"]) == len(events)


def test_tracing_off_records_nothing():
    was = tracing.enabled()
    tracing.disable()
    try:
        tracing.clear()
        with tracing.profile("x"):
            assert tracing.current_context() is None
        tracing.record_span("y", 0.0, 1.0)
        assert tracing.get_spans() == []
    finally:
        if was:
            tracing.enable()


# -- goodput --------------------------------------------------------------------


def _ledger_calls(mod):
    mod.reset()
    mod.set_job("job-a")
    with mod.region("step_compute"):
        time.sleep(0.02)
        with mod.region("compile"):
            time.sleep(0.03)
        with mod.region("collective_wait"):
            time.sleep(0.01)
    mod.add("bubble", 0.004)  # a window measured elsewhere
    mod.add("input_stall", 0.0)  # nothing to add
    mod.count("steps")
    mod.count("steps", 2)
    mod.count("compiles")
    mod.note_mfu(0.375)
    time.sleep(0.02)  # unattributed: idle, and room for the bubble
    return mod.snapshot(), mod.flush_payload(node="n0")


def test_goodput_ledger_equals_the_jax_modules():
    jax_metrics, _, jax_goodput = _jax_util()
    if not jax_goodput.enabled():
        pytest.skip("the JAX ledger is turned off in this environment")
    ours, payload = _ledger_calls(goodput)
    theirs, jax_payload = _ledger_calls(jax_goodput)
    for snap in (ours, theirs):
        assert snap["job"] == "job-a"
        assert set(snap["buckets"]) == set(goodput.BUCKETS) | {"idle"}
        # exhaustive: the buckets and idle sum to the wall
        assert math.isclose(sum(snap["buckets"].values()), snap["wall_s"],
                            rel_tol=1e-9)
        b = snap["buckets"]
        # exclusive: the parent region keeps only its own time
        assert 0.02 <= b["step_compute"] < 0.03
        assert b["compile"] >= 0.03 and b["collective_wait"] >= 0.01
        assert b["bubble"] == 0.004 and b["input_stall"] == 0.0
        assert b["idle"] > 0.0
    assert set(ours) == set(theirs)
    assert ours["counters"] == theirs["counters"] == {"steps": 3,
                                                       "compiles": 1}
    assert ours["mfu"] == theirs["mfu"] == 0.375
    assert set(payload) == set(jax_payload)
    assert payload["node"] == "n0"
    scraped = metrics.scrape_metrics()
    want = jax_metrics.scrape_metrics()
    for name in ("fraction", "mfu", "compiles", "recompiles",
                 "bucket_seconds"):
        key = f"ray_tpu.goodput.{name}"
        assert scraped[key]["kind"] == want[key]["kind"]
        assert set(scraped[key]["data"]) == set(want[key]["data"])
    assert scraped["ray_tpu.goodput.mfu"]["data"] == {"{}": 0.375}
    goodput.reset()
    jax_goodput.reset()
    assert goodput.flush_payload() is None


def test_goodput_wall_starts_with_the_first_region():
    """Without ``set_job`` the port's ledger starts its wall as the first
    region opens, so the first region lies inside it (the JAX module starts
    it as the first region closes)."""
    goodput.reset()
    with goodput.region("step_compute"):
        time.sleep(0.02)
    snap = goodput.snapshot()
    assert snap["buckets"]["step_compute"] >= 0.02
    assert snap["wall_s"] >= snap["buckets"]["step_compute"]
    assert math.isclose(sum(snap["buckets"].values()), snap["wall_s"],
                        rel_tol=1e-9)
    goodput.reset()


def test_compile_watch_sequence_equals_the_jax_modules():
    _, _, jax_goodput = _jax_util()
    shapes = [(4, 16), (4, 16), (8, 16), (4, 16), (8, 32), (8, 16)]
    progs = ["fused", "fused", "fused", "phases", "fused", "phases"]

    def run(mod, make):
        watch = mod.CompileWatch()
        return [watch.observe(p, mod.batch_key({"tokens": make(s),
                                                "mask": make(s)}))
                for p, s in zip(progs, shapes)]

    ours = run(goodput, lambda s: torch.zeros(s, dtype=torch.int32))
    theirs = run(jax_goodput, lambda s: np.zeros(s, np.int32))
    assert ours == theirs == ["compile", None, "recompile", "compile",
                              "recompile", "recompile"]
    key = goodput.batch_key({"tokens": torch.zeros(2, 3, dtype=torch.long),
                             "mask": torch.ones(2, 3)})
    assert key == (("mask", (2, 3), "torch.float32"),
                   ("tokens", (2, 3), "torch.int64"))


# -- events ---------------------------------------------------------------------


def _feed_events(mod):
    mod._local_events.clear()
    mod.record("weights", "warning", "publish lagging", version=3)
    mod.record("weights", "not-a-severity", "normalized")
    mod.record("serve", "info", "autoscale d: 1 -> 2 (queue)",
               deployment="d", direction="up")
    mod.record("other", "ERROR", "boom", n=1.5)
    views = [mod.list_events(), mod.list_events(source="weights"),
             mod.list_events(severity="error"), mod.list_events(limit=2),
             mod.list_events(source="serve", severity="INFO")]
    mod._local_events.clear()
    return [[{k: v for k, v in e.items() if k != "ts"} for e in view]
            for view in views]


def test_events_equal_the_jax_module_in_local_mode():
    pytest.importorskip("flax")
    import ray_tpu
    from ray_tpu.util import events as jax_events

    import ray_tpu_torch
    from ray_tpu_torch.util import events

    runtimes = (ray_tpu_torch, ray_tpu)
    for rt in runtimes:
        rt.shutdown()
        rt.init(local_mode=True)
    try:
        ours, theirs = _feed_events(events), _feed_events(jax_events)
    finally:
        for rt in runtimes:
            rt.shutdown()
    assert ours == theirs
    assert [e["severity"] for e in ours[0]] == ["WARNING", "INFO", "INFO",
                                                "ERROR"]
