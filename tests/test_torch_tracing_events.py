"""A mirror of ``tests/test_tracing_events.py`` on the port's runtime
(``ray_tpu_torch``, on the CPU): the same scenarios and assertions.

util/tracing.py + util/events.py coverage: the span pipeline
(record -> flush -> get_spans -> chrome-trace JSON golden) and the
structured-event ring bounds (GCS ring + local tier).

Complements test_tracing.py (cluster-level span collection): these tests pin
the exact export format and the bounded-memory contracts.
"""

import json
import os

import pytest

import ray_tpu_torch
from ray_tpu_torch.util import events, tracing


@pytest.fixture
def traced_local():
    """Local-mode session with tracing on; restores flag + buffers after."""
    ray_tpu_torch.shutdown()
    prev_env = os.environ.get("RAY_TPU_ENABLE_TRACING")
    tracing.enable()
    tracing.clear()
    ray_tpu_torch.init(local_mode=True)
    tracing.clear()
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()
    tracing.clear()
    if prev_env is None:
        os.environ.pop("RAY_TPU_ENABLE_TRACING", None)
    tracing._enabled = None


def test_chrome_trace_golden(traced_local, tmp_path):
    """record_span -> flush -> get_spans -> export writes exactly the
    chrome://tracing event this span describes (complete-event 'X' phase,
    microsecond units, extras under args)."""
    tracing.record_span("tokenize", 10.0, 10.25, category="user",
                        model="m1", shard=3)
    with tracing.profile("fwd", step=7):
        pass
    tracing.flush()
    spans = tracing.get_spans()
    assert [s["name"] for s in spans] == ["tokenize", "fwd"]

    path = str(tmp_path / "trace.json")
    assert tracing.export_chrome_trace(path) == 2
    data = json.load(open(path))
    assert set(data) == {"traceEvents"}
    ev = data["traceEvents"][0]
    golden = {
        "name": "tokenize",
        "cat": "user",
        "ph": "X",
        "ts": 10.0 * 1e6,
        "dur": 0.25 * 1e6,
        "args": {"model": "m1", "shard": 3},
    }
    assert {k: ev[k] for k in golden} == golden
    assert ev["pid"] == os.getpid() and isinstance(ev["tid"], int)
    fwd = data["traceEvents"][1]
    assert fwd["args"]["step"] == 7 and fwd["dur"] >= 0.0


def test_span_buffer_drop_oldest():
    """Pre-init spans accumulate in the process buffer, which is bounded:
    beyond _MAX_BUFFER the OLDEST spans fall off (tracing never leaks)."""
    ray_tpu_torch.shutdown()
    tracing.enable()
    try:
        with tracing._lock:
            tracing._buffer.clear()
        total = tracing._MAX_BUFFER + 57
        for i in range(total):
            tracing.record_span(f"s{i}", float(i), float(i) + 1.0)
        with tracing._lock:
            names = [s["name"] for s in tracing._buffer]
        assert len(names) <= tracing._MAX_BUFFER
        assert f"s{total - 1}" in names  # newest kept
        assert "s0" not in names  # oldest dropped
    finally:
        with tracing._lock:
            tracing._buffer.clear()
        os.environ.pop("RAY_TPU_ENABLE_TRACING", None)
        tracing._enabled = None


def test_local_event_tier_and_severity_normalization(traced_local):
    events._local_events.clear()
    events.record("weights", "warning", "publish lagging", version=3)
    events.record("weights", "not-a-severity", "normalized")
    events.record("other", "error", "boom")
    evs = events.list_events(source="weights")
    assert [e["message"] for e in evs] == ["publish lagging", "normalized"]
    assert evs[0]["metadata"] == {"version": 3}
    assert evs[1]["severity"] == "INFO"  # unknown severities normalize
    assert [e["source"] for e in events.list_events(severity="ERROR")] \
        == ["other"]
    # limit takes the newest
    assert [e["source"] for e in events.list_events(limit=1)] == ["other"]


def test_event_ring_bounds_cluster():
    """The GCS keeps a bounded ring (1000): flooding it evicts the oldest
    events and never grows without bound."""
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2, device="cpu")
    try:
        for i in range(1040):
            events.record("flood", "info", f"e{i}", seq=i)
        evs = events.list_events(source="flood", limit=5000)
        assert len(evs) <= 1000
        seqs = [e["metadata"]["seq"] for e in evs]
        assert seqs[-1] == 1039  # newest survived
        assert 0 not in seqs  # oldest evicted
        assert seqs == sorted(seqs)
    finally:
        ray_tpu_torch.shutdown()
