"""The port's dashboard head on its runtime, on the CPU: a mirror of
``tests/test_dashboard.py`` (reference tier: dashboard REST + Prometheus +
jobs endpoints, python/ray/dashboard/modules/*/tests), each test asserting
what its twin asserts, over the port's HTTP server."""

import json
import time
import urllib.request

import pytest

import ray_tpu_torch


@pytest.fixture(scope="module")
def dash_cluster():
    ray_tpu_torch.shutdown()
    worker = ray_tpu_torch.init(num_cpus=4, include_dashboard=True,
                                device="cpu")
    address = worker.node_supervisor.dashboard_address
    yield address
    ray_tpu_torch.shutdown()


def _get(address, path, timeout=30):
    with urllib.request.urlopen(f"http://{address}{path}", timeout=timeout) as r:
        body = r.read().decode()
        ctype = r.headers.get("Content-Type", "")
    return body, ctype


def _get_json(address, path):
    body, _ = _get(address, path)
    return json.loads(body)


def test_state_endpoints(dash_cluster):
    @ray_tpu_torch.remote
    class Marker:
        def ping(self):
            return True

    m = Marker.options(name="dash_marker", num_cpus=0.1).remote()
    assert ray_tpu_torch.get(m.ping.remote(), timeout=60)

    nodes = _get_json(dash_cluster, "/api/nodes")
    assert len([n for n in nodes if n["alive"]]) == 1
    actors = _get_json(dash_cluster, "/api/actors")
    assert any(a["name"] == "dash_marker" for a in actors)
    summary = _get_json(dash_cluster, "/api/summary")
    assert summary["num_nodes"] == 1 and summary["num_actors"] >= 1
    status = _get_json(dash_cluster, "/api/cluster_status")
    assert status["nodes"] and "demands" in status


def test_index_html(dash_cluster):
    body, ctype = _get(dash_cluster, "/")
    assert "text/html" in ctype
    assert "ray_tpu cluster" in body


def test_prometheus_metrics(dash_cluster):
    from ray_tpu_torch.util.metrics import Counter, publish_metrics

    c = Counter("dash_test_total", description="test counter")
    c.inc(3.0)
    publish_metrics()

    body, ctype = _get(dash_cluster, "/metrics")
    assert "text/plain" in ctype
    assert "ray_tpu_cluster_nodes_alive 1" in body
    assert 'ray_tpu_cluster_resource_total{resource="CPU"} 4' in body
    assert "dash_test_total" in body


def test_jobs_rest_roundtrip(dash_cluster):
    payload = json.dumps({
        "entrypoint": "python -c \"print('dash job ran')\"",
    }).encode()
    req = urllib.request.Request(
        f"http://{dash_cluster}/api/jobs", data=payload,
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        sid = json.loads(r.read())["submission_id"]

    deadline = time.monotonic() + 120
    status = None
    while time.monotonic() < deadline:
        info = _get_json(dash_cluster, f"/api/jobs/{sid}")
        status = info["status"]
        if status in ("SUCCEEDED", "FAILED", "STOPPED"):
            break
        time.sleep(0.5)
    assert status == "SUCCEEDED", f"job ended as {status}"
    logs, _ = _get(dash_cluster, f"/api/jobs/{sid}/logs")
    assert "dash job ran" in logs
    jobs = _get_json(dash_cluster, "/api/jobs")
    assert any(j["submission_id"] == sid for j in jobs)


# ---------------------------------------------------------------------------
# the renderers against the JAX head's, on the same GCS records
# ---------------------------------------------------------------------------

# (handler, query, path parameters): every GET the GCS alone answers
RENDERED = [
    ("_index", {}, {}), ("_version", {}, {}), ("_state", {}, {}),
    ("_nodes", {}, {}), ("_actors", {}, {}), ("_pgs", {}, {}),
    ("_cluster_status", {}, {}), ("_summary", {}, {}), ("_tasks", {}, {}),
    ("_tasks", {"name": "render_probe", "limit": "5"}, {}),
    ("_tasks_summary", {}, {}), ("_timeline", {"limit": "50"}, {}),
    ("_timeline", {"spans": "0", "start_ts": "0"}, {}), ("_health", {}, {}),
    ("_goodput", {}, {}), ("_metrics_history", {}, {}),
    ("_metrics_history", {"name": "render_gauge", "tier": "raw"}, {}),
    ("_workers", {}, {}), ("_prometheus", {}, {}), ("_data_stats", {}, {}),
    ("_weights", {}, {}), ("_checkpoints", {}, {}), ("_serve", {}, {}),
    ("_jobs_list", {}, {}), ("_job_info", {}, {"id": "nope"}),
]


class _FakeRequest:
    """What the JAX head's handlers read of an aiohttp request."""

    def __init__(self, query, match_info):
        self.query = query
        self.match_info = match_info


def test_renderers_match_the_jax_head(dash_cluster):
    """Each GCS-backed handler of the port's head and of the JAX head
    (called directly, no aiohttp server) renders the same GCS replies —
    recorded from the port's live GCS — to the same body: JSON key for key,
    the Prometheus and HTML text character for character."""
    import asyncio
    import copy

    from ray_tpu.dashboard.head import DashboardHead as JaxHead
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.dashboard.head import DashboardHead, Request
    from ray_tpu_torch.job import JobSubmissionClient
    from ray_tpu_torch.util.metrics import (Counter, Gauge, Histogram,
                                            publish_metrics)

    @ray_tpu_torch.remote(num_cpus=0.1)
    def render_probe(x):
        return x + 1

    assert ray_tpu_torch.get([render_probe.remote(i) for i in range(3)],
                             timeout=60) == [1, 2, 3]
    Counter("render_total", description="c", tag_keys=("route",)).inc(
        2.0, {"route": "/a"})
    Gauge("render_gauge", description="g").set(7.5)
    h = Histogram("render_seconds", description="h", boundaries=[0.1, 1.0])
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    publish_metrics()
    client = JobSubmissionClient()
    sid = client.submit_job(entrypoint="true")
    assert client.wait_until_finished(sid, timeout=120) == "SUCCEEDED"
    rendered = RENDERED + [("_job_info", {}, {"id": sid}),
                           ("_job_logs", {}, {"id": sid})]

    gcs = global_worker().gcs_address
    replies = {}

    class Recording(DashboardHead):
        async def _call(self, method, req):
            out = await super()._call(method, req)
            replies[(method, repr(sorted(req.items())))] = copy.deepcopy(out)
            return out

    async def replay(method, req):
        return copy.deepcopy(replies[(method, repr(sorted(req.items())))])

    async def render_both():
        port_head = Recording(gcs)
        jax_head = JaxHead(gcs)
        jax_head._call = replay
        out = []
        try:
            for name, query, match in rendered:
                req = Request("GET", "/", query)
                req.match_info = dict(match)
                got = await getattr(port_head, name)(req)
                want = await getattr(jax_head, name)(
                    _FakeRequest(dict(query), dict(match)))
                out.append((name, query, got, want))
        finally:
            await port_head.stop()
        return out

    results = asyncio.run(render_both())
    for name, query, got, want in results:
        where = f"{name} {query}"
        assert got.status == want.status, where
        assert got.content_type == want.content_type, where
        if got.content_type == "application/json":
            assert json.loads(got.text) == json.loads(want.text), where
        else:
            assert got.text == want.text, where
    body = next(g.text for n, _, g, _ in results if n == "_prometheus")
    assert 'render_total{node="' in body and 'route="/a"' in body
    assert 'render_seconds_bucket{le="+Inf"' in body


def test_http_server_answers_what_aiohttp_would(dash_cluster):
    """The head's own HTTP/1.1 server: two requests on one kept-alive
    connection, 404 for an unknown path, 405 for a known path's other
    method, 413 for a body over aiohttp's 1 MiB default and 400 for a
    request line it cannot parse."""
    import socket

    host, port = dash_cluster.rsplit(":", 1)

    def exchange(raw: bytes) -> list:
        """The status lines of the answers to ``raw``, read until the
        server closes (each case's last request asks it to, or is one it
        cannot go on after)."""
        with socket.create_connection((host, int(port)), timeout=30) as s:
            s.sendall(raw)
            data = b""
            while chunk := s.recv(65536):
                data += chunk
        return [part.split(b"\r\n", 1)[0].decode()
                for part in data.split(b"HTTP/1.1 ")[1:]]

    get = b"GET /api/summary HTTP/1.1\r\nHost: x\r\n\r\n"
    close = b"Connection: close\r\n"
    assert exchange(get + get[:-2] + close + b"\r\n") == ["200 OK", "200 OK"]
    assert exchange(b"GET /api/nope HTTP/1.1\r\n" + close + b"\r\n") == [
        "404 Not Found"]
    assert exchange(b"POST /api/summary HTTP/1.1\r\nContent-Length: 0\r\n"
                    + close + b"\r\n") == ["405 Method Not Allowed"]
    assert exchange(b"POST /api/jobs HTTP/1.1\r\nContent-Length: 99999999"
                    b"\r\n\r\n") == ["413 Request Entity Too Large"]
    assert exchange(b"BOGUS\r\n\r\n") == ["400 Bad Request"]
