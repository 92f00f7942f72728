"""Dashboard-lite: the head HTTP server.

Reference: python/ray/dashboard/head.py (:49) + its modules — state
(``modules/state``), jobs REST (``modules/job/job_head.py``), Prometheus
metrics (``modules/metrics``), logs (``modules/log``). This build serves the
same surfaces from one HTTP server backed directly by the GCS (no React
frontend; a minimal HTML status page instead).

The port of ``ray_tpu/dashboard/head.py``: the same routes, bodies and
content types, served by a small HTTP/1.1 server on
``asyncio.start_server`` (the JAX head is an aiohttp app; the card's
machine has no aiohttp). Handlers take a :class:`Request` and return a
:class:`Response` with aiohttp's names, so each reads as its JAX twin.

Endpoints:
  GET  /                     - HTML cluster overview
  GET  /api/version          - framework version
  GET  /api/state            - full GCS state dump
  GET  /api/nodes|actors|pgs - tables
  GET  /api/cluster_status   - autoscaler view (demands, idle, per-node)
  GET  /api/summary          - aggregate counts
  GET  /api/workers          - per-node worker-pool / provisioning stats
  GET  /api/timeline         - Perfetto chrome-trace of the task flow graph
  GET  /api/health           - cluster-health report (stuck/straggler scan)
  GET  /api/goodput          - per-job goodput ledgers (wall-clock buckets)
  GET  /api/metrics/history  - metric time-series (raw + rollup tiers)
  GET  /metrics              - Prometheus text exposition
  GET  /api/jobs             - submitted jobs (job manager KV)
  POST /api/jobs             - {"entrypoint": ..., "runtime_env": ...}
  GET  /api/jobs/{id}        - job info
  GET  /api/jobs/{id}/logs   - job logs (text)
  POST /api/jobs/{id}/stop   - stop a job
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from typing import Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qsl, unquote, urlsplit

from ray_tpu_torch._private import wire
from ray_tpu_torch._private.rpc import RetryingRpcClient

logger = logging.getLogger("ray_tpu_torch.dashboard")

_HTTP_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
                 405: "Method Not Allowed", 413: "Request Entity Too Large",
                 500: "Internal Server Error"}
_MAX_BODY = 1 << 20  # aiohttp's default client_max_size


class Request:
    """One HTTP request, with the parts of aiohttp's ``web.Request`` the
    handlers read: ``method``, ``path``, ``query``, ``match_info`` and
    ``await json()``."""

    def __init__(self, method: str, path: str,
                 query: Optional[Dict[str, str]] = None, body: bytes = b"",
                 keep_alive: bool = False):
        self.method = method
        self.path = path
        self.query = dict(query or {})
        self.match_info: Dict[str, str] = {}
        self.body = body
        self.keep_alive = keep_alive

    async def json(self):
        return json.loads(self.body.decode())


class Response:
    """A response as aiohttp's ``web.Response(text=, status=,
    content_type=)`` builds it: utf-8 text with its charset named."""

    def __init__(self, text: str = "", status: int = 200,
                 content_type: str = "text/plain"):
        self.text = text
        self.status = status
        self.content_type = content_type

    def encode(self, keep_alive: bool) -> bytes:
        body = self.text.encode()
        head = [f"HTTP/1.1 {self.status} "
                f"{_HTTP_REASONS.get(self.status, 'Unknown')}",
                f"Content-Type: {self.content_type}; charset=utf-8",
                f"Content-Length: {len(body)}",
                f"Connection: {'keep-alive' if keep_alive else 'close'}"]
        return ("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + body


def json_response(data, status: int = 200) -> Response:
    """aiohttp's ``web.json_response``: ``json.dumps`` of ``data``."""
    return Response(text=json.dumps(data), status=status,
                    content_type="application/json")


async def _read_request(reader: asyncio.StreamReader):
    """(request, None) for one HTTP/1.1 request off ``reader``; (None,
    None) at a clean close between requests, (None, an answer) for a
    request that cannot be parsed."""
    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except asyncio.IncompleteReadError as e:
        if e.partial:
            raise
        return None, None
    lines = head.decode("latin-1").split("\r\n")
    try:
        method, target, version = lines[0].split(" ", 2)
    except ValueError:
        return None, Response(text="400: bad request line", status=400)
    headers = {}
    for line in lines[1:]:
        if ":" in line:
            k, v = line.split(":", 1)
            headers[k.strip().lower()] = v.strip()
    try:
        length = int(headers.get("content-length") or 0)
    except ValueError:
        return None, Response(text="400: bad content-length", status=400)
    if length > _MAX_BODY:
        return None, Response(text=f"413: body of {length} bytes, the most "
                                   f"is {_MAX_BODY}", status=413)
    body = await reader.readexactly(length) if length > 0 else b""
    conn = headers.get("connection", "").lower()
    keep = conn != "close" if version == "HTTP/1.1" else conn == "keep-alive"
    url = urlsplit(target)
    return Request(method, unquote(url.path), dict(parse_qsl(url.query)),
                   body, keep), None


_HTML = """<!doctype html>
<html><head><title>ray_tpu dashboard</title>
<style>
 body {{ font-family: monospace; margin: 2em; background: #111; color: #eee; }}
 h1 {{ color: #7fd4ff; }} table {{ border-collapse: collapse; }}
 td, th {{ border: 1px solid #444; padding: 4px 10px; text-align: left; }}
 a {{ color: #7fd4ff; }}
</style></head>
<body>
<h1>ray_tpu cluster</h1>
<p>uptime {uptime:.0f}s &middot; {num_nodes} nodes &middot; {num_actors} actors
&middot; {num_jobs} jobs</p>
<h2>resources</h2><table>{resources}</table>
<h2>nodes</h2><table><tr><th>node</th><th>alive</th><th>resources</th>
<th>labels</th></tr>{nodes}</table>
<h2>actors</h2><table><tr><th>actor</th><th>class</th><th>state</th>
<th>name</th></tr>{actors}</table>
<p><a href="/api/state">/api/state</a> &middot;
<a href="/api/cluster_status">/api/cluster_status</a> &middot;
<a href="/metrics">/metrics</a> &middot; <a href="/api/jobs">/api/jobs</a></p>
</body></html>"""


class DashboardHead:
    def __init__(self, gcs_address: str, host: str = "127.0.0.1", port: int = 0):
        self.gcs_address = gcs_address
        self.host = host
        self.port = port
        self._gcs: Optional[RetryingRpcClient] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._writers: set = set()
        self._route_table = self._routes()

    # -- GCS I/O -------------------------------------------------------

    async def _call(self, method: str, req: dict) -> dict:
        if self._gcs is None:
            self._gcs = RetryingRpcClient(self.gcs_address)
        return wire.loads(await self._gcs.call(method, wire.dumps(req)))

    # -- lifecycle -----------------------------------------------------

    def _routes(self) -> List[Tuple[str, str, Callable]]:
        return [
            ("GET", "/", self._index),
            ("GET", "/api/version", self._version),
            ("GET", "/api/state", self._state),
            ("GET", "/api/nodes", self._nodes),
            ("GET", "/api/actors", self._actors),
            ("GET", "/api/pgs", self._pgs),
            ("GET", "/api/cluster_status", self._cluster_status),
            ("GET", "/api/summary", self._summary),
            ("GET", "/api/tasks", self._tasks),
            ("GET", "/api/tasks/summary", self._tasks_summary),
            ("GET", "/api/timeline", self._timeline),
            ("GET", "/api/health", self._health),
            ("GET", "/api/goodput", self._goodput),
            ("GET", "/api/metrics/history", self._metrics_history),
            ("GET", "/api/workers", self._workers),
            ("GET", "/metrics", self._prometheus),
            ("GET", "/api/nodes/{node_id}/stats", self._node_stats),
            ("GET", "/api/data_stats", self._data_stats),
            ("GET", "/api/weights", self._weights),
            ("GET", "/api/checkpoints", self._checkpoints),
            ("GET", "/api/serve", self._serve),
            ("POST", "/api/profile/stacks", self._profile_stacks),
            ("POST", "/api/profile/memory", self._profile_memory),
            ("GET", "/api/jobs", self._jobs_list),
            ("POST", "/api/jobs", self._jobs_submit),
            ("GET", "/api/jobs/{id}", self._job_info),
            ("GET", "/api/jobs/{id}/logs", self._job_logs),
            ("POST", "/api/jobs/{id}/stop", self._job_stop),
        ]

    def _route(self, method: str, path: str):
        """(handler, path parameters) for a request; (None, status) where
        no route matches (404) or none takes the method (405)."""
        parts = path.rstrip("/").split("/") if path != "/" else [""]
        status = 404
        for m, template, handler in self._route_table:
            tparts = template.rstrip("/").split("/") if template != "/" \
                else [""]
            if len(tparts) != len(parts):
                continue
            match = {}
            for t, p in zip(tparts, parts):
                if t.startswith("{") and t.endswith("}"):
                    if not p:
                        break
                    match[t[1:-1]] = p
                elif t != p:
                    break
            else:
                if m == method:
                    return handler, match
                status = 405
        return None, status

    async def start(self) -> int:
        self._server = await asyncio.start_server(
            self._connection, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def stop(self):
        if self._server is not None:
            self._server.close()
            for writer in list(self._writers):
                writer.close()
            await self._server.wait_closed()
            self._server = None
        for client in [self._gcs, *getattr(self, "_raylets", {}).values()]:
            if client is not None:
                await client.close()
        self._gcs = None

    async def handle(self, request: "Request") -> "Response":
        """Answer one parsed request (the server's path; tests call it
        directly)."""
        handler, match = self._route(request.method, request.path)
        if handler is None:
            reason = _HTTP_REASONS[match]
            return Response(text=f"{match}: {reason}", status=match)
        request.match_info = match
        try:
            return await handler(request)
        except Exception as e:  # the handler failed: a 500, as aiohttp answers
            logger.exception("dashboard %s %s failed", request.method,
                             request.path)
            return Response(text=f"500 Internal Server Error\n\n{e!r}",
                            status=500)

    async def _connection(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter):
        self._writers.add(writer)
        try:
            while True:
                request, bad = await _read_request(reader)
                if request is None:
                    if bad is not None:
                        writer.write(bad.encode(False))
                        await writer.drain()
                    break
                response = await self.handle(request)
                writer.write(response.encode(request.keep_alive))
                await writer.drain()
                if not request.keep_alive:
                    break
        except (ConnectionError, asyncio.IncompleteReadError,
                asyncio.LimitOverrunError):
            pass  # the client went away mid-request, or sent 64 KiB of head
        finally:
            self._writers.discard(writer)
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:  # already closed by the peer
                pass

    # -- handlers ------------------------------------------------------

    async def _version(self, request):
        import ray_tpu_torch

        return json_response({
            "version": getattr(ray_tpu_torch, "__version__", "dev"),
            "gcs_address": self.gcs_address})

    async def _state(self, request):
        return json_response(await self._call("GetState", {}))

    async def _nodes(self, request):
        return json_response(
            (await self._call("GetAllNodes", {}))["nodes"])

    async def _actors(self, request):
        return json_response(
            (await self._call("ListActors", {}))["actors"])

    async def _raylet(self, node_id: str):
        """Cached client to one node's raylet (for agent stats/profiling)."""
        if not hasattr(self, "_raylets"):
            self._raylets = {}
        client = self._raylets.get(node_id)
        if client is None:
            nodes = (await self._call("GetAllNodes", {}))["nodes"]
            addr = next((n["address"] for n in nodes
                         if n["node_id"].startswith(node_id) and n["alive"]),
                        None)
            if addr is None:
                return None
            client = RetryingRpcClient(addr)
            self._raylets[node_id] = client
        return client

    async def _data_stats(self, request):
        """Recent Dataset executions' per-op metrics (reference: the data
        tab of the dashboard; fed by Dataset._publish_stats)."""
        keys = (await self._call("KVKeys",
                                 {"ns": "data_stats", "prefix": ""}))["keys"]
        out = []
        for k in keys[-50:]:
            blob = (await self._call("KVGet",
                                     {"ns": "data_stats", "key": k}))["value"]
            if blob is not None:
                entry = wire.loads(blob)
                entry["dataset"] = k
                out.append(entry)
        out.sort(key=lambda e: e.get("ts", 0))
        return json_response(out)

    async def _kv_namespace_dump(self, ns: str) -> dict:
        """All wire-decoded values of one stats-mirror KV namespace
        (one batched KVMultiGet instead of a round trip per key)."""
        keys = (await self._call("KVKeys", {"ns": ns, "prefix": ""}))["keys"]
        values = (await self._call("KVMultiGet",
                                   {"ns": ns, "keys": keys}))["values"]
        return {k: wire.loads(blob) for k, blob in values.items()
                if blob is not None}

    async def _workers(self, request):
        """Per-node worker-pool stats from the provisioning plane: warm
        pool size, zygote liveness, adoption hit/miss and fork/cold-spawn
        counters (mirrored to the ``workers`` KV namespace by every
        raylet's metrics loop)."""
        per_node = await self._kv_namespace_dump("workers")
        totals = {"hits": 0, "misses": 0, "forks": 0, "cold_spawns": 0,
                  "zygote_restarts": 0, "total_workers": 0,
                  "warm_default_env": 0}
        for entry in per_node.values():
            pool = entry.get("pool", {})
            for k in totals:
                totals[k] += int(pool.get(k, 0) or 0)
        return json_response({"nodes": per_node, "totals": totals})

    async def _weights(self, request):
        """Weight-plane stores: per-version publish/pull bytes, chunk
        counts, commit timestamps (mirrored to the ``weights`` KV namespace
        by WeightStoreActor on every commit/pull)."""
        return json_response(await self._kv_namespace_dump("weights"))

    async def _checkpoints(self, request):
        """Checkpoint-plane stores: per-store latest/pinned ids, per-
        checkpoint step/bytes/dedup stats, retention drop counters and —
        for tiered stores — per-checkpoint residency columns plus the
        latest GCS sweeper report (``ckpt`` / ``ckpt_sweep`` KV
        namespaces, mirrored by CheckpointStore/TieredStore and the
        retention sweeper)."""
        stores = await self._kv_namespace_dump("ckpt")
        sweeps = await self._kv_namespace_dump("ckpt_sweep")
        for name, stats in stores.items():
            if isinstance(stats, dict) and name in sweeps:
                stats["last_sweep"] = sweeps[name]
        return json_response(stores)

    async def _serve(self, request):
        """Serve autoscale plane: per-deployment replica target vs live
        count, windowed rate rollup (arrival rate, queue p99, execute
        mean), registered SLOs and recent scale transitions (mirrored to
        the ``serve`` KV namespace by the controller every autoscale
        tick)."""
        return json_response(await self._kv_namespace_dump("serve"))

    async def _node_stats(self, request):
        """Per-node agent sample: node cpu/mem/load + every worker's
        cpu/rss/fds (reference: dashboard modules/reporter)."""
        client = await self._raylet(request.match_info["node_id"])
        if client is None:
            return json_response({"error": "unknown node"}, status=404)
        stats = wire.loads(await client.call(
            "GetNodeStats", wire.dumps({"agent": True}), timeout=30.0))
        return json_response(stats)

    async def _profile(self, request, kind: str):
        body = await request.json()
        client = await self._raylet(str(body.get("node_id", "")))
        if client is None:
            return json_response({"error": "unknown node"}, status=404)
        out = wire.loads(await client.call("ProfileWorker", wire.dumps({
            "pid": int(body["pid"]), "kind": kind,
            "args": body.get("args") or {},
            "timeout": float(body.get("timeout", 60.0)),
        }), timeout=float(body.get("timeout", 60.0)) + 10.0))
        status = 200 if out.get("status") == "ok" else 404
        return json_response(out, status=status)

    async def _profile_stacks(self, request):
        return await self._profile(request, "stacks")

    async def _profile_memory(self, request):
        return await self._profile(request, "memory")

    async def _tasks(self, request):
        """Task lifecycle records from the GCS task manager (reference:
        the dashboard's state API /api/v0/tasks). Query params: job_id,
        name, state, limit."""
        q = request.query
        reply = await self._call("ListTasks", {
            "job_id": q.get("job_id"), "name": q.get("name"),
            "state": q.get("state"), "limit": int(q.get("limit", 200))})
        return json_response(reply["tasks"])

    async def _tasks_summary(self, request):
        """Per-function counts by lifecycle state (`ray summary tasks`)."""
        return json_response(await self._call(
            "SummarizeTasks", {"job_id": request.query.get("job_id")}))

    async def _timeline(self, request):
        """Perfetto-loadable chrome-trace JSON of the task flow graph from
        the GCS task-event ring (+ built-in spans), filterable by job and
        time window. Query params: job_id, start_ts, end_ts (unix
        seconds), limit, spans=0 to omit span records. Save the body and
        open it in ui.perfetto.dev / chrome://tracing."""
        q = request.query
        req = {"job_id": q.get("job_id") or None,
               "limit": int(q.get("limit", 5000)),
               "spans": q.get("spans", "1") not in ("0", "false")}
        if q.get("start_ts"):
            req["start_ts"] = float(q["start_ts"])
        if q.get("end_ts"):
            req["end_ts"] = float(q["end_ts"])
        return json_response(await self._call("GetTimeline", req))

    async def _health(self, request):
        """Latest cluster-health report (stuck tasks, straggler nodes,
        provisioning-pool pathology). ``?scan=1`` forces a scan NOW
        instead of returning the last periodic one."""
        scan = request.query.get("scan", "0") not in ("0", "false", "")
        reply = await self._call("GetClusterHealth", {"scan": scan})
        return json_response(reply["health"])

    async def _goodput(self, request):
        """Per-job goodput ledgers: cumulative wall-clock attribution
        buckets, counters, and the derived goodput_fraction.
        ``?job=<run name>`` filters to one job."""
        req = {}
        if request.query.get("job"):
            req["job"] = request.query["job"]
        reply = await self._call("GetGoodput", req)
        return json_response(reply["jobs"])

    async def _metrics_history(self, request):
        """Metric time-series from the GCS history ring. Query params:
        name (omit to list recorded names), window (seconds),
        tier=raw|rollup|auto."""
        q = request.query
        name = q.get("name")
        if not name:
            return json_response(
                (await self._call("GetMetricsHistory", {}))["names"])
        req = {"name": name, "tier": q.get("tier") or "auto"}
        if q.get("window"):
            req["window_s"] = float(q["window"])
        reply = await self._call("GetMetricsHistory", req)
        return json_response(reply["history"])

    async def _pgs(self, request):
        return json_response((await self._call("GetState", {}))["pgs"])

    async def _cluster_status(self, request):
        return json_response(await self._call("GetClusterStatus", {}))

    async def _summary(self, request):
        state = await self._call("GetState", {})
        by_state: dict = {}
        for a in state["actors"]:
            by_state[a["state"]] = by_state.get(a["state"], 0) + 1
        return json_response({
            "num_nodes": sum(1 for n in state["nodes"] if n["alive"]),
            "num_actors": len(state["actors"]),
            "actors_by_state": by_state,
            "num_jobs": len(state["jobs"]),
            "num_placement_groups": len(state["pgs"]),
            "uptime_s": state.get("uptime_s", 0.0),
        })

    async def _index(self, request):
        state = await self._call("GetState", {})
        res = await self._call("GetClusterResources", {})
        rows_r = "".join(
            f"<tr><td>{k}</td><td>{res['available'].get(k, 0):g} / {v:g}</td></tr>"
            for k, v in sorted(res["total"].items()))
        rows_n = "".join(
            f"<tr><td>{n['node_id'][:12]}</td><td>{n['alive']}</td>"
            f"<td>{n['total_resources']}</td><td>{n['labels']}</td></tr>"
            for n in state["nodes"])
        rows_a = "".join(
            f"<tr><td>{a['actor_id'][:12]}</td><td>{a['class_name']}</td>"
            f"<td>{a['state']}</td><td>{a['name']}</td></tr>"
            for a in state["actors"][:200])
        html = _HTML.format(
            uptime=state.get("uptime_s", 0.0),
            num_nodes=sum(1 for n in state["nodes"] if n["alive"]),
            num_actors=len(state["actors"]),
            num_jobs=len(state["jobs"]),
            resources=rows_r, nodes=rows_n, actors=rows_a)
        return Response(text=html, content_type="text/html")

    # -- Prometheus ----------------------------------------------------

    async def _prometheus(self, request):
        lines = []

        def emit(name, value, labels=None, help_=None, kind="gauge"):
            if help_:
                lines.append(f"# HELP {name} {help_}")
                lines.append(f"# TYPE {name} {kind}")
            label_s = ""
            if labels:
                inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
                label_s = "{" + inner + "}"
            lines.append(f"{name}{label_s} {value}")

        state = await self._call("GetState", {})
        res = await self._call("GetClusterResources", {})
        emit("ray_tpu_cluster_nodes_alive",
             sum(1 for n in state["nodes"] if n["alive"]),
             help_="alive raylets", kind="gauge")
        first = True
        for k, v in sorted(res["total"].items()):
            emit("ray_tpu_cluster_resource_total", v, {"resource": k},
                 help_="total cluster resources" if first else None)
            first = False
        first = True
        for k, v in sorted(res["available"].items()):
            emit("ray_tpu_cluster_resource_available", v, {"resource": k},
                 help_="available cluster resources" if first else None)
            first = False
        by_state: dict = {}
        for a in state["actors"]:
            by_state[a["state"]] = by_state.get(a["state"], 0) + 1
        first = True
        for st, n in sorted(by_state.items()):
            emit("ray_tpu_actors", n, {"state": st},
                 help_="actors by state" if first else None)
            first = False

        # application metrics published by workers (util/metrics.py)
        keys = (await self._call("KVKeys", {"ns": "metrics", "prefix": ""}))["keys"]
        seen_names = set()
        for key in keys:
            blob = (await self._call("KVGet", {"ns": "metrics", "key": key}))["value"]
            if blob is None:
                continue
            try:
                payload = wire.loads(blob)
            except Exception:
                continue
            if time.time() - payload.get("time", 0) > 120:
                continue  # stale process snapshot
            # pid alone is not unique cluster-wide (two nodes can both have
            # a pid 1234; duplicate label sets make Prometheus reject the
            # whole scrape) — disambiguate with the reporting node
            proc_labels = {"pid": str(payload["pid"])}
            if payload.get("node"):
                proc_labels["node"] = str(payload["node"])[:16]
            for name, m in payload.get("metrics", {}).items():
                prom = name.replace(".", "_").replace("-", "_")
                if m["kind"] in ("counter", "gauge"):
                    for tag_json, val in m["data"].items():
                        labels = {**json.loads(tag_json), **proc_labels}
                        emit(prom, val, labels,
                             help_=m.get("description") if prom not in seen_names else None,
                             kind=m["kind"])
                        seen_names.add(prom)
                elif m["kind"] == "histogram":
                    bounds = m["data"].get("boundaries") or []
                    first_h = prom not in seen_names
                    seen_names.add(prom)
                    if first_h:
                        lines.append(f"# HELP {prom} {m.get('description', '')}")
                        lines.append(f"# TYPE {prom} histogram")
                    for tag_json, counts in m["data"].get("counts", {}).items():
                        labels = {**json.loads(tag_json), **proc_labels}
                        cum = 0
                        for b, c in zip(bounds, counts):
                            cum += c
                            emit(prom + "_bucket", cum, {**labels, "le": str(b)})
                        cum += counts[-1] if len(counts) > len(bounds) else 0
                        emit(prom + "_bucket", cum, {**labels, "le": "+Inf"})
                        emit(prom + "_count", cum, labels)
                        s = m["data"].get("sums", {}).get(tag_json)
                        if s is not None:
                            emit(prom + "_sum", s, labels)
        return Response(text="\n".join(lines) + "\n",
                        content_type="text/plain")

    # -- jobs ----------------------------------------------------------

    async def _jobs_list(self, request):
        keys = (await self._call("KVKeys", {"ns": "job", "prefix": ""}))["keys"]
        out = []
        for k in keys:
            blob = (await self._call("KVGet", {"ns": "job", "key": k}))["value"]
            if blob is not None:
                out.append(wire.loads(blob))
        return json_response(out)

    async def _job_info(self, request):
        sid = request.match_info["id"]
        blob = (await self._call("KVGet", {"ns": "job", "key": sid}))["value"]
        if blob is None:
            return json_response({"error": f"no job {sid}"}, status=404)
        return json_response(wire.loads(blob))

    async def _job_logs(self, request):
        sid = request.match_info["id"]
        blob = (await self._call("KVGet", {"ns": "job_logs", "key": sid}))["value"]
        return Response(text=(blob or b"").decode(errors="replace"),
                        content_type="text/plain")

    async def _jobs_submit(self, request):
        body = await request.json()
        if "entrypoint" not in body:
            return json_response({"error": "entrypoint required"}, status=400)

        def _submit():
            from ray_tpu_torch.job.job_manager import JobSubmissionClient

            client = JobSubmissionClient(self.gcs_address)
            return client.submit_job(
                entrypoint=body["entrypoint"],
                runtime_env=body.get("runtime_env"),
                submission_id=body.get("submission_id"),
                metadata=body.get("metadata"))

        sid = await asyncio.get_running_loop().run_in_executor(None, _submit)
        return json_response({"submission_id": sid})

    async def _job_stop(self, request):
        sid = request.match_info["id"]

        def _stop():
            from ray_tpu_torch.job.job_manager import JobSubmissionClient

            client = JobSubmissionClient(self.gcs_address)
            return client.stop_job(sid)

        ok = await asyncio.get_running_loop().run_in_executor(None, _stop)
        return json_response({"stopped": bool(ok)})


def main():
    from ray_tpu_torch._private.common import die_with_parent

    die_with_parent()

    import argparse

    from ray_tpu_torch._private.logs import setup_process_logging

    parser = argparse.ArgumentParser()
    parser.add_argument("--gcs-address", required=True)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8265)
    parser.add_argument("--log-dir", default="")
    parser.add_argument("--address-file", default="")
    args = parser.parse_args()
    setup_process_logging("dashboard", args.log_dir)

    async def run():
        head = DashboardHead(args.gcs_address, args.host, args.port)
        port = await head.start()
        if args.address_file:
            import os

            tmp = args.address_file + ".tmp"
            with open(tmp, "w") as f:
                f.write(f"{args.host}:{port}")
            os.replace(tmp, args.address_file)
        print(f"dashboard listening on http://{args.host}:{port}", flush=True)
        await asyncio.Event().wait()

    asyncio.run(run())


if __name__ == "__main__":
    main()
