"""The port's Serve (``ray_tpu_torch/serve``) on a port cluster, on the CPU:
a mirror of ``tests/test_serve.py``, ``tests/test_serve_advanced.py`` and
``tests/test_serve_streaming.py``. The HTTP proxy (``asyncio.start_server``
in the port, aiohttp in the JAX package) is driven with ``urllib``, and a
deployment, the proxy and a weight store also run in a cluster in which
``aiohttp``, ``grpc``, ``cloudpickle`` and the JAX package cannot load.

Deployment targets defined inside a test travel by value (the port's
pickler). Every cluster call carries its own timeout."""

import json
import os
import subprocess
import sys
import textwrap
import threading
import time
import urllib.error
import urllib.request

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 120


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=10, device="cpu")
    yield ray_tpu_torch
    try:
        serve.shutdown()
    except Exception:
        pass
    ray_tpu_torch.shutdown()


def _post(port, path, body, headers=None, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


# ---------------------------------------------------------------------------
# tests/test_serve.py
# ---------------------------------------------------------------------------


def test_function_deployment(cluster):
    @serve.deployment(ray_actor_options={"num_cpus": 0.5})
    def doubler(body):
        return body["x"] * 2

    handle = serve.run(doubler.bind())
    assert ray_tpu_torch.get(handle.remote({"x": 21}), timeout=T) == 42
    serve.delete("doubler")


def test_class_deployment_replicas_and_status(cluster):
    @serve.deployment(num_replicas=2, ray_actor_options={"num_cpus": 0.5})
    class Counter:
        def __init__(self, start):
            self.n = start

        def __call__(self, body):
            self.n += 1
            return {"base": self.n}

        def peek(self, body=None):
            return self.n

    handle = serve.run(Counter.bind(10))
    outs = ray_tpu_torch.get([handle.remote({}) for _ in range(6)],
                             timeout=T)
    assert all(o["base"] >= 11 for o in outs)
    st = serve.status()
    assert st["Counter"]["num_replicas"] == 2
    peek = handle.options(method_name="peek")
    assert ray_tpu_torch.get(peek.remote(), timeout=T) >= 10
    # broadcast reaches every replica, bypassing routing
    assert len(handle.broadcast("peek")) == 2
    serve.delete("Counter")


def test_model_composition(cluster):
    @serve.deployment(ray_actor_options={"num_cpus": 0.5})
    class Child:
        def __call__(self, body):
            return body["v"] + 1

    @serve.deployment(ray_actor_options={"num_cpus": 0.5})
    class Parent:
        def __init__(self, child):
            self.child = child

        def __call__(self, body):
            inner = ray_tpu_torch.get(self.child.remote({"v": body["v"]}))
            return inner * 10

    child_app = Child.bind()
    serve.run(child_app)
    handle = serve.run(Parent.bind(child_app))
    assert ray_tpu_torch.get(handle.remote({"v": 4}), timeout=T) == 50
    serve.delete("Parent")
    serve.delete("Child")


def test_batching(cluster):
    @serve.deployment(ray_actor_options={"num_cpus": 0.5})
    class Batched:
        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.05)
        async def __call__(self, bodies):
            n = len(bodies)
            return [{"batch_size": n, "x": b["x"]} for b in bodies]

    handle = serve.run(Batched.bind())
    outs = ray_tpu_torch.get([handle.remote({"x": i}) for i in range(4)],
                             timeout=T)
    assert {o["x"] for o in outs} == {0, 1, 2, 3}
    assert max(o["batch_size"] for o in outs) >= 2
    serve.delete("Batched")


def test_replica_restart_on_death(cluster):
    @serve.deployment(ray_actor_options={"num_cpus": 0.5})
    class Fragile:
        def __call__(self, body):
            if body.get("die"):
                os._exit(1)
            return "alive"

    handle = serve.run(Fragile.bind())
    assert ray_tpu_torch.get(handle.remote({}), timeout=T) == "alive"
    try:
        ray_tpu_torch.get(handle.remote({"die": True}), timeout=60)
    except Exception:
        pass
    controller = ray_tpu_torch.get_actor("serve_controller")
    deadline = time.time() + 60
    ok = False
    while time.time() < deadline:
        ray_tpu_torch.get(controller.check_replicas.remote(), timeout=T)
        handle._refresh(force=True)
        try:
            if ray_tpu_torch.get(handle.remote({}), timeout=30) == "alive":
                ok = True
                break
        except Exception:
            time.sleep(0.5)
    assert ok
    serve.delete("Fragile")


def test_http_proxy(cluster):
    @serve.deployment(ray_actor_options={"num_cpus": 0.5})
    def echo(body):
        if body.get("fail"):
            raise ValueError("asked to fail")
        return {"echo": body}

    serve.run(echo.bind())
    port = serve.start_http_proxy()
    assert _post(port, "/echo", {"hi": 1}) == (200,
                                               {"result": {"echo": {"hi": 1}}})
    # the same proxy again (a named detached actor): the same port
    assert serve.start_http_proxy() == port
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/-/healthz",
                                timeout=60) as resp:
        assert json.loads(resp.read()) == {"ok": True}
    # a failing request answers 500 with the error, as aiohttp's proxy does
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(port, "/echo", {"fail": True})
    assert err.value.code == 500
    assert "asked to fail" in json.loads(err.value.read())["error"]
    # an unknown route
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(f"http://127.0.0.1:{port}/a/b", timeout=60)
    assert err.value.code == 404
    serve.delete("echo")


def test_http_proxy_keep_alive(cluster):
    """Two requests on one HTTP/1.1 connection, as a pooled client sends
    them."""
    import http.client

    @serve.deployment(ray_actor_options={"num_cpus": 0.5})
    def plus(body):
        return body["x"] + 1

    serve.run(plus.bind())
    port = serve.start_http_proxy()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        for x in (1, 5):
            conn.request("POST", "/plus", body=json.dumps({"x": x}),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert resp.status == 200
            assert json.loads(resp.read()) == {"result": x + 1}
    finally:
        conn.close()
    serve.delete("plus")


def test_replica_peak_sampling_under_stats_lock():
    """The replica's ongoing/peak counters under its stats lock: a burst
    that fully drains between two autoscaler polls is still seen, once.
    No cluster: the replica is driven directly on a private event loop."""
    import asyncio

    from ray_tpu_torch._private.serialization import dumps
    from ray_tpu_torch.serve.api import _Replica

    class SlowTarget:
        def __init__(self):
            self.gate = asyncio.Event()

        async def __call__(self):
            await self.gate.wait()
            return "ok"

    loop = asyncio.new_event_loop()
    runner = threading.Thread(target=loop.run_forever, daemon=True)
    runner.start()
    try:
        replica = _Replica.cls(dumps(SlowTarget), dumps(((), {})))
        args_blob = dumps(((), {}))
        futs = [asyncio.run_coroutine_threadsafe(
            replica.handle_request("__call__", args_blob), loop)
            for _ in range(3)]
        deadline = time.monotonic() + 10
        while replica.num_ongoing() < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert replica.num_ongoing() == 3
        loop.call_soon_threadsafe(replica._callable.gate.set)
        assert [f.result(10) for f in futs] == ["ok"] * 3
        assert replica.num_ongoing() == 0
        assert replica.take_ongoing_peak() == 3
        assert replica.take_ongoing_peak() == 0
        stats = replica.take_stats()
        assert (stats["arrived"], stats["completed"]) == (3, 3)
    finally:
        loop.call_soon_threadsafe(loop.stop)
        runner.join(5)
        loop.close()


# ---------------------------------------------------------------------------
# tests/test_serve_streaming.py
# ---------------------------------------------------------------------------


def test_handle_streaming_chunks_incremental(cluster):
    @serve.deployment(ray_actor_options={"num_cpus": 0.5})
    class Tokens:
        async def __call__(self, body):
            import asyncio

            for i in range(4):
                await asyncio.sleep(0.4)
                yield {"token": i}

    handle = serve.run(Tokens.bind(), name="tok")
    # time the stream, not the replica's start
    ray_tpu_torch.get([r.health.remote() for r in handle._replicas],
                      timeout=T)
    t0 = time.monotonic()
    gen = handle.options(stream=True).remote({})
    first = ray_tpu_torch.get(next(gen), timeout=60)
    first_latency = time.monotonic() - t0
    rest = [ray_tpu_torch.get(r, timeout=60) for r in gen]
    assert first == {"token": 0}
    assert rest == [{"token": 1}, {"token": 2}, {"token": 3}]
    assert first_latency < 1.5, f"stream not incremental: {first_latency}"
    serve.delete("tok")


def test_sync_generator_target_streams(cluster):
    @serve.deployment(ray_actor_options={"num_cpus": 0.5})
    def letters(body):
        for c in "abc":
            yield c

    handle = serve.run(letters.bind(), name="letters")
    out = [ray_tpu_torch.get(r, timeout=60)
           for r in handle.options(stream=True).remote({})]
    assert out == ["a", "b", "c"]
    serve.delete("letters")


@pytest.mark.parametrize("how", ["query", "accept"])
def test_http_proxy_streams_chunks(cluster, how):
    """Each chunk reaches the client as the replica yields it: the first
    arrives well before the last is produced (chunks are not batched)."""
    @serve.deployment(ray_actor_options={"num_cpus": 0.5})
    class Stream:
        async def __call__(self, body):
            import asyncio

            for i in range(3):
                await asyncio.sleep(0.4)
                yield {"i": i}

    serve.run(Stream.bind(), name="stream")
    port = serve.start_http_proxy()
    path, headers = ("/stream?stream=1", {}) if how == "query" else \
        ("/stream", {"Accept": "text/event-stream"})
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=b"{}",
        headers={"Content-Type": "application/json", **headers})
    chunks, arrivals = [], []
    t0 = time.monotonic()
    with urllib.request.urlopen(req, timeout=60) as resp:
        assert resp.headers["Transfer-Encoding"] == "chunked"
        for line in resp:
            line = line.strip()
            if line:
                chunks.append(json.loads(line))
                arrivals.append(time.monotonic() - t0)
    assert chunks == [{"i": 0}, {"i": 1}, {"i": 2}]
    assert arrivals[2] - arrivals[0] > 0.5, arrivals
    serve.delete("stream")


def test_rolling_update_zero_dropped(cluster):
    """Redeploying keeps serving: requests issued continuously across the
    rollout all succeed, and the new version takes over."""
    def make_app(version):
        @serve.deployment(num_replicas=2, ray_actor_options={"num_cpus": 0.2})
        class App:
            def __call__(self, body):
                time.sleep(0.05)
                return {"version": version}

        return App.bind()

    serve.run(make_app(1), name="roll")
    results, errors = [], []
    stop = threading.Event()

    def hammer():
        h = serve.get_app_handle("roll")
        while not stop.is_set():
            try:
                results.append(ray_tpu_torch.get(h.remote({}), timeout=60))
            except Exception as e:  # any dropped request fails the test
                errors.append(e)
            time.sleep(0.05)

    t = threading.Thread(target=hammer, daemon=True)
    t.start()
    time.sleep(1.0)
    serve.run(make_app(2), name="roll")  # rolling redeploy
    deadline = time.time() + 90
    while time.time() < deadline:
        tail = [r["version"] for r in results[-6:]]
        if len(tail) == 6 and all(v == 2 for v in tail):
            break
        time.sleep(0.5)
    stop.set()
    t.join(timeout=30)
    assert not errors, f"dropped requests during rollout: {errors[:3]}"
    assert {r["version"] for r in results} == {1, 2}
    tail = [r["version"] for r in results[-6:]]
    assert all(v == 2 for v in tail), f"rollout did not complete: {tail}"
    serve.delete("roll")


# ---------------------------------------------------------------------------
# tests/test_serve_advanced.py
# ---------------------------------------------------------------------------


def test_long_poll_topology_updates(cluster):
    @serve.deployment(num_replicas=1, ray_actor_options={"num_cpus": 0.5})
    def echo(body):
        return body

    handle = serve.run(echo.bind(), name="lp_echo")
    v0 = handle._version
    changed = {}

    def watch():
        deadline = time.monotonic() + 40
        result = False
        while time.monotonic() < deadline:
            result = handle._long_poll_refresh(timeout=10.0) or result
            if len(handle._replicas) == 2:
                break
        changed["result"] = result

    t = threading.Thread(target=watch)
    t.start()
    time.sleep(0.3)
    serve.run(echo.options(num_replicas=2).bind(), name="lp_echo")
    t.join(timeout=50)
    assert not t.is_alive()
    assert changed["result"] is True
    assert handle._version != v0
    assert len(handle._replicas) == 2
    serve.delete("lp_echo")


def test_redeploy_version_monotonic(cluster):
    @serve.deployment(num_replicas=1, ray_actor_options={"num_cpus": 0.5})
    def f(body):
        return 1

    h1 = serve.run(f.bind(), name="vmono")
    v1 = h1._version
    h2 = serve.run(f.options(num_replicas=2).bind(), name="vmono")
    assert h2._version > v1
    serve.delete("vmono")


def test_multiplexed_models(cluster):
    @serve.deployment(num_replicas=2, ray_actor_options={"num_cpus": 0.5})
    class Zoo:
        def __init__(self):
            self.loads = []

        @serve.multiplexed(max_num_models_per_replica=2)
        async def get_model(self, model_id: str):
            self.loads.append(model_id)
            return {"id": model_id}

        async def __call__(self, body):
            model = await self.get_model(serve.get_multiplexed_model_id())
            return {"model": model["id"], "loads": list(self.loads)}

    handle = serve.run(Zoo.bind())
    m1 = handle.options(multiplexed_model_id="m1")
    outs = ray_tpu_torch.get([m1.remote({}) for _ in range(4)], timeout=T)
    assert all(o["model"] == "m1" for o in outs)
    assert all(o["loads"].count("m1") == 1 for o in outs)
    m2 = handle.options(multiplexed_model_id="m2")
    assert ray_tpu_torch.get(m2.remote({}), timeout=T)["model"] == "m2"
    serve.delete("Zoo")


def test_multiplexed_single_flight_and_lru(cluster):
    @serve.deployment(num_replicas=1, ray_actor_options={"num_cpus": 0.5})
    class Zoo:
        def __init__(self):
            self.loads = []

        @serve.multiplexed(max_num_models_per_replica=2)
        async def get_model(self, model_id: str):
            import asyncio

            self.loads.append(model_id)
            await asyncio.sleep(0.3)  # a slow load window for the race
            return model_id

        async def __call__(self, body):
            await self.get_model(body["m"])
            return list(self.loads)

    handle = serve.run(Zoo.bind(), name="sflight")
    outs = ray_tpu_torch.get([handle.remote({"m": "a"}) for _ in range(4)],
                             timeout=T)
    assert max(o.count("a") for o in outs) == 1  # loaded once, not 4x
    ray_tpu_torch.get(handle.remote({"m": "b"}), timeout=T)
    ray_tpu_torch.get(handle.remote({"m": "c"}), timeout=T)  # evicts "a"
    loads = ray_tpu_torch.get(handle.remote({"m": "a"}), timeout=T)
    assert loads == ["a", "b", "c", "a"]
    serve.delete("sflight")


def test_num_replicas_conflict_rejected():
    with pytest.raises(ValueError, match="mutually exclusive"):
        serve.deployment(num_replicas=3,
                         autoscaling_config={"min_replicas": 1})(lambda b: b)
    with pytest.raises(ValueError, match="unknown autoscaling_config"):
        serve.deployment(autoscaling_config={"max_replica": 2})(lambda b: b)


# ---------------------------------------------------------------------------
# Serve and the weight store with aiohttp, grpc, cloudpickle and JAX blocked
# ---------------------------------------------------------------------------

_BLOCKED = ("aiohttp", "grpc", "cloudpickle", "msgpack", "jax", "ray_tpu")

_DRIVER = textwrap.dedent("""
    import json, sys, urllib.request
    import numpy as np
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.weights import WeightStore

    rt.init(num_cpus=4, device="cpu")
    store = WeightStore("blocked")

    class Model:
        def __init__(self):
            self.w = 0.0

        def __call__(self, body):
            return {"y": body["x"] * self.w,
                    "loaded": [n for n in BLOCKED if n in sys.modules]}

        def update_weights(self, name):
            tree, v = WeightStore(name, create=False).pull(
                return_version=True)
            self.w = float(tree["w"][0])
            return v

    app = serve.deployment(Model, name="m", num_replicas=2,
                           ray_actor_options={"num_cpus": 0.5}).bind()
    handle = serve.run(app)
    v = store.publish({"w": np.full(3, 2.0, np.float32)}, compression="bf16")
    print(handle.broadcast("update_weights", "blocked") == [v, v])
    port = serve.start_http_proxy()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/m", data=json.dumps({"x": 4}).encode(),
        headers={"Content-Type": "application/json"})
    out = json.loads(urllib.request.urlopen(req, timeout=60).read())
    print(out["result"]["y"], out["result"]["loaded"])
    from ray_tpu_torch.serve.grpc_ingress import (ServeGrpcClient,
                                                  start_grpc_proxy)
    client = ServeGrpcClient(f"127.0.0.1:{start_grpc_proxy()}")
    out = client.call("m", {"x": 4}, timeout=60)
    print(out["y"], out["loaded"])
    client.close()
    print([n for n in BLOCKED if n in sys.modules])
    serve.shutdown()
    rt.shutdown()
""")


def test_serve_and_weights_without_aiohttp_grpc_cloudpickle_or_jax(
        tmp_path):
    """A deployment behind the HTTP proxy takes a bf16-encoded weight version
    by broadcast and answers through the gRPC ingress too, in a cluster
    whose driver, GCS, raylet and workers cannot import aiohttp, grpc,
    cloudpickle, msgpack or the JAX package (shadowed on ``PYTHONPATH`` by
    modules that raise)."""
    shim = tmp_path / "shim"
    shim.mkdir()
    for name in _BLOCKED:
        (shim / f"{name}.py").write_text(
            f"raise ImportError('{name} is blocked in this test')\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RAY_TPU_TORCH_")}
    env["PYTHONPATH"] = f"{shim}{os.pathsep}{REPO}"
    out = subprocess.run(
        [sys.executable, "-c", f"BLOCKED = {_BLOCKED!r}\n" + _DRIVER],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split("\n")[:4] == ["True", "8.0 []", "8.0 []", "[]"]
