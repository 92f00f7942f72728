"""The port's utilities, DAG authoring and channels through the runtime, on
the CPU: a mirror of ``tests/test_utils_dag.py`` (``ActorPool``, ``Queue``,
function graphs, a compiled actor graph read with ``get``, a seqlock round
trip, a channel read in another process, metrics, the state API and the
microbenchmark's ``timeit``), each test asserting what its twin asserts."""

import time
import uuid

import pytest
import torch

import ray_tpu_torch


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, device="cpu")
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_dag_function_graph(cluster):
    from ray_tpu_torch.dag import InputNode

    @ray_tpu_torch.remote(num_cpus=0.5)
    def plus(a, b):
        return a + b

    @ray_tpu_torch.remote(num_cpus=0.5)
    def times(a, b):
        return a * b

    with InputNode() as inp:
        dag = times.bind(plus.bind(inp, 1), 3)
    assert ray_tpu_torch.get(dag.execute(4), timeout=60) == 15
    assert ray_tpu_torch.get(dag.execute(0), timeout=60) == 3
    # a function node cannot be compiled: compiled graphs run actor methods
    with pytest.raises(ValueError, match="actor methods only"):
        dag.experimental_compile()


def test_dag_actor_compiled(cluster):
    from ray_tpu_torch.dag import InputNode

    @ray_tpu_torch.remote(num_cpus=0.5)
    class Stage:
        def __init__(self, mult):
            self.mult = mult

        def apply(self, x):
            return x * self.mult

    with InputNode() as inp:
        s1 = Stage.bind(2)
        s2 = Stage.bind(10)
        dag = s2.apply.bind(s1.apply.bind(inp))
    compiled = dag.experimental_compile()
    assert ray_tpu_torch.get(compiled.execute(3), timeout=60) == 60
    assert ray_tpu_torch.get(compiled.execute(5), timeout=60) == 100
    compiled.teardown()


def test_channel_seqlock_roundtrip(cluster):
    from ray_tpu_torch.dag.channels import Channel

    name = f"test_chan_{uuid.uuid4().hex[:8]}"
    writer = Channel(name, capacity=1 << 16, create=True)
    reader = Channel(name)
    arr = torch.arange(100, dtype=torch.float64)
    writer.write({"arr": arr, "step": 1})
    out = reader.read(timeout=10)
    assert torch.equal(out["arr"], arr)
    writer.write({"arr": arr * 2, "step": 2})
    out2 = reader.read(timeout=10)
    assert out2["step"] == 2 and torch.equal(out2["arr"], arr * 2)
    writer.close(unlink=True)


def test_channel_cross_process(cluster):
    from ray_tpu_torch.dag.channels import Channel

    name = f"test_chan_xp_{uuid.uuid4().hex[:8]}"
    writer = Channel(name, capacity=1 << 16, create=True)

    @ray_tpu_torch.remote(num_cpus=0.5)
    def consume(chan_name):
        from ray_tpu_torch.dag.channels import Channel as C

        ch = C(chan_name)
        v = ch.read(timeout=30)
        return v["value"] + 1

    ref = consume.remote(name)
    time.sleep(0.3)
    writer.write({"value": 41})
    assert ray_tpu_torch.get(ref, timeout=60) == 42
    writer.close(unlink=True)


def test_actor_pool(cluster):
    from ray_tpu_torch.util import ActorPool

    @ray_tpu_torch.remote(num_cpus=0.5)
    class Worker:
        def double(self, x):
            return x * 2

    pool = ActorPool([Worker.remote() for _ in range(2)])
    out = pool.map(lambda a, v: a.double.remote(v), list(range(8)))
    assert sorted(out) == [i * 2 for i in range(8)]


def test_queue(cluster):
    from ray_tpu_torch.util import Queue

    q = Queue()
    q.put({"a": 1})
    q.put({"a": 2})
    assert q.qsize() == 2
    assert q.get()["a"] == 1
    assert not q.empty()
    q.shutdown()


def test_metrics(cluster):
    from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram, scrape_metrics

    c = Counter("test_requests", tag_keys=("route",))
    c.inc(2, {"route": "/a"})
    c.inc(3, {"route": "/a"})
    g = Gauge("test_depth")
    g.set(7)
    h = Histogram("test_latency", boundaries=[1, 10])
    h.observe(0.5)
    h.observe(50)
    snap = scrape_metrics()
    assert list(snap["test_requests"]["data"].values())[0] == 5
    assert list(snap["test_depth"]["data"].values())[0] == 7


def test_state_api(cluster):
    from ray_tpu_torch.util import state

    @ray_tpu_torch.remote
    class Marker:
        def ping(self):
            return 1

    m = Marker.options(name="state_marker").remote()
    ray_tpu_torch.get(m.ping.remote(), timeout=60)
    actors = state.list_actors(state_filter="ALIVE")
    assert any(a["name"] == "state_marker" for a in actors)
    summary = state.summarize_cluster()
    assert summary["num_nodes"] == 1
    ray_tpu_torch.kill(m)


def test_microbenchmark_smoke(cluster):
    from ray_tpu_torch._private.microbenchmark import timeit

    @ray_tpu_torch.remote(num_cpus=0.2)
    def f():
        return 1

    row = timeit("smoke", lambda: (ray_tpu_torch.get(f.remote(), timeout=60), 1)[1],
                 duration=0.5)
    assert row["rate_per_s"] > 1
