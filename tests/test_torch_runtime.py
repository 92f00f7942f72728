"""The port's runtime on a real cluster of GCS, raylet and worker processes,
on the CPU: a mirror of ``tests/test_cluster.py`` on ``ray_tpu_torch``,
tensors through the object store and task returns, the ``GPU`` resource
(one card declared through ``RAY_TPU_TORCH_GPUS``, so scheduling by cards
runs here), a cluster driven with ``cloudpickle``, ``msgpack`` and the JAX
package blocked in every process, and a tiny LM's JAX parameters served
greedily by the port's ``LLMServer`` inside a port actor, token for token
with the JAX engine.

Every cluster call carries its own timeout. Nothing here imports JAX at
module level: the workers import this module to reach its helpers."""

import asyncio
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.exceptions import TaskError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 60  # seconds, each cluster call


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.shutdown()
    saved = os.environ.get("RAY_TPU_TORCH_GPUS")
    os.environ["RAY_TPU_TORCH_GPUS"] = "1"  # the raylet detects one card
    try:
        ray_tpu_torch.init(num_cpus=4)
    finally:
        if saved is None:
            os.environ.pop("RAY_TPU_TORCH_GPUS")
        else:
            os.environ["RAY_TPU_TORCH_GPUS"] = saved
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_submit_and_get(cluster):
    @ray_tpu_torch.remote
    def add(a, b):
        return a + b

    assert ray_tpu_torch.get(add.remote(1, 2), timeout=T) == 3


def test_parallel_tasks(cluster):
    @ray_tpu_torch.remote
    def sq(x):
        return x * x

    refs = [sq.remote(i) for i in range(20)]
    assert ray_tpu_torch.get(refs, timeout=T) == [i * i for i in range(20)]


def test_task_chain_ref_args(cluster):
    @ray_tpu_torch.remote
    def inc(x):
        return x + 1

    ref = inc.remote(0)
    for _ in range(5):
        ref = inc.remote(ref)
    assert ray_tpu_torch.get(ref, timeout=T) == 6


def test_large_object_roundtrip(cluster):
    arr = np.random.rand(512, 1024)  # 4 MiB -> shared-memory store

    @ray_tpu_torch.remote
    def total(a):
        return float(a.sum())

    ref = ray_tpu_torch.put(arr)
    assert abs(ray_tpu_torch.get(total.remote(ref), timeout=T)
               - arr.sum()) < 1e-6


def test_large_task_result(cluster):
    @ray_tpu_torch.remote
    def big():
        return np.ones((1024, 1024))  # 8 MiB result -> store, not inline

    out = ray_tpu_torch.get(big.remote(), timeout=T)
    assert out.shape == (1024, 1024) and out[0, 0] == 1.0


def test_tensors_through_the_store(cluster):
    """fp32, bf16 and a non-contiguous tensor through put/get, as a task's
    argument and as its return: the same dtype, shape and bits, on the CPU."""
    g = torch.Generator().manual_seed(0)
    values = {"fp32": torch.randn(512, 1024, generator=g),
              "bf16": torch.randn(1024, 700, generator=g).bfloat16(),
              "strided": torch.randn(300, 400, generator=g).t()[::2],
              "small": torch.arange(6).reshape(2, 3)}

    @ray_tpu_torch.remote
    def echo(tensors):
        return {k: (v.dtype, tuple(v.shape), v * 1) for k, v in
                tensors.items()}

    assert {k: torch.equal(v, values[k]) for k, v in
            ray_tpu_torch.get(ray_tpu_torch.put(values), timeout=T).items()} \
        == dict.fromkeys(values, True)
    back = ray_tpu_torch.get(echo.remote(values), timeout=T)
    for k, v in values.items():
        dtype, shape, got = back[k]
        assert (dtype, shape) == (v.dtype, tuple(v.shape))
        assert got.device.type == "cpu" and torch.equal(got, v)


def test_task_error(cluster):
    @ray_tpu_torch.remote
    def boom():
        raise RuntimeError("exploded")

    with pytest.raises(TaskError, match="exploded"):
        ray_tpu_torch.get(boom.remote(), timeout=T)


def test_nested_tasks(cluster):
    @ray_tpu_torch.remote
    def inner(x):
        return x * 2

    @ray_tpu_torch.remote
    def outer(x):
        return ray_tpu_torch.get(inner.remote(x), timeout=T) + 1

    assert ray_tpu_torch.get(outer.remote(10), timeout=T) == 21


def test_actor_lifecycle(cluster):
    @ray_tpu_torch.remote
    class Counter:
        def __init__(self, start=0):
            self.n = start

        def incr(self, by=1):
            self.n += by
            return self.n

        def value(self):
            return self.n

    c = Counter.remote(100)
    refs = [c.incr.remote() for _ in range(10)]
    assert ray_tpu_torch.get(refs, timeout=T) == list(range(101, 111))
    assert ray_tpu_torch.get(c.value.remote(), timeout=T) == 110


def test_named_actor_cross_process(cluster):
    @ray_tpu_torch.remote
    class Registry:
        def __init__(self):
            self.data = {}

        def set(self, k, v):
            self.data[k] = v
            return True

        def get(self, k):
            return self.data.get(k)

    Registry.options(name="reg", lifetime="detached").remote()

    @ray_tpu_torch.remote
    def writer():
        h = ray_tpu_torch.get_actor("reg")
        return ray_tpu_torch.get(h.set.remote("from_task", 42), timeout=T)

    assert ray_tpu_torch.get(writer.remote(), timeout=T)
    h = ray_tpu_torch.get_actor("reg")
    assert ray_tpu_torch.get(h.get.remote("from_task"), timeout=T) == 42
    ray_tpu_torch.kill(h)


def test_actor_handle_passed_to_task(cluster):
    @ray_tpu_torch.remote
    class Store:
        def __init__(self):
            self.v = 0

        def bump(self):
            self.v += 1
            return self.v

    s = Store.remote()

    @ray_tpu_torch.remote
    def bump_it(handle):
        return ray_tpu_torch.get(handle.bump.remote(), timeout=T)

    assert ray_tpu_torch.get(bump_it.remote(s), timeout=T) == 1
    assert ray_tpu_torch.get(s.bump.remote(), timeout=T) == 2


def test_wait(cluster):
    @ray_tpu_torch.remote
    def slow(t):
        time.sleep(t)
        return t

    fast = slow.remote(0.01)
    slower = slow.remote(5.0)
    ready, rest = ray_tpu_torch.wait([fast, slower], num_returns=1,
                                     timeout=30)
    assert ready == [fast] and rest == [slower]


def test_cluster_resources(cluster):
    total = ray_tpu_torch.cluster_resources()
    assert total.get("CPU") == 4.0
    assert total.get("GPU") == 1.0  # detected from RAY_TPU_TORCH_GPUS
    assert len(ray_tpu_torch.nodes()) == 1


def test_async_actor(cluster):
    @ray_tpu_torch.remote
    class AsyncActor:
        async def work(self, x):
            await asyncio.sleep(0.01)
            return x + 1

    a = AsyncActor.options(max_concurrency=4).remote()
    out = ray_tpu_torch.get([a.work.remote(i) for i in range(8)], timeout=T)
    assert out == [i + 1 for i in range(8)]


def test_gpu_actor_pends_until_the_card_is_free(cluster):
    """The node has one ``GPU``: a second ``num_gpus=1`` actor waits until
    the first is killed, then starts."""
    @ray_tpu_torch.remote(num_gpus=1, num_cpus=0)
    class Holder:
        def ping(self):
            return os.getpid()

    first = Holder.remote()
    assert ray_tpu_torch.get(first.ping.remote(), timeout=T) > 0
    second = Holder.remote()
    pending = second.ping.remote()
    ready, _ = ray_tpu_torch.wait([pending], timeout=3.0)
    assert ready == []
    assert ray_tpu_torch.available_resources().get("GPU", 0.0) == 0.0
    ray_tpu_torch.kill(first)
    assert ray_tpu_torch.get(pending, timeout=T) > 0
    ray_tpu_torch.kill(second)


def test_gpu_task_runs_on_the_declared_card(cluster):
    """The task's worker sees the one card its lease holds."""
    @ray_tpu_torch.remote(num_gpus=1)
    def on_card():
        return os.environ.get("CUDA_VISIBLE_DEVICES")

    assert ray_tpu_torch.get(on_card.remote(), timeout=T) == "0"


def test_gpu_lease_gives_its_card_back_once_its_worker_exited(cluster):
    """A GPU task's worker is retired with its lease, and may still hold the
    card's memory while it exits: the next ``num_gpus=1`` task gets the
    card only once that process is gone. The first task makes its worker
    take 2 s to act on the raylet's SIGTERM (its handler's stop event sets
    late), so a card handed back at the lease's return would start the
    second task while the first process still lives."""
    @ray_tpu_torch.remote(num_gpus=1)
    def slow_to_exit():
        import signal
        import threading

        handler = signal.getsignal(signal.SIGTERM)
        stop = next(c.cell_contents for c in handler.__closure__
                    if isinstance(c.cell_contents, threading.Event))
        stop.set = lambda: threading.Timer(
            2.0, threading.Event.set, (stop,)).start()
        return os.getpid()

    # another shape, so the owner asks for a lease of its own rather than
    # run it on the first task's cached one
    @ray_tpu_torch.remote(num_gpus=1, num_cpus=0.5)
    def alive(pid):
        try:
            os.kill(pid, 0)  # a zombie not yet reaped counts as alive
        except ProcessLookupError:
            return os.getpid(), False
        return os.getpid(), True

    pid = ray_tpu_torch.get(slow_to_exit.remote(), timeout=T)
    other, first_alive = ray_tpu_torch.get(alive.remote(pid), timeout=T)
    assert other != pid and first_alive is False


# ---------------------------------------------------------------------------
# a cluster in which cloudpickle, msgpack and the JAX package cannot load
# ---------------------------------------------------------------------------

_BLOCKED = ("cloudpickle", "msgpack", "psutil", "boto3", "jax", "ray_tpu")

_DRIVER = textwrap.dedent("""
    import sys
    import ray_tpu_torch as rt

    rt.init(num_cpus=2, device="cpu")

    def make(k):
        def scale(x):
            return x * k

        @rt.remote
        def nested(x):
            return scale(x) + 1

        @rt.remote
        class Local:
            def __init__(self):
                self.total = k

            def add(self, v):
                self.total += v
                return self.total

            def loaded(self, names):
                return [n for n in names if n in sys.modules]

        return nested, Local

    nested, Local = make(3)
    print(rt.get(nested.remote(4), timeout=60))
    a = Local.remote()
    print(rt.get([a.add.remote(1), a.add.remote(2)], timeout=60))
    print(rt.get(a.loaded.remote(BLOCKED), timeout=60))
    print(rt.get(rt.put(lambda y: y + 100), timeout=60)(1))
    rt.shutdown()
""")


def test_cluster_without_cloudpickle_msgpack_or_jax(tmp_path):
    """A nested function and a local actor class run on a port cluster in
    which the third-party ``cloudpickle`` and ``msgpack`` and the JAX
    package fail to import in the driver, the GCS, the raylet and every
    worker (shadowed on ``PYTHONPATH`` by modules that raise)."""
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
    assert out.stdout.split("\n")[:4] == ["13", "[4, 6]", "[]", "101"]


# ---------------------------------------------------------------------------
# a tiny LM served inside an actor against the JAX engine
# ---------------------------------------------------------------------------

ENGINE = dict(max_num_seqs=4, max_model_len=128, page_size=16,
              prefill_bucket_min=16)
PROMPTS = ["hello world", list(range(3, 3 + 30)), "a",
           list(range(40, 40 + 17)), "the quick brown fox", "zz"]


def test_actor_serves_jax_converted_tiny_lm_token_for_token(cluster):
    """The JAX engine's tiny fp32 parameters (its Pallas flash forward in
    interpret mode), converted by ``from_jax_params`` and put in the object
    store, build the port's ``LLMServer`` inside an actor, which answers the
    prompts concurrently: greedy tokens equal the JAX engine's."""
    pytest.importorskip("flax")
    import jax
    import jax.numpy as jnp

    from ray_tpu.llm.config import EngineConfig as JaxEngineConfig
    from ray_tpu.llm.config import LLMConfig as JaxLLMConfig
    from ray_tpu.llm.config import SamplingParams as JaxSamplingParams
    from ray_tpu.llm.engine import JaxLLMEngine
    from ray_tpu_torch.models import from_jax_params

    jax_engine = JaxLLMEngine(JaxLLMConfig(
        model_id="tiny", engine_config=JaxEngineConfig(**ENGINE),
        model_overrides={"attention_impl": "flash_interpret",
                         "dtype": jnp.float32}), seed=0)
    want = jax_engine.generate(PROMPTS, JaxSamplingParams(max_tokens=12))
    params = from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                    jax_engine.params))

    @ray_tpu_torch.remote
    class Server:
        def __init__(self, params, engine):
            from ray_tpu_torch.llm.config import EngineConfig, LLMConfig
            from ray_tpu_torch.llm.serve_llm import LLMServer

            self.server = LLMServer(
                LLMConfig(model_id="tiny",
                          engine_config=EngineConfig(**engine),
                          model_overrides={"dtype": "float32"}),
                params=params, device="cpu")

        def answer(self, prompts, max_tokens):
            async def all_of():
                return await asyncio.gather(*(
                    self.server.completions(p, max_tokens=max_tokens)
                    for p in prompts))

            return [out["token_ids"] for out in asyncio.run(all_of())]

    server = Server.remote(ray_tpu_torch.put(params), ENGINE)
    got = ray_tpu_torch.get(server.answer.remote(PROMPTS, 12), timeout=120)
    assert got == [list(o.token_ids) for o in want]
    ray_tpu_torch.kill(server)


def test_publish_metrics_reaches_the_gcs(cluster):
    """``util.metrics.publish_metrics`` ships the driver's registry to the
    GCS KV under the periodic flush's key."""
    from ray_tpu_torch._private import wire
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch._private.core_worker import _obs_proc_tag
    from ray_tpu_torch.util import metrics

    metrics.Counter("ray_tpu_torch_test_published").inc(3)
    metrics.publish_metrics()
    core = worker_mod.global_worker()
    reply = core._run(core._gcs_call("KVGet", {
        "ns": "metrics", "key": f"proc_{_obs_proc_tag()}"}), timeout=T)
    payload = wire.loads(reply["value"])
    assert payload["pid"] == os.getpid()
    snap = payload["metrics"]["ray_tpu_torch_test_published"]
    assert snap["kind"] == "counter" and 3.0 in snap["data"].values()
