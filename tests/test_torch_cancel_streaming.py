"""A mirror of ``tests/test_cancel_streaming.py`` on the port's runtime
(``ray_tpu_torch``, on the CPU): the same scenarios and assertions.

Task cancellation (cooperative + force) and streaming generators.

Reference: CoreWorker::CancelTask paths in core_worker.cc (cooperative
raise / force worker kill), num_returns="streaming" dynamic returns
(task_manager.cc + generator_waiter.cc), python/ray/tests/test_cancel.py
and test_streaming_generator.py scenarios.
"""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.exceptions import TaskCancelledError


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=6, device="cpu")
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_cancel_running_task_cooperative(cluster):
    @ray_tpu_torch.remote(num_cpus=0.5)
    def spin():
        t0 = time.time()
        while time.time() - t0 < 60.0:
            time.sleep(0.01)
        return "finished"

    ref = spin.remote()
    time.sleep(2.0)  # let it start
    t0 = time.monotonic()
    ray_tpu_torch.cancel(ref)
    with pytest.raises(TaskCancelledError):
        ray_tpu_torch.get(ref, timeout=60)
    assert time.monotonic() - t0 < 30.0  # cancelled, not run to completion


def test_cancel_pending_task(cluster):
    @ray_tpu_torch.remote(num_cpus=6.0)
    def blocker():
        time.sleep(8.0)
        return "b"

    @ray_tpu_torch.remote(num_cpus=6.0)
    def queued():
        return "q"

    b = blocker.remote()
    time.sleep(1.0)
    q = queued.remote()  # cannot schedule while blocker holds all CPUs
    time.sleep(0.5)
    ray_tpu_torch.cancel(q)
    with pytest.raises(TaskCancelledError):
        ray_tpu_torch.get(q, timeout=60)
    assert ray_tpu_torch.get(b, timeout=60) == "b"


def test_cancel_force_kills_worker(cluster):
    @ray_tpu_torch.remote(num_cpus=0.5, max_retries=0)
    def stubborn():
        while True:  # ignores cooperative cancellation forever
            try:
                time.sleep(0.5)
            except BaseException:
                pass

    ref = stubborn.remote()
    time.sleep(2.0)
    ray_tpu_torch.cancel(ref, force=True)
    with pytest.raises(TaskCancelledError):
        ray_tpu_torch.get(ref, timeout=60)


def test_cancel_finished_task_is_noop(cluster):
    @ray_tpu_torch.remote
    def quick():
        return 7

    ref = quick.remote()
    assert ray_tpu_torch.get(ref, timeout=60) == 7
    ray_tpu_torch.cancel(ref)  # no-op, no error
    assert ray_tpu_torch.get(ref, timeout=60) == 7


def test_streaming_generator_basic(cluster):
    @ray_tpu_torch.remote(num_returns="streaming")
    def gen(n):
        for i in range(n):
            yield i * 10

    out = [ray_tpu_torch.get(ref, timeout=60) for ref in gen.remote(5)]
    assert out == [0, 10, 20, 30, 40]


def test_streaming_consumed_while_producing(cluster):
    """Refs become available as items are yielded, before the task ends."""
    @ray_tpu_torch.remote(num_returns="streaming")
    def slow_gen():
        for i in range(4):
            time.sleep(0.5)
            yield i

    it = slow_gen.remote()
    t0 = time.monotonic()
    first = ray_tpu_torch.get(next(it), timeout=60)
    first_latency = time.monotonic() - t0
    rest = [ray_tpu_torch.get(r, timeout=60) for r in it]
    assert first == 0 and rest == [1, 2, 3]
    # the first item arrived well before all 4 * 0.5s of production
    assert first_latency < 1.9, f"stream not incremental: {first_latency:.1f}s"


def test_streaming_large_items_ride_the_store(cluster):
    import numpy as np

    @ray_tpu_torch.remote(num_returns="streaming")
    def big_gen():
        for i in range(3):
            yield np.full(300_000, float(i))

    vals = [ray_tpu_torch.get(r, timeout=120) for r in big_gen.remote()]
    assert [float(v[0]) for v in vals] == [0.0, 1.0, 2.0]


def test_streaming_generator_error_propagates(cluster):
    @ray_tpu_torch.remote(num_returns="streaming")
    def bad_gen():
        yield 1
        raise ValueError("mid-stream failure")

    it = bad_gen.remote()
    assert ray_tpu_torch.get(next(it), timeout=60) == 1
    with pytest.raises(Exception, match="mid-stream failure"):
        for ref in it:
            ray_tpu_torch.get(ref, timeout=60)


def test_streaming_slow_consumer_items_survive(cluster):
    """Items yielded by an already-finished generator must stay readable
    until the consumer reaches them (arrival pins outlive the free grace)."""
    @ray_tpu_torch.remote(num_returns="streaming")
    def fast_gen():
        for i in range(4):
            yield i * 3

    it = fast_gen.remote()
    time.sleep(3.0)  # generator done; free grace long past
    assert [ray_tpu_torch.get(r, timeout=60) for r in it] == [0, 3, 6, 9]


def test_streaming_error_preserves_prior_items(cluster):
    """A mid-stream failure must not clobber already-yielded values."""
    @ray_tpu_torch.remote(num_returns="streaming")
    def half_gen():
        yield "ok-0"
        yield "ok-1"
        raise RuntimeError("boom at 2")

    it = half_gen.remote()
    r0, r1 = next(it), next(it)
    with pytest.raises(Exception, match="boom at 2"):
        next(it)
    time.sleep(1.5)  # past the completion error processing
    assert ray_tpu_torch.get(r0, timeout=60) == "ok-0"
    assert ray_tpu_torch.get(r1, timeout=60) == "ok-1"


def test_streaming_non_generator_errors(cluster):
    @ray_tpu_torch.remote(num_returns="streaming")
    def not_a_gen():
        return 42

    it = not_a_gen.remote()
    with pytest.raises(Exception, match="did not return a generator"):
        next(it)


# ---------------------------------------------------------------------------
# actor-task cancellation (reference: CancelTask actor paths; queued calls
# dropped, running async calls asyncio-cancelled, force refused)
# ---------------------------------------------------------------------------


def test_cancel_queued_actor_task(cluster):
    @ray_tpu_torch.remote(num_cpus=0.5)
    class Slow:
        def work(self, seconds):
            time.sleep(seconds)
            return "done"

    a = Slow.remote()
    first = a.work.remote(6.0)
    time.sleep(1.0)  # first call occupies the single-concurrency actor
    queued = a.work.remote(0.1)
    ray_tpu_torch.cancel(queued)
    with pytest.raises(TaskCancelledError):
        ray_tpu_torch.get(queued, timeout=60)
    # the actor itself is unharmed and finishes the first call
    assert ray_tpu_torch.get(first, timeout=60) == "done"
    ray_tpu_torch.kill(a)


def test_cancel_running_async_actor_task(cluster):
    import asyncio as aio

    @ray_tpu_torch.remote(num_cpus=0.5)
    class AsyncActor:
        async def sleepy(self, seconds):
            await aio.sleep(seconds)
            return "slept"

        async def quick(self):
            return "quick"

    a = AsyncActor.remote()
    assert ray_tpu_torch.get(a.quick.remote(), timeout=60) == "quick"
    ref = a.sleepy.remote(60.0)
    time.sleep(1.5)  # in flight
    t0 = time.monotonic()
    ray_tpu_torch.cancel(ref)
    with pytest.raises(TaskCancelledError):
        ray_tpu_torch.get(ref, timeout=60)
    assert time.monotonic() - t0 < 30.0
    # actor survives and serves further calls
    assert ray_tpu_torch.get(a.quick.remote(), timeout=60) == "quick"
    ray_tpu_torch.kill(a)


def test_cancel_actor_task_force_refused(cluster):
    @ray_tpu_torch.remote(num_cpus=0.5)
    class A:
        def m(self):
            time.sleep(5.0)
            return 1

    a = A.remote()
    ref = a.m.remote()
    with pytest.raises(ValueError, match="force=True is not supported"):
        ray_tpu_torch.cancel(ref, force=True)
    assert ray_tpu_torch.get(ref, timeout=60) == 1
    ray_tpu_torch.kill(a)
