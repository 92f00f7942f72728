"""A mirror of ``tests/test_task_dependencies.py`` on the port's runtime
(``ray_tpu_torch``, on the CPU): the same scenarios and assertions.

Dependent-task submission regressions (the round-3 PushTaskBatch
deadlock): chains and fan-in graphs submitted before any get must complete,
and task batches must never serialize independent long tasks.

Reference: the owner-side dependency resolver shape —
src/ray/core_worker/task_submission/dependency_resolver.cc used by
normal_task_submitter.cc:32 (deps resolve before dispatch).
"""

import time

import pytest

import ray_tpu_torch


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=8, device="cpu")
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_deep_chain_before_get(cluster):
    @ray_tpu_torch.remote
    def inc(x):
        return x + 1

    r = 0
    for _ in range(100):
        r = inc.remote(r)
    assert ray_tpu_torch.get(r, timeout=180) == 100


def test_mixed_fanin_graph_before_get(cluster):
    @ray_tpu_torch.remote
    def inc(x):
        return x + 1

    @ray_tpu_torch.remote
    def add(*xs):
        return sum(xs)

    leaves = [inc.remote(i) for i in range(8)]          # 1..8
    mids = [add.remote(leaves[i], leaves[i + 1]) for i in range(0, 8, 2)]
    root = add.remote(*mids)
    assert ray_tpu_torch.get(root, timeout=180) == sum(range(1, 9))


def test_chain_on_large_objects(cluster):
    """Chains through store-resident (non-inline) values."""
    import numpy as np

    @ray_tpu_torch.remote
    def bump(a):
        return a + 1.0

    r = bump.remote(np.zeros(300_000))
    for _ in range(5):
        r = bump.remote(r)
    out = ray_tpu_torch.get(r, timeout=180)
    assert out.shape == (300_000,) and float(out[0]) == 6.0


def test_failed_producer_propagates_to_dependents(cluster):
    @ray_tpu_torch.remote
    def boom():
        raise ValueError("producer failed")

    @ray_tpu_torch.remote
    def consume(x):
        return x

    ref = consume.remote(consume.remote(boom.remote()))
    with pytest.raises(Exception, match="producer failed"):
        ray_tpu_torch.get(ref, timeout=180)


def test_long_tasks_run_in_parallel(cluster):
    """Batching must not serialize independent long tasks onto one worker."""
    @ray_tpu_torch.remote
    def slow(i):
        time.sleep(1.5)
        return i

    # warm the pool so the measurement sees steady state, not cold spawns
    ray_tpu_torch.get([slow.remote(i) for i in range(4)], timeout=180)
    t0 = time.monotonic()
    out = ray_tpu_torch.get([slow.remote(i) for i in range(4)], timeout=180)
    dt = time.monotonic() - t0
    assert sorted(out) == [0, 1, 2, 3]
    assert dt < 4.5, f"independent tasks serialized: {dt:.1f}s"


def test_infeasible_tasks_fail_even_when_queued_deep(cluster):
    """2+ queued infeasible tasks must all get the scheduling error (the
    respawn loop must not make the last-pusher drain unreachable)."""
    from ray_tpu_torch._private.config import RAY_CONFIG
    from ray_tpu_torch.exceptions import TaskError

    @ray_tpu_torch.remote(resources={"NoSuchThing": 1.0})
    def impossible(i):
        return i

    old = RAY_CONFIG.infeasible_task_timeout_s
    RAY_CONFIG.infeasible_task_timeout_s = 3.0
    try:
        refs = [impossible.remote(i) for i in range(3)]
        for ref in refs:
            with pytest.raises(TaskError, match="scheduling failed"):
                ray_tpu_torch.get(ref, timeout=120)
    finally:
        RAY_CONFIG.infeasible_task_timeout_s = old
