"""The port's compiled graphs (``ray_tpu_torch/dag``) on the CPU: a mirror of
``tests/test_compiled_dag.py``. Static per-actor schedules run over the
shared-memory channel plane; a 3-stage actor pipeline must be at least 5x
faster per iteration than eager ``.remote()`` chaining, and every stage
must observe every value.

Actor classes here travel by name: the port's workers import this module,
so it imports nothing of JAX.
"""

import statistics
import time

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.dag import InputNode, MultiOutputNode


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, device="cpu")
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote(num_cpus=0.3)
class Stage:
    def __init__(self, add):
        self.add = add
        self.seen = []

    def apply(self, x):
        self.seen.append(x)
        return x + self.add

    def history(self):
        return self.seen


def test_compiled_pipeline_correct(cluster):
    with InputNode() as inp:
        s1, s2, s3 = Stage.bind(1), Stage.bind(10), Stage.bind(100)
        dag = s3.apply.bind(s2.apply.bind(s1.apply.bind(inp)))
    compiled = dag.experimental_compile()
    try:
        for i in range(20):
            assert compiled.execute(i).get(timeout=60) == i + 111
        # tensors cross the channel plane as tensors
        x = torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)
        out = compiled.execute(x).get(timeout=60)
        assert out.dtype == torch.bfloat16 and torch.equal(out, x + 111)
    finally:
        compiled.teardown()


def test_compiled_pipeline_every_value_observed(cluster):
    """Reader-ack channels must deliver EVERY value to every stage, in
    order — nothing skipped for slow consumers."""

    @ray_tpu_torch.remote(num_cpus=0.3)
    class Slow:
        def __init__(self):
            self.seen = []

        def apply(self, x):
            time.sleep(0.02)  # slower than the producer
            self.seen.append(x)
            return x

        def history(self):
            return self.seen

    with InputNode() as inp:
        fast = Stage.bind(0)
        slow = Slow.bind()
        dag = slow.apply.bind(fast.apply.bind(inp))
    compiled = dag.experimental_compile()
    try:
        n = 30
        refs = [compiled.execute(i) for i in range(n)]
        assert [r.get(timeout=120) for r in refs] == list(range(n))
    finally:
        compiled.teardown(kill_actors=False)
    # both stages saw every value in order (the graph actors survive
    # teardown so their history can be inspected)
    for node in (fast, slow):
        assert ray_tpu_torch.get(node._actor_handle.history.remote(),
                                 timeout=60) == list(range(n))


def test_compiled_multi_output(cluster):
    with InputNode() as inp:
        a = Stage.bind(1)
        b = Stage.bind(2)
        dag = MultiOutputNode([a.apply.bind(inp), b.apply.bind(inp)])
    compiled = dag.experimental_compile()
    try:
        assert compiled.execute(5).get(timeout=60) == [6, 7]
        assert compiled.execute(7).get(timeout=60) == [8, 9]
    finally:
        compiled.teardown()


def test_compiled_stage_error_propagates(cluster):
    @ray_tpu_torch.remote(num_cpus=0.3)
    class Exploder:
        def apply(self, x):
            if x == 3:
                raise ValueError("boom on 3")
            return x

    with InputNode() as inp:
        dag = Exploder.bind().apply.bind(inp)
    compiled = dag.experimental_compile()
    try:
        assert compiled.execute(1).get(timeout=60) == 1
        with pytest.raises(RuntimeError, match="boom on 3"):
            compiled.execute(3).get(timeout=60)
        # the loop survives an application error
        assert compiled.execute(4).get(timeout=60) == 4
    finally:
        compiled.teardown()


def test_compiled_5x_faster_than_eager(cluster):
    """The headline criterion: per-iteration latency of the compiled
    3-stage pipeline must be at least 5x better than eager chaining. Each
    side's latency is the median of 50 timed iterations, so a few
    iterations stalled by a busy host do not decide it."""

    s1, s2, s3 = Stage.remote(1), Stage.remote(10), Stage.remote(100)
    iters = 50
    # warm-up + eager timing
    ray_tpu_torch.get(s3.apply.remote(s2.apply.remote(s1.apply.remote(0))),
                      timeout=60)
    eager = []
    for i in range(iters):
        t0 = time.perf_counter()
        out = ray_tpu_torch.get(
            s3.apply.remote(s2.apply.remote(s1.apply.remote(i))), timeout=60)
        eager.append(time.perf_counter() - t0)
    assert out == iters - 1 + 111

    with InputNode() as inp:
        c1, c2, c3 = Stage.bind(1), Stage.bind(10), Stage.bind(100)
        dag = c3.apply.bind(c2.apply.bind(c1.apply.bind(inp)))
    compiled = dag.experimental_compile()
    try:
        assert compiled.execute(0).get(timeout=60) == 111  # warm-up
        comp = []
        for i in range(iters):
            t0 = time.perf_counter()
            out = compiled.execute(i).get(timeout=60)
            comp.append(time.perf_counter() - t0)
        assert out == iters - 1 + 111
    finally:
        compiled.teardown()
    eager_s, compiled_s = statistics.median(eager), statistics.median(comp)
    speedup = eager_s / compiled_s
    print(f"\neager {eager_s*1e3:.3f} ms/iter, compiled {compiled_s*1e3:.3f} "
          f"ms/iter, speedup {speedup:.1f}x")
    assert speedup >= 5.0, (
        f"compiled pipeline only {speedup:.1f}x faster than eager")
