"""Core microbenchmark suite (reference: python/ray/_private/ray_perf.py:95,
invoked as `ray microbenchmark`). Measures the owner-side submit path, actor
call throughput, and object plane bandwidth on the local cluster. The port
of ``ray_tpu/_private/microbenchmark.py``: the same suite and result
names, on the port's runtime."""

from __future__ import annotations

import time
from typing import Callable, Dict, List

import numpy as np

import ray_tpu_torch


def timeit(name: str, fn: Callable[[], int], duration: float = 2.0) -> Dict:
    # warmup
    fn()
    t0 = time.perf_counter()
    count = 0
    while time.perf_counter() - t0 < duration:
        count += fn()
    dt = time.perf_counter() - t0
    rate = count / dt
    return {"name": name, "rate_per_s": round(rate, 1)}


@ray_tpu_torch.remote(num_cpus=0.2)
def _noop():
    return b"ok"


@ray_tpu_torch.remote(num_cpus=0.2)
class _BenchActor:
    def noop(self):
        return b"ok"

    async def anoop(self):
        return b"ok"


def main(duration: float = 2.0) -> List[Dict]:
    results = []

    # tasks: sync round-trip and pipelined batches (ray_perf.py:176-191)
    results.append(timeit(
        "tasks_sync_per_s",
        lambda: (ray_tpu_torch.get(_noop.remote(), timeout=60), 1)[1], duration))

    def batch_tasks():
        refs = [_noop.remote() for _ in range(100)]
        ray_tpu_torch.get(refs, timeout=60)
        return 100

    results.append(timeit("tasks_async_batch_per_s", batch_tasks, duration))

    # deep pipeline, the reference's async-task shape (ray_perf.py keeps
    # ~1000 tasks in flight): amortizes the submit/complete barrier
    def pipeline_tasks():
        refs = [_noop.remote() for _ in range(1000)]
        ray_tpu_torch.get(refs, timeout=120)
        return 1000

    results.append(timeit("tasks_pipeline1k_per_s", pipeline_tasks, duration))

    # actor calls 1:1 sync + async batches (ray_perf.py:198-243)
    actor = _BenchActor.remote()
    ray_tpu_torch.get(actor.noop.remote(), timeout=60)
    results.append(timeit(
        "actor_calls_sync_per_s",
        lambda: (ray_tpu_torch.get(actor.noop.remote(), timeout=60), 1)[1], duration))

    def batch_actor():
        refs = [actor.noop.remote() for _ in range(100)]
        ray_tpu_torch.get(refs, timeout=60)
        return 100

    results.append(timeit("actor_calls_async_batch_per_s", batch_actor, duration))

    async_actor = _BenchActor.options(max_concurrency=8).remote()
    ray_tpu_torch.get(async_actor.anoop.remote(), timeout=60)

    def batch_async_actor():
        refs = [async_actor.anoop.remote() for _ in range(100)]
        ray_tpu_torch.get(refs, timeout=60)
        return 100

    results.append(timeit("async_actor_calls_batch_per_s", batch_async_actor,
                          duration))

    # object plane: small put/get and large-object bandwidth (ray_perf.py:122-148)
    small = {"k": 1}
    results.append(timeit(
        "put_small_per_s", lambda: (ray_tpu_torch.put(small), 1)[1], duration))

    # numpy payload rides the out-of-band zero-copy path (shm-mapped on
    # read), like ray_perf.py's large-object cases
    big = np.frombuffer(np.random.bytes(10 * 1024 * 1024), dtype=np.uint8)

    def put_gig():
        ref = ray_tpu_torch.put(big)
        ray_tpu_torch.get(ref, timeout=120)
        return 1

    r = timeit("put_get_10MB_roundtrips_per_s", put_gig, duration)
    r["GB_per_s"] = round(r["rate_per_s"] * 10 * 2 / 1024, 3)
    results.append(r)

    ray_tpu_torch.kill(actor)
    ray_tpu_torch.kill(async_actor)
    return results


if __name__ == "__main__":
    ray_tpu_torch.init()
    for row in main():
        print(row)
    ray_tpu_torch.shutdown()
