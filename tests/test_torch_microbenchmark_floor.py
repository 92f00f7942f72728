"""Core-throughput floors of the port's runtime: a mirror of
``tests/test_microbenchmark_floor.py`` with its floors unchanged. They catch
order-of-magnitude regressions in the submit/execute/object paths
(reference: release/microbenchmark tracking of ray_perf.py numbers), far
below measured best-of, since CI hosts are noisy: this guards against
wedged batching/scheduling, not run-to-run variance.
"""

import pytest

import ray_tpu_torch
from ray_tpu_torch._private import microbenchmark


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=8, device="cpu")
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


# calibrated for the WORST case — mid-full-suite on a saturated 1-core CI
# host (measured ~4x below standalone best-of): these floors catch a
# wedged submit/execute path (the round-3 deadlock measured ~0), not noise
FLOORS = {
    "tasks_async_batch_per_s": 250.0,
    "tasks_pipeline1k_per_s": 400.0,
    "actor_calls_async_batch_per_s": 700.0,
    "put_small_per_s": 1200.0,
}


def test_core_throughput_floors(cluster):
    results = {r["name"]: r for r in microbenchmark.main(duration=1.5)}
    failures = []
    for name, floor in FLOORS.items():
        rate = results[name]["rate_per_s"]
        if rate < floor:
            failures.append(f"{name}: {rate:.0f}/s < floor {floor:.0f}/s")
    assert not failures, "; ".join(failures)
    # object plane bandwidth (10MB roundtrips)
    gbs = results["put_get_10MB_roundtrips_per_s"]["GB_per_s"]
    assert gbs >= 0.4, f"object plane bandwidth {gbs} GB/s below floor"
