"""Device-fed iteration and the Dataset's structured stats in the port
(``Dataset.iter_device_batches``, ``stats_data``, ``util.state.
list_dataset_stats``) on a port cluster, on the CPU, against the JAX
package's on a JAX cluster: a mirror of ``tests/test_data_device_iter.py``.

``iter_device_batches(device="cpu")`` yields dicts of tensors equal to the
port's ``iter_batches`` (of their dtypes) and to the JAX device batches'
values; prefetch overlaps a slow consumer; an early ``break`` releases the
producer; the consumer's waits land in the goodput ledger; the stats reach
the GCS's ``data_stats`` namespace. The CUDA route (pinned host memory, a
side stream, the consumer's stream waiting on each copy's event) runs on
the card in ``chip_smoke.py``.

Every JAX-side call runs under a timeout. Nothing here imports JAX or the
JAX package at module level."""

import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import data as pdata

from test_torch_data import both, jax_side  # noqa: E402


@pytest.fixture(scope="module")
def clusters():
    pytest.importorskip("pyarrow")  # the JAX package's blocks
    import ray_tpu

    ray_tpu.shutdown()
    ray_tpu.init(resources={"CPU": 4.0})
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, device="cpu")
    yield
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def test_iter_device_batches_yields_device_tensors(clusters):
    def build(rd):
        return rd.range(400).map_batches(
            lambda b: {"x": np.asarray(b["id"], dtype=np.float32) * 2.0,
                       "id": b["id"]})

    def device_batches(ds):
        return [{k: np.asarray(v) for k, v in b.items()}
                for b in ds.iter_device_batches(batch_size=64,
                                                device_prefetch=2)]

    import ray_tpu.data as jdata

    want = jax_side(lambda: device_batches(build(jdata)))
    host = list(build(pdata).iter_batches(batch_size=64))
    got = list(build(pdata).iter_device_batches(batch_size=64,
                                                device_prefetch=2,
                                                device="cpu"))
    assert len(got) == len(host) == len(want) == 7
    total = 0
    for g, h, w in zip(got, host, want):
        # jax.device_put orders a dict's keys (a pytree); the port keeps
        # the host batch's order
        assert list(g) == list(h) and sorted(g) == list(w)
        for k in g:
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            assert g[k].dtype == torch.from_numpy(h[k]).dtype
            assert np.array_equal(g[k].numpy(), h[k])
            # the JAX device batch holds the same values in its own dtype
            assert np.array_equal(g[k].numpy().astype(w[k].dtype), w[k])
        total += int(g["x"].shape[0])
        assert float(g["x"][0]) % 2.0 == 0.0
    assert total == 400


def test_iter_device_batches_needs_a_card_unless_told_cpu(clusters):
    ds = pdata.range(10)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(iter(ds.iter_device_batches(batch_size=4)))


def test_device_prefetch_overlaps_consumer_compute(clusters):
    """With a deliberately slow consumer, prefetched iteration overlaps the
    producer's block fetch with the consumer's step; an early break
    releases the producer thread; each wait is counted in the goodput
    ledger's ``input_waits``."""
    from ray_tpu_torch.util import goodput

    def slow_map(b):
        time.sleep(0.03)
        return {"x": np.asarray(b["id"], dtype=np.float32)}

    def run(depth):
        ds = pdata.range(1200, parallelism=12).map_batches(slow_map)
        t0 = time.perf_counter()
        n = 0
        for batch in ds.iter_device_batches(batch_size=100,
                                            device_prefetch=depth,
                                            device="cpu"):
            time.sleep(0.03)  # consumer "compute"
            n += batch["x"].shape[0]
        assert n == 1200
        return time.perf_counter() - t0

    waits0 = goodput.snapshot()["counters"].get("input_waits", 0)
    serial = run(1)  # depth 1 still pipelines one ahead
    fast = run(3)
    assert fast < serial * 1.25, (fast, serial)
    waits = goodput.snapshot()["counters"].get("input_waits", 0) - waits0
    assert waits == 2 * 13  # 12 batches and the end, twice

    def producers():
        return [t for t in threading.enumerate()
                if t.name == "ray_tpu_torch-device-prefetch"]

    it = pdata.range(1200, parallelism=12).iter_device_batches(
        batch_size=10, device_prefetch=2, device="cpu")
    next(it)
    assert len(producers()) == 1
    it.close()  # an early break joins the producer
    assert not producers()


def test_stats_data_per_op(clusters):
    def build(rd):
        return rd.range(300).map_batches(
            lambda b: {"x": np.asarray(b["id"]) + 1})

    def run(ds):
        list(ds.iter_batches(batch_size=50))
        return ds

    want, got = both(build, run)
    stats = got.stats_data()
    assert stats, "expected per-op stats"
    assert any(s["rows_out"] >= 300 for s in stats), stats
    for s in stats:
        assert {"op", "tasks", "rows_out", "bytes_out",
                "task_wall_s", "wall_s"} <= set(s)
    jstats = jax_side(want.stats_data)
    assert [(s["op"], s["tasks"], s["rows_out"]) for s in stats] == \
        [(s["op"], s["tasks"], s["rows_out"]) for s in jstats]
    # string form still renders
    assert "rows" in got.stats()


def test_stats_visible_via_state_api(clusters):
    from ray_tpu_torch.util.state import list_dataset_stats

    ds = pdata.range(100).map_batches(lambda b: {"y": np.asarray(b["id"])})
    list(ds.iter_batches(batch_size=25))
    entries = list_dataset_stats()
    assert entries, "dataset stats should be published to the state API"
    assert any(e["dataset"] == ds._stats_key() for e in entries)
    assert any(any(op["rows_out"] >= 100 for op in e["ops"])
               for e in entries)


def test_state_api_reads_the_gcs(clusters):
    """Every state function the port's GCS backs answers in the shape the
    JAX one does on its cluster, the dashboard's agent too: its node sample
    carries the node id and each worker's RSS, and a worker's profile
    returns its stacks."""
    import ray_tpu.util.state as jstate

    from ray_tpu_torch.util import state as pstate

    @ray_tpu_torch.remote
    def one():
        return 1

    assert ray_tpu_torch.get(one.remote(), timeout=60) == 1
    calls = {
        "list_nodes": (), "list_actors": (), "list_jobs": (),
        "list_placement_groups": (), "list_tasks": (),
        "summarize_tasks": (), "metrics_history": (), "cluster_health": (),
        "goodput": (), "get_timeline": (), "list_weight_stores": (),
        "list_checkpoints": (), "ckpt_sweeps": (), "serve_state": (),
        "list_worker_pools": (), "summarize_cluster": (),
        "list_dataset_stats": ()}
    for name, args in calls.items():
        got = getattr(pstate, name)(*args)
        want = jax_side(lambda: getattr(jstate, name)(*args))
        assert type(got) is type(want), name
        if isinstance(got, dict) and name in ("summarize_tasks",
                                              "summarize_cluster",
                                              "get_timeline"):
            assert set(got) == set(want), name
    node = pstate.list_nodes()[0]
    stats = pstate.get_node_stats(node["address"])
    assert stats["node_id"] == node["node_id"]
    assert pstate.summarize_cluster()["num_nodes"] == 1
    sampled = pstate.get_node_stats(node["address"], agent=True)
    assert sampled["node_id"] == node["node_id"]
    workers = sampled["agent"]["workers"]
    assert workers and all(w["rss_mb"] > 0 for w in workers)
    jnode = jax_side(lambda: [n for n in jstate.list_nodes()
                              if n["alive"]][0])
    jsampled = jax_side(lambda: jstate.get_node_stats(jnode["address"],
                                                      agent=True))
    assert set(sampled["agent"]) == set(jsampled["agent"])
    assert set(workers[0]) == set(jsampled["agent"]["workers"][0])
    prof = pstate.profile_worker(node["address"], workers[0]["pid"],
                                 duration_s=0.3, interval_ms=5.0)
    assert prof["status"] == "ok" and prof["profile"]["samples"] > 0
    assert prof["profile"]["folded"], prof
