"""The port's per-node agent and worker profiling, on the CPU: a mirror of
``tests/test_dashboard_agent.py`` (reference: python/ray/dashboard/agent.py,
modules/reporter/ — py-spy stack sampling and memray allocation tracking,
rebuilt as cooperative in-process profilers; the port's agent reads
``/proc`` where the JAX one calls psutil)."""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.dashboard.agent import MemoryProfiler, sample_stacks
from ray_tpu_torch.util.state import get_node_stats, list_nodes, profile_worker


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(resources={"CPU": 4.0}, device="cpu")
    yield
    ray_tpu_torch.shutdown()


def test_sample_stacks_catches_hot_function():
    def busy_loop(deadline):
        x = 0
        while time.monotonic() < deadline:
            x += 1
        return x

    import threading

    t = threading.Thread(target=busy_loop,
                         args=(time.monotonic() + 1.5,), daemon=True)
    t.start()
    out = sample_stacks(duration_s=0.8, interval_ms=5.0)
    t.join()
    assert out["samples"] > 10
    assert any("busy_loop" in stack for stack in out["folded"])


def test_memory_profiler_tracks_allocations():
    prof = MemoryProfiler()
    prof.start(frames=8)
    hog = [bytearray(1024) for _ in range(2000)]
    snap = prof.snapshot(top=10)
    prof.stop()
    assert snap["status"] == "ok"
    assert snap["current_kb"] > 1500
    assert snap["top"], "expected at least one allocation site"
    del hog


def test_node_agent_stats(cluster):
    @ray_tpu_torch.remote(num_cpus=0.1)
    def warm():
        return 1

    assert ray_tpu_torch.get(warm.remote(), timeout=120) == 1
    node = next(n for n in list_nodes() if n["alive"])
    stats = get_node_stats(node["address"], agent=True)
    agent = stats["agent"]
    assert agent["mem_total_mb"] > 0
    assert agent["cpu_percent"] >= 0.0
    assert isinstance(agent["workers"], list) and agent["workers"]
    w = agent["workers"][0]
    assert w["rss_mb"] > 0 and w["num_threads"] >= 1


def test_profile_running_worker(cluster):
    @ray_tpu_torch.remote(num_cpus=0.1)
    class Spinner:
        def spin(self, seconds):
            deadline = time.monotonic() + seconds
            n = 0
            while time.monotonic() < deadline:
                n += 1
            return n

        def pid(self):
            import os

            return os.getpid()

    a = Spinner.remote()
    pid = ray_tpu_torch.get(a.pid.remote(), timeout=120)
    node = next(n for n in list_nodes() if n["alive"])
    ref = a.spin.remote(4.0)  # keep the worker busy while we sample
    out = profile_worker(node["address"], pid, kind="stacks",
                         duration_s=1.0, interval_ms=5.0)
    assert out["status"] == "ok", out
    prof = out["profile"]
    assert prof["samples"] > 10
    assert any("spin" in stack for stack in prof["folded"]), \
        list(prof["folded"])[:5]
    ray_tpu_torch.get(ref, timeout=120)

    mem = profile_worker(node["address"], pid, kind="memory",
                         action="start")
    assert mem["profile"]["status"] == "started"
    mem = profile_worker(node["address"], pid, kind="memory",
                         action="snapshot")
    assert mem["profile"]["status"] == "ok"
    profile_worker(node["address"], pid, kind="memory", action="stop")
