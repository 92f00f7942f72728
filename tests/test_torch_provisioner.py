"""A mirror of ``tests/test_provisioner.py`` on the port's runtime
(``ray_tpu_torch``, on the CPU): the same scenarios and assertions.

Worker provisioning plane: zygote prefork pool, warm-worker adoption,
batched lease grants, and failure fallbacks (reference: worker_pool.h
prestart/adoption behind RequestWorkerLease, node_manager.cc:1820).

These tests boot a real GCS + raylet IN-PROCESS (one asyncio loop) and talk
to the raylet over its actual RPC surface; workers are real processes
forked from the zygote (or cold-spawned on the fallback paths).
"""

import asyncio
import os
import signal
import time

import ray_tpu_torch
from ray_tpu_torch._private import wire
from ray_tpu_torch._private.gcs import GcsServer
from ray_tpu_torch._private.raylet import Raylet
from ray_tpu_torch._private.rpc import RetryingRpcClient


def run(coro, timeout=120.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


async def boot(resources=None, prestart=0, warm=0):
    os.environ["RAY_TPU_PRESTART_WORKERS"] = str(prestart)
    os.environ["RAY_TPU_WORKER_POOL_WARM_TARGET"] = str(warm)
    gcs = GcsServer()
    gcs_addr = await gcs.start()
    raylet = Raylet(gcs_address=gcs_addr, resources=resources or {"CPU": 8.0})
    await raylet.start()
    client = RetryingRpcClient(raylet.server.address)
    return gcs, raylet, client


async def teardown(gcs, raylet, client):
    await client.close()
    await raylet.stop()
    await gcs.stop()
    os.environ.pop("RAY_TPU_PRESTART_WORKERS", None)
    os.environ.pop("RAY_TPU_WORKER_POOL_WARM_TARGET", None)


async def wait_warm(raylet, n, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        warm = [w for w in raylet.idle_workers
                if w.job_hex is None and not w.renv_hash]
        if len(warm) >= n:
            return warm
        await asyncio.sleep(0.05)
    raise AssertionError(
        f"warm pool never reached {n} (have {len(raylet.idle_workers)})")


async def request_lease(client, resources=None, count=1, renv=None):
    return wire.loads(await client.call("RequestWorkerLease", wire.dumps({
        "resources": resources or {"CPU": 1.0},
        "job_id": None,
        "count": count,
        "runtime_env": renv,
    }), timeout=90.0))


def test_lease_adoption_reuses_prestarted_worker():
    """A granted lease must ADOPT a warm registered worker: same pid, no
    new process, counted as a pool hit."""
    async def body():
        gcs, raylet, client = await boot(warm=1)
        try:
            warm = await wait_warm(raylet, 1)
            warm_pids = {w.pid for w in warm}
            nworkers = len(raylet.workers)
            hits0 = raylet.provisioner.stats["hits"]
            reply = await request_lease(client)
            assert reply["status"] == "granted", reply
            assert reply["worker_pid"] in warm_pids, (
                "lease did not adopt the prestarted worker")
            assert raylet.provisioner.stats["hits"] == hits0 + 1
            # adoption spawned nothing (replenish may add more later, but
            # the granted worker itself is the old process)
            assert reply["worker_pid"] in {w.pid for w in raylet.workers.values()}
            assert len(raylet.workers) >= nworkers
            await client.call("ReturnWorkerLease", wire.dumps(
                {"lease_id": reply["lease_id"]}))
        finally:
            await teardown(gcs, raylet, client)
    run(body())


def test_renv_mismatch_bypasses_warm_pool():
    """A lease carrying a runtime env must NOT adopt a default-env warm
    worker: the pool is keyed by renv hash; a fresh dedicated worker is
    spawned and the warm one stays idle."""
    async def body():
        gcs, raylet, client = await boot(warm=1)
        try:
            warm = await wait_warm(raylet, 1)
            warm_pids = {w.pid for w in warm}
            misses0 = raylet.provisioner.stats["misses"]
            reply = await request_lease(
                client, renv={"env_vars": {"PROV_TEST": "1"}})
            assert reply["status"] == "granted", reply
            assert reply["worker_pid"] not in warm_pids, (
                "runtime-env lease adopted a default-env warm worker")
            assert raylet.provisioner.stats["misses"] == misses0 + 1
            # the warm worker was not consumed
            assert any(w.pid in warm_pids for w in raylet.idle_workers)
            await client.call("ReturnWorkerLease", wire.dumps(
                {"lease_id": reply["lease_id"]}))
        finally:
            await teardown(gcs, raylet, client)
    run(body())


def test_batched_multi_grant_vs_per_task():
    """count=N returns up to N grants in ONE reply (distinct leases on
    distinct warm workers, resources debited N times); count=1 keeps the
    single-grant shape."""
    async def body():
        gcs, raylet, client = await boot(warm=3)
        try:
            await wait_warm(raylet, 3)
            cpus0 = raylet.available["CPU"]
            reply = await request_lease(client, count=3)
            assert reply["status"] == "granted", reply
            extras = reply.get("extra_grants") or []
            assert len(extras) == 2, f"expected 2 extra grants, got {extras}"
            grants = [reply] + extras
            lease_ids = {g["lease_id"] for g in grants}
            pids = {g["worker_pid"] for g in grants}
            assert len(lease_ids) == 3 and len(pids) == 3
            assert raylet.available["CPU"] == cpus0 - 3.0
            for g in grants:
                await client.call("ReturnWorkerLease", wire.dumps(
                    {"lease_id": g["lease_id"]}))
            assert raylet.available["CPU"] == cpus0
            # per-task shape: count=1 never carries extra grants
            r1 = await request_lease(client, count=1)
            assert r1["status"] == "granted" and "extra_grants" not in r1
            await client.call("ReturnWorkerLease", wire.dumps(
                {"lease_id": r1["lease_id"]}))
        finally:
            await teardown(gcs, raylet, client)
    run(body())


def test_zygote_crash_respawns_and_cold_spawn_fallback():
    """Killing the zygote must not break leasing: the next spawn falls back
    to cold Popen, and the provisioner respawns the zygote in the
    background (counted in zygote_restarts)."""
    async def body():
        gcs, raylet, client = await boot(warm=0)
        try:
            prov = raylet.provisioner
            # zygote boots in the background; wait for it before crashing it
            deadline = time.monotonic() + 60
            while not prov.zygote_alive and time.monotonic() < deadline:
                await asyncio.sleep(0.05)
            assert prov.zygote_alive, "zygote never came up after start"
            await prov.crash_zygote_for_test()
            # lease immediately: pool empty + zygote dead -> cold spawn
            reply = await request_lease(client)
            assert reply["status"] == "granted", reply
            assert prov.stats["cold_spawns"] >= 1 or prov.zygote_alive, (
                "neither cold fallback nor a respawned zygote served the "
                f"lease: {prov.stats}")
            # the respawn loop brings the zygote back
            deadline = time.monotonic() + 60
            while not prov.zygote_alive and time.monotonic() < deadline:
                await asyncio.sleep(0.1)
            assert prov.zygote_alive, "zygote never respawned"
            assert prov.stats["zygote_restarts"] >= 1
            # and the respawned zygote serves forks again
            pid = await prov.fork_worker(None)
            assert pid is not None
            os.kill(pid, signal.SIGKILL)
            await client.call("ReturnWorkerLease", wire.dumps(
                {"lease_id": reply["lease_id"]}))
        finally:
            await teardown(gcs, raylet, client)
    run(body())


def test_oom_kill_of_adopted_worker_releases_leases():
    """When the memory monitor kills an adopted worker, the monitor loop
    must release its leases (credit the pool) and WasWorkerOOM must
    attribute the death."""
    async def body():
        gcs, raylet, client = await boot(warm=1)
        try:
            await wait_warm(raylet, 1)
            cpus0 = raylet.available["CPU"]
            reply = await request_lease(client)
            assert reply["status"] == "granted", reply
            assert raylet.available["CPU"] == cpus0 - 1.0
            w = raylet.workers[reply["worker_pid"]]
            # simulate the memory monitor's kill path: record + SIGKILL
            raylet.oom_kills[w.address] = time.monotonic()
            os.kill(w.pid, signal.SIGKILL)
            deadline = time.monotonic() + 30
            while reply["lease_id"] in raylet.leases \
                    and time.monotonic() < deadline:
                await asyncio.sleep(0.1)
            assert reply["lease_id"] not in raylet.leases, (
                "lease not released after the adopted worker died")
            assert raylet.available["CPU"] == cpus0
            assert w.pid not in raylet.workers
            oom = wire.loads(await client.call("WasWorkerOOM", wire.dumps(
                {"worker_address": w.address})))
            assert oom["oom"] is True
        finally:
            await teardown(gcs, raylet, client)
    run(body())


def test_forked_worker_runs_tasks_end_to_end():
    """Full-stack sanity: a driver on a zygote-backed cluster runs tasks
    and actors on adopted workers, and the pool stats surface through
    GetNodeStats."""
    ray_tpu_torch.shutdown()
    os.environ["RAY_TPU_WORKER_POOL_WARM_TARGET"] = "2"
    try:
        ray_tpu_torch.init(device="cpu")

        @ray_tpu_torch.remote(num_cpus=0.1)
        def pid(i):
            import os as _os

            return _os.getpid()

        @ray_tpu_torch.remote(num_cpus=0.1)
        class A:
            def ping(self):
                return "pong"

        pids = ray_tpu_torch.get([pid.remote(i) for i in range(20)], timeout=120)
        assert len(pids) == 20
        actors = [A.remote() for _ in range(4)]
        assert ray_tpu_torch.get([a.ping.remote() for a in actors],
                           timeout=120) == ["pong"] * 4
        from ray_tpu_torch._private.worker import _global_worker

        stats = _global_worker._run(_global_worker.raylet.call(
            "GetNodeStats", wire.dumps({})), 30.0)
        pool = wire.loads(stats)["worker_pool"]
        assert pool["enabled"] and pool["zygote_alive"]
        assert pool["hits"] + pool["misses"] > 0
        assert pool["forks"] >= 1, pool
    finally:
        ray_tpu_torch.shutdown()
        os.environ.pop("RAY_TPU_WORKER_POOL_WARM_TARGET", None)
