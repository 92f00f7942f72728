"""Raylet-side half of the provisioning plane.

``WorkerProvisioner`` owns the zygote subprocess + its control channel and
routes worker spawns: zygote fork for default-interpreter workers (fast —
imports are resident in the zygote image), cold ``Popen`` for pip/uv envs,
zygote death, or fork-less platforms. It also keeps the warm pool topped up
(``worker_pool_warm_target``) so lease grants are pure adoption, and owns
the pool counters/histograms surfaced through ``/metrics`` and
``/api/workers``.

Reference: ``worker_pool.h:276`` (PopWorker/PrestartWorkers and the
registered-idle pool) — the zygote itself has no reference analog; it
replaces the per-spawn interpreter+import cost the reference pays in
``StartWorkerProcess``.
"""

from __future__ import annotations

import asyncio
import logging
import os
import signal
import socket
import subprocess
import sys
import time
from typing import Dict, Optional

from ray_tpu_torch._private.async_util import spawn
from ray_tpu_torch._private.config import RAY_CONFIG
from ray_tpu_torch._private.provisioner.framing import FrameReader, encode_frame

logger = logging.getLogger("ray_tpu_torch.provisioner")

_pool_instruments = None


def _obs():
    """Lazy pool instruments (ride the process's auto-published registry)."""
    global _pool_instruments
    if _pool_instruments is None:
        from ray_tpu_torch.util.metrics import Counter, Histogram

        _pool_instruments = {
            "hits": Counter("ray_tpu_worker_pool_hits",
                            "lease grants served by adopting a warm worker"),
            "misses": Counter("ray_tpu_worker_pool_misses",
                              "lease grants that had to spawn a worker"),
            "forks": Counter("ray_tpu_worker_pool_forks",
                             "workers forked from the zygote"),
            "cold": Counter("ray_tpu_worker_pool_cold_spawns",
                            "workers cold-spawned via subprocess.Popen"),
            "zygote_restarts": Counter(
                "ray_tpu_worker_pool_zygote_restarts",
                "zygote crashes followed by a respawn"),
            "adoption": Histogram(
                "ray_tpu_worker_adoption_seconds",
                "lease-grant worker acquisition latency (warm pop or spawn)",
                boundaries=[0.0005, 0.002, 0.01, 0.05, 0.2, 1.0, 5.0, 30.0]),
            "grant_batch": Histogram(
                "ray_tpu_lease_grant_batch_size",
                "grants returned per RequestWorkerLease reply",
                boundaries=[1, 2, 4, 8, 16, 32]),
        }
    return _pool_instruments


def fork_supported() -> bool:
    return hasattr(os, "fork") and sys.platform.startswith("linux")


class ForkedProc:
    """Popen-compatible view of a zygote-forked worker: exit codes come
    from the zygote's reap stream; liveness probing covers a dead zygote."""

    def __init__(self, pid: int, provisioner: "WorkerProvisioner"):
        self.pid = pid
        self._prov = provisioner
        # which zygote forked us: a worker of a crashed generation has NO
        # reaper (it reparented to init), even if a respawned zygote is
        # alive — its exit event will never arrive
        self._gen = provisioner.generation
        self.returncode: Optional[int] = None

    def poll(self) -> Optional[int]:
        if self.returncode is not None:
            return self.returncode
        code = self._prov.reaped_exit(self.pid)
        if code is None and (self._gen != self._prov.generation
                             or not self._prov.zygote_alive):
            # no reaper for this worker: probe the pid directly (same uid)
            try:
                os.kill(self.pid, 0)
            except ProcessLookupError:
                code = -1
            except PermissionError:  # raylint: disable=EXC001 pid exists but other uid: not ours to call dead
                pass
        if code is not None:
            self.returncode = code
        return self.returncode

    def _signal(self, sig: int):
        try:
            os.kill(self.pid, sig)
        except ProcessLookupError:
            if self.returncode is None:
                self.returncode = -1

    def kill(self):
        self._signal(signal.SIGKILL)

    def terminate(self):
        self._signal(signal.SIGTERM)


class WorkerProvisioner:
    """Zygote lifecycle + fork RPCs + warm-pool replenishment for one
    raylet. All coroutines run on the raylet's event loop."""

    def __init__(self, raylet):
        self.raylet = raylet
        self.enabled = bool(RAY_CONFIG.worker_zygote_enabled) \
            and fork_supported()
        self._proc: Optional[subprocess.Popen] = None
        self._sock: Optional[socket.socket] = None
        self._reader_task: Optional[asyncio.Task] = None
        self._pending: Dict[int, asyncio.Future] = {}
        self._exits: Dict[int, int] = {}
        self._seq = 0
        self._ready = False
        self._respawning = False
        self._closed = False
        self.generation = 0  # bumps per zygote (re)spawn; see ForkedProc
        # readiness-ping failures since the last successful boot: once a
        # boot has failed, fork_worker stops PARKING on in-flight boots
        # (cold spawn immediately) so a zygote that can never become ready
        # cannot wedge the node's whole spawn path
        self._boot_failures = 0
        # counters mirrored to GetNodeStats + the "workers" KV namespace
        self.stats: Dict[str, int] = {
            "hits": 0, "misses": 0, "forks": 0, "cold_spawns": 0,
            "zygote_restarts": 0, "fork_failures": 0,
        }
        # renv-keyed warm pool: the most-recently-leased non-default
        # runtime env (hash, env dict). The replenish loop keeps warm
        # workers forked for it too, so a hot non-default env stops
        # bypassing the pool (otherwise every grant for it is a fork).
        self.hot_renv: Optional[tuple] = None

    def note_renv(self, renv_hash: str, renv: Optional[dict]):
        """Record the most-recently-requested runtime env for replenish
        keying. Only zygote-forkable envs qualify (pip envs — including
        uv, which normalize() folds into the "pip" key — run a different
        interpreter and can never come from the pool)."""
        if renv_hash and renv and "pip" not in renv:
            self.hot_renv = (renv_hash, dict(renv))

    # -- zygote lifecycle ----------------------------------------------

    @property
    def zygote_alive(self) -> bool:
        return (self._ready and self._proc is not None
                and self._proc.poll() is None)

    async def start(self):
        if not self.enabled:
            return
        try:
            await self._spawn_zygote()
        except Exception:
            logger.warning("zygote start failed; cold spawns only",
                           exc_info=True)
            self._abort_boot()

    def _abort_boot(self):
        """A zygote that missed its readiness ping must not linger half-up:
        a live-but-never-ready process would make _wait_ready park every
        spawn for the full timeout. Kill it so the state is unambiguous
        (the reader's EOF handler owns any respawn)."""
        self._boot_failures += 1
        if self._proc is not None and self._proc.poll() is None:
            try:
                self._proc.kill()
            except Exception as e:
                logger.debug("boot-abort zygote kill failed: %s", e)

    async def _wait_ready(self, timeout: float) -> bool:
        """Wait for an in-flight zygote BOOT (start() runs in the
        background so the raylet registers immediately). A crashed or
        absent zygote returns False at once — callers cold-spawn rather
        than stalling behind the respawn backoff."""
        deadline = time.monotonic() + timeout
        while not self._closed and time.monotonic() < deadline:
            if self.zygote_alive:
                return True
            if self._boot_failures:
                # a boot already failed once: don't park lease-driven
                # spawns behind retry attempts — cold spawn now, adopt the
                # zygote whenever a retry finally succeeds
                return False
            if self._proc is None or self._proc.poll() is not None:
                return False
            await asyncio.sleep(0.05)
        return self.zygote_alive

    async def close(self):
        self._closed = True
        if self._reader_task is not None:
            self._reader_task.cancel()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:  # raylint: disable=EXC001 already-closed control socket at shutdown
                pass
        if self._proc is not None and self._proc.poll() is None:
            try:
                self._proc.kill()
            except Exception as e:
                logger.debug("zygote kill at close failed: %s", e)

    async def _spawn_zygote(self):
        self.generation += 1
        parent_sock, child_sock = socket.socketpair()
        cmd = [sys.executable, "-m", "ray_tpu_torch._private.provisioner.zygote",
               "--control-fd", str(child_sock.fileno())]
        if RAY_CONFIG.zygote_preimport_torch:
            cmd.append("--preimport-torch")
        self._proc = subprocess.Popen(
            cmd, env=self.raylet._spawn_env,
            pass_fds=[child_sock.fileno()],
            stdout=self.raylet._log_file("worker_stdout"),
            stderr=subprocess.STDOUT)
        child_sock.close()
        parent_sock.setblocking(False)
        self._sock = parent_sock
        self._reader_task = spawn(self._reader_loop(parent_sock),
                                  what="zygote control reader")
        # wait for the preimport to finish: first fork must be warm
        reply = await self._request({"op": "ping"},
                                    timeout=RAY_CONFIG.worker_start_timeout_s)
        self._ready = True
        self._boot_failures = 0
        logger.info("zygote pid=%d ready (%d modules resident)",
                    self._proc.pid, len(reply.get("preimported", ())))

    async def _reader_loop(self, sock: socket.socket):
        loop = asyncio.get_event_loop()
        reader = FrameReader()
        try:
            while True:
                try:
                    data = await loop.sock_recv(sock, 1 << 16)
                except (OSError, ValueError):
                    data = b""
                if not data:
                    break
                for msg in reader.feed(data):
                    op = msg.get("op")
                    if op == "exit":
                        self._exits[int(msg["pid"])] = int(msg["code"])
                        if len(self._exits) > 4096:
                            self._exits.pop(next(iter(self._exits)))
                    elif op in ("pong", "forked"):
                        if op == "forked" and msg.get("pid") is not None:
                            # pid-reuse defense, done HERE and not in
                            # fork_worker: the zygote always sends 'forked'
                            # before that child's 'exit', and frames are
                            # processed in order — so any exit record
                            # present now is from a previous incarnation
                            # of this pid, while popping later (after the
                            # awaiting coroutine resumes) could erase a
                            # genuine crash-at-bootstrap exit
                            self._exits.pop(int(msg["pid"]), None)
                        fut = self._pending.pop(msg.get("seq"), None)
                        if fut is not None and not fut.done():
                            fut.set_result(msg)
        finally:
            if sock is self._sock:
                self._on_zygote_death()

    def _on_zygote_death(self):
        self._ready = False
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(RuntimeError("zygote died"))
        self._pending.clear()
        if self._closed or self._respawning:
            return
        self._respawning = True
        spawn(self._respawn(), what="zygote respawn")

    async def _respawn(self):
        """Zygote crashed: back off briefly, then rebuild it. Meanwhile
        spawn_worker falls back to cold Popen."""
        try:
            delay = 0.2
            while not self._closed:
                await asyncio.sleep(delay)
                try:
                    if self._sock is not None:
                        self._sock.close()
                    await self._spawn_zygote()
                    self.stats["zygote_restarts"] += 1
                    _obs()["zygote_restarts"].inc()
                    logger.warning("zygote respawned after crash")
                    return
                except Exception as e:
                    logger.warning("zygote respawn failed (retrying): %s", e)
                    self._abort_boot()
                    delay = min(delay * 2, 5.0)
        finally:
            self._respawning = False

    async def _request(self, msg: dict, timeout: float) -> dict:
        assert self._sock is not None
        self._seq += 1
        seq = self._seq
        msg = dict(msg, seq=seq)
        loop = asyncio.get_event_loop()
        fut = loop.create_future()
        self._pending[seq] = fut
        try:
            await loop.sock_sendall(self._sock, encode_frame(msg))
            return await asyncio.wait_for(fut, timeout)
        finally:
            self._pending.pop(seq, None)

    # -- spawn routing --------------------------------------------------

    def reaped_exit(self, pid: int) -> Optional[int]:
        return self._exits.get(pid)

    async def fork_worker(self, renv: Optional[dict]) -> Optional[int]:
        """Ask the zygote for a worker; returns the pid, or None when the
        zygote path is unavailable (caller cold-spawns)."""
        if not self.enabled:
            return None
        # wait at most HALF the start timeout for an in-flight zygote boot:
        # the cold-spawn fallback still has to fit its own registration
        # wait inside the owner's RequestWorkerLease RPC budget
        # (worker_start_timeout_s + 30 on the caller side)
        if not self.zygote_alive and not await self._wait_ready(
                RAY_CONFIG.worker_start_timeout_s / 2):
            return None
        raylet = self.raylet
        args = {
            "raylet_address": raylet.server.address,
            "gcs_address": raylet.gcs_address,
            "node_id": raylet.node_id.hex(),
            "log_dir": raylet.log_dir,
            "runtime_env": renv,
        }
        try:
            reply = await self._request(
                {"op": "fork", "args": args},
                timeout=RAY_CONFIG.zygote_fork_timeout_s)
            if reply.get("error"):
                # zygote stayed up but THIS fork failed (EAGAIN / pid
                # limit): cold-spawn this one worker
                self.stats["fork_failures"] += 1
                logger.warning("zygote fork refused: %s", reply["error"])
                return None
            pid = int(reply["pid"])
            self.stats["forks"] += 1
            _obs()["forks"].inc()
            return pid
        except (RuntimeError, asyncio.TimeoutError, OSError) as e:
            self.stats["fork_failures"] += 1
            logger.warning("zygote fork failed (falling back to cold "
                           "spawn): %s", e)
            return None

    async def crash_zygote_for_test(self):
        """Fault injection: make the zygote exit abruptly."""
        if self._proc is not None and self._proc.poll() is None:
            self._proc.kill()

    # -- warm pool replenishment ----------------------------------------

    async def replenish_loop(self):
        """Keep ``worker_pool_warm_target`` default-env workers — PLUS
        ``worker_pool_warm_target_renv`` workers keyed to the most-recently
        -leased non-default runtime env (``note_renv``) — forked AND
        registered so lease grants adopt instead of spawning. Zygote-only:
        when the zygote is down, topping up via cold Popen would burn the
        very CPU the pending leases need."""
        target = max(0, int(RAY_CONFIG.worker_pool_warm_target))
        renv_target = max(0, int(RAY_CONFIG.worker_pool_warm_target_renv))
        if (target == 0 and renv_target == 0) or not self.enabled:
            return
        raylet = self.raylet
        while True:
            await asyncio.sleep(0.25)
            try:
                # evict warm workers keyed to a renv that is no longer hot:
                # without this, cycling through unique runtime envs leaves
                # up to renv_target idle workers behind per env until
                # max_workers_per_node starves both replenish and top-up.
                # Runs BEFORE the zygote/capacity gate below — a node at
                # max_workers_per_node is exactly the starved state this
                # must dig out of, and the kill is a plain SIGKILL that
                # needs no live zygote. Only never-leased pool forks
                # qualify (job_hex None); removal from idle_workers is
                # synchronous so a concurrent grant can't adopt a worker
                # we are about to kill — the death monitor reaps the rest
                # of the bookkeeping.
                hot_hash = self.hot_renv[0] if self.hot_renv else ""
                for w in list(raylet.idle_workers):
                    if w.job_hex is None and w.renv_hash \
                            and w.renv_hash != hot_hash:
                        raylet.idle_workers.remove(w)
                        try:
                            w.proc.kill()
                        except Exception as e:
                            logger.debug("stale-renv evict of pid %d "
                                         "failed: %s", w.pid, e)
                if not self.zygote_alive \
                        or len(raylet.workers) >= RAY_CONFIG.max_workers_per_node:
                    continue
                # one top-up per round, default env first; the hot renv
                # bucket only replenishes once the default pool is full
                renv, renv_hash = None, ""
                warm = sum(1 for w in raylet.idle_workers
                           if w.job_hex is None and not w.renv_hash)
                if warm >= target:
                    if self.hot_renv is None or renv_target == 0:
                        continue
                    renv_hash, renv = self.hot_renv
                    warm_renv = sum(1 for w in raylet.idle_workers
                                    if w.job_hex is None
                                    and w.renv_hash == renv_hash)
                    if warm_renv >= renv_target:
                        continue
                w = None
                async with raylet._spawn_sem:
                    # fork directly, NEVER through the cold-Popen fallback:
                    # a refused fork (EAGAIN, zygote mid-crash) just skips
                    # this top-up round
                    pid = await self.fork_worker(renv)
                    if pid is None:
                        continue
                    w = raylet._register_forked(pid, renv_hash)
                    try:
                        await asyncio.wait_for(
                            w.registered, RAY_CONFIG.worker_start_timeout_s)
                    except asyncio.TimeoutError:
                        # kill + untrack: a late registrant would sit in
                        # raylet.workers but never join idle_workers, and
                        # repeating rounds would strand live processes
                        # until max_workers_per_node is consumed
                        logger.warning("warm-pool replenish: registration "
                                       "timed out; reaping pid %d", w.pid)
                        try:
                            w.proc.kill()
                        except Exception as e:
                            logger.debug("replenish reap of pid %d "
                                         "failed: %s", w.pid, e)
                        raylet.workers.pop(w.pid, None)
                        continue
                w.job_hex = None
                if w.pid in raylet.workers and w not in raylet.idle_workers:
                    raylet.idle_workers.append(w)
            except Exception:
                logger.exception("warm-pool replenish iteration failed")

    # -- introspection --------------------------------------------------

    def snapshot(self) -> dict:
        raylet = self.raylet
        hot_hash = self.hot_renv[0] if self.hot_renv else ""
        return {
            "enabled": self.enabled,
            "zygote_alive": self.zygote_alive,
            "zygote_pid": self._proc.pid if self._proc else None,
            "warm_target": int(RAY_CONFIG.worker_pool_warm_target),
            "idle_workers": len(raylet.idle_workers),
            "warm_default_env": sum(
                1 for w in raylet.idle_workers
                if w.job_hex is None and not w.renv_hash),
            "hot_renv_hash": hot_hash,
            "warm_hot_renv": sum(
                1 for w in raylet.idle_workers
                if w.job_hex is None and hot_hash
                and w.renv_hash == hot_hash),
            "total_workers": len(raylet.workers),
            **self.stats,
        }
