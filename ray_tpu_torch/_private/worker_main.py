"""Worker process entrypoint, spawned by the raylet's worker pool.

Reference: python/ray/_private/workers/default_worker.py — connects the
embedded CoreWorker to its node's raylet + the GCS, registers, then serves
PushTask until killed.

Two spawn paths share ``run_worker``:

- cold: the raylet ``Popen``s ``python -m ray_tpu_torch._private.worker_main``
  (fresh interpreter, pays the full import cost) — ``main()`` below;
- warm: the provisioner's zygote (``_private/provisioner/zygote.py``) forks
  a child that calls ``run_worker`` directly — imports are already resident,
  so start-up is fork(2) + connect.
"""

from __future__ import annotations

import argparse

from ray_tpu_torch._private import wire
import os
import signal
import threading
import time
from typing import Optional


def reset_observability_after_fork() -> None:
    """Reset every inherited observability buffer in a forked worker.

    The zygote image carries live span buffers, task-event buffers and a
    metrics registry; a forked child that keeps them re-emits the parent
    process's buffered events/spans under its own identity and re-reports
    the parent's accumulated counters (the ``_obs_proc_tag`` class of
    fork bug). Called by the zygote's fork child before
    :func:`run_worker`; safe to call in any process."""
    from ray_tpu_torch._private import task_events
    from ray_tpu_torch.util import goodput, metrics, tracing

    task_events.reset_after_fork()
    tracing.reset_after_fork()
    metrics.reset_after_fork()
    goodput.reset_after_fork()


def run_worker(raylet_address: str, gcs_address: str, node_id_hex: str,
               log_dir: str = "", runtime_env: Optional[dict] = None,
               orphan_ppid: Optional[int] = None) -> None:
    """Boot the worker runtime and serve until SIGTERM (or orphaning).

    ``orphan_ppid``: zygote-forked workers cannot use PDEATHSIG against the
    raylet (their parent is the zygote, and inheriting the zygote's PDEATHSIG
    would kill every worker on a zygote crash) — instead they watch for
    reparenting (zygote gone). A zygote crash alone is SURVIVABLE (the
    provisioner respawns it and this worker keeps its leases), so on
    orphaning the worker exits only once the raylet itself stops answering
    — the actual dead-cluster signal.
    """
    from ray_tpu_torch._private.logs import setup_process_logging

    setup_process_logging("worker", log_dir)
    import faulthandler

    # `kill -USR1 <pid>` dumps all thread stacks to the worker log — the
    # ray-stack equivalent for debugging silent hangs
    faulthandler.register(signal.SIGUSR1, all_threads=True)

    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch._private.core_worker import CoreWorker
    from ray_tpu_torch._private.ids import NodeID

    core = CoreWorker(
        gcs_address=gcs_address,
        raylet_address=raylet_address,
        node_id=NodeID.from_hex(node_id_hex),
        is_driver=False,
    )
    core.current_task_id = None
    core.current_actor_id = None
    core.connect()
    worker_mod._global_worker = core

    if runtime_env:
        from ray_tpu_torch._private import runtime_env as renv_mod

        def kv_get(key: str):
            return core._run(core._gcs_call(
                "KVGet", {"ns": "renv", "key": key}))["value"]

        renv_mod.apply(runtime_env, kv_get)

    core._run(core.raylet.call("RegisterWorker", wire.dumps({
        "pid": os.getpid(), "address": core.address})))

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    last_probe = 0.0
    while not stop.is_set():
        if orphan_ppid is not None and os.getppid() != orphan_ppid \
                and time.monotonic() - last_probe > 5.0:
            # reparented: the zygote died. If the raylet still answers this
            # is a survivable zygote crash (it gets respawned); only a dead
            # raylet means the cluster is gone and lingering would orphan us
            last_probe = time.monotonic()
            try:
                core._run(core.raylet.call(
                    "StoreStats", b"", timeout=5.0, retries=1), 15.0)
            except Exception as e:
                import logging

                logging.getLogger("ray_tpu_torch.worker").warning(
                    "orphaned (zygote gone) and raylet unreachable (%s); "
                    "exiting", e)
                break
        stop.wait(1.0)


def main():
    from ray_tpu_torch._private.common import die_with_parent

    die_with_parent()

    parser = argparse.ArgumentParser()
    parser.add_argument("--raylet-address", required=True)
    parser.add_argument("--gcs-address", required=True)
    parser.add_argument("--node-id", required=True)
    parser.add_argument("--log-dir", default="")
    parser.add_argument("--runtime-env", default="",
                        help="base64 JSON runtime-env descriptor")
    args = parser.parse_args()

    renv = None
    if args.runtime_env:
        import base64
        import json

        renv = json.loads(base64.b64decode(args.runtime_env))

    run_worker(args.raylet_address, args.gcs_address, args.node_id,
               log_dir=args.log_dir, runtime_env=renv)


if __name__ == "__main__":
    main()
