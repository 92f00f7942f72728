"""The zygote process: pre-imports the heavy stack, forks workers on demand.

Runs as ``python -m ray_tpu_torch._private.provisioner.zygote --control-fd N``
with one end of a socketpair inherited from the raylet. The protocol is
length-prefixed JSON frames (4-byte big-endian length):

  -> {"op": "ping", "seq": k}                 <- {"op": "pong", "seq": k, ...}
  -> {"op": "fork", "seq": k, "args": {...}}  <- {"op": "forked", "seq": k,
                                                  "pid": p}
  (async, no seq)                             <- {"op": "exit", "pid": p,
                                                  "code": c}

Fork safety: the zygote is strictly single-threaded and never runs an event
loop — every import below must keep it that way (torch starts thread pools,
so it is only pre-imported behind ``zygote_preimport_torch``). It never
initialises CUDA either: a child forked from a process that holds a CUDA
context cannot use the card, so :func:`preimport` checks that importing
torch left CUDA uninitialised. The port of
``ray_tpu/_private/provisioner/zygote.py``. The fork child
closes the control fd, resets inherited signal/prctl state, and enters the
shared ``worker_main.run_worker`` bootstrap; the parent reaps children with
``waitpid(WNOHANG)`` and streams exit events back to the raylet.
"""

from __future__ import annotations

import os
import select
import signal
import sys
import traceback

from ray_tpu_torch._private.provisioner.framing import FrameReader, send_frame


def preimport(preimport_torch: bool = False) -> list:
    """Pay the import cost ONCE, before any fork: everything a worker needs
    at start-up (serialization, rpc, the worker runtime) plus the usual
    numeric stack. Returns the module names made resident (for the pong)."""
    mods = [
        "numpy",
        "ray_tpu_torch",
        "ray_tpu_torch._private.core_worker",
        "ray_tpu_torch._private.object_store",
        "ray_tpu_torch._private.rpc",
        "ray_tpu_torch._private.runtime_env",
        "ray_tpu_torch._private.serialization",
        "ray_tpu_torch._private.task_events",
        "ray_tpu_torch._private.wire",
        "ray_tpu_torch._private.worker_main",
    ]
    if preimport_torch:
        mods.append("torch")
    loaded = []
    for mod in mods:
        try:
            __import__(mod)
            loaded.append(mod)
        except Exception:  # keep serving: the worker will fail visibly later
            traceback.print_exc()
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        raise RuntimeError("the zygote must not initialise CUDA: its forked "
                           "workers could not use the card")
    return loaded


def _clear_pdeathsig() -> None:
    """The fork child inherits the zygote's PR_SET_PDEATHSIG (armed against
    the raylet). Left in place it would SIGKILL every worker the moment the
    zygote exits — clear it; orphan detection is the ppid poll in
    run_worker instead."""
    try:
        import ctypes

        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        libc.prctl(1, 0)  # PR_SET_PDEATHSIG, no signal
    except Exception:  # raylint: disable=EXC001 best-effort prctl reset in fork child
        pass


def _child_main(control_fd: int, args: dict, zygote_pid: int) -> "None":
    """Post-fork worker bootstrap. Never returns.

    ``zygote_pid`` is the parent's pid captured BEFORE the fork: calling
    ``os.getppid()`` here instead would race a zygote that dies in the fork
    window (the child would record init's pid and never detect orphaning).
    """
    code = 0
    try:
        os.close(control_fd)
        signal.signal(signal.SIGCHLD, signal.SIG_DFL)
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        _clear_pdeathsig()
        # the PRNG state is part of the zygote image: without a reseed every
        # forked worker would draw the same "random" stream (numpy's global
        # RandomState is preimported, so it needs its own reseed)
        import random
        import sys

        random.seed()
        if "numpy" in sys.modules:
            sys.modules["numpy"].random.seed()
        from ray_tpu_torch._private.worker_main import (
            reset_observability_after_fork, run_worker)

        # the zygote image holds live span/task-event buffers and a metric
        # registry; the child must not re-emit them as its own
        reset_observability_after_fork()
        run_worker(
            args["raylet_address"], args["gcs_address"], args["node_id"],
            log_dir=args.get("log_dir", ""),
            runtime_env=args.get("runtime_env"),
            orphan_ppid=zygote_pid,
        )
    except BaseException:
        traceback.print_exc()
        code = 1
    finally:
        # skip atexit/gc of state shared with the zygote image
        os._exit(code)


def serve(control_fd: int, preimport_torch: bool = False) -> None:
    loaded = preimport(preimport_torch)
    reader = FrameReader()
    my_pid = os.getpid()
    while True:
        try:
            ready, _, _ = select.select([control_fd], [], [], 0.2)
        except InterruptedError:  # raylint: disable=EXC001 EINTR on select: retry
            continue
        # reap forked children and stream exits to the raylet
        while True:
            try:
                pid, status = os.waitpid(-1, os.WNOHANG)
            except ChildProcessError:  # raylint: disable=EXC001 no children to reap
                break
            if pid == 0:
                break
            send_frame(control_fd, {
                "op": "exit", "pid": pid,
                "code": os.waitstatus_to_exitcode(status)})
        if not ready:
            continue
        try:
            data = os.read(control_fd, 1 << 16)
        except OSError:  # raylint: disable=EXC001 control fd gone: raylet died, exit quietly
            return
        if not data:
            return  # raylet closed its end: we're done
        for msg in reader.feed(data):
            op = msg.get("op")
            if op == "ping":
                send_frame(control_fd, {"op": "pong", "seq": msg.get("seq"),
                                        "pid": os.getpid(),
                                        "preimported": loaded})
            elif op == "fork":
                try:
                    pid = os.fork()
                except OSError as e:
                    # EAGAIN under the very burst load we exist to serve
                    # (or a pids cgroup limit): stay up, report the
                    # failure for THIS request only
                    send_frame(control_fd, {
                        "op": "forked", "seq": msg.get("seq"),
                        "error": f"fork failed: {e}"})
                    continue
                if pid == 0:
                    _child_main(control_fd, msg["args"], my_pid)  # no return
                send_frame(control_fd, {"op": "forked", "seq": msg.get("seq"),
                                        "pid": pid})
            elif op == "crash":  # fault injection for tests
                os._exit(42)


def main():
    from ray_tpu_torch._private.common import die_with_parent

    die_with_parent()

    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--control-fd", type=int, required=True)
    parser.add_argument("--preimport-torch", action="store_true")
    args = parser.parse_args()
    # stdout/stderr are the raylet's worker log; keep our own chatter out of
    # the frame channel (which is a dedicated fd)
    try:
        serve(args.control_fd, preimport_torch=args.preimport_torch)
    except KeyboardInterrupt:  # raylint: disable=EXC001 clean ^C shutdown path
        pass
    # zygote exits quietly when the raylet goes away; forked children notice
    # via their ppid poll


if __name__ == "__main__":
    main()
