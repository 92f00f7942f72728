"""The port's runtime against the JAX runtime on the CPU: core rates, and
where the driver's and an actor's event-loop threads spend their time.

    PYTHONPATH=. python tools/wire_profile.py rates [--runs 3]
    PYTHONPATH=. python tools/wire_profile.py profile {port,port_plain,jax}

``rates`` runs each package's ``_private/microbenchmark.py:main(duration=1.5)``
after ``init(num_cpus=8)``, each run in a fresh process, alternating the
port and the JAX runtime, and prints one JSON line a run. ``profile`` runs
cProfile on the driver's event-loop thread over 20 rounds of 100 batched
actor calls and 20 rounds of 100 batched tasks, and on the actor's
event-loop thread over the actor rounds, and prints each thread's seconds
and its top functions by own time. ``port_plain`` is the port with its
pure-Python codec (``_private/msgpack_plain.py``) in place of the native
one, in the driver and in the actor. ``PYTHONPATH`` must name the repo
root: the GCS and raylet processes import the packages from there.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import pstats
import subprocess
import sys
import threading
import time

ROUNDS, BATCH = 20, 100


def _runtime(pkg: str):
    if pkg.startswith("port"):
        import ray_tpu_torch as rt

        rt.init(num_cpus=8, device="cpu")
        return rt
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import ray_tpu as rt

    rt.init(num_cpus=8)
    return rt


def _worker(rt):
    return sys.modules[rt.__name__ + "._private.worker"].global_worker()


def _use_plain_codec() -> None:
    from ray_tpu_torch._private import msgpack, msgpack_plain

    msgpack._native = msgpack_plain


def _on_loop(worker, fn) -> None:
    """Run ``fn`` on the core worker's event-loop thread and wait."""
    done = threading.Event()
    worker.loop.call_soon_threadsafe(lambda: (fn(), done.set()))
    done.wait()


def _top(prof) -> str:
    """The 12 functions with the most time of their own."""
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(12)
    return "\n".join(line for line in out.getvalue().splitlines()
                     if line.strip() and "Ordered by" not in line
                     and "List reduced" not in line)


def profile(pkg: str) -> None:
    import cProfile

    rt = _runtime(pkg)
    if pkg == "port_plain":
        _use_plain_codec()

    @rt.remote(num_cpus=0.2)
    class Actor:
        def noop(self):
            return b"ok"

        def start(self, pkg):
            import cProfile as cp

            if pkg == "port_plain":
                _use_plain_codec()
            self.prof = cp.Profile()
            _on_loop(_worker(rt), self.prof.enable)

        def stop(self):
            _on_loop(_worker(rt), self.prof.disable)
            return _top(self.prof)

    @rt.remote(num_cpus=0.2)
    def noop():
        return b"ok"

    actor = Actor.remote()
    for _ in range(5):  # warm: workers leased, connections open
        rt.get([actor.noop.remote() for _ in range(BATCH)], timeout=60)
        rt.get([noop.remote() for _ in range(BATCH)], timeout=60)
    worker = _worker(rt)
    for kind in ("actor", "task"):
        if kind == "actor":
            rt.get(actor.start.remote(pkg), timeout=60)
        prof = cProfile.Profile()
        _on_loop(worker, prof.enable)
        t0 = time.perf_counter()
        for _ in range(ROUNDS):
            if kind == "actor":
                rt.get([actor.noop.remote() for _ in range(BATCH)],
                       timeout=60)
            else:
                rt.get([noop.remote() for _ in range(BATCH)], timeout=60)
        wall = time.perf_counter() - t0
        _on_loop(worker, prof.disable)
        print(f"== {pkg}, {ROUNDS * BATCH} batched {kind} calls in "
              f"{wall:.3f} s: the driver's loop thread")
        print(_top(prof))
        if kind == "actor":
            print(f"== {pkg}: the actor's loop thread")
            print(rt.get(actor.stop.remote(), timeout=60))
    rt.shutdown()


def _rates(pkg: str) -> None:
    rt = _runtime(pkg)
    if pkg.startswith("port"):
        from ray_tpu_torch._private import microbenchmark
    else:
        from ray_tpu._private import microbenchmark
    rows = microbenchmark.main(duration=1.5)
    print(json.dumps({"package": pkg, **{r["name"]: r["rate_per_s"]
                                        for r in rows}}), flush=True)
    rt.shutdown()


def rates(runs: int) -> None:
    for i in range(runs):
        for pkg in ("port", "jax"):
            out = subprocess.run([sys.executable, __file__, "_rates", pkg],
                                 capture_output=True, text=True, timeout=600)
            lines = [x for x in out.stdout.splitlines() if x.startswith("{")]
            if out.returncode != 0 or not lines:
                raise RuntimeError(f"{pkg} run {i}: {out.stderr[-2000:]}")
            print(lines[-1], flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("rates")
    r.add_argument("--runs", type=int, default=3)
    p = sub.add_parser("profile")
    p.add_argument("pkg", choices=("port", "port_plain", "jax"))
    sub.add_parser("_rates").add_argument("pkg")
    args = parser.parse_args()
    if args.cmd == "rates":
        rates(args.runs)
    elif args.cmd == "profile":
        profile(args.pkg)
    else:
        _rates(args.pkg)


if __name__ == "__main__":
    main()
