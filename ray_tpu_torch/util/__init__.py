"""Observability of the port: the metrics registry (``metrics``), causal
spans with a chrome://tracing export (``tracing``) and the goodput ledger
(``goodput``), the counterparts of ``ray_tpu/util``'s modules of those
names, GPU detection for the raylet (``accelerators``, the port of
the module that detects TPU chips), and placement groups and scheduling
strategies (``placement_group``, ``scheduling_strategies``), and the state
API over the GCS (``state``: nodes, actors, tasks, timelines, goodput and
the Dataset's stats), and structured cluster events (``events``). Metrics,
spans, events and the goodput ledger ship to the GCS inside the port's
runtime. ``ActorPool`` and ``Queue`` are the JAX package's, on the port's
actors, as are ``multiprocessing`` (the ``Pool`` shim over cluster tasks)
and ``client`` (the ``ray-tpu://`` proxy and its thin client)."""

from __future__ import annotations

from typing import Any, Callable, List

import ray_tpu_torch



class ActorPool:
    """Work distribution over a fixed set of actors (reference:
    python/ray/util/actor_pool.py)."""

    def __init__(self, actors: List[Any]):
        self._idle = list(actors)
        self._future_to_actor = {}
        self._pending = []  # (fn, value) waiting for an idle actor

    def submit(self, fn: Callable, value: Any):
        if self._idle:
            actor = self._idle.pop()
            ref = fn(actor, value)
            self._future_to_actor[ref] = actor
        else:
            self._pending.append((fn, value))

    def _drain_pending(self):
        while self._pending and self._idle:
            fn, value = self._pending.pop(0)
            actor = self._idle.pop()
            ref = fn(actor, value)
            self._future_to_actor[ref] = actor

    def get_next(self, timeout: float = 300.0):
        if not self._future_to_actor:
            raise StopIteration("no pending work")
        ready, _ = ray_tpu_torch.wait(list(self._future_to_actor),
                                num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("ActorPool.get_next timed out")
        ref = ready[0]
        actor = self._future_to_actor.pop(ref)
        self._idle.append(actor)
        self._drain_pending()
        return ray_tpu_torch.get(ref)

    def map(self, fn: Callable, values: List[Any]):
        for v in values:
            self.submit(fn, v)
        out = []
        for _ in values:
            out.append(self.get_next())
        return out

    def has_next(self) -> bool:
        return bool(self._future_to_actor) or bool(self._pending)


@ray_tpu_torch.remote(num_cpus=0.1)
class _QueueActor:
    def __init__(self, maxsize: int = 0):
        import asyncio

        self._q = asyncio.Queue(maxsize=maxsize)

    async def put(self, item, timeout=None):
        import asyncio

        await asyncio.wait_for(self._q.put(item), timeout)
        return True

    async def get(self, timeout=None):
        import asyncio

        return await asyncio.wait_for(self._q.get(), timeout)

    def qsize(self) -> int:
        return self._q.qsize()

    def empty(self) -> bool:
        return self._q.empty()


class Queue:
    """Distributed FIFO queue backed by an actor (reference:
    python/ray/util/queue.py)."""

    def __init__(self, maxsize: int = 0, name: str = ""):
        opts = {"max_concurrency": 16, "num_cpus": 0.1}
        if name:
            opts.update(name=name, get_if_exists=True, lifetime="detached")
        self._actor = _QueueActor.options(**opts).remote(maxsize)

    def put(self, item, timeout: float = None):
        ray_tpu_torch.get(self._actor.put.remote(item, timeout), timeout=timeout or 300)

    def get(self, timeout: float = None):
        return ray_tpu_torch.get(self._actor.get.remote(timeout),
                           timeout=(timeout or 300) + 10)

    def qsize(self) -> int:
        return ray_tpu_torch.get(self._actor.qsize.remote(), timeout=60)

    def empty(self) -> bool:
        return ray_tpu_torch.get(self._actor.empty.remote(), timeout=60)

    def shutdown(self):
        ray_tpu_torch.kill(self._actor)
