"""``multiprocessing.Pool`` drop-in on cluster tasks.

Reference: python/ray/util/multiprocessing — the Pool shim that lets
stdlib-Pool code scale across a cluster unchanged. Work items run as
framework tasks; ``processes`` caps in-flight parallelism.

The port of ``ray_tpu/util/multiprocessing.py``: work functions cross in the
port's pickler (by value where they cannot be imported by name), not
``cloudpickle``. A ``Pool`` made before ``init`` starts a cluster with
``init()``'s defaults, which take the card and raise on a host without one.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List, Optional

import ray_tpu_torch


@ray_tpu_torch.remote
def _pool_apply(fn_blob: bytes, args, kwargs):
    from ray_tpu_torch._private.serialization import loads_trusted

    fn = loads_trusted(fn_blob)
    return fn(*args, **(kwargs or {}))


class AsyncResult:
    def __init__(self, ref):
        self._ref = ref

    def get(self, timeout: Optional[float] = None):
        return ray_tpu_torch.get(self._ref, timeout=timeout)

    def wait(self, timeout: Optional[float] = None):
        ray_tpu_torch.wait([self._ref], timeout=timeout)

    def ready(self) -> bool:
        ready, _ = ray_tpu_torch.wait([self._ref], timeout=0)
        return bool(ready)

    def successful(self) -> bool:
        try:
            self.get(timeout=0.001)
            return True
        except Exception:
            return False


class Pool:
    """API-compatible subset of multiprocessing.Pool over cluster tasks."""

    def __init__(self, processes: Optional[int] = None,
                 initializer: Optional[Callable] = None, initargs: tuple = (),
                 ray_remote_args: Optional[dict] = None):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        if processes is None:
            processes = max(1, int(ray_tpu_torch.cluster_resources().get("CPU", 1)))
        self._processes = processes
        self._remote_args = ray_remote_args or {}
        self._initializer = initializer
        self._initargs = initargs
        self._closed = False

    def _submit(self, fn, args, kwargs=None):
        from ray_tpu_torch._private.serialization import dumps

        if self._initializer is not None:
            init, initargs = self._initializer, self._initargs

            def wrapped(*a, _fn=fn, **kw):
                init(*initargs)
                return _fn(*a, **kw)

            blob = dumps(wrapped)
        else:
            blob = dumps(fn)
        task = _pool_apply
        if self._remote_args:
            task = task.options(**self._remote_args)
        return task.remote(blob, tuple(args), kwargs)

    def _bounded_map(self, fn, chunks: List[tuple]) -> List[Any]:
        out_refs: List[Any] = []
        in_flight: List[Any] = []
        for args in chunks:
            if len(in_flight) >= self._processes:
                ready, in_flight = ray_tpu_torch.wait(
                    in_flight, num_returns=1, timeout=None)
                in_flight = list(in_flight)
            ref = self._submit(fn, args)
            out_refs.append(ref)
            in_flight.append(ref)
        return ray_tpu_torch.get(out_refs)

    # -- Pool API ------------------------------------------------------

    def apply(self, fn, args: tuple = (), kwds: Optional[dict] = None):
        return ray_tpu_torch.get(self._submit(fn, args, kwds))

    def apply_async(self, fn, args: tuple = (), kwds: Optional[dict] = None
                    ) -> AsyncResult:
        return AsyncResult(self._submit(fn, args, kwds))

    def map(self, fn, iterable: Iterable, chunksize: Optional[int] = None):
        return self._bounded_map(fn, [(x,) for x in iterable])

    def map_async(self, fn, iterable: Iterable) -> List[AsyncResult]:
        return [self.apply_async(fn, (x,)) for x in iterable]

    def starmap(self, fn, iterable: Iterable[tuple]):
        return self._bounded_map(fn, [tuple(x) for x in iterable])

    def imap(self, fn, iterable: Iterable, chunksize: Optional[int] = None):
        refs = [self._submit(fn, (x,)) for x in iterable]
        for ref in refs:
            yield ray_tpu_torch.get(ref)

    def imap_unordered(self, fn, iterable: Iterable,
                       chunksize: Optional[int] = None):
        pending = [self._submit(fn, (x,)) for x in iterable]
        while pending:
            ready, pending = ray_tpu_torch.wait(pending, num_returns=1)
            pending = list(pending)
            yield ray_tpu_torch.get(ready[0])

    def close(self):
        self._closed = True

    def terminate(self):
        self._closed = True

    def join(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
