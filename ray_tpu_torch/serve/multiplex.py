"""Model multiplexing, the port of ``ray_tpu/serve/multiplex.py`` (reference:
python/ray/serve/multiplex.py + api.get_multiplexed_model_id): many fine-tuned models share one
deployment's replicas; each replica lazily loads up to N models in an LRU
cache, and the handle routes a given model id consistently to the same
replica so its cache stays hot.

Usage::

    @serve.deployment
    class ModelZoo:
        @serve.multiplexed(max_num_models_per_replica=3)
        async def get_model(self, model_id: str):
            return load_model(model_id)       # called once per id per replica

        async def __call__(self, body):
            model = await self.get_model(serve.get_multiplexed_model_id())
            return model(body)

    handle.options(multiplexed_model_id="m1").remote({...})
"""

from __future__ import annotations

import asyncio
import collections
import contextvars
import functools
from typing import Any, Callable, Optional

_current_model_id: contextvars.ContextVar[str] = contextvars.ContextVar(
    "serve_multiplexed_model_id", default="")


def get_multiplexed_model_id() -> str:
    """The model id the in-flight request was routed with."""
    return _current_model_id.get()


def _set_current_model_id(model_id: str):
    return _current_model_id.set(model_id)


def multiplexed(_fn: Optional[Callable] = None, *,
                max_num_models_per_replica: int = 3):
    """Decorator for an async model loader ``(self, model_id) -> model``.
    Results are cached per replica in an LRU of the given capacity; evicted
    models are dropped (and their ``__del__`` releases device memory)."""

    def wrap(fn):
        caches: dict = {}
        inflight: dict = {}

        @functools.wraps(fn)
        async def wrapper(self, model_id: str):
            cache = caches.get(id(self))
            if cache is None:
                cache = caches[id(self)] = collections.OrderedDict()
            if model_id in cache:
                cache.move_to_end(model_id)
                return cache[model_id]
            # single-flight per (replica, model): concurrent requests for the
            # same id await ONE load instead of loading N copies
            key = (id(self), model_id)
            existing = inflight.get(key)
            if existing is not None:
                return await asyncio.shield(existing)
            fut = asyncio.get_event_loop().create_future()
            inflight[key] = fut
            try:
                model = fn(self, model_id)
                if asyncio.iscoroutine(model):
                    model = await model
                cache[model_id] = model
                cache.move_to_end(model_id)
                while len(cache) > max_num_models_per_replica:
                    cache.popitem(last=False)
                fut.set_result(model)
                return model
            except BaseException as e:
                if not fut.done():
                    fut.set_exception(e)
                raise
            finally:
                inflight.pop(key, None)

        wrapper.__serve_multiplexed__ = True
        return wrapper

    if _fn is not None:
        return wrap(_fn)
    return wrap
