"""Serve implementation: deployments, controller, replicas, router, batching,
the HTTP proxy. The port of ``ray_tpu/serve/api.py`` on this package's
runtime: blobs (targets, init args, configs, request args) go through the
runtime's own pickler (``_private/serialization.py``), and the HTTP proxy is
a small HTTP/1.1 server on ``asyncio.start_server`` with the JAX proxy's
routes and bodies.

Reference mapping:
- ``@serve.deployment`` / ``.bind`` / ``serve.run``: serve/api.py:320,681
- ``ServeController``: serve/_private/controller.py:102 (reconciles replica
  sets, restarts dead replicas)
- replica: serve/_private/replica.py (user callable behind an actor)
- router: power-of-two-choices on outstanding requests
  (serve/_private/request_router/pow_2_router.py:27), client-side here
- ``@serve.batch``: serve/batching.py (async dynamic batching)
"""

from __future__ import annotations

import asyncio
import copy
import functools
import random
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch._private.serialization import dumps as _dumps

CONTROLLER_NAME = "serve_controller"

_obs_lock = threading.Lock()
_obs_metrics: Optional[dict] = None


def _obs() -> dict:
    """Lazily-created serve request metrics on the shared registry
    (always on: every request through a handle/replica lands in
    ``/metrics`` with route/queue/execute phase histograms)."""
    global _obs_metrics
    with _obs_lock:
        if _obs_metrics is None:
            from ray_tpu_torch.util.metrics import Counter, Histogram

            bounds = [0.001, 0.01, 0.1, 1, 10]
            _obs_metrics = {
                "route": Histogram(
                    "ray_tpu.serve.route_seconds",
                    "handle-side routing: topology refresh + replica pick",
                    boundaries=bounds),
                "queue": Histogram(
                    "ray_tpu.serve.queue_seconds",
                    "request wait between handle dispatch and replica "
                    "execution start", boundaries=bounds),
                "execute": Histogram(
                    "ray_tpu.serve.execute_seconds",
                    "user-callable execution on the replica",
                    boundaries=bounds),
                "requests": Counter(
                    "ray_tpu.serve.requests",
                    "requests executed by this replica process"),
                "ttft": Histogram(
                    "ray_tpu.serve.ttft_seconds",
                    "server-side time to first token: handle dispatch to "
                    "the replica's first response chunk (whole response "
                    "for unary calls)", boundaries=bounds),
            }
        return _obs_metrics


_auto_obs_metrics: Optional[dict] = None


def _auto_obs() -> dict:
    """Autoscaler gauges on the shared registry (controller process):
    flushed into the GCS metrics-history ring like every other metric, so
    dashboards read scale state as rates over time."""
    global _auto_obs_metrics
    with _obs_lock:
        if _auto_obs_metrics is None:
            from ray_tpu_torch.util.metrics import Gauge

            _auto_obs_metrics = {
                "arrival": Gauge(
                    "ray_tpu.serve.arrival_rate",
                    "windowed request arrival rate per deployment (req/s)"),
                "replicas": Gauge(
                    "ray_tpu.serve.replicas",
                    "live replica count per deployment"),
                "target": Gauge(
                    "ray_tpu.serve.target_replicas",
                    "autoscaler replica target per deployment"),
                "queue_p99": Gauge(
                    "ray_tpu.serve.queue_wait_p99_seconds",
                    "windowed p99 queue wait per deployment"),
                "ttft_p99": Gauge(
                    "ray_tpu.serve.ttft_p99_seconds",
                    "windowed p99 server-side time to first token per "
                    "deployment"),
            }
        return _auto_obs_metrics


# ---------------------------------------------------------------------------
# public authoring API
# ---------------------------------------------------------------------------


@dataclass
class AutoscalingConfig:
    """Reference: serve/autoscaling_policy.py + config.AutoscalingConfig.

    Scaling is demand-driven (``serve/autoscale/``): the controller prices
    replica demand from windowed RATES (arrival rate x mean execute time,
    windowed ongoing rollup, queue-wait p99) — never from an
    instantaneous gauge — then applies the sustained-condition delays,
    the hysteresis band, and the post-action cooldown below."""

    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 2.0
    downscale_delay_s: float = 10.0
    # sliding window the rates are computed over
    window_s: float = 10.0
    # a replica is released only when demand clears this band below the
    # next-lower capacity step (anti-flap)
    hysteresis: float = 0.1
    # minimum seconds between any two scale actions
    scale_cooldown_s: float = 1.0

    @classmethod
    def from_dict(cls, d: dict) -> "AutoscalingConfig":
        unknown = set(d) - set(cls.__dataclass_fields__)
        if unknown:
            raise ValueError(f"unknown autoscaling_config keys: {sorted(unknown)}")
        return cls(**d)


@dataclass
class DeploymentConfig:
    num_replicas: int = 1
    max_ongoing_requests: int = 16
    ray_actor_options: Dict[str, Any] = field(default_factory=lambda: {"num_cpus": 1.0})
    health_check_period_s: float = 2.0
    autoscaling: Optional[AutoscalingConfig] = None
    # per-route SLO targets (ingress.SLOConfig dict): registered with the
    # controller -> published to the GCS health monitor; the autoscaler
    # defends queue_target_s as up-pressure
    slo: Optional[dict] = None


class Deployment:
    def __init__(self, target, name: str, config: DeploymentConfig):
        self._target = target
        self.name = name
        self.config = config

    def options(self, *, name: Optional[str] = None, num_replicas=None,
                max_ongoing_requests: Optional[int] = None,
                ray_actor_options: Optional[Dict[str, Any]] = None,
                autoscaling_config: Optional[dict] = None,
                slo: Optional[dict] = None) -> "Deployment":
        cfg = copy.deepcopy(self.config)
        if num_replicas == "auto" or autoscaling_config is not None:
            if isinstance(num_replicas, int) and num_replicas != 1:
                raise ValueError(
                    "num_replicas and autoscaling_config are mutually "
                    "exclusive; set min/max_replicas in the config instead")
            cfg.autoscaling = AutoscalingConfig.from_dict(autoscaling_config or {})
            cfg.num_replicas = cfg.autoscaling.min_replicas
        elif num_replicas is not None:
            cfg.num_replicas = num_replicas
            cfg.autoscaling = None
        if max_ongoing_requests is not None:
            cfg.max_ongoing_requests = max_ongoing_requests
        if ray_actor_options is not None:
            cfg.ray_actor_options = dict(ray_actor_options)
        if slo is not None:
            from ray_tpu_torch.serve.autoscale.ingress import SLOConfig

            cfg.slo = SLOConfig.from_dict(slo).to_dict()  # validate keys
        return Deployment(self._target, name or self.name, cfg)

    def bind(self, *args, **kwargs) -> "Application":
        return Application(self, args, kwargs)


@dataclass
class Application:
    deployment: Deployment
    init_args: tuple
    init_kwargs: dict


def deployment(target=None, *, name: Optional[str] = None, num_replicas=1,
               max_ongoing_requests: int = 16,
               ray_actor_options: Optional[Dict[str, Any]] = None,
               autoscaling_config: Optional[dict] = None,
               slo: Optional[dict] = None):
    """@serve.deployment on a class or function. ``num_replicas="auto"`` or
    an ``autoscaling_config`` dict enables demand-driven autoscaling; an
    ``slo`` dict (SLOConfig keys) registers per-route targets with the
    controller and the cluster health monitor."""

    def wrap(t):
        auto = None
        n = num_replicas
        if num_replicas == "auto" or autoscaling_config is not None:
            if isinstance(num_replicas, int) and num_replicas != 1:
                raise ValueError(
                    "num_replicas and autoscaling_config are mutually "
                    "exclusive; set min/max_replicas in the config instead")
            auto = AutoscalingConfig.from_dict(autoscaling_config or {})
            n = auto.min_replicas
        slo_dict = None
        if slo is not None:
            from ray_tpu_torch.serve.autoscale.ingress import SLOConfig

            slo_dict = SLOConfig.from_dict(slo).to_dict()
        cfg = DeploymentConfig(
            num_replicas=n,
            max_ongoing_requests=max_ongoing_requests,
            ray_actor_options=ray_actor_options or {"num_cpus": 1.0},
            autoscaling=auto,
            slo=slo_dict,
        )
        return Deployment(t, name or t.__name__, cfg)

    if target is not None:
        return wrap(target)
    return wrap


# ---------------------------------------------------------------------------
# replica actor
# ---------------------------------------------------------------------------


@ray_tpu_torch.remote
class _Replica:
    def __init__(self, target_blob: bytes, init_args_blob: bytes):
        from ray_tpu_torch._private.serialization import loads_trusted

        target = loads_trusted(target_blob)
        args, kwargs = loads_trusted(init_args_blob)
        # resolve nested Applications into handles (model composition)
        args = tuple(_resolve_app_args(a) for a in args)
        kwargs = {k: _resolve_app_args(v) for k, v in kwargs.items()}
        if isinstance(target, type):
            self._callable = target(*args, **kwargs)
        else:
            self._callable = functools.partial(target, *args, **kwargs) \
                if args or kwargs else target
        import threading as _th

        self._num_ongoing = 0
        # high-water mark since the autoscaler's last poll: a short burst
        # that starts AND drains between two 0.5s samples is still load —
        # instantaneous sampling alone is blind to it
        self._peak_ongoing = 0
        # request accounting runs on the replica's event loop, but
        # take_ongoing_peak() is a sync actor method on a pool thread:
        # its read-reset is a two-step RMW, so without a lock a burst
        # peaking between the read and the reset is silently dropped
        self._stats_lock = _th.Lock()
        # cumulative demand counters for the rate-based autoscaler
        # (serve/autoscale/window.py): monotone totals survive any number
        # of missed polls, so a burst that fully drains between two
        # control ticks still registers as arrivals
        self._arrived = 0
        self._completed = 0
        self._execute_sum = 0.0
        self._execute_count = 0
        import collections as _coll

        # recent per-request queue-wait observations, drained by
        # take_stats() into the controller's window for the p99 view
        self._queue_drain = _coll.deque(maxlen=256)
        # replica-stamped time-to-first-token observations (handle
        # dispatch -> first yielded chunk / unary completion), same
        # drain -> window -> ttft_p99 path as the queue waits
        self._ttft_drain = _coll.deque(maxlen=256)

    async def handle_request(self, method_name: str, args_blob: bytes):
        import contextvars as _cv

        from ray_tpu_torch._private.serialization import loads_trusted
        from ray_tpu_torch.serve.multiplex import _set_current_model_id
        from ray_tpu_torch.util import tracing

        args, kwargs = loads_trusted(args_blob)
        model_id = kwargs.pop("_serve_multiplexed_model_id", "")
        submit_ts = kwargs.pop("_serve_submit_ts", None)
        now = time.time()
        queue_wait = None
        if submit_ts is not None and now >= submit_ts:
            # handle-dispatch → execution-start wait (the actor queue):
            # built-in queue phase of every serve request
            queue_wait = now - submit_ts
            _obs()["queue"].observe(queue_wait)
            tracing.record_span("serve.queue", submit_ts, now,
                                category="serve")
        token = _set_current_model_id(model_id)
        with self._stats_lock:
            self._num_ongoing += 1
            self._peak_ongoing = max(self._peak_ongoing, self._num_ongoing)
            self._arrived += 1
            if queue_wait is not None:
                self._queue_drain.append(queue_wait)
        t_exec = time.perf_counter()
        try:
            if method_name == "__call__":
                if not callable(self._callable):
                    raise TypeError("deployment target is not callable")
                fn = self._callable
            else:
                fn = getattr(self._callable, method_name)
            with tracing.profile("serve.execute", category="serve"):
                if asyncio.iscoroutinefunction(fn):
                    out = await fn(*args, **kwargs)
                else:
                    # sync user code runs off-loop so it can call other
                    # handles; copy the context so
                    # get_multiplexed_model_id() works there
                    loop = asyncio.get_event_loop()
                    ctx = _cv.copy_context()
                    out = await loop.run_in_executor(
                        None, functools.partial(ctx.run, fn, *args, **kwargs))
                    if asyncio.iscoroutine(out):
                        out = await out
            # a unary response's first token IS the whole response
            self._record_ttft(submit_ts)
            return out
        finally:
            obs = _obs()
            dt_exec = time.perf_counter() - t_exec
            obs["execute"].observe(dt_exec)
            obs["requests"].inc()
            with self._stats_lock:
                self._num_ongoing -= 1
                self._completed += 1
                self._execute_sum += dt_exec
                self._execute_count += 1

    async def handle_request_streaming(self, method_name: str,
                                       args_blob: bytes):
        """Async-generator entry: yields response chunks as the user
        target produces them. Invoked with num_returns="streaming" so each
        yield streams to the caller immediately (reference:
        serve/_private/replica.py UserCallableWrapper.call_user_generator +
        proxy streaming responses)."""
        import inspect

        from ray_tpu_torch._private.serialization import loads_trusted

        args, kwargs = loads_trusted(args_blob)
        kwargs.pop("_serve_multiplexed_model_id", "")
        submit_ts = kwargs.pop("_serve_submit_ts", None)
        now = time.time()
        queue_wait = None
        if submit_ts is not None and now >= submit_ts:
            from ray_tpu_torch.util import tracing

            queue_wait = now - submit_ts
            _obs()["queue"].observe(queue_wait)
            tracing.record_span("serve.queue", submit_ts, now,
                                category="serve")
        if method_name == "__call__":
            fn = self._callable
        else:
            fn = getattr(self._callable, method_name)
        t_exec = time.perf_counter()
        with self._stats_lock:
            self._num_ongoing += 1
            self._peak_ongoing = max(self._peak_ongoing, self._num_ongoing)
            self._arrived += 1
            if queue_wait is not None:
                self._queue_drain.append(queue_wait)
        stamped = False

        def _stamp():
            # first produced chunk stamps the server-side TTFT; later
            # chunks are throughput, not first-token latency
            nonlocal stamped
            if not stamped:
                stamped = True
                self._record_ttft(submit_ts)

        try:
            if inspect.isasyncgenfunction(fn):
                async for chunk in fn(*args, **kwargs):
                    _stamp()
                    yield chunk
                return
            out = fn(*args, **kwargs)
            if inspect.iscoroutine(out):
                out = await out
            if hasattr(out, "__aiter__"):
                async for chunk in out:
                    _stamp()
                    yield chunk
            elif hasattr(out, "__next__") or (
                    hasattr(out, "__iter__")
                    and not isinstance(out, (str, bytes, dict))):
                for chunk in out:
                    _stamp()
                    yield chunk
            else:
                _stamp()
                yield out
        finally:
            dt_exec = time.perf_counter() - t_exec
            with self._stats_lock:
                self._num_ongoing -= 1
                self._completed += 1
                self._execute_sum += dt_exec
                self._execute_count += 1

    def _record_ttft(self, submit_ts: Optional[float]):
        """Stamp server-side time-to-first-token for one request (handle
        dispatch wall clock -> now); rides the replica histogram and the
        take_stats drain into the autoscaler's windowed ttft_p99."""
        if submit_ts is None:
            return
        ttft = time.time() - submit_ts
        if ttft < 0:
            return  # clock skew between handle and replica hosts
        _obs()["ttft"].observe(ttft)
        with self._stats_lock:
            self._ttft_drain.append(ttft)

    def num_ongoing(self) -> int:
        return self._num_ongoing

    def take_ongoing_peak(self) -> int:
        """Autoscaler sample: the highest concurrent-request count since
        the previous call (reset to the current level). Peak-based
        sampling sees bursts that fully drain between two polls."""
        with self._stats_lock:
            peak = max(self._peak_ongoing, self._num_ongoing)
            self._peak_ongoing = self._num_ongoing
        return peak

    def take_stats(self) -> dict:
        """Autoscaler sample v2: cumulative counters + drained queue-wait
        samples. Counters are CUMULATIVE so the controller's sliding
        window prices rates from deltas — a burst that arrives and fully
        drains between two polls still moves ``arrived``/``completed``
        (the burst-blindness case a point gauge misses)."""
        with self._stats_lock:
            peak = max(self._peak_ongoing, self._num_ongoing)
            self._peak_ongoing = self._num_ongoing
            queue_samples = list(self._queue_drain)
            self._queue_drain.clear()
            ttft_samples = list(self._ttft_drain)
            self._ttft_drain.clear()
            return {
                "arrived": self._arrived,
                "completed": self._completed,
                "execute_sum": self._execute_sum,
                "execute_count": self._execute_count,
                "ongoing": self._num_ongoing,
                "peak": peak,
                "queue_samples": queue_samples,
                "ttft_samples": ttft_samples,
            }

    def drain(self) -> int:
        """Rolling update support: called on a replica that has been
        removed from the topology; returns outstanding request count so
        the controller can kill it only when it reaches zero."""
        return self._num_ongoing

    def health(self) -> bool:
        return True


def _resolve_app_args(v):
    if isinstance(v, Application):
        return get_app_handle(v.deployment.name)
    return v


# ---------------------------------------------------------------------------
# controller actor
# ---------------------------------------------------------------------------


@ray_tpu_torch.remote
class _ServeController:
    """Reconciles target replica sets; restarts dead replicas; runs the
    request-driven autoscaler (reference: _private/controller.py reconcile
    loop + autoscaling_state.py); publishes versioned topology with a
    long-poll wait (reference: _private/long_poll.py)."""

    def __init__(self):
        import threading as _th

        self.apps: Dict[str, dict] = {}  # name -> {blob, init, cfg, replicas,
        #                                           version, target, scale_ts}
        self._running = True
        self._loop_started = False
        self._cv = _th.Condition()
        # serializes deploy/delete vs the control loop's reconcile/autoscale
        # (both run on executor threads)
        self._mutate = _th.RLock()

    def _bump(self, name: str):
        with self._cv:
            app = self.apps.get(name)
            if app is not None:
                app["version"] += 1
            self._cv.notify_all()

    def deploy(self, name: str, target_blob: bytes, init_blob: bytes,
               cfg_blob: bytes) -> bool:
        from ray_tpu_torch._private.serialization import loads_trusted

        cfg = loads_trusted(cfg_blob)
        with self._mutate:
            old = self.apps.get(name)
            if old:
                # versioned ROLLING update (reference: serve/_private/
                # deployment_state.py _check_and_update_replicas): keep the
                # old code version serving; the reconcile loop replaces
                # replicas one at a time, draining each before killing it,
                # so no request is dropped during an upgrade
                old.update({"blob": target_blob, "init": init_blob,
                            "cfg": cfg, "target": cfg.num_replicas})
                old["code_version"] += 1
                old["version"] += 1
                if cfg.slo:
                    old["slo"] = dict(cfg.slo)
                self._reconcile(name)
                return True
            from ray_tpu_torch.serve.autoscale import (DeploymentMetricsWindow,
                                                 PolicyState)

            auto = cfg.autoscaling
            self.apps[name] = {"blob": target_blob, "init": init_blob,
                               "cfg": cfg, "replicas": [], "version": 0,
                               "code_version": 0, "replica_versions": {},
                               "rollout": None,
                               "target": cfg.num_replicas,
                               "scale_up_since": None, "scale_down_since": None,
                               # demand-driven autoscale plane: sliding
                               # rate window fed by replica counter deltas,
                               # policy smoothing state, bounded scale-event
                               # history, per-deployment SLO targets
                               "window": DeploymentMetricsWindow(
                                   window_s=auto.window_s if auto else 10.0),
                               "policy_state": PolicyState(),
                               "transitions": [],
                               "slo": dict(cfg.slo) if cfg.slo else None,
                               "draining": []}
            self._reconcile(name)
        return True

    def register_slo(self, name: str, slo: dict) -> bool:
        """Ingress handles register per-route SLO targets here; the
        autoscaler turns the queue-wait target into up-pressure and the
        GCS health scan reads the published state for violations."""
        with self._mutate:
            app = self.apps.get(name)
            if app is None:
                return False
            app["slo"] = dict(slo)
        return True

    def _reconcile(self, name: str):
        from ray_tpu_torch.serve import api as _api

        import time as _t

        app = self.apps[name]
        cfg = app["cfg"]
        want = app["target"]
        strikes = app.setdefault("strikes", {})
        alive = []
        # batched health checks under ONE deadline: a single wedged replica
        # must not stall the loop 10s per replica per app
        health_refs = [(r, r.health.remote()) for r in app["replicas"]]
        deadline = _t.monotonic() + 10.0
        for r, ref in health_refs:
            try:
                ray_tpu_torch.get(ref, timeout=max(0.5, deadline - _t.monotonic()))
                strikes.pop(r, None)
                alive.append(r)
            except Exception as e:
                from ray_tpu_torch.exceptions import ActorDiedError

                cause = getattr(e, "cause", None)
                dead = isinstance(e, ActorDiedError) or isinstance(
                    cause, ActorDiedError) or "ActorDied" in str(e)
                # a slow health check under load is not death: give a
                # replica several strikes before replacing it (a replica
                # building its model can starve the loop on small hosts)
                from ray_tpu_torch._private.config import RAY_CONFIG as _cfg

                strikes[r] = strikes.get(r, 0) + 1
                if not dead and strikes[r] < _cfg.serve_health_strikes:
                    alive.append(r)
                else:
                    strikes.pop(r, None)
                    try:
                        ray_tpu_torch.kill(r)  # don't leak the struck-out actor
                    except Exception:
                        pass
        changed = len(alive) != len(app["replicas"])
        rv = app.setdefault("replica_versions", {})
        code_version = app.setdefault("code_version", 0)

        def _start_replica():
            opts = dict(cfg.ray_actor_options)
            replica = _api._Replica.options(
                num_cpus=opts.get("num_cpus", 1.0),
                num_gpus=opts.get("num_gpus", 0.0),
                resources=opts.get("resources", {}),
                max_concurrency=cfg.max_ongoing_requests,
                max_restarts=-1,
            ).remote(app["blob"], app["init"])
            rv[replica] = code_version
            return replica

        while len(alive) < want:
            alive.append(_start_replica())
            changed = True
        draining = app.setdefault("draining", [])
        for extra in alive[want:]:
            # drain-aware scale-down: the surplus replica leaves the
            # topology NOW but stays alive until idle — handle caches
            # refresh on a ~5s TTL, so an immediate kill would drop
            # requests routed by a stale cache (the autoscale bench's
            # zero-drop criterion)
            changed = True
            rv.pop(extra, None)
            draining.append({
                "replica": extra, "removed_at": _t.monotonic(),
                "deadline": _t.monotonic()
                + getattr(cfg, "graceful_shutdown_timeout_s", 30.0)})
        app["replicas"] = alive[:want]
        keep = {id(app.get("surge_replica")),
                id((app.get("rollout") or {}).get("draining"))}
        for r in list(rv):
            if r not in app["replicas"] and id(r) not in keep:
                rv.pop(r, None)
        if self._advance_scaledown(app):
            changed = True
        if self._advance_rollout(name, app):
            changed = True
        if changed:
            self._bump(name)

    def _advance_scaledown(self, app: dict) -> bool:
        """Kill drained scale-down victims: after a stale-cache grace each
        victim is polled for outstanding requests and killed only at zero
        (hard-capped by the graceful window)."""
        import time as _t

        remaining = []
        for entry in app.get("draining", []):
            replica = entry["replica"]
            now = _t.monotonic()
            done = now >= entry["deadline"]
            if not done and now - entry["removed_at"] >= 6.0:
                try:
                    done = ray_tpu_torch.get(replica.drain.remote(),
                                       timeout=5.0) == 0
                except Exception:
                    done = True  # already dead
            if done:
                try:
                    ray_tpu_torch.kill(replica)
                except Exception:
                    pass
            else:
                remaining.append(entry)
        app["draining"] = remaining
        # killing a drained victim never changes the topology (it already
        # left the replica list when the scale-down was decided)
        return False

    def _advance_rollout(self, name: str, app: dict) -> bool:
        """One rolling-update step per control-loop tick (reference:
        deployment_state.py's max-surge-1 rollout): start ONE new-version
        replica; once it answers health, pull ONE old-version replica out
        of the topology; kill it only when drained (or after the graceful
        window). Returns True if the topology changed."""
        import time as _t

        rv = app["replica_versions"]
        code_version = app["code_version"]
        ro = app.get("rollout")
        changed = False
        if ro is not None:
            # a drain is in flight. The victim left the topology, but handle
            # caches refresh on a ~5s TTL — keep it ALIVE (still serving)
            # for a propagation grace so stale routers hit a live replica,
            # then kill once idle (hard-capped by the graceful window)
            draining = ro["draining"]
            now = _t.monotonic()
            done = now >= ro["deadline"]
            if not done and now - ro["removed_at"] >= 6.0:
                try:
                    done = ray_tpu_torch.get(draining.drain.remote(),
                                       timeout=5.0) == 0
                except Exception:
                    done = True  # already dead
            if done:
                rv.pop(draining, None)
                try:
                    ray_tpu_torch.kill(draining)
                except Exception:
                    pass
                app["rollout"] = None
            return False
        stale = [r for r in app["replicas"] if rv.get(r, 0) != code_version]
        if not stale:
            return False
        # surge one new-version replica, wait for it to answer health
        surge = app.get("surge_replica")
        if surge is None:
            opts = dict(app["cfg"].ray_actor_options)
            from ray_tpu_torch.serve import api as _api

            surge = _api._Replica.options(
                num_cpus=opts.get("num_cpus", 1.0),
                num_gpus=opts.get("num_gpus", 0.0),
                resources=opts.get("resources", {}),
                max_concurrency=app["cfg"].max_ongoing_requests,
                max_restarts=-1,
            ).remote(app["blob"], app["init"])
            app["surge_replica"] = surge
            rv[surge] = code_version
            return False
        try:
            ray_tpu_torch.get(surge.health.remote(), timeout=5.0)
        except Exception:
            return False  # not ready yet; try next tick
        # swap: new replica enters the topology, oldest stale leaves it
        victim = stale[0]
        replicas = [r for r in app["replicas"] if r is not victim] + [surge]
        app["replicas"] = replicas
        app["surge_replica"] = None
        app["rollout"] = {
            "draining": victim, "removed_at": _t.monotonic(),
            "deadline": _t.monotonic()
            + getattr(app["cfg"], "graceful_shutdown_timeout_s", 30.0)}
        return True

    def _autoscale(self, name: str):
        """Demand-driven autoscaling: poll cumulative replica counters,
        fold them into the deployment's sliding rate window, and let the
        policy price replica demand (Little's law concurrency, hysteresis,
        cooldown, queue-SLO pressure). Rates from counter DELTAS replace
        the old ``take_ongoing_peak`` gauge — a burst that arrives and
        fully drains between two 0.5s ticks still moves the cumulative
        ``arrived`` counter, so burst blindness is covered structurally
        instead of patched per-gauge (reference: autoscaling_state.py)."""
        import time as _t

        from ray_tpu_torch.serve.autoscale import decide

        app = self.apps[name]
        auto: AutoscalingConfig = app["cfg"].autoscaling
        if auto is None or not app["replicas"]:
            return
        window = app.get("window")
        state = app.get("policy_state")
        if window is None or state is None:
            return
        # wait-then-get: a wedged or cold replica must not stall the
        # control loop — fold in whichever samples arrived in budget
        refs = [r.take_stats.remote() for r in app["replicas"]]
        try:
            ready, _ = ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=5.0)
            stats = [ray_tpu_torch.get(ref) for ref in ready]
        except Exception:
            return
        if not stats:
            return
        now = _t.monotonic()
        window.observe(stats, now)
        slo = app.get("slo") or {}
        decision = decide(window, current_target=app["target"], config=auto,
                          state=state, now=now,
                          queue_target_s=slo.get("queue_target_s"),
                          ttft_target_s=slo.get("ttft_target_s"))
        rollup = window.rollup(now)
        self._publish_autoscale(name, app, rollup)
        if decision.want != app["target"]:
            before = app["target"]
            app["target"] = decision.want
            self._record_transition(name, before, decision)

    def _record_transition(self, name: str, before: int, decision):
        """Bounded per-app scale history + timeline span, so the trace
        shows WHY each scale action fired. (The JAX package also records a
        task-plane event; the port has no event log.)"""
        import time as _t

        app = self.apps[name]
        entry = {"ts": _t.time(), "from": before, "to": decision.want,
                 "direction": decision.direction, "reason": decision.reason,
                 "metrics": decision.metrics}
        transitions = app.setdefault("transitions", [])
        transitions.append(entry)
        del transitions[:-64]
        try:
            from ray_tpu_torch.util import events, tracing

            events.record(
                "serve", "INFO",
                "autoscale %s: %d -> %d (%s)" % (name, before, decision.want,
                                                 decision.reason),
                deployment=name, direction=decision.direction,
                **decision.metrics)
            end = _t.time()
            tracing.record_span("serve.autoscale", end - 1e-4, end,
                                category="serve", deployment=name,
                                direction=decision.direction,
                                replicas_from=before,
                                replicas_to=decision.want)
        except Exception:  # observability is best-effort by contract
            pass

    def _publish_autoscale(self, name: str, app: dict, rollup: dict):
        """Per-tick observability fan-out: registry gauges (flushed into
        the GCS metrics-history ring) + a KV ``serve`` namespace mirror
        (dashboard ``/api/serve``, CLI, and the GCS health scan's SLO
        check read it back)."""
        try:
            obs = _auto_obs()
            tags = {"deployment": name}
            obs["arrival"].set(rollup.get("arrival_rate") or 0.0, tags=tags)
            obs["replicas"].set(float(len(app["replicas"])), tags=tags)
            obs["target"].set(float(app["target"]), tags=tags)
            qp99 = rollup.get("queue_p99_s")
            if qp99 is not None:
                obs["queue_p99"].set(qp99, tags=tags)
            tp99 = rollup.get("ttft_p99_s")
            if tp99 is not None:
                obs["ttft_p99"].set(tp99, tags=tags)
        except Exception:
            pass
        try:
            import time as _t

            from ray_tpu_torch._private import wire
            from ray_tpu_torch.experimental.internal_kv import _internal_kv_put

            _internal_kv_put(name.encode(), wire.dumps({
                "ts": _t.time(),
                "target": app["target"],
                "replicas": len(app["replicas"]),
                "draining": len(app.get("draining", [])),
                "slo": app.get("slo"),
                "rollup": rollup,
                "transitions": list(app.get("transitions", []))[-8:],
            }), namespace="serve")
        except Exception:  # stats mirror is best-effort by contract
            pass

    def run_control_loop(self):
        """Blocking reconcile+autoscale loop; started once by serve.run
        (runs on one of the controller's executor threads)."""
        import time as _t

        if self._loop_started:
            return False
        self._loop_started = True
        while self._running:
            for name in list(self.apps):
                try:
                    with self._mutate:
                        if name in self.apps:
                            self._autoscale(name)
                            self._reconcile(name)
                except Exception:
                    pass
            _t.sleep(0.5)
        return True

    def check_replicas(self):
        """One reconcile pass (also available to tests/handles)."""
        for name in list(self.apps):
            with self._mutate:
                if name in self.apps:
                    self._reconcile(name)
        return True

    def get_replicas(self, name: str):
        app = self.apps.get(name)
        if app is None:
            raise KeyError(f"no deployment named {name!r}")
        return list(app["replicas"])

    def get_topology(self, name: str):
        """Versioned replica set for handle caches."""
        app = self.apps.get(name)
        if app is None:
            raise KeyError(f"no deployment named {name!r}")
        return {"version": app["version"], "replicas": list(app["replicas"])}

    async def poll_topology(self, name: str, version: int, timeout: float = 25.0):
        """Long-poll: returns when the replica set version moves past
        ``version`` (or on timeout, with the current state). Async so a
        waiting poller costs no executor thread (reference:
        serve/_private/long_poll.py LongPollHost). 100ms check granularity.
        """
        import time as _t

        deadline = _t.monotonic() + timeout
        while True:
            app = self.apps.get(name)
            if app is None:
                return {"version": -1, "replicas": []}
            if app["version"] != version or _t.monotonic() >= deadline:
                return {"version": app["version"],
                        "replicas": list(app["replicas"])}
            await asyncio.sleep(0.1)

    def get_autoscale_state(self, name: str) -> dict:
        """Rate rollup + scale history for one deployment (CLI/dashboard/
        bench read-back)."""
        with self._mutate:
            app = self.apps.get(name)
            if app is None:
                raise KeyError(f"no deployment named {name!r}")
            window = app.get("window")
            return {
                "target": app["target"],
                "replicas": len(app["replicas"]),
                "draining": len(app.get("draining", [])),
                "slo": app.get("slo"),
                "rollup": window.rollup() if window is not None else None,
                "transitions": list(app.get("transitions", [])),
            }

    def delete(self, name: str) -> bool:
        with self._mutate:
            app = self.apps.pop(name, None)
            if app:
                victims = list(app["replicas"]) + [
                    e["replica"] for e in app.get("draining", [])]
                for r in victims:
                    try:
                        ray_tpu_torch.kill(r)
                    except Exception:
                        pass
                try:
                    from ray_tpu_torch.experimental.internal_kv import \
                        _internal_kv_del

                    _internal_kv_del(name.encode(), namespace="serve")
                except Exception:
                    pass
        with self._cv:
            self._cv.notify_all()
        return True

    def stop_loops(self):
        self._running = False
        return True

    def status(self) -> Dict[str, Any]:
        out = {}
        for name, app in self.apps.items():
            transitions = app.get("transitions") or []
            out[name] = {
                "num_replicas": len(app["replicas"]),
                "target": app["target"],
                "version": app["version"],
                "autoscaling": app["cfg"].autoscaling is not None,
                "draining": len(app.get("draining", [])),
                "slo": app.get("slo"),
                "last_transition": transitions[-1] if transitions else None,
            }
        return out


def _get_controller(create: bool = True):
    try:
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except ValueError:
        if not create:
            raise
        return _ServeController.options(
            name=CONTROLLER_NAME, lifetime="detached", num_cpus=0.1,
            max_concurrency=16, get_if_exists=True).remote()


# ---------------------------------------------------------------------------
# handle + router
# ---------------------------------------------------------------------------


class DeploymentHandle:
    """Client-side router: power-of-two-choices over replica pending counts,
    fed by the controller's versioned topology (long-pollable).
    ``options(routing_policy="prefix")`` swaps keyed routing onto the
    shared consistent-hash :class:`~ray_tpu.serve.autoscale.PrefixRouter`
    policy (promoted from the LLMHandle one-off)."""

    def __init__(self, deployment_name: str, method_name: str = "__call__",
                 multiplexed_model_id: str = "", stream: bool = False,
                 routing_policy: str = "pow2"):
        self._name = deployment_name
        self._method = method_name
        self._model_id = multiplexed_model_id
        self._stream = stream
        self._routing_policy = routing_policy
        self._prefix_router = None
        self._replicas: List[Any] = []
        self._version = -1
        self._pending: Dict[Any, int] = {}
        self._last_refresh = 0.0

    def options(self, method_name: Optional[str] = None,
                multiplexed_model_id: Optional[str] = None,
                stream: Optional[bool] = None,
                routing_policy: Optional[str] = None) -> "DeploymentHandle":
        if routing_policy is not None and routing_policy not in (
                "pow2", "prefix"):
            raise ValueError(
                f"unknown routing_policy {routing_policy!r}; "
                "expected 'pow2' or 'prefix'")
        h = DeploymentHandle(
            self._name,
            method_name if method_name is not None else self._method,
            multiplexed_model_id if multiplexed_model_id is not None
            else self._model_id,
            stream if stream is not None else self._stream,
            routing_policy if routing_policy is not None
            else self._routing_policy)
        h._replicas = self._replicas
        h._version = self._version
        h._pending = self._pending
        return h

    def _router(self):
        if self._prefix_router is None:
            from ray_tpu_torch.serve.autoscale import PrefixRouter

            self._prefix_router = PrefixRouter(self._name)
        return self._prefix_router

    def _refresh(self, force: bool = False):
        if not force and self._replicas and time.monotonic() - self._last_refresh < 5.0:
            return
        controller = _get_controller(create=False)
        topo = ray_tpu_torch.get(
            controller.get_topology.remote(self._name), timeout=60)
        self._replicas = topo["replicas"]
        self._version = topo["version"]
        self._pending = {r: 0 for r in self._replicas}
        self._last_refresh = time.monotonic()

    def _long_poll_refresh(self, timeout: float = 25.0):
        """Blocking topology watch (proxies use this in a background
        thread); returns True if the replica set changed."""
        controller = _get_controller(create=False)
        topo = ray_tpu_torch.get(controller.poll_topology.remote(
            self._name, self._version, timeout), timeout=timeout + 30)
        changed = topo["version"] != self._version
        self._replicas = topo["replicas"]
        self._version = topo["version"]
        if changed:
            self._pending = {r: 0 for r in self._replicas}
        self._last_refresh = time.monotonic()
        return changed

    def _pick(self):
        self._refresh()
        if not self._replicas:
            # replicas may be mid-restart: re-ask the controller (it
            # reconciles on demand) before giving up
            deadline = time.monotonic() + 30.0
            while not self._replicas and time.monotonic() < deadline:
                time.sleep(0.2)
                try:
                    self._refresh(force=True)
                except Exception:
                    pass
            if not self._replicas:
                raise RuntimeError(f"deployment {self._name} has no replicas")
        if len(self._replicas) == 1:
            return self._replicas[0]
        a, b = random.sample(self._replicas, 2)
        return a if self._pending.get(a, 0) <= self._pending.get(b, 0) else b

    def remote(self, *args, **kwargs):
        if self._model_id:
            # model multiplexing: the same model id sticks to the same
            # replica so its model cache stays hot (reference:
            # serve/multiplex.py + prefix-aware routing)
            kwargs["_serve_multiplexed_model_id"] = self._model_id
            return self.remote_with_key(self._model_id, *args, **kwargs)
        from ray_tpu_torch.util import tracing

        t0 = time.perf_counter()
        with tracing.profile("serve.route", category="serve",
                             deployment=self._name):
            key = None
            if self._routing_policy == "prefix" and args:
                # derive the routing key from the request body's prompt
                # prefix; non-prompt bodies fall back to pow-2
                key = self._router().key_of(args[0])
            replica = self._pick_keyed(key) if key else self._pick()
        _obs()["route"].observe(time.perf_counter() - t0)
        return self._dispatch(replica, args, kwargs)

    def remote_with_key(self, routing_key: str, *args, **kwargs):
        """Consistent routing: the same key prefers the same replica (the
        prefix-cache-aware policy — see autoscale/router.py). A replica
        joining or leaving remaps only ~1/N of the key space, so warm KV
        prefixes survive autoscaling and rolling updates."""
        from ray_tpu_torch.util import tracing

        t0 = time.perf_counter()
        with tracing.profile("serve.route", category="serve",
                             deployment=self._name):
            replica = self._pick_keyed(routing_key)
        _obs()["route"].observe(time.perf_counter() - t0)
        return self._dispatch(replica, args, kwargs)

    def _pick_keyed(self, routing_key: str):
        self._refresh()
        if not self._replicas or len(self._replicas) == 1:
            return self._pick()  # waits for replicas / raises
        return self._router().pick(routing_key, self._replicas,
                                   version=self._version)

    def broadcast(self, method_name: str, *args, timeout: float = 120.0,
                  **kwargs) -> List[Any]:
        """Invoke ``method_name`` once on EVERY current replica (bypasses
        routing). This is the live weight-update primitive: replicas keep
        serving while each applies the call — e.g.
        ``handle.broadcast("update_weights", store_name)`` makes every
        replica pull the newest version from a WeightStore with zero
        dropped requests (the method runs as one more actor task on the
        replica's queue; nothing restarts). Returns one result per replica.
        """
        self._refresh(force=True)
        if not self._replicas:
            raise RuntimeError(f"deployment {self._name} has no replicas")
        blob = _dumps((args, kwargs))
        refs = [r.handle_request.remote(method_name, blob)
                for r in self._replicas]
        return ray_tpu_torch.get(refs, timeout=timeout)

    def _dispatch(self, replica, args, kwargs):
        # pending counters decay by zeroing at each periodic refresh
        self._pending[replica] = self._pending.get(replica, 0) + 1
        # dispatch timestamp rides the request so the replica can record
        # the built-in serve.queue span (popped before user code sees it)
        kwargs = {**kwargs, "_serve_submit_ts": time.time()}
        blob = _dumps((args, kwargs))
        if self._stream:
            # ObjectRefGenerator of chunk refs, produced as the replica
            # yields (reference: handle.options(stream=True))
            return replica.handle_request_streaming.options(
                num_returns="streaming").remote(self._method, blob)
        return replica.handle_request.remote(self._method, blob)

    def __reduce__(self):
        return (DeploymentHandle,
                (self._name, self._method, self._model_id, self._stream,
                 self._routing_policy))


def get_app_handle(name: str) -> DeploymentHandle:
    return DeploymentHandle(name)


# ---------------------------------------------------------------------------
# run / delete / status
# ---------------------------------------------------------------------------


def run(app: Application, name: Optional[str] = None, *,
        _blocking: bool = True) -> DeploymentHandle:
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init()
    controller = _get_controller()
    dep = app.deployment
    deploy_name = name or dep.name
    ray_tpu_torch.get(controller.deploy.remote(
        deploy_name,
        _dumps(dep._target),
        _dumps((app.init_args, app.init_kwargs)),
        _dumps(dep.config)), timeout=600)
    from ray_tpu_torch._private.worker import global_worker

    if global_worker().mode != "local":
        # local mode executes actor calls inline, so the blocking control
        # loop must not start there (health/autoscaling don't apply anyway)
        controller.run_control_loop.remote()  # idempotent; fire-and-forget
    handle = DeploymentHandle(deploy_name)
    handle._refresh(force=True)
    return handle


def delete(name: str):
    controller = _get_controller(create=False)
    ray_tpu_torch.get(controller.delete.remote(name), timeout=60)


def status() -> Dict[str, Any]:
    controller = _get_controller(create=False)
    return ray_tpu_torch.get(controller.status.remote(), timeout=60)


def shutdown():
    try:
        controller = _get_controller(create=False)
    except ValueError:
        return
    for name in list(ray_tpu_torch.get(controller.status.remote(), timeout=60)):
        ray_tpu_torch.get(controller.delete.remote(name), timeout=60)
    ray_tpu_torch.kill(controller)


# ---------------------------------------------------------------------------
# dynamic batching (reference: serve/batching.py)
# ---------------------------------------------------------------------------


def batch(_fn=None, *, max_batch_size: int = 8, batch_wait_timeout_s: float = 0.01):
    """Decorator for async methods taking a list of requests: concurrent
    single calls are buffered into one batched invocation."""

    def wrap(fn):
        state = {"queue": [], "event": None, "task": None}

        async def flush(self_ref):
            await asyncio.sleep(batch_wait_timeout_s)
            await do_flush(self_ref)

        async def do_flush(self_ref):
            queue, state["queue"] = state["queue"], []
            state["task"] = None
            if not queue:
                return
            items = [item for item, _ in queue]
            futs = [f for _, f in queue]
            try:
                results = await fn(self_ref, items) if self_ref is not None \
                    else await fn(items)
                for f, r in zip(futs, results):
                    if not f.done():
                        f.set_result(r)
            except Exception as e:
                for f in futs:
                    if not f.done():
                        f.set_exception(e)

        @functools.wraps(fn)
        async def wrapper(*args):
            if len(args) == 2:
                self_ref, item = args
            else:
                self_ref, item = None, args[0]
            fut = asyncio.get_event_loop().create_future()
            state["queue"].append((item, fut))
            if len(state["queue"]) >= max_batch_size:
                if state["task"] is not None:
                    state["task"].cancel()
                    state["task"] = None
                await do_flush(self_ref)
            elif state["task"] is None:
                state["task"] = asyncio.ensure_future(flush(self_ref))
            return await fut

        return wrapper

    if _fn is not None:
        return wrap(_fn)
    return wrap


# ---------------------------------------------------------------------------
# HTTP proxy (reference: serve/_private/proxy.py)
# ---------------------------------------------------------------------------

_HTTP_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
                 405: "Method Not Allowed", 500: "Internal Server Error"}


def _encode_chunk(chunk) -> bytes:
    if isinstance(chunk, bytes):
        return chunk
    if isinstance(chunk, str):
        return chunk.encode()
    import json

    return (json.dumps(chunk) + "\n").encode()


def _response_head(status: int, headers: Dict[str, str]) -> bytes:
    lines = [f"HTTP/1.1 {status} {_HTTP_REASONS.get(status, 'Unknown')}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


@ray_tpu_torch.remote
class _HttpProxy:
    """HTTP/1.1 ingress on ``asyncio.start_server`` (the JAX proxy runs
    aiohttp, which the port does not depend on), with the JAX proxy's
    routes and bodies: ``POST /<deployment>`` with a JSON body routes to
    the deployment handle and answers ``{"result": ...}``, or
    ``{"error": ...}`` with status 500; ``?stream=1`` (or ``Accept:
    text/event-stream``) answers a chunked response whose chunks go out as
    the replica yields them; ``GET /-/healthz`` answers ``{"ok": true}``.
    One request per connection at a time, keep-alive honoured."""

    def __init__(self, port: int):
        self.port = port
        self._server = None

    async def start(self) -> int:
        """Bind and serve; a failure to bind raises."""
        if self._server is None:
            self._server = await asyncio.start_server(
                self._connection, "127.0.0.1", self.port)
        return self.port

    async def _connection(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter):
        try:
            while True:
                keep = await self._one_request(reader, writer)
                if not keep:
                    break
        except (ConnectionError, asyncio.IncompleteReadError,
                asyncio.LimitOverrunError):
            pass  # the client went away mid-request, or sent 64 KiB of head
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:  # already closed by the peer
                pass

    async def _one_request(self, reader, writer) -> bool:
        """Read and answer one request; returns whether the connection
        stays open for another."""
        import json
        from urllib.parse import parse_qs, unquote, urlsplit

        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except asyncio.IncompleteReadError as e:
            if e.partial:
                raise
            return False  # a clean close between requests
        lines = head.decode("latin-1").split("\r\n")
        try:
            method, target, version = lines[0].split(" ", 2)
        except ValueError:
            await self._send_json(writer, 400, {"error": "bad request line"},
                                  False)
            return False
        headers = {}
        for line in lines[1:]:
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        try:
            length = int(headers.get("content-length") or 0)
        except ValueError:
            await self._send_json(writer, 400, {"error": "bad content-length"},
                                  False)
            return False
        raw = await reader.readexactly(length) if length > 0 else b""
        conn = headers.get("connection", "").lower()
        keep = conn != "close" if version == "HTTP/1.1" else \
            conn == "keep-alive"
        url = urlsplit(target)
        path = unquote(url.path)
        if path == "/-/healthz" and method == "GET":
            await self._send_json(writer, 200, {"ok": True}, keep)
            return keep
        name = path[1:]
        if method != "POST" or not name or "/" in name:
            status = 404 if method in ("GET", "POST") else 405
            await self._send_json(writer, status,
                                  {"error": f"no route {method} {path}"},
                                  keep)
            return keep
        try:
            body = json.loads(raw) if raw else {}
        except ValueError:
            body = {}
        query = parse_qs(url.query)
        stream = query.get("stream", [""])[-1] in ("1", "true") or \
            "text/event-stream" in headers.get("accept", "")
        if stream:
            await self._stream(writer, name, body)
            return False  # the chunked body ends the exchange
        loop = asyncio.get_running_loop()
        try:
            # route off-loop: handle calls block on the core worker
            result = await loop.run_in_executor(
                None, functools.partial(_route, name, body))
            await self._send_json(writer, 200, {"result": result}, keep)
        except Exception as e:
            await self._send_json(writer, 500, {"error": str(e)}, keep)
        return keep

    async def _send_json(self, writer, status: int, obj, keep: bool):
        import json

        data = json.dumps(obj).encode()
        writer.write(_response_head(status, {
            "Content-Type": "application/json",
            "Content-Length": str(len(data)),
            "Connection": "keep-alive" if keep else "close"}) + data)
        await writer.drain()

    async def _stream(self, writer, name: str, body):
        """Chunked response: each replica yield is flushed to the client
        as it arrives (reference: proxy.py streaming responses for
        generator deployments). A thread-safe queue and a stop flag, with
        every block bounded, so a client that leaves can never strand the
        pump thread."""
        import queue as _qmod

        q: _qmod.Queue = _qmod.Queue(maxsize=8)
        # raylint: disable=ASY002 cross-thread stop flag: loop side only set()/is_set(), never wait()
        stop = threading.Event()
        end = object()

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except _qmod.Full:
                    continue
            return False

        def _pump():
            try:
                h = DeploymentHandle(name, stream=True)
                for ref in h.remote(body):
                    if not _put(ray_tpu_torch.get(ref, timeout=120)):
                        return  # client left; drop the stream
                _put(end)
            except Exception as e:
                _put(RuntimeError(str(e)))

        loop = asyncio.get_running_loop()
        writer.write(_response_head(200, {
            "Content-Type": "application/octet-stream",
            "Transfer-Encoding": "chunked", "Connection": "close"}))
        await writer.drain()
        loop.run_in_executor(None, _pump)
        try:
            while True:
                try:
                    item = await loop.run_in_executor(
                        None, functools.partial(q.get, timeout=0.5))
                except _qmod.Empty:
                    continue
                if item is end:
                    break
                data = _encode_chunk({"error": str(item)}) if isinstance(
                    item, RuntimeError) else _encode_chunk(item)
                if data:
                    writer.write(b"%x\r\n%s\r\n" % (len(data), data))
                    await writer.drain()
                if isinstance(item, RuntimeError):
                    break
            writer.write(b"0\r\n\r\n")
            await writer.drain()
        finally:
            stop.set()


def _route(name: str, body):
    return ray_tpu_torch.get(DeploymentHandle(name).remote(body),
                             timeout=120)


def start_http_proxy(port: int = 0) -> int:
    """Start (or attach to) the detached HTTP proxy actor and return its
    port; ``port=0`` picks a free one."""
    import socket

    if port == 0:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
    proxy = _HttpProxy.options(name="serve_http_proxy", lifetime="detached",
                               num_cpus=0.1, max_concurrency=64,
                               get_if_exists=True).remote(port)
    return ray_tpu_torch.get(proxy.start.remote(), timeout=120)
