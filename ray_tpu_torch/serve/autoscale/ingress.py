"""SLO-aware ingress/admission plane at the handle tier: the port of
``ray_tpu/serve/autoscale/ingress.py``.

Reference shape: the serve proxy + request router keep per-deployment
queues and apply backpressure; production LLM gateways add per-tenant
fairness and explicit load shedding. Three pieces:

* :class:`SLOConfig` — per-route targets. ``queue_target_s`` is defended
  by the autoscaler (queue-wait p99 over it reads as up-pressure) and the
  GCS health monitor flags routes whose observed p99s exceed their
  registered targets; ``latency_budget_s`` is the admission deadline —
  a request still queued past it is shed instead of dispatched doomed.
* :class:`FairQueue` — deficit-round-robin across tenant/session keys
  with BOUNDED per-tenant queues. A full queue sheds synchronously
  (:class:`LoadShedError`) instead of growing an unbounded backlog; a
  2x-weight tenant drains twice as fast, and one flooding tenant can
  only ever occupy its own bound, never another tenant's throughput.
* :class:`IngressHandle` — wraps a DeploymentHandle: ``submit()`` returns
  a ``concurrent.futures.Future``; a dispatcher thread admits queued
  requests whenever in-flight capacity frees (replicas x
  ``max_inflight_per_replica``), and one completer thread resolves ALL
  outstanding refs through a single vectorized ``ray_tpu_torch.wait`` poll —
  no per-request waiter threads.

Everything observable lands on the shared metrics registry
(``ray_tpu.serve.queue_depth`` / ``ray_tpu.serve.shed_requests`` /
``ray_tpu.serve.admitted_requests``) and therefore in the GCS
metrics-history ring.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Dict, Optional

_obs_lock = threading.Lock()
_obs_metrics: Optional[dict] = None


def _obs() -> dict:
    global _obs_metrics
    with _obs_lock:
        if _obs_metrics is None:
            from ray_tpu_torch.util.metrics import Counter, Gauge

            _obs_metrics = {
                "queue_depth": Gauge(
                    "ray_tpu.serve.queue_depth",
                    "requests waiting in the ingress fair queue"),
                "shed": Counter(
                    "ray_tpu.serve.shed_requests",
                    "requests rejected by admission control (full tenant "
                    "queue or expired latency budget)"),
                "admitted": Counter(
                    "ray_tpu.serve.admitted_requests",
                    "requests dispatched to replicas by the ingress"),
            }
        return _obs_metrics


class LoadShedError(RuntimeError):
    """Explicit load-shed response: the ingress refused (or abandoned)
    the request instead of queueing it unboundedly. Callers should treat
    it as retryable-after-backoff (HTTP 503 semantics)."""


@dataclass
class SLOConfig:
    """Per-route service-level objectives registered with the serve
    controller (and through it, the GCS health monitor)."""

    ttft_target_s: Optional[float] = None
    queue_target_s: Optional[float] = None
    latency_budget_s: Optional[float] = None
    max_queue_depth: int = 256
    tenant_weights: Dict[str, float] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SLOConfig":
        unknown = set(d) - set(cls.__dataclass_fields__)
        if unknown:
            raise ValueError(f"unknown slo keys: {sorted(unknown)}")
        return cls(**d)


class FairQueue:
    """Deficit-round-robin fair queue over tenant keys (thread-safe).

    Unit-cost DRR: each visit tops a tenant's deficit up by
    ``quantum x weight`` and drains items while the deficit covers them,
    so long-run throughput shares converge to the weight ratio while
    per-tenant order stays FIFO. Bounded per-tenant depth: ``push`` on a
    full queue returns False (the ingress sheds instead of buffering)."""

    def __init__(self, max_depth_per_tenant: int = 256,
                 quantum: float = 1.0,
                 weights: Optional[Dict[str, float]] = None):
        self.max_depth = int(max_depth_per_tenant)
        self.quantum = float(quantum)
        self._weights = dict(weights or {})
        self._queues: Dict[str, deque] = {}
        self._deficit: Dict[str, float] = {}
        self._active: deque = deque()  # tenant visit order
        self._visiting: Optional[str] = None
        self._lock = threading.Lock()

    def weight(self, tenant: str) -> float:
        return max(float(self._weights.get(tenant, 1.0)), 1e-6)

    def __len__(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._queues.values())

    def depths(self) -> Dict[str, int]:
        with self._lock:
            return {t: len(q) for t, q in self._queues.items() if q}

    def push(self, tenant: str, item: Any) -> bool:
        with self._lock:
            q = self._queues.get(tenant)
            if q is None:
                q = self._queues[tenant] = deque()
            if len(q) >= self.max_depth:
                return False
            if not q and tenant not in self._active:
                self._active.append(tenant)
            q.append(item)
            return True

    def pop(self) -> Optional[Any]:
        """Next item under DRR, or None when empty."""
        with self._lock:
            # bounded walk: each tenant needs at most ceil(1/(q*w)) visits
            # to accumulate unit deficit; the +4 absorbs empty-queue pops
            for _ in range(4 + 4 * len(self._active) * 4):
                if not self._active:
                    return None
                if self._visiting is None:
                    self._visiting = self._active[0]
                    t = self._visiting
                    self._deficit[t] = self._deficit.get(t, 0.0) \
                        + self.quantum * self.weight(t)
                t = self._visiting
                q = self._queues.get(t)
                if not q:
                    self._active.popleft()
                    self._deficit[t] = 0.0
                    self._visiting = None
                    continue
                if self._deficit[t] >= 1.0:
                    self._deficit[t] -= 1.0
                    item = q.popleft()
                    if not q:
                        self._active.popleft()
                        self._deficit[t] = 0.0
                        self._visiting = None
                    return item
                # budget spent: move this tenant to the back of the cycle
                self._active.rotate(-1)
                self._visiting = None
            return None  # pathological weights; treat as empty this call


@dataclass
class _PendingRequest:
    tenant: str
    method: str
    args: tuple
    kwargs: dict
    future: Future
    arrival_ts: float
    deadline: Optional[float]
    routing_key: Optional[str] = None


class IngressHandle:
    """Admission-controlled front door for one deployment.

    ``submit()`` never blocks on capacity: it either enqueues (returning
    a Future that resolves to the replica's response) or sheds with
    :class:`LoadShedError` when the tenant's bounded queue is full.
    Dispatch order across tenants is DRR-fair; within a tenant, FIFO.
    """

    def __init__(self, deployment_name: str, *,
                 slo: Optional[SLOConfig] = None,
                 max_inflight_per_replica: int = 8,
                 handle: Optional[Any] = None,
                 register: bool = True):
        from ray_tpu_torch.serve import api as serve_api

        self._name = deployment_name
        self.slo = slo or SLOConfig()
        self._handle = handle if handle is not None \
            else serve_api.DeploymentHandle(deployment_name)
        self._per_replica = max(1, int(max_inflight_per_replica))
        self._queue = FairQueue(
            max_depth_per_tenant=self.slo.max_queue_depth,
            weights=self.slo.tenant_weights)
        self._inflight: Dict[Any, _PendingRequest] = {}
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._running = True
        self._stats = {"admitted": 0, "shed": 0, "completed": 0,
                       "failed": 0}
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True,
            name=f"serve-ingress-dispatch-{deployment_name}")
        self._completer = threading.Thread(
            target=self._complete_loop, daemon=True,
            name=f"serve-ingress-complete-{deployment_name}")
        self._dispatcher.start()
        self._completer.start()
        if register and (self.slo.ttft_target_s is not None
                         or self.slo.queue_target_s is not None):
            try:
                import ray_tpu_torch

                controller = serve_api._get_controller(create=False)
                ray_tpu_torch.get(controller.register_slo.remote(
                    deployment_name, self.slo.to_dict()), timeout=30)
            except Exception:
                pass  # SLO registration is best-effort observability

    # -- public API -----------------------------------------------------

    def submit(self, *args, tenant: str = "default",
               method: str = "__call__",
               routing_key: Optional[str] = None, **kwargs) -> Future:
        fut: Future = Future()
        now = time.monotonic()
        deadline = (now + self.slo.latency_budget_s
                    if self.slo.latency_budget_s is not None else None)
        req = _PendingRequest(tenant, method, args, kwargs, fut, now,
                              deadline, routing_key)
        with self._lock:
            if not self._running:
                fut.set_exception(RuntimeError("ingress closed"))
                return fut
            if not self._queue.push(tenant, req):
                self._stats["shed"] += 1
                _obs()["shed"].inc(tags={"deployment": self._name,
                                         "reason": "queue_full"})
                fut.set_exception(LoadShedError(
                    f"tenant {tenant!r} queue full "
                    f"({self.slo.max_queue_depth} deep) on {self._name}"))
                return fut
            _obs()["queue_depth"].set(len(self._queue),
                                      tags={"deployment": self._name})
            self._work.notify_all()
        return fut

    def stats(self) -> dict:
        with self._lock:
            return {**self._stats, "queued": len(self._queue),
                    "inflight": len(self._inflight),
                    "tenant_depths": self._queue.depths()}

    def close(self, timeout: float = 5.0):
        with self._lock:
            self._running = False
            self._work.notify_all()
        self._dispatcher.join(timeout)
        self._completer.join(timeout)

    # -- internals ------------------------------------------------------

    def _capacity(self) -> int:
        return max(1, len(self._handle._replicas)) * self._per_replica

    def _dispatch_loop(self):
        import ray_tpu_torch  # noqa: F401  (ensures worker context in thread)

        while True:
            with self._lock:
                while self._running and (
                        len(self._queue) == 0
                        or len(self._inflight) >= self._capacity()):
                    self._work.wait(timeout=0.2)
                    if not self._running:
                        break
                if not self._running and len(self._queue) == 0:
                    return
                req = self._queue.pop()
                _obs()["queue_depth"].set(len(self._queue),
                                          tags={"deployment": self._name})
            if req is None:
                continue
            now = time.monotonic()
            if req.deadline is not None and now > req.deadline:
                # doomed request: its latency budget elapsed in the queue;
                # shedding beats burning replica time on a dead answer
                with self._lock:
                    self._stats["shed"] += 1
                _obs()["shed"].inc(tags={"deployment": self._name,
                                         "reason": "deadline"})
                if not req.future.done():
                    req.future.set_exception(LoadShedError(
                        f"request queued {now - req.arrival_ts:.3f}s, over "
                        f"latency budget {self.slo.latency_budget_s}s"))
                continue
            try:
                h = self._handle if req.method == "__call__" \
                    else self._handle.options(method_name=req.method)
                if req.routing_key is not None:
                    ref = h.remote_with_key(req.routing_key, *req.args,
                                            **req.kwargs)
                else:
                    ref = h.remote(*req.args, **req.kwargs)
            except Exception as e:
                with self._lock:
                    self._stats["failed"] += 1
                if not req.future.done():
                    req.future.set_exception(e)
                continue
            with self._lock:
                self._stats["admitted"] += 1
                self._inflight[ref] = req
            _obs()["admitted"].inc(tags={"deployment": self._name})

    def _complete_loop(self):
        import ray_tpu_torch

        while True:
            with self._lock:
                if not self._running and not self._inflight \
                        and len(self._queue) == 0:
                    return
                refs = list(self._inflight.keys())
            if not refs:
                time.sleep(0.02)
                continue
            try:
                # one vectorized wait across every outstanding ref (rides
                # the core worker's batched result-future setup)
                ready, _ = ray_tpu_torch.wait(refs, num_returns=len(refs),
                                        timeout=0.1)
            except Exception:
                time.sleep(0.1)
                continue
            for ref in ready:
                with self._lock:
                    req = self._inflight.pop(ref, None)
                if req is None:
                    continue
                try:
                    value = ray_tpu_torch.get(ref, timeout=30)
                    with self._lock:
                        self._stats["completed"] += 1
                    if not req.future.done():
                        req.future.set_result(value)
                except Exception as e:
                    with self._lock:
                        self._stats["failed"] += 1
                    if not req.future.done():
                        req.future.set_exception(e)
                with self._lock:
                    self._work.notify_all()


def build_ingress(deployment_name: str, slo: Optional[dict] = None,
                  **kwargs) -> IngressHandle:
    """Convenience constructor taking a plain SLO dict (the HTTP-proxy /
    CLI-facing spelling)."""
    cfg = SLOConfig.from_dict(slo) if isinstance(slo, dict) else slo
    return IngressHandle(deployment_name, slo=cfg, **kwargs)
