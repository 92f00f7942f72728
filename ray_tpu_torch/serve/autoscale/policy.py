"""Demand-driven autoscaling policy, the port of
``ray_tpu/serve/autoscale/policy.py`` (reference: serve/autoscaling_state.py
+ autoscaling_policy.py, rebuilt on window RATES instead of point gauges).

The decision function prices demand by Little's law: the concurrency a
deployment must absorb is ``arrival_rate x mean_execute_seconds``. Divided
by the per-replica concurrency target that yields a fractional replica
demand; the policy then applies

* **hysteresis** — a replica is only released when demand clears a band
  BELOW the next-lower capacity step, so demand hovering at a boundary
  never flaps the replica count;
* **sustained-condition delays** — up/down pressure must hold for
  ``upscale_delay_s`` / ``downscale_delay_s`` before acting (the
  reference's delay smoothing);
* **cooldown** — after any scale action the policy holds for
  ``scale_cooldown_s`` regardless of pressure, bounding actuation rate
  while replicas start/drain;
* **SLO pressure** — when the deployment registered a queue-wait or
  time-to-first-token target and the windowed p99 exceeds it, the policy
  treats that as up-pressure even if the rate math says capacity is
  sufficient (the rate view can under-price demand while a backlog is
  already queued or streams are slow to first byte).

Scale-up jumps straight to the demanded replica count (bursts need
capacity NOW); scale-down steps one replica at a time so each release
re-prices demand against the smaller set before the next.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

from ray_tpu_torch.serve.autoscale.window import DeploymentMetricsWindow


@dataclass
class Decision:
    """One autoscale verdict: the replica target to reconcile toward and
    the structured reason that rides the task-plane scale event."""

    want: int
    reason: str
    direction: str  # "up" | "down" | "hold"
    metrics: dict = field(default_factory=dict)


@dataclass
class PolicyState:
    """Per-deployment smoothing state (lives in the controller's app
    record; the policy itself stays stateless/testable)."""

    up_since: Optional[float] = None
    down_since: Optional[float] = None
    last_scale_ts: float = 0.0


def replica_demand(window: DeploymentMetricsWindow,
                   target_ongoing: float,
                   now: Optional[float] = None) -> tuple:
    """Fractional replicas demanded by the window rates. Returns
    ``(demand, detail)`` where detail carries the inputs for the reason
    string / scale event."""
    arrival = window.arrival_rate(now)
    exec_mean = window.execute_mean_s(now)
    avg_ongoing = window.avg_ongoing(now)
    # Little's law concurrency; falls back to the windowed ongoing rollup
    # while no request has completed inside the window yet (cold start /
    # first burst) — both are window aggregates, never point samples
    littles = arrival * exec_mean if exec_mean is not None else 0.0
    concurrency = max(littles, avg_ongoing)
    demand = concurrency / max(target_ongoing, 1e-9)
    return demand, {
        "arrival_rate": round(arrival, 4),
        "execute_mean_s": None if exec_mean is None else round(exec_mean, 6),
        "avg_ongoing": round(avg_ongoing, 4),
        "concurrency_demand": round(concurrency, 4),
        "replica_demand": round(demand, 4),
    }


def decide(window: DeploymentMetricsWindow, *, current_target: int,
           config, state: PolicyState, now: float,
           queue_target_s: Optional[float] = None,
           ttft_target_s: Optional[float] = None) -> Decision:
    """One policy evaluation. ``config`` is the deployment's
    AutoscalingConfig (min/max bounds, target_ongoing_requests, delays,
    hysteresis, cooldown); ``queue_target_s`` / ``ttft_target_s`` the
    registered queue-wait and time-to-first-token SLOs, if any."""
    demand, detail = replica_demand(window, config.target_ongoing_requests,
                                    now)
    detail["current_target"] = current_target
    queue_p99 = window.queue_p99_s(now)
    detail["queue_p99_s"] = None if queue_p99 is None else round(queue_p99, 6)
    ttft_p99 = window.ttft_p99_s(now)
    detail["ttft_p99_s"] = None if ttft_p99 is None else round(ttft_p99, 6)

    queue_pressure = (queue_target_s is not None and queue_p99 is not None
                      and queue_p99 > queue_target_s)
    ttft_pressure = (ttft_target_s is not None and ttft_p99 is not None
                     and ttft_p99 > ttft_target_s)
    slo_pressure = queue_pressure or ttft_pressure
    up_pressure = demand > current_target + 1e-9 or slo_pressure
    # hysteresis band: only shed a replica when demand fits the SMALLER
    # set with headroom to spare
    down_ok = demand < (current_target - 1) * (1.0 - config.hysteresis) \
        + 1e-9
    down_pressure = (not up_pressure and current_target > config.min_replicas
                     and down_ok)

    in_cooldown = now - state.last_scale_ts < config.scale_cooldown_s

    if up_pressure and current_target < config.max_replicas:
        state.down_since = None
        if state.up_since is None:
            state.up_since = now
        if not in_cooldown and now - state.up_since >= config.upscale_delay_s:
            want = min(config.max_replicas,
                       max(current_target + 1, math.ceil(demand)))
            state.up_since = None
            state.last_scale_ts = now
            if slo_pressure and demand <= current_target:
                why = ("queue p99 %.3fs over SLO %.3fs"
                       % (queue_p99, queue_target_s) if queue_pressure
                       else "ttft p99 %.3fs over SLO %.3fs"
                       % (ttft_p99, ttft_target_s))
            else:
                why = "demand %.2f replicas > target %d" % (demand,
                                                            current_target)
            return Decision(want, why, "up", detail)
        return Decision(current_target, "up-pressure pending delay/cooldown",
                        "hold", detail)
    if down_pressure:
        state.up_since = None
        if state.down_since is None:
            state.down_since = now
        if not in_cooldown and now - state.down_since >= \
                config.downscale_delay_s:
            want = max(config.min_replicas, current_target - 1)
            state.down_since = None
            state.last_scale_ts = now
            return Decision(
                want, "demand %.2f replicas under hysteresis band of %d"
                % (demand, current_target), "down", detail)
        return Decision(current_target,
                        "down-pressure pending delay/cooldown", "hold",
                        detail)
    state.up_since = None
    state.down_since = None
    return Decision(current_target, "demand within band", "hold", detail)
