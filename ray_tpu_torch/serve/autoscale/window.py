"""Per-deployment sliding-window rate history for the serve autoscaler: the
port of ``ray_tpu/serve/autoscale/window.py``, pure Python.

A cluster-wide metrics history keeps series — it aggregates every process and tag set into one
curve, which is the right view for dashboards but loses the per-deployment
axis the autoscaler must scale on. This module keeps the same
rates-over-a-window idea controller-side: every control tick the
controller polls each replica's cumulative request counters
(``_Replica.take_stats``) and appends ONE cluster-summed sample per
deployment; the window then answers rate questions (request arrival rate,
queue-time p99, execute-time rollups) instead of exposing instantaneous
gauges.

Why rates and not the ``take_ongoing_peak()`` gauge: a peak gauge
tells you the burst happened but not how big the demand actually is — 100
requests that arrive and fully drain between two polls read as "peak 3"
if they never overlapped more than 3-deep, yet the *arrival counter*
advanced by 100 and the window prices that as demand. The cumulative
counters make the window burst-proof by construction (the reference's
autoscaling_state.py draws the same conclusion: scale on aggregated
request metrics over a look-back window, not on point samples).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional

# one replica's cumulative counter snapshot (take_stats() payload); the
# window consumes the cluster-wide sum so dead replicas just drop out
STAT_KEYS = ("arrived", "completed", "execute_sum", "execute_count")


def percentile(sorted_vals: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile of an ascending list (None when empty)."""
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[idx]


class DeploymentMetricsWindow:
    """Bounded ring of per-tick cluster-summed replica stats for ONE
    deployment, answering windowed rates.

    Counter deltas are clamped at zero: the cluster value is a sum over
    the CURRENT replica set, so a replica death (or replacement during a
    rolling update) steps the cumulative total down — that step is a
    membership change, not negative traffic (same clamp the GCS rollup
    tier applies to counter rates)."""

    def __init__(self, window_s: float = 30.0, max_points: int = 256,
                 max_queue_samples: int = 512):
        self.window_s = float(window_s)
        self._points: deque = deque(maxlen=max_points)
        # drained per-request queue-wait samples ride separately from the
        # tick ring so p99 comes from real observations, not tick means
        self._queue_samples: deque = deque(maxlen=max_queue_samples)
        # server-side time-to-first-token observations (replica-stamped:
        # handle dispatch -> first response chunk), same drain shape
        self._ttft_samples: deque = deque(maxlen=max_queue_samples)

    # -- ingestion ------------------------------------------------------

    def observe(self, replica_stats: List[dict],
                now: Optional[float] = None) -> dict:
        """Append one sample: the sum of every responding replica's
        cumulative counters plus the instantaneous ongoing/peak levels
        (kept for rollup averaging, never consumed as point gauges).
        Timestamps are ``time.monotonic()`` — pass a consistent clock."""
        now = time.monotonic() if now is None else now
        sample = {"ts": now, "n_replicas": len(replica_stats),
                  "ongoing": 0, "peak": 0}
        for key in STAT_KEYS:
            sample[key] = 0
        for st in replica_stats:
            for key in STAT_KEYS:
                sample[key] += st.get(key, 0) or 0
            sample["ongoing"] += st.get("ongoing", 0) or 0
            sample["peak"] += st.get("peak", 0) or 0
            for q in st.get("queue_samples") or ():
                self._queue_samples.append((now, float(q)))
            for t in st.get("ttft_samples") or ():
                self._ttft_samples.append((now, float(t)))
        self._points.append(sample)
        return sample

    # -- reads ----------------------------------------------------------

    def _window(self, now: Optional[float] = None) -> List[dict]:
        now = time.monotonic() if now is None else now
        lo = now - self.window_s
        return [p for p in self._points if p["ts"] >= lo]

    def _rate(self, key: str, now: Optional[float] = None) -> float:
        pts = self._window(now)
        if len(pts) < 2:
            return 0.0
        span = max(pts[-1]["ts"] - pts[0]["ts"], 1e-9)
        return max(0.0, pts[-1][key] - pts[0][key]) / span

    def arrival_rate(self, now: Optional[float] = None) -> float:
        """Requests/s entering replicas over the window (cumulative
        arrival counter delta — sees bursts that drain between ticks)."""
        return self._rate("arrived", now)

    def completion_rate(self, now: Optional[float] = None) -> float:
        return self._rate("completed", now)

    def execute_mean_s(self, now: Optional[float] = None) -> Optional[float]:
        """Mean user-callable execution seconds over the window (None
        until a request completes inside it)."""
        pts = self._window(now)
        if len(pts) < 2:
            return None
        dn = pts[-1]["execute_count"] - pts[0]["execute_count"]
        ds = pts[-1]["execute_sum"] - pts[0]["execute_sum"]
        if dn <= 0 or ds < 0:
            return None
        return ds / dn

    def queue_p99_s(self, now: Optional[float] = None) -> Optional[float]:
        now = time.monotonic() if now is None else now
        lo = now - self.window_s
        vals = sorted(v for ts, v in self._queue_samples if ts >= lo)
        return percentile(vals, 0.99)

    def ttft_p99_s(self, now: Optional[float] = None) -> Optional[float]:
        """Windowed p99 of replica-stamped time-to-first-token (None
        until a first token lands inside the window)."""
        now = time.monotonic() if now is None else now
        lo = now - self.window_s
        vals = sorted(v for ts, v in self._ttft_samples if ts >= lo)
        return percentile(vals, 0.99)

    def avg_ongoing(self, now: Optional[float] = None) -> float:
        """Mean concurrent-request level across window ticks — a rollup
        of the level series, not a point sample."""
        pts = self._window(now)
        if not pts:
            return 0.0
        return sum(p["ongoing"] for p in pts) / len(pts)

    def peak_ongoing(self, now: Optional[float] = None) -> int:
        pts = self._window(now)
        return max((p["peak"] for p in pts), default=0)

    def rollup(self, now: Optional[float] = None) -> Dict[str, object]:
        """One dict with every windowed rate the policy consumes (also the
        payload published to the GCS KV ``serve`` namespace)."""
        now = time.monotonic() if now is None else now
        return {
            "window_s": self.window_s,
            "arrival_rate": self.arrival_rate(now),
            "completion_rate": self.completion_rate(now),
            "execute_mean_s": self.execute_mean_s(now),
            "queue_p99_s": self.queue_p99_s(now),
            "ttft_p99_s": self.ttft_p99_s(now),
            "avg_ongoing": self.avg_ongoing(now),
            "peak_ongoing": self.peak_ongoing(now),
            "samples": len(self._points),
        }
