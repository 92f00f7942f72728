"""Node memory monitor + worker-killing policy (OOM defense).

Reference: ``src/ray/common/memory_monitor.h:52`` — a periodic check of node
memory usage against a threshold — and
``src/ray/raylet/worker_killing_policy_group_by_owner.cc`` — when over the
threshold, workers are grouped by owning job and the NEWEST worker of the
LARGEST group is killed first (preserves older, likely-further-along work
and spreads pain across jobs fairly).

Two accounting modes:
- system (default): usage = 1 - MemAvailable/MemTotal from /proc/meminfo —
  what the reference does on a dedicated node;
- budget (``memory_monitor_capacity_bytes`` > 0): usage = sum of tracked
  worker RSS / capacity — deterministic on shared CI hosts where system
  memory is dominated by other tenants.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private.config import RAY_CONFIG

_PAGE = os.sysconf("SC_PAGE_SIZE")


def worker_rss(pid: int) -> int:
    """Resident set size of one process in bytes (0 if gone)."""
    try:
        with open(f"/proc/{pid}/statm") as f:
            return int(f.read().split()[1]) * _PAGE
    except (OSError, ValueError, IndexError):
        return 0


def system_usage() -> Tuple[int, int]:
    """(used, total) bytes from /proc/meminfo (available-based, like the
    reference's MemoryMonitor)."""
    total = avail = 0
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total = int(line.split()[1]) * 1024
                elif line.startswith("MemAvailable:"):
                    avail = int(line.split()[1]) * 1024
                if total and avail:
                    break
    except OSError:
        return 0, 0
    return max(0, total - avail), total


class MemoryMonitor:
    """Threshold check + group-by-owner victim selection."""

    def __init__(self, threshold: Optional[float] = None,
                 capacity_bytes: Optional[int] = None):
        self.threshold = (threshold if threshold is not None
                          else RAY_CONFIG.memory_usage_threshold)
        self.capacity = (capacity_bytes if capacity_bytes is not None
                         else RAY_CONFIG.memory_monitor_capacity_bytes)

    def usage(self, worker_pids: List[int]) -> Tuple[float, int, int]:
        """(fraction, used, cap) under the configured accounting mode."""
        if self.capacity > 0:
            used = sum(worker_rss(pid) for pid in worker_pids)
            return used / self.capacity, used, self.capacity
        used, total = system_usage()
        if total <= 0:
            return 0.0, 0, 0
        return used / total, used, total

    def over_threshold(self, worker_pids: List[int]) -> Tuple[bool, str]:
        frac, used, cap = self.usage(worker_pids)
        if frac <= self.threshold:
            return False, ""
        return True, (f"memory usage {frac:.0%} ({used >> 20} MiB of "
                      f"{cap >> 20} MiB) above threshold {self.threshold:.0%}")

    @staticmethod
    def pick_victim(workers: List[dict]) -> Optional[dict]:
        """Group-by-owner newest-first: workers are dicts with at least
        {"pid", "job", "started"}, where "started" is the LAST WORK
        ASSIGNMENT time (not process age — reused workers are old
        processes that may hold the newest work); returns the victim dict
        or None. (reference: worker_killing_policy_group_by_owner.cc ranks
        by task assignment recency)"""
        if not workers:
            return None
        groups: Dict[str, List[dict]] = {}
        for w in workers:
            groups.setdefault(w.get("job") or "?", []).append(w)
        # largest group first; tie-break on the group with the newest worker
        group = max(groups.values(),
                    key=lambda g: (len(g), max(w["started"] for w in g)))
        return max(group, key=lambda w: w["started"])  # newest in the group
