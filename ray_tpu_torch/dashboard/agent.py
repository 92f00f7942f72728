"""Per-node agent: process/node stats + worker profiling.

Reference: python/ray/dashboard/agent.py:23 + modules/reporter/ — the
reference runs one agent process per node that samples every worker's
cpu/rss via psutil, reports to the dashboard, and serves profiling requests
(py-spy stack sampling, memray allocation tracking). Here the agent is a
component hosted by the raylet (one fewer process per node, same surface):
``collect()`` backs the extended ``GetNodeStats`` RPC, and the profiling
half lives in every worker as RPC handlers (``ProfileStacks`` /
``ProfileMemory``) backed by :func:`sample_stacks` — a cooperative
stack-sampling profiler (sys._current_frames) and tracemalloc, the
pure-Python equivalents of py-spy / memray that need no ptrace.

The port of ``ray_tpu/dashboard/agent.py``: the same fields, read from
``/proc`` instead of psutil (the card's machine has no psutil). CPU shares
are psutil's: the first sample of a process reads 0.0, later ones the
share since the previous sample.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private.memory_monitor import system_usage, worker_rss

_CLK_TCK = os.sysconf("SC_CLK_TCK")


def _boot_time() -> float:
    with open("/proc/stat") as f:
        for line in f:
            if line.startswith("btime "):
                return float(line.split()[1])
    return 0.0


def _cpu_times() -> Tuple[float, float]:
    """(busy, total) jiffies of the whole node, from ``/proc/stat``."""
    with open("/proc/stat") as f:
        fields = [float(x) for x in f.readline().split()[1:]]
    # user nice system idle iowait irq softirq steal (guest is in user)
    total = sum(fields[:8])
    idle = fields[3] + (fields[4] if len(fields) > 4 else 0.0)
    return total - idle, total


def _proc_stat(pid: int) -> dict:
    """One process's cpu seconds, threads and start time (``/proc/<pid>/stat``;
    raises OSError once it has exited)."""
    with open(f"/proc/{pid}/stat") as f:
        rest = f.read().rsplit(")", 1)[1].split()
    return {"cpu_s": (int(rest[11]) + int(rest[12])) / _CLK_TCK,
            "num_threads": int(rest[17]),
            "start_ticks": int(rest[19])}


class NodeAgent:
    """Collects node + per-worker process stats (reference:
    dashboard/modules/reporter/reporter_agent.py)."""

    def __init__(self):
        self._boot = time.time()
        self._btime = _boot_time()
        self._procs: Dict[int, Tuple[float, float]] = {}  # pid -> (cpu_s, t)
        self._node_cpu = _cpu_times()

    def _cpu_percent(self, pid: int, cpu_s: float) -> float:
        now = time.monotonic()
        last = self._procs.get(pid)
        self._procs[pid] = (cpu_s, now)
        if last is None or now <= last[1]:
            return 0.0  # psutil's first call: no interval yet
        return round(100.0 * (cpu_s - last[0]) / (now - last[1]), 1)

    def _node_cpu_percent(self) -> float:
        busy, total = _cpu_times()
        last_busy, last_total = self._node_cpu
        self._node_cpu = (busy, total)
        if total <= last_total:
            return 0.0
        return round(100.0 * (busy - last_busy) / (total - last_total), 1)

    def collect(self, worker_pids: List[int]) -> dict:
        used, total = system_usage()
        try:
            load1, load5, load15 = os.getloadavg()
        except OSError:
            load1 = load5 = load15 = 0.0
        disk = os.statvfs("/")
        disk_total = disk.f_blocks * disk.f_frsize
        disk_used = (disk.f_blocks - disk.f_bfree) * disk.f_frsize
        workers = []
        seen = set()
        for pid in worker_pids:
            seen.add(pid)
            try:
                st = _proc_stat(pid)
                workers.append({
                    "pid": pid,
                    "cpu_percent": self._cpu_percent(pid, st["cpu_s"]),
                    "rss_mb": round(worker_rss(pid) / 2**20, 1),
                    "num_fds": len(os.listdir(f"/proc/{pid}/fd")),
                    "num_threads": st["num_threads"],
                    "create_time": self._btime + st["start_ticks"] / _CLK_TCK,
                })
            except (OSError, ValueError, IndexError):
                continue  # worker exited between listing and sampling
        for pid in list(self._procs):
            if pid not in seen:
                del self._procs[pid]
        return {
            "uptime_s": round(time.time() - self._boot, 1),
            "cpu_percent": self._node_cpu_percent(),
            "mem_total_mb": round(total / 2**20, 1),
            "mem_available_mb": round((total - used) / 2**20, 1),
            "mem_percent": round(100.0 * used / total, 1) if total else 0.0,
            "load_avg": [load1, load5, load15],
            "disk_percent": round(100.0 * disk_used / disk_total, 1)
            if disk_total else 0.0,
            "workers": workers,
        }


def sample_stacks(duration_s: float = 2.0, interval_ms: float = 10.0,
                  target_thread_ids: Optional[List[int]] = None) -> dict:
    """In-process stack-sampling profiler (the py-spy role, cooperatively).

    A sampler thread snapshots ``sys._current_frames()`` every
    ``interval_ms`` for ``duration_s`` and aggregates frames into folded
    stacks ("a;b;c count" — the flamegraph input format py-spy emits with
    --format raw). The sampler excludes itself.
    """
    import sys

    folded: Dict[str, int] = {}
    samples = 0
    stop = time.monotonic() + max(0.05, duration_s)
    me = threading.get_ident()
    interval = max(0.001, interval_ms / 1000.0)
    while time.monotonic() < stop:
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue
            if target_thread_ids and tid not in target_thread_ids:
                continue
            stack = []
            f = frame
            depth = 0
            while f is not None and depth < 64:
                code = f.f_code
                stack.append(f"{os.path.basename(code.co_filename)}:"
                             f"{code.co_name}:{f.f_lineno}")
                f = f.f_back
                depth += 1
            key = ";".join(reversed(stack))
            folded[key] = folded.get(key, 0) + 1
        samples += 1
        time.sleep(interval)
    top = sorted(folded.items(), key=lambda kv: -kv[1])
    return {
        "samples": samples,
        "duration_s": duration_s,
        "folded": dict(top[:500]),
        "top": [{"stack": k.rsplit(";", 3)[-1], "count": v}
                for k, v in top[:25]],
    }


class MemoryProfiler:
    """tracemalloc wrapper (the memray role, allocation tracking)."""

    def __init__(self):
        self._running = False

    def start(self, frames: int = 16):
        import tracemalloc

        if not self._running:
            tracemalloc.start(frames)
            self._running = True
        return {"status": "started"}

    def snapshot(self, top: int = 25) -> dict:
        import tracemalloc

        if not self._running:
            return {"status": "not_running", "top": []}
        snap = tracemalloc.take_snapshot()
        stats = snap.statistics("traceback")
        out = []
        for st in stats[:top]:
            out.append({
                "size_kb": round(st.size / 1024, 1),
                "count": st.count,
                "traceback": [str(fr) for fr in st.traceback.format()[-6:]],
            })
        current, peak = tracemalloc.get_traced_memory()
        return {"status": "ok", "current_kb": round(current / 1024, 1),
                "peak_kb": round(peak / 1024, 1), "top": out}

    def stop(self):
        import tracemalloc

        if self._running:
            tracemalloc.stop()
            self._running = False
        return {"status": "stopped"}
