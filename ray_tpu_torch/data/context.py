"""DataContext: per-driver execution knobs, the port of
``ray_tpu/data/context.py`` (reference: python/ray/data/context.py
DataContext.get_current)."""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, Optional

_lock = threading.Lock()
_current: Optional["DataContext"] = None


@dataclass
class DataContext:
    # rows per block targeted by sources that can choose (range/from_items)
    target_block_rows: int = 4096
    # global cap on concurrently running data tasks (None -> cluster CPUs)
    max_tasks_in_flight: Optional[int] = None
    # per-operator cap on undispatched input + output bundles before
    # upstream dispatch is throttled (streaming backpressure)
    max_buffered_bundles: int = 16
    # default partition count for shuffles/joins/groupbys (None -> #blocks)
    default_shuffle_partitions: Optional[int] = None
    # bounded consumer prefetch for iter_batches/iter_rows
    prefetch_bundles: int = 4
    # default CPU request per data task
    num_cpus_per_task: float = 1.0
    # collect per-operator stats
    enable_stats: bool = True

    @staticmethod
    def get_current() -> "DataContext":
        global _current
        with _lock:
            if _current is None:
                _current = DataContext()
            return _current
