"""Application metrics: the port of ``ray_tpu/util/metrics.py``.

``Counter``, ``Gauge`` and ``Histogram`` record in the process, in a
registry keyed by metric name, and ``scrape_metrics`` reads every one of
them in the JAX module's snapshot format (a value per tag set, a
histogram's counts per bucket with their sums and boundaries). The names,
boundaries and formats are the JAX package's, so one dashboard reads both.

Not ported yet: ``publish_metrics``, which ships the registry to the
runtime's GCS and waits for the runtime's port (``ROADMAP.md`` queue 1).
"""

from __future__ import annotations

import json
import threading
from typing import Dict, List, Optional, Tuple

_registry: Dict[str, "_Metric"] = {}
_lock = threading.Lock()


class _Metric:
    kind = "metric"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Tuple[str, ...] = ()):
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._default_tags: Dict[str, str] = {}
        with _lock:
            _registry[name] = self

    def set_default_tags(self, tags: Dict[str, str]):
        self._default_tags = dict(tags)
        return self

    def _key(self, tags: Optional[Dict[str, str]]) -> str:
        merged = dict(self._default_tags)
        if tags:
            merged.update(tags)
        return json.dumps(merged, sort_keys=True)


class Counter(_Metric):
    kind = "counter"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._values: Dict[str, float] = {}

    def inc(self, value: float = 1.0, tags: Optional[Dict[str, str]] = None):
        k = self._key(tags)
        with _lock:
            self._values[k] = self._values.get(k, 0.0) + value

    def snapshot(self):
        return dict(self._values)


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._values: Dict[str, float] = {}

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        with _lock:
            self._values[self._key(tags)] = float(value)

    def snapshot(self):
        return dict(self._values)


class Histogram(_Metric):
    """Counts of observations per bucket: bucket i holds the values at most
    ``boundaries[i]`` and above the boundary before it; the last bucket
    holds the values above every boundary."""

    kind = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Optional[List[float]] = None,
                 tag_keys: Tuple[str, ...] = ()):
        super().__init__(name, description, tag_keys)
        self.boundaries = boundaries or [0.01, 0.1, 1, 10, 100]
        self._counts: Dict[str, List[int]] = {}
        self._sums: Dict[str, float] = {}

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None):
        k = self._key(tags)
        with _lock:
            counts = self._counts.setdefault(
                k, [0] * (len(self.boundaries) + 1))
            for i, b in enumerate(self.boundaries):
                if value <= b:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            self._sums[k] = self._sums.get(k, 0.0) + value

    def snapshot(self):
        return {"counts": {k: list(v) for k, v in self._counts.items()},
                "sums": dict(self._sums),
                "boundaries": list(self.boundaries)}


def scrape_metrics() -> Dict[str, dict]:
    """Every metric registered in this process: name -> kind, description
    and snapshot."""
    with _lock:
        return {
            name: {"kind": m.kind, "description": m.description,
                   "data": m.snapshot()}
            for name, m in _registry.items()
        }
