"""Prefix-cache-aware routing as a first-class router policy: the port of
``ray_tpu/serve/autoscale/router.py``.

Reference: serve routing_policies/prefix_aware/prefix_aware_router.py —
route requests that share a prompt prefix to the same replica so their KV
prefixes stay warm on one engine. Promoted here from the ``LLMHandle``
one-off (which hashed ``md5(key) % n_replicas``: ANY replica-set change
remapped essentially every key, cold-starting every KV cache at once)
into a shared policy with

* a **consistent-hash ring** (virtual nodes per replica), so a replica
  joining or leaving moves only ~1/N of the key space while every other
  prefix keeps hitting its warm replica;
* **cache-hit accounting** on the shared metrics registry
  (``ray_tpu.serve.prefix_cache_hits`` / ``_misses``): a routing
  decision is a "hit" when the key lands on the same replica as its
  previous request (bounded LRU of recent keys), which is exactly the
  warm-KV expectation the policy exists to maximize.

``DeploymentHandle.remote_with_key`` routes through this policy; plain
``options(routing_policy="prefix")`` handles derive the key from the
request body's prompt/messages prefix automatically.
"""

from __future__ import annotations

import bisect
import hashlib
import threading
from collections import OrderedDict
from typing import Any, List, Optional, Sequence

_obs_lock = threading.Lock()
_obs_metrics: Optional[dict] = None


def _obs() -> dict:
    global _obs_metrics
    with _obs_lock:
        if _obs_metrics is None:
            from ray_tpu_torch.util.metrics import Counter

            _obs_metrics = {
                "hits": Counter(
                    "ray_tpu.serve.prefix_cache_hits",
                    "prefix-routed requests that landed on the same "
                    "replica as the previous request for that key"),
                "misses": Counter(
                    "ray_tpu.serve.prefix_cache_misses",
                    "prefix-routed requests that moved to a different "
                    "replica (first sight of the key, or ring churn)"),
            }
        return _obs_metrics


def _hash64(data: str) -> int:
    return int.from_bytes(
        hashlib.blake2b(data.encode(), digest_size=8).digest(), "little")


def _replica_id(replica: Any) -> str:
    """Stable identity for a replica across handle refreshes (the actor
    id survives topology re-fetches; id() of the handle object does not)."""
    actor_id = getattr(replica, "_actor_id", None)
    if actor_id is not None:
        return actor_id.hex() if hasattr(actor_id, "hex") else str(actor_id)
    return repr(replica)


class ConsistentHashRing:
    """Classic consistent hashing with virtual nodes: each replica owns
    ``vnodes`` points on a 64-bit ring; a key maps to the first point
    clockwise. Adding/removing one replica remaps only the key ranges
    adjacent to its points (~1/N of the space)."""

    def __init__(self, replicas: Sequence[Any], vnodes: int = 64):
        self.vnodes = vnodes
        self._points: List[int] = []
        self._owners: List[Any] = []
        for replica in replicas:
            rid = _replica_id(replica)
            for v in range(vnodes):
                point = _hash64(f"{rid}:{v}")
                idx = bisect.bisect(self._points, point)
                self._points.insert(idx, point)
                self._owners.insert(idx, replica)

    def __len__(self) -> int:
        return len(self._points)

    def lookup(self, key: str) -> Any:
        if not self._points:
            raise ValueError("empty hash ring")
        idx = bisect.bisect(self._points, _hash64(key)) % len(self._points)
        return self._owners[idx]


class PrefixRouter:
    """Key -> replica policy for one deployment: consistent-hash lookup
    plus hit/miss accounting against the key's previous assignment."""

    def __init__(self, deployment_name: str, prefix_len: int = 64,
                 vnodes: int = 64, history: int = 4096):
        self._name = deployment_name
        self.prefix_len = prefix_len
        self._vnodes = vnodes
        self._ring: Optional[ConsistentHashRing] = None
        self._ring_version: Optional[int] = None
        # bounded LRU: key -> replica id of its last routing decision
        self._last: OrderedDict = OrderedDict()
        self._history = history
        self._lock = threading.Lock()

    def key_of(self, body: Any) -> Optional[str]:
        """Derive the routing key from a request body: the prompt (or
        flattened messages) prefix. None -> caller should fall back to
        its default policy."""
        if isinstance(body, dict):
            prompt = body.get("prompt") or str(body.get("messages", ""))
        elif isinstance(body, str):
            prompt = body
        else:
            return None
        return prompt[: self.prefix_len] if prompt else None

    def pick(self, key: str, replicas: Sequence[Any],
             version: Optional[int] = None) -> Any:
        """Route ``key`` over the CURRENT replica set. The ring rebuilds
        only when the topology version moves; hit/miss counters compare
        against the key's previous assignment."""
        with self._lock:
            if self._ring is None or self._ring_version != version \
                    or len(self._ring) != len(replicas) * self._vnodes:
                self._ring = ConsistentHashRing(replicas,
                                                vnodes=self._vnodes)
                self._ring_version = version
            replica = self._ring.lookup(key)
            rid = _replica_id(replica)
            prev = self._last.pop(key, None)
            self._last[key] = rid
            if len(self._last) > self._history:
                self._last.popitem(last=False)
        obs = _obs()
        if prev is None or prev != rid:
            obs["misses"].inc(tags={"deployment": self._name})
        else:
            obs["hits"].inc(tags={"deployment": self._name})
        return replica
