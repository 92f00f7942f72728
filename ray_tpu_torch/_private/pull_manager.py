"""Prioritized pull admission (reference: object_manager/pull_manager.cc).

The reference classes pulls by urgency — a blocked ``ray.get`` outranks task
argument fetches, which outrank background/wait prefetches — and cancels
pulls nobody needs anymore. This is the asyncio equivalent: a fixed number
of transfer slots, admission by (priority class, FIFO) order, priority
upgrades when a hotter requester arrives, and cancellation of queued pulls
whose waiters have all gone away.

Priorities: 0 = get (a caller is blocked on the value NOW),
1 = task-arg (a leased task is waiting to start), 2 = background
(broadcast prefetch / wait warm-up).
"""

from __future__ import annotations

import asyncio
import itertools
import time
from typing import Dict, Optional

PRIO_GET = 0
PRIO_ARG = 1
PRIO_BACKGROUND = 2


class PullQueue:
    def __init__(self, slots: int, stale_ttl_s: float = 30.0):
        self._slots = max(1, slots)
        self._in_flight = 0
        self._stale_ttl = stale_ttl_s
        self._seq = itertools.count()
        # oid -> entry; entry: prio, seq, queued_at, waiters, event, state
        self._entries: Dict[bytes, dict] = {}

    # -- waiter interest (drives obsolete-pull cancellation) ----------

    def add_waiter(self, oid: bytes):
        e = self._entries.get(oid)
        if e is not None:
            e["waiters"] += 1

    def remove_waiter(self, oid: bytes):
        e = self._entries.get(oid)
        if e is not None and e["waiters"] > 0:
            e["waiters"] -= 1

    # -- admission -----------------------------------------------------

    def request(self, oid: bytes, prio: int) -> None:
        """Register (or upgrade) a pull's priority before admit()."""
        e = self._entries.get(oid)
        if e is None:
            # waiters starts at 0: interest is asserted only by
            # add_waiter() (the StoreGet path), so a pull whose every
            # getter left really does hit the <= 0 stale sweep
            self._entries[oid] = {
                "prio": prio, "seq": next(self._seq),
                "queued_at": time.monotonic(), "waiters": 0,
                "event": asyncio.Event(), "state": "queued"}
        elif prio < e["prio"]:
            e["prio"] = prio  # upgrade keeps the original FIFO seq
            self._kick()

    async def admit(self, oid: bytes) -> bool:
        """Wait for a transfer slot. Returns False if the pull was
        cancelled as obsolete while queued. Only pulls parked HERE compete
        for slots — a pull still polling the directory for locations must
        not hold up admissible transfers behind it."""
        e = self._entries.get(oid)
        if e is None:
            self.request(oid, PRIO_BACKGROUND)
            e = self._entries[oid]
        if e["state"] == "queued":
            e["state"] = "ready"
        while True:
            if e["state"] == "cancelled":
                self._entries.pop(oid, None)
                return False
            if e["state"] == "ready" and self._in_flight < self._slots \
                    and self._next_oid() == oid:
                e["state"] = "transferring"
                self._in_flight += 1
                return True
            e["event"].clear()
            try:
                await asyncio.wait_for(e["event"].wait(), 0.5)
            except asyncio.TimeoutError:
                self._sweep_stale()

    def release(self, oid: bytes):
        e = self._entries.pop(oid, None)
        if e is not None and e["state"] == "transferring":
            # raylint: disable=RCE001 release() is only called from the raylet's async pull path (same loop as admit); the cross-object call edge is beyond the resolver, so its context defaults to the caller thread
            self._in_flight -= 1
        self._kick()

    def cancel(self, oid: bytes):
        e = self._entries.get(oid)
        if e is not None and e["state"] in ("queued", "ready"):
            e["state"] = "cancelled"
            e["event"].set()

    # -- internals -----------------------------------------------------

    def _next_oid(self) -> Optional[bytes]:
        best = None
        for oid, e in self._entries.items():
            if e["state"] != "ready":
                continue
            key = (e["prio"], e["seq"])
            if best is None or key < best[0]:
                best = (key, oid)
        return best[1] if best else None

    def _kick(self):
        for e in self._entries.values():
            if e["state"] in ("queued", "ready"):
                e["event"].set()

    def _sweep_stale(self):
        """Cancel queued pulls whose waiters all left (reference:
        pull_manager.cc deactivating pulls no request needs)."""
        now = time.monotonic()
        for oid, e in list(self._entries.items()):
            if e["state"] in ("queued", "ready") and e["waiters"] <= 0 \
                    and now - e["queued_at"] > self._stale_ttl:
                self.cancel(oid)

    def stats(self) -> dict:
        by_prio: Dict[int, int] = {}
        for e in self._entries.values():
            if e["state"] in ("queued", "ready"):
                by_prio[e["prio"]] = by_prio.get(e["prio"], 0) + 1
        return {"in_flight": self._in_flight, "queued_by_prio": by_prio,
                "total_tracked": len(self._entries)}
