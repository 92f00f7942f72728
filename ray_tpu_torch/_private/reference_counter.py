"""Distributed reference counting for object ownership.

Reference: ``src/ray/core_worker/reference_counter.h:44`` — every object has
an owner (the worker that created it); the owner tracks local references,
in-flight submissions that depend on the object, and remote borrowers, and
frees the object cluster-wide when all reach zero. Lineage retention
(``task_manager.h:183``) pins task records while their outputs are
referenced so lost objects can be reconstructed by re-execution.

TPU-first deviations from the reference protocol:
- borrows are reported on the task reply (the executor lists foreign refs it
  still holds after the call) plus a debounced ``AddBorrower`` RPC for refs
  that arrive outside task args; a short grace period before the actual
  free absorbs in-flight registrations instead of the reference's full
  borrower-chain handshake;
- counts are process-wide per object id rather than per-handle.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Set, Tuple


class _Count:
    __slots__ = ("local", "pins", "borrowers", "lineage", "owner", "nested")

    def __init__(self, owner: str = ""):
        self.local = 0          # live ObjectRef instances in this process
        self.pins = 0           # in-flight handovers / stored-value nesting
        self.borrowers: Set[str] = set()  # remote holders (owner side)
        self.lineage = 0        # retained task records depending on this oid
        self.owner = owner      # owner address ("" = unknown yet)
        self.nested: List[Tuple[bytes, str]] = []  # inner refs we pin


class ReferenceCounter:
    """Process-wide object reference state.

    Thread-safe: ObjectRef __init__/__del__ fire on arbitrary threads; all
    free/borrow actions are deferred to the core worker's io loop through
    the ``on_zero`` / ``on_borrow_released`` callbacks.
    """

    def __init__(self, my_address: Callable[[], str]):
        import collections

        self._lock = threading.Lock()
        self._counts: Dict[bytes, _Count] = {}
        self._my_address = my_address
        # __del__-safe deletion queue: ObjectRef.__del__ may run via cyclic
        # GC on a thread that already holds self._lock (any allocation inside
        # a locked section can trigger GC) — taking the lock there would
        # self-deadlock. __del__ only appends here (deque.append is
        # GIL-atomic and reentrancy-safe); normal entry points drain it.
        self._pending_deletes: "collections.deque" = collections.deque()
        # zero-transition sink, installed by the core worker (borrow release
        # needs no sink: the OWNER observes it via its WaitBorrowsDone watch)
        self.on_owned_zero: Optional[Callable[[bytes], None]] = None
        # fired when a foreign-owned oid is first held here (0 -> 1)
        self.on_borrow_first: Optional[Callable[[bytes, str], None]] = None

    # -- ObjectRef lifecycle hooks (any thread) --

    def ref_created(self, oid: bytes, owner: str):
        self.flush_deletes()
        first_borrow = False
        with self._lock:
            c = self._counts.get(oid)
            if c is None:
                c = self._counts[oid] = _Count(owner)
            elif owner and not c.owner:
                c.owner = owner
            first_borrow = (c.local <= 0 and c.pins <= 0 and c.owner
                            and c.owner != self._my_address())
            c.local += 1
        if first_borrow and self.on_borrow_first is not None:
            self.on_borrow_first(oid, owner or "")

    def ref_deleted(self, oid: bytes):
        """Called from ObjectRef.__del__ — must NOT take the lock (see
        _pending_deletes). The decrement is applied at the next drain."""
        self._pending_deletes.append(oid)

    def flush_deletes(self):
        """Apply queued __del__ decrements. Called from normal (non-GC)
        entry points and the core worker's periodic sweep."""
        fires = []
        while True:
            try:
                oid = self._pending_deletes.popleft()
            except IndexError:
                break
            with self._lock:
                c = self._counts.get(oid)
                if c is None:
                    continue
                c.local -= 1
                if c.local <= 0 and c.pins <= 0:
                    kind = self._zero_kind(c)
                    if kind:
                        fires.append((kind, oid))
        for kind, oid in fires:
            self._fire(kind, oid)

    def _zero_kind(self, c: _Count):
        me = self._my_address()
        if not c.owner or c.owner == me:
            return "owned" if not c.borrowers else None
        return None  # borrow release: the owner's watch observes it

    def _fire(self, kind: Optional[str], oid: bytes):
        if kind == "owned" and self.on_owned_zero is not None:
            self.on_owned_zero(oid)

    # -- pins (handover / nesting; io loop or any thread) --

    def pin(self, oid: bytes, owner: str = ""):
        with self._lock:
            c = self._counts.get(oid)
            if c is None:
                c = self._counts[oid] = _Count(owner)
            elif owner and not c.owner:
                c.owner = owner
            c.pins += 1

    def unpin(self, oid: bytes):
        self.flush_deletes()
        fire = None
        with self._lock:
            c = self._counts.get(oid)
            if c is None:
                return
            c.pins -= 1
            if c.local <= 0 and c.pins <= 0:
                fire = self._zero_kind(c)
        self._fire(fire, oid)

    def pin_nested(self, outer: bytes, inner: List[Tuple[bytes, str]]):
        """Pin refs serialized inside a stored owned value until the outer
        object is freed (reference: nested refs in reference_counter.cc)."""
        if not inner:
            return
        with self._lock:
            c = self._counts.get(outer)
            if c is None:
                c = self._counts[outer] = _Count(self._my_address())
            c.nested.extend(inner)
        for oid, owner in inner:
            self.pin(oid, owner)

    def release_nested(self, outer: bytes) -> List[Tuple[bytes, str]]:
        with self._lock:
            c = self._counts.get(outer)
            if c is None or not c.nested:
                return []
            nested, c.nested = c.nested, []
        for oid, _ in nested:
            self.unpin(oid)
        return nested

    # -- borrowers (owner side, io loop) --

    def add_borrower(self, oid: bytes, address: str):
        with self._lock:
            c = self._counts.get(oid)
            if c is None:
                c = self._counts[oid] = _Count(self._my_address())
            c.borrowers.add(address)

    def remove_borrower(self, oid: bytes, address: str):
        self.flush_deletes()
        fire = None
        with self._lock:
            c = self._counts.get(oid)
            if c is None:
                return
            c.borrowers.discard(address)
            if c.local <= 0 and c.pins <= 0 and not c.borrowers:
                fire = self._zero_kind(c)
        self._fire(fire, oid)

    # -- lineage pinning --

    def lineage_add(self, oid: bytes):
        with self._lock:
            c = self._counts.get(oid)
            if c is None:
                c = self._counts[oid] = _Count()
            c.lineage += 1

    def lineage_remove(self, oid: bytes):
        with self._lock:
            c = self._counts.get(oid)
            if c is not None:
                c.lineage -= 1

    # -- queries --

    def local_count(self, oid: bytes) -> int:
        with self._lock:
            c = self._counts.get(oid)
            return 0 if c is None else c.local

    def held_count(self, oid: bytes) -> int:
        """Live handles + pins: what a borrow-done probe must see as zero
        (nested pins keep a borrow alive without any ObjectRef instance)."""
        with self._lock:
            c = self._counts.get(oid)
            return 0 if c is None else max(c.local, 0) + max(c.pins, 0)

    def borrowed_held(self) -> List[Tuple[bytes, str]]:
        """Foreign-owned oids this process still holds — the set a borrower
        periodically re-asserts with its owners (heals wrong reclaims)."""
        me = self._my_address()
        with self._lock:
            return [(oid, c.owner) for oid, c in self._counts.items()
                    if c.owner and c.owner != me
                    and (c.local > 0 or c.pins > 0)]

    def lineage_count(self, oid: bytes) -> int:
        with self._lock:
            c = self._counts.get(oid)
            return 0 if c is None else c.lineage

    def owner_of(self, oid: bytes) -> str:
        with self._lock:
            c = self._counts.get(oid)
            return "" if c is None else c.owner

    def freeable(self, oid: bytes) -> bool:
        """Owner-side re-check at actual free time (after the grace delay)."""
        self.flush_deletes()
        with self._lock:
            c = self._counts.get(oid)
            if c is None:
                return True
            return c.local <= 0 and c.pins <= 0 and not c.borrowers

    def drop(self, oid: bytes):
        with self._lock:
            self._counts.pop(oid, None)

    def stats(self) -> dict:
        with self._lock:
            return {
                "tracked": len(self._counts),
                "borrowed": sum(1 for c in self._counts.values()
                                if c.owner and c.owner != self._my_address()),
            }
