"""ObjectRef: a future for a value in the distributed object store.

Reference: ObjectRef in python/ray/includes/object_ref.pxi — an id plus owner
metadata; values are resolved with ``ray_tpu.get``.
"""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch._private.ids import ObjectID

# process-wide reference counter hook, installed by the connected CoreWorker
# (reference: reference_counter.cc tracks every handle's lifetime)
_ref_counter = None


def set_ref_counter(rc) -> None:
    global _ref_counter
    _ref_counter = rc


class ObjectRef:
    __slots__ = ("_id", "_owner_address", "__weakref__")

    def __init__(self, object_id: ObjectID, owner_address: str = ""):
        self._id = object_id
        self._owner_address = owner_address
        rc = _ref_counter
        if rc is not None:
            rc.ref_created(object_id.binary(), owner_address)

    def __del__(self):
        rc = _ref_counter
        if rc is not None:
            try:
                rc.ref_deleted(self._id.binary())
            except Exception:
                pass  # interpreter teardown

    @property
    def id(self) -> ObjectID:
        return self._id

    def binary(self) -> bytes:
        return self._id.binary()

    def hex(self) -> str:
        return self._id.hex()

    def owner_address(self) -> str:
        return self._owner_address

    def task_id(self):
        return self._id.task_id()

    def future(self):
        """concurrent.futures.Future resolving to the value."""
        from ray_tpu_torch._private import worker as _worker

        return _worker.global_worker().as_future(self)

    def __reduce__(self):
        lst = getattr(_serialized_refs, "refs", None)
        if lst is not None:
            lst.append((self._id.binary(), self._owner_address))
        return (_rebuild_ref, (self._id.binary(), self._owner_address))

    def __hash__(self):
        return hash(self._id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __repr__(self):
        return f"ObjectRef({self._id.hex()})"

    def __await__(self):
        from ray_tpu_torch._private import worker as _worker

        return _worker.global_worker().await_ref(self).__await__()


def _rebuild_ref(id_bytes: bytes, owner_address: str) -> ObjectRef:
    lst = getattr(_deserialized_refs, "refs", None)
    if lst is not None:
        lst.append((id_bytes, owner_address))
    return ObjectRef(ObjectID(id_bytes), owner_address)


# thread-local collector: while active, every ObjectRef serialized on this
# thread is recorded so the caller can pin/track contained (nested) refs
import contextlib as _contextlib
import threading as _threading

_serialized_refs = _threading.local()


@_contextlib.contextmanager
def collect_serialized_refs():
    prev = getattr(_serialized_refs, "refs", None)
    out: list = []
    _serialized_refs.refs = out
    try:
        yield out
    finally:
        _serialized_refs.refs = prev


_deserialized_refs = _threading.local()


@_contextlib.contextmanager
def collect_deserialized_refs():
    """Record every ObjectRef rebuilt from a pickle on this thread — used by
    executors to learn which foreign refs a task received (borrow tracking)."""
    prev = getattr(_deserialized_refs, "refs", None)
    out: list = []
    _deserialized_refs.refs = out
    try:
        yield out
    finally:
        _deserialized_refs.refs = prev


class ObjectRefGenerator:
    """Iterator over a streaming task's dynamically-created return refs
    (reference: ray.ObjectRefGenerator for num_returns="streaming",
    generator_waiter.cc). Each __next__ blocks until the executor has
    streamed the next yield to the owner, then hands back its ObjectRef;
    exhausts with StopIteration when the generator completes."""

    def __init__(self, core, task_id, owner_address: str):
        self._core = core
        self._task_id = task_id
        self._owner_address = owner_address
        self._index = 0

    def __iter__(self):
        return self

    def __next__(self):
        ref = self._core.stream_next(self._task_id, self._index)
        self._index += 1
        return ref

    def __repr__(self):
        return (f"ObjectRefGenerator(task={self._task_id.hex()[:12]}, "
                f"next_index={self._index})")

    def __del__(self):
        # release arrival pins for items never consumed (lock-based, safe
        # from GC on any thread)
        try:
            self._core.stream_release(self._task_id)
        except Exception:
            pass
