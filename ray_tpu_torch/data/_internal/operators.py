"""Physical operators for the streaming executor, the port of
``ray_tpu/data/_internal/operators.py``.

Reference: python/ray/data/_internal/execution/operators/ —
TaskPoolMapOperator / ActorPoolMapOperator (map_operator.py),
AllToAllOperator (all_to_all_operator.py) backing shuffle/sort/groupby,
hash-shuffle two-phase fan (hash_shuffle.py), LimitOperator, ZipOperator,
UnionOperator, and the RefBundle currency (interfaces/ref_bundle.py).

Data moves as ``RefBundle``s: object refs to blocks plus their (already
resolved) row/byte counts. Operators never fetch block contents — only the
small meta dicts travel to the driver. UDFs, key functions and specs
travel as blobs of the port's by-value pickler
(``_private/serialization.py:dumps``)."""

from __future__ import annotations

import collections
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch._private.serialization import dumps
from ray_tpu_torch.data._internal import tasks as T
from ray_tpu_torch.object_ref import ObjectRef


class RefBundle:
    __slots__ = ("block", "rows", "bytes")

    def __init__(self, block: ObjectRef, rows: Optional[int] = None,
                 nbytes: int = 0):
        self.block = block
        self.rows = rows
        self.bytes = nbytes

    def __repr__(self):
        return f"RefBundle(rows={self.rows})"


class OpStats:
    __slots__ = ("name", "tasks", "rows_out", "bytes_out", "task_wall_s",
                 "start_ts", "end_ts")

    def __init__(self, name: str):
        self.name = name
        self.tasks = 0
        self.rows_out = 0
        self.bytes_out = 0
        self.task_wall_s = 0.0
        self.start_ts: Optional[float] = None
        self.end_ts: Optional[float] = None

    def record(self, meta: dict):
        self.tasks += 1
        self.rows_out += meta.get("rows", 0)
        self.bytes_out += meta.get("bytes", 0)
        self.task_wall_s += meta.get("wall_s", 0.0)
        self.end_ts = time.time()

    def summary(self) -> str:
        wall = (self.end_ts or time.time()) - (self.start_ts or time.time())
        return (f"{self.name}: {self.tasks} tasks, {self.rows_out} rows, "
                f"{self.bytes_out / 1e6:.2f} MB, task-time {self.task_wall_s:.2f}s, "
                f"wall {wall:.2f}s")


class PhysicalOperator:
    """Base: push-based input, pull-based output, task-parallel inside."""

    def __init__(self, name: str, num_cpus: float = 1.0,
                 concurrency: Optional[int] = None):
        self.name = name
        self.num_cpus = num_cpus
        self.concurrency = concurrency  # per-op task cap (None -> global only)
        self.inqueue: collections.deque = collections.deque()
        self.outqueue: collections.deque = collections.deque()
        self.inputs_done = False
        self._active: Dict[ObjectRef, Any] = {}  # wait-ref -> task record
        self.stats = OpStats(name)
        # datasets are ordered: tasks may finish out of order, so emissions
        # are sequenced (reference: bundle ordering in the map operators)
        self._seq_dispatch = 0
        self._seq_emit = 0
        self._seq_buf: Dict[int, RefBundle] = {}

    # -- lifecycle -----------------------------------------------------

    def start(self):
        self.stats.start_ts = time.time()

    def shutdown(self):
        pass

    # -- scheduling ----------------------------------------------------

    def add_input(self, bundle: RefBundle):
        self.inqueue.append(bundle)

    def notify_inputs_done(self):
        self.inputs_done = True

    def can_dispatch(self) -> bool:
        if self.concurrency is not None and len(self._active) >= self.concurrency:
            return False
        return self._has_dispatchable()

    def _has_dispatchable(self) -> bool:
        return bool(self.inqueue)

    def dispatch_one(self) -> List[ObjectRef]:
        """Submit one task; returns refs the executor should wait on."""
        raise NotImplementedError

    def on_task_done(self, ref: ObjectRef):
        raise NotImplementedError

    @property
    def num_active(self) -> int:
        return len(self._active)

    def _take_seq(self) -> int:
        s = self._seq_dispatch
        self._seq_dispatch += 1
        return s

    def _emit(self, seq: int, bundle: RefBundle):
        self._seq_buf[seq] = bundle
        while self._seq_emit in self._seq_buf:
            self.outqueue.append(self._seq_buf.pop(self._seq_emit))
            self._seq_emit += 1

    def is_finished(self) -> bool:
        return (self.inputs_done and not self.inqueue and not self._active
                and not self._seq_buf and not self.outqueue)

    def work_remaining(self) -> bool:
        return bool(self.inqueue or self._active or self._seq_buf)


class ReadOperator(PhysicalOperator):
    """Source: one read task per thunk (reference: InputDataBuffer + the
    read tasks planned by planner/plan_read_op.py)."""

    def __init__(self, thunks: List[bytes], num_cpus: float = 1.0,
                 concurrency: Optional[int] = None):
        super().__init__("Read", num_cpus, concurrency)
        self._thunks = collections.deque(thunks)
        self.inputs_done = True

    def _has_dispatchable(self) -> bool:
        return bool(self._thunks)

    def dispatch_one(self) -> List[ObjectRef]:
        thunk = self._thunks.popleft()
        block_ref, meta_ref = T.read_block.options(
            num_returns=2, num_cpus=self.num_cpus).remote(thunk)
        self._active[meta_ref] = (block_ref, self._take_seq())
        return [meta_ref]

    def on_task_done(self, meta_ref: ObjectRef):
        block_ref, seq = self._active.pop(meta_ref)
        meta = ray_tpu_torch.get(meta_ref)
        self.stats.record(meta)
        self._emit(seq, RefBundle(block_ref, meta["rows"], meta["bytes"]))

    def is_finished(self) -> bool:
        return (not self._thunks and not self._active
                and not self._seq_buf and not self.outqueue)

    def work_remaining(self) -> bool:
        return bool(self._thunks or self._active or self._seq_buf)


class InputDataOperator(PhysicalOperator):
    """Source over already-materialized block refs."""

    def __init__(self, bundles: List[RefBundle]):
        super().__init__("InputData")
        self.outqueue.extend(bundles)
        self.inputs_done = True

    def _has_dispatchable(self) -> bool:
        return False

    def dispatch_one(self):  # pragma: no cover
        raise AssertionError

    def is_finished(self) -> bool:
        return not self.outqueue

    def work_remaining(self) -> bool:
        return False


class TaskPoolMapOperator(PhysicalOperator):
    """Fused map chain executed as one stateless task per block."""

    def __init__(self, name: str, chain: List[tuple], num_cpus: float = 1.0,
                 concurrency: Optional[int] = None):
        super().__init__(name, num_cpus, concurrency)
        self._chain_blob = dumps(chain)

    def dispatch_one(self) -> List[ObjectRef]:
        bundle: RefBundle = self.inqueue.popleft()
        block_ref, meta_ref = T.map_block.options(
            num_returns=2, num_cpus=self.num_cpus).remote(
                self._chain_blob, bundle.block)
        self._active[meta_ref] = (block_ref, self._take_seq())
        return [meta_ref]

    def on_task_done(self, meta_ref: ObjectRef):
        block_ref, seq = self._active.pop(meta_ref)
        meta = ray_tpu_torch.get(meta_ref)
        self.stats.record(meta)
        self._emit(seq, RefBundle(block_ref, meta["rows"], meta["bytes"]))


class ActorPoolMapOperator(PhysicalOperator):
    """Map chain with stateful class-UDFs on a pool of actors
    (reference: ActorPoolMapOperator + _ActorPool autoscaling)."""

    def __init__(self, name: str, chain: List[tuple],
                 ctors: Dict[str, tuple], pool_size: int = 2,
                 num_cpus: float = 1.0):
        super().__init__(name, num_cpus, concurrency=None)
        self._chain_blob = dumps(chain)
        self._ctors_blob = dumps(ctors)
        self._pool_size = pool_size
        self._actors: List[Any] = []
        self._idle: collections.deque = collections.deque()

    def start(self):
        super().start()
        for _ in range(self._pool_size):
            actor = T.MapWorker.options(num_cpus=self.num_cpus).remote(
                self._ctors_blob)
            self._actors.append(actor)
            # each actor can run a small pipeline of calls
            self._idle.extend([actor, actor])

    def shutdown(self):
        for a in self._actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass
        self._actors.clear()

    def can_dispatch(self) -> bool:
        return bool(self.inqueue) and bool(self._idle)

    def dispatch_one(self) -> List[ObjectRef]:
        bundle: RefBundle = self.inqueue.popleft()
        actor = self._idle.popleft()
        block_ref, meta_ref = actor.map_block.options(num_returns=2).remote(
            self._chain_blob, bundle.block)
        self._active[meta_ref] = (block_ref, actor, self._take_seq())
        return [meta_ref]

    def on_task_done(self, meta_ref: ObjectRef):
        block_ref, actor, seq = self._active.pop(meta_ref)
        self._idle.append(actor)
        meta = ray_tpu_torch.get(meta_ref)
        self.stats.record(meta)
        self._emit(seq, RefBundle(block_ref, meta["rows"], meta["bytes"]))


class AllToAllOperator(PhysicalOperator):
    """Barrier operator running a two-phase hash/range shuffle.

    Phase 1 (map): partition every input block into N parts.
    Phase 2 (reduce): per partition, concat its parts from all maps and
    apply the reduce fn. ``prepare`` optionally computes shared state (e.g.
    sampled sort boundaries) from the materialized inputs first."""

    def __init__(self, name: str, num_partitions: Optional[int],
                 part_fn_factory: Callable[[Any], Callable],
                 reduce_fn_factory: Callable[[Any], Callable],
                 prepare: Optional[Callable] = None,
                 num_cpus: float = 1.0):
        super().__init__(name, num_cpus)
        self._num_partitions = num_partitions
        self._part_fn_factory = part_fn_factory
        self._reduce_fn_factory = reduce_fn_factory
        self._prepare = prepare
        self._input_bundles: List[RefBundle] = []
        self._phase = "collect"  # collect -> prepare -> map -> reduce
        self._prepare_ref: Optional[ObjectRef] = None
        self._prepared_state: Any = None
        self._map_pending: collections.deque = collections.deque()
        self._map_outputs: List[ObjectRef] = []
        self._maps_in_flight: Dict[ObjectRef, int] = {}
        self._reduce_pending: collections.deque = collections.deque()
        # ordered emission (sort): buffer finished partitions and release
        # them in partition order so the global order is preserved
        self.ordered = False
        self.reverse_order = False
        self._ordered_buf: Dict[int, RefBundle] = {}
        self._next_emit = 0

    def add_input(self, bundle: RefBundle):
        self._input_bundles.append(bundle)

    def _n_parts(self) -> int:
        if self._num_partitions:
            return self._num_partitions
        return max(1, len(self._input_bundles))

    def _advance_phase(self):
        if self._phase == "collect" and self.inputs_done:
            if self._prepare is not None:
                self._phase = "prepare"
                self._prepare_ref = self._prepare(
                    self._input_bundles, self._n_parts())
            else:
                self._start_map(None)

    def _start_map(self, state):
        self._prepared_state = state
        part_fn = self._part_fn_factory(state)
        self._part_blob = dumps(part_fn)
        self._phase = "map"
        self._map_pending.extend(self._input_bundles)
        if not self._map_pending:
            # zero inputs: go straight to reduce (it emits empty blocks)
            self._on_all_maps_done()
            self._phase = "reduce"
            order = range(self._n_parts())
            self._reduce_pending.extend(
                reversed(order) if self.reverse_order else order)
            if self.reverse_order:
                self._next_emit = self._n_parts() - 1

    def _has_dispatchable(self) -> bool:
        self._advance_phase()
        if self._phase == "prepare":
            return False  # waiting on the prepare task
        return bool(self._map_pending or self._reduce_pending)

    def can_dispatch(self) -> bool:
        self._advance_phase()
        if self._phase == "prepare":
            return False
        return self._has_dispatchable()

    def wait_refs(self) -> List[ObjectRef]:
        """Extra refs (prepare task) the executor must poll."""
        return [self._prepare_ref] if (
            self._phase == "prepare" and self._prepare_ref is not None) else []

    def _on_map_done(self, map_ref: ObjectRef, bundle: RefBundle):
        self._map_outputs.append(map_ref)

    def _on_all_maps_done(self):
        pass

    def dispatch_one(self) -> List[ObjectRef]:
        if self._map_pending:
            bundle: RefBundle = self._map_pending.popleft()
            ref = T.shuffle_map.options(num_cpus=self.num_cpus).remote(
                bundle.block, self._part_blob, self._n_parts())
            self._maps_in_flight[ref] = 1
            self._active[ref] = ("map", ref, bundle)
            return [ref]
        part_index = self._reduce_pending.popleft()
        reduce_fn = self._reduce_fn_factory(self._prepared_state)
        block_ref, meta_ref = T.shuffle_reduce.options(
            num_returns=2, num_cpus=self.num_cpus).remote(
                dumps(reduce_fn), part_index, *self._map_outputs)
        self._active[meta_ref] = ("reduce", block_ref, part_index)
        return [meta_ref]

    def on_task_done(self, ref: ObjectRef):
        if self._phase == "prepare" and ref is self._prepare_ref:
            state = ray_tpu_torch.get(ref)
            self._prepare_ref = None
            self._start_map(state)
            return
        record = self._active.pop(ref)
        if record[0] == "map":
            self._maps_in_flight.pop(ref, None)
            self._on_map_done(record[1], record[2])
            if not self._map_pending and not self._maps_in_flight:
                self._on_all_maps_done()
                self._phase = "reduce"
                order = range(self._n_parts())
                self._reduce_pending.extend(
                    reversed(order) if self.reverse_order else order)
                if self.reverse_order:
                    self._next_emit = self._n_parts() - 1
        else:
            _, block_ref, part_index = record
            meta = ray_tpu_torch.get(ref)
            self.stats.record(meta)
            bundle = RefBundle(block_ref, meta["rows"], meta["bytes"])
            if not self.ordered:
                self.outqueue.append(bundle)
                return
            self._ordered_buf[part_index] = bundle
            step = -1 if self.reverse_order else 1
            while self._next_emit in self._ordered_buf:
                self.outqueue.append(self._ordered_buf.pop(self._next_emit))
                self._next_emit += step

    def is_finished(self) -> bool:
        return (self.inputs_done and self._phase == "reduce"
                and not self._reduce_pending and not self._active
                and not self._ordered_buf and not self.outqueue)

    def work_remaining(self) -> bool:
        if not self.inputs_done:
            return True
        return (self._phase in ("collect", "prepare", "map")
                or bool(self._reduce_pending or self._active
                        or self._ordered_buf))


class LimitOperator(PhysicalOperator):
    """Truncates the stream after n rows; downstream of it the executor
    stops feeding once satisfied (early-stop backpressure)."""

    def __init__(self, n: int):
        super().__init__(f"Limit[{n}]")
        self._remaining = n
        self._slicing: Dict[ObjectRef, ObjectRef] = {}

    @property
    def satisfied(self) -> bool:
        return self._remaining <= 0

    def _has_dispatchable(self) -> bool:
        return bool(self.inqueue) and not self.satisfied

    def dispatch_one(self) -> List[ObjectRef]:
        bundle: RefBundle = self.inqueue.popleft()
        if bundle.rows is not None and bundle.rows <= self._remaining:
            self._remaining -= bundle.rows
            self.outqueue.append(bundle)
            return []
        take = self._remaining
        self._remaining = 0
        block_ref, meta_ref = T.slice_block.options(num_returns=2).remote(
            bundle.block, 0, take)
        self._active[meta_ref] = block_ref
        return [meta_ref]

    def on_task_done(self, meta_ref: ObjectRef):
        # the slice is always the final emission; direct append keeps order
        block_ref = self._active.pop(meta_ref)
        meta = ray_tpu_torch.get(meta_ref)
        self.stats.record(meta)
        self.outqueue.append(RefBundle(block_ref, meta["rows"], meta["bytes"]))

    def is_finished(self) -> bool:
        return ((self.satisfied or (self.inputs_done and not self.inqueue))
                and not self._active and not self.outqueue)

    def work_remaining(self) -> bool:
        if self.satisfied:
            # leftover queued inputs are abandoned, not work
            return bool(self._active)
        return bool(self.inqueue or self._active)


class UnionOperator(PhysicalOperator):
    """Streams bundles from all upstreams through unchanged."""

    def __init__(self):
        super().__init__("Union")

    def add_input(self, bundle: RefBundle):
        self.outqueue.append(bundle)

    def _has_dispatchable(self) -> bool:
        return False

    def dispatch_one(self):  # pragma: no cover
        raise AssertionError

    def is_finished(self) -> bool:
        return self.inputs_done and not self.outqueue

    def work_remaining(self) -> bool:
        return False


class ZipOperator(PhysicalOperator):
    """Row-aligned zip of two upstreams. A barrier: left and right block
    structures may differ (different parallelism, filters...), so alignment
    is planned from row counts once both sides are complete — the i-th left
    block is zipped against the right ROW RANGE it covers (reference:
    ZipOperator aligns on rows, not blocks)."""

    def __init__(self):
        super().__init__("Zip")
        self._left: List[RefBundle] = []
        self._right: List[RefBundle] = []
        self.left_done = False
        self.right_done = False
        self._planned = False
        self._pending: collections.deque = collections.deque()

    def add_left(self, bundle: RefBundle):
        self._left.append(bundle)

    def add_right(self, bundle: RefBundle):
        self._right.append(bundle)

    def _plan(self):
        if self._planned or not self.inputs_done:
            return
        self._planned = True
        n_left = sum(b.rows or 0 for b in self._left)
        n_right = sum(b.rows or 0 for b in self._right)
        if n_left != n_right:
            raise ValueError(
                f"zip requires equal row counts; left has {n_left}, "
                f"right has {n_right}")
        # for each left block [lo, hi): the right blocks + offsets covering it
        right_bounds = []
        pos = 0
        for b in self._right:
            right_bounds.append((pos, pos + (b.rows or 0), b))
            pos += b.rows or 0
        lo = 0
        for lb in self._left:
            hi = lo + (lb.rows or 0)
            picks = []  # (bundle, skip, take)
            for rlo, rhi, rb in right_bounds:
                s, e = max(lo, rlo), min(hi, rhi)
                if s < e:
                    picks.append((rb.block, s - rlo, e - s))
            self._pending.append((lb, picks))
            lo = hi

    def _has_dispatchable(self) -> bool:
        self._plan()
        return bool(self._pending)

    def can_dispatch(self) -> bool:
        return self._has_dispatchable()

    def dispatch_one(self) -> List[ObjectRef]:
        lb, picks = self._pending.popleft()
        spans = [(skip, take) for _, skip, take in picks]
        right_blocks = [ref for ref, _, _ in picks]
        block_ref, meta_ref = T.zip_aligned.options(num_returns=2).remote(
            lb.block, dumps(spans), *right_blocks)
        self._active[meta_ref] = (block_ref, self._take_seq())
        return [meta_ref]

    def on_task_done(self, meta_ref: ObjectRef):
        block_ref, seq = self._active.pop(meta_ref)
        meta = ray_tpu_torch.get(meta_ref)
        self.stats.record(meta)
        self._emit(seq, RefBundle(block_ref, meta["rows"], meta["bytes"]))

    def is_finished(self) -> bool:
        return (self.inputs_done and self._planned and not self._pending
                and not self._active and not self._seq_buf
                and not self.outqueue)

    def work_remaining(self) -> bool:
        if not self.inputs_done:
            return True
        return bool(not self._planned or self._pending or self._active
                    or self._seq_buf)


class WriteOperator(PhysicalOperator):
    """One write task per block; emits {'path': ...} rows."""

    def __init__(self, write_fn: Callable, num_cpus: float = 1.0):
        super().__init__("Write", num_cpus)
        self._write_blob = dumps(write_fn)
        self._index = 0

    def dispatch_one(self) -> List[ObjectRef]:
        bundle: RefBundle = self.inqueue.popleft()
        idx = self._index
        self._index += 1
        block_ref, meta_ref = T.write_block.options(
            num_returns=2, num_cpus=self.num_cpus).remote(
                bundle.block, self._write_blob, idx)
        self._active[meta_ref] = (block_ref, self._take_seq())
        return [meta_ref]

    def on_task_done(self, meta_ref: ObjectRef):
        block_ref, seq = self._active.pop(meta_ref)
        meta = ray_tpu_torch.get(meta_ref)
        self.stats.record(meta)
        self._emit(seq, RefBundle(block_ref, meta["rows"], meta["bytes"]))
