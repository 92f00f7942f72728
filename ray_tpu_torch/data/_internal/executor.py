"""The streaming executor, the port of ``ray_tpu/data/_internal/executor.py``.

Reference: python/ray/data/_internal/execution/streaming_executor.py (:66,
loop :338, step :445) and streaming_executor_state.select_operator_to_run
(:744): a driver thread pumps RefBundles through the operator topology —
dispatching tasks under a global in-flight cap and per-operator buffer
caps (backpressure), moving finished outputs downstream, and feeding a
bounded consumer queue so iteration backpressures the whole pipeline."""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.data._internal.operators import (
    AllToAllOperator,
    LimitOperator,
    PhysicalOperator,
    RefBundle,
    ZipOperator,
)
from ray_tpu_torch.data.context import DataContext
from ray_tpu_torch.object_ref import ObjectRef

_SENTINEL = object()


class Edge:
    __slots__ = ("src", "dst", "port")

    def __init__(self, src: PhysicalOperator, dst: PhysicalOperator,
                 port: str = "in"):
        self.src = src
        self.dst = dst
        self.port = port


class StreamingExecutor:
    def __init__(self, ops: List[PhysicalOperator], edges: List[Edge],
                 output_op: PhysicalOperator,
                 context: Optional[DataContext] = None):
        self.ops = ops
        self.edges = edges
        self.output_op = output_op
        self.ctx = context or DataContext.get_current()
        self._out_queue: "queue.Queue" = queue.Queue(
            maxsize=max(1, self.ctx.prefetch_bundles))
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._stopped = threading.Event()
        self._done_notified: Dict[Tuple[int, str], bool] = {}
        # downstream-first dispatch order (constructed upstream->downstream)
        self._dispatch_order = list(reversed(ops))
        self._upstream: Dict[int, List[PhysicalOperator]] = {}
        for e in edges:
            self._upstream.setdefault(id(e.dst), []).append(e.src)

    # -- public --------------------------------------------------------

    def start(self):
        for op in self.ops:
            op.start()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="data-streaming-executor")
        self._thread.start()
        return self

    def stop(self):
        self._stopped.set()
        if self._thread:
            self._thread.join(timeout=30.0)

    def iter_output(self):
        """Yields RefBundles of the output operator as they materialize."""
        while True:
            item = self._out_queue.get()
            if item is _SENTINEL:
                if self._error is not None:
                    raise self._error
                return
            yield item

    def stats_summary(self) -> str:
        return "\n".join(op.stats.summary() for op in self.ops)

    def stats_data(self) -> list:
        """Structured per-op runtime metrics (reference:
        data/_internal/stats.py + op_runtime_metrics.py)."""
        import time as _t

        out = []
        for op in self.ops:
            st = op.stats
            wall = (st.end_ts or _t.time()) - (st.start_ts or _t.time())
            out.append({"op": st.name, "tasks": st.tasks,
                        "rows_out": st.rows_out, "bytes_out": st.bytes_out,
                        "task_wall_s": round(st.task_wall_s, 4),
                        "wall_s": round(wall, 4)})
        return out

    # -- loop ----------------------------------------------------------

    def _global_cap(self) -> int:
        if self.ctx.max_tasks_in_flight:
            return self.ctx.max_tasks_in_flight
        try:
            cpus = ray_tpu_torch.cluster_resources().get("CPU", 4.0)
        except Exception:
            cpus = 4.0
        return max(2, int(cpus * 1.5))

    def _run(self):
        try:
            self._pump()
        except BaseException as e:  # surface to the consumer
            self._error = e
        finally:
            for op in self.ops:
                try:
                    op.shutdown()
                except Exception:
                    pass
            # never block forever on a full queue: an abandoning consumer
            # (schema()/take() closing the stream early) sets _stopped and
            # will not read again
            while True:
                try:
                    self._out_queue.put_nowait(_SENTINEL)
                    break
                except queue.Full:
                    if self._stopped.is_set():
                        break
                    time.sleep(0.01)

    def _upstream_of(self, op) -> List[PhysicalOperator]:
        return self._upstream.get(id(op), [])

    def _halted_ops(self) -> set:
        """Ops transitively upstream of a satisfied Limit: their output can
        never be needed again, so stop dispatching them (early stop)."""
        halted: set = set()
        frontier = [op for op in self.ops
                    if isinstance(op, LimitOperator) and op.satisfied]
        while frontier:
            dst = frontier.pop()
            for e in self.edges:
                if e.dst is dst and id(e.src) not in halted:
                    halted.add(id(e.src))
                    frontier.append(e.src)
        return halted

    def _pump(self):
        cap = self._global_cap()
        max_buf = self.ctx.max_buffered_bundles
        waitmap: Dict[ObjectRef, PhysicalOperator] = {}

        while not self._stopped.is_set():
            progressed = False

            # 1. propagate outputs downstream / to the consumer queue
            for e in self.edges:
                dst_busy = len(e.dst.inqueue) if hasattr(e.dst, "inqueue") else 0
                while e.src.outqueue and dst_busy < max_buf:
                    bundle = e.src.outqueue.popleft()
                    if e.port == "left":
                        e.dst.add_left(bundle)
                    elif e.port == "right":
                        e.dst.add_right(bundle)
                    else:
                        e.dst.add_input(bundle)
                    dst_busy += 1
                    progressed = True
            while self.output_op.outqueue:
                try:
                    self._out_queue.put_nowait(self.output_op.outqueue[0])
                    self.output_op.outqueue.popleft()
                    progressed = True
                except queue.Full:
                    break

            # 2. propagate inputs-done markers once a src fully drains
            halted = self._halted_ops()
            for e in self.edges:
                key = (id(e.src), id(e.dst), e.port)
                if self._done_notified.get(key):
                    continue
                if id(e.src) in halted or (
                        e.src.inputs_done and not e.src.work_remaining()
                        and not e.src.outqueue):
                    self._done_notified[key] = True
                    if isinstance(e.dst, ZipOperator):
                        if e.port == "left":
                            e.dst.left_done = True
                        else:
                            e.dst.right_done = True
                        if e.dst.left_done and e.dst.right_done:
                            e.dst.notify_inputs_done()
                    else:
                        self._count_done(e.dst)
                    progressed = True

            # 3. dispatch, downstream-first, under caps
            inflight = sum(op.num_active for op in self.ops)
            for op in self._dispatch_order:
                if id(op) in halted:
                    continue
                while (inflight < cap and op.can_dispatch()
                       and len(op.outqueue) < max_buf):
                    refs = op.dispatch_one()
                    for r in refs:
                        waitmap[r] = op
                    inflight += 1
                    progressed = True
                # barrier prepare-tasks need polling even with no dispatch
                if isinstance(op, AllToAllOperator):
                    for r in op.wait_refs():
                        if r not in waitmap:
                            waitmap[r] = op

            # 4. termination
            if self.output_op.is_finished() and not self.output_op.outqueue:
                self._check_drained()
                return
            # an output op that can't make progress anymore (e.g. satisfied
            # limit with drained queues)
            if (isinstance(self.output_op, LimitOperator)
                    and self.output_op.satisfied
                    and not self.output_op.work_remaining()
                    and not self.output_op.outqueue):
                return

            # 5. wait for some task to finish
            if waitmap:
                ready, _ = ray_tpu_torch.wait(list(waitmap.keys()), num_returns=1,
                                        timeout=0.2 if progressed else 1.0)
                for ref in ready:
                    op = waitmap.pop(ref)
                    op.on_task_done(ref)
                    progressed = True
            elif not progressed:
                time.sleep(0.005)

    def _check_drained(self):
        """Invariant at clean termination: nothing buffered anywhere. A
        violation means bundles would be silently dropped — fail loudly."""
        halted = self._halted_ops()
        for op in self.ops:
            if id(op) in halted or op is self.output_op:
                continue
            leftovers = []
            if getattr(op, "_seq_buf", None):
                leftovers.append(f"seq_buf={list(op._seq_buf)}")
            if getattr(op, "_ordered_buf", None):
                leftovers.append(f"ordered_buf={list(op._ordered_buf)}")
            if op._active:
                leftovers.append(f"active={len(op._active)}")
            if op.outqueue:
                leftovers.append(f"outqueue={len(op.outqueue)}")
            if op.work_remaining():
                leftovers.append("work_remaining")
            if leftovers:
                raise RuntimeError(
                    f"streaming executor terminated with undrained operator "
                    f"{op.name}: {', '.join(leftovers)} — this is a bug; "
                    f"bundles would have been dropped")

    def _count_done(self, dst: PhysicalOperator):
        """Mark dst inputs-done once EVERY upstream edge has finished."""
        for e in self.edges:
            if e.dst is dst and not self._done_notified.get(
                    (id(e.src), id(e.dst), e.port)):
                return
        dst.notify_inputs_done()
