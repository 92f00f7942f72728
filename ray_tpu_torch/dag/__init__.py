"""DAG authoring + compiled execution (reference: python/ray/dag), the
port of ``ray_tpu/dag/__init__.py``.

``fn.bind(...)`` / ``Actor.bind(...)`` / ``handle.method.bind(...)`` build a
lazy graph (dag_node.py, class_node.py, input_node.py); ``execute`` walks it
eagerly over the actor-call plane; ``experimental_compile``
(dag_node.py:279) returns a ``CompiledDAG``: every actor of the graph gets
ONE static schedule (``dag/executor.py``), run on a thread of its own, and
every cross-actor edge, the input and the outputs become shared-memory
channels (``dag/channels.py``: seqlock slot rings with per-reader acks and
tensor-aware framing; an edge whose parties sit on different nodes rides
the cross-host mailbox). After compile, an ``execute`` is one channel write
and a ``get`` one channel read: the driver and the control plane are out of
the per-iteration loop.

``with_tensor_transport("object")`` keeps the channel plane;
``"ici"`` (a same-actor hand-off inside the actor's device mesh,
``ray_tpu/dag/device_channel.py``) is not ported.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.object_ref import ObjectRef


class DAGNode:
    def __init__(self, args: tuple, kwargs: dict):
        self._bound_args = args
        self._bound_kwargs = kwargs

    def with_tensor_transport(self, transport: str = "ici", *,
                              shift: int = 1) -> "DAGNode":
        """Annotate this node's OUTGOING edges (reference:
        DAGNode.with_tensor_transport / with_type_hint). ``"object"`` keeps
        them on the channel plane. ``"ici"`` (a same-actor hand-off shifted
        across the actor's device mesh) is not ported and raises."""
        if transport not in ("ici", "object"):
            raise ValueError(f"unknown tensor transport {transport!r}")
        if transport == "ici":
            from ray_tpu_torch._private.common import not_ported

            raise not_ported("device channels")
        return self

    def _deps(self) -> List["DAGNode"]:
        out = []
        for v in list(self._bound_args) + list(self._bound_kwargs.values()):
            if isinstance(v, DAGNode):
                out.append(v)
        return out

    def execute(self, *input_args, **input_kwargs):
        """Eagerly execute the graph rooted here; returns an ObjectRef."""
        cache: Dict[int, Any] = {}
        return self._execute_node(input_args, input_kwargs, cache)

    def _resolve(self, v, input_args, input_kwargs, cache):
        if isinstance(v, DAGNode):
            return v._execute_node(input_args, input_kwargs, cache)
        return v

    def _resolved_args(self, input_args, input_kwargs, cache):
        args = [self._resolve(a, input_args, input_kwargs, cache)
                for a in self._bound_args]
        kwargs = {k: self._resolve(v, input_args, input_kwargs, cache)
                  for k, v in self._bound_kwargs.items()}
        return args, kwargs

    def _execute_node(self, input_args, input_kwargs, cache):
        raise NotImplementedError

    def experimental_compile(self) -> "CompiledDAG":
        return CompiledDAG(self)


class InputNode(DAGNode):
    """Placeholder for the value passed to execute() (reference:
    dag/input_node.py). Supports `with InputNode() as inp:` authoring."""

    def __init__(self, index: int = 0):
        super().__init__((), {})
        self._index = index

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def _execute_node(self, input_args, input_kwargs, cache):
        return input_args[self._index]


class FunctionNode(DAGNode):
    def __init__(self, remote_fn, args, kwargs):
        super().__init__(args, kwargs)
        self._remote_fn = remote_fn

    def _execute_node(self, input_args, input_kwargs, cache):
        key = id(self)
        if key not in cache:
            args, kwargs = self._resolved_args(input_args, input_kwargs, cache)
            cache[key] = self._remote_fn.remote(*args, **kwargs)
        return cache[key]


class ClassNode(DAGNode):
    """Actor construction in a DAG; instantiated once per compiled graph."""

    def __init__(self, actor_cls, args, kwargs):
        super().__init__(args, kwargs)
        self._actor_cls = actor_cls
        self._actor_handle = None

    def _get_actor(self, input_args, input_kwargs, cache):
        if self._actor_handle is None:
            args, kwargs = self._resolved_args(input_args, input_kwargs, cache)
            args = [ray_tpu_torch.get(a) if isinstance(a, ObjectRef) else a for a in args]
            self._actor_handle = self._actor_cls.remote(*args, **kwargs)
        return self._actor_handle

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return _ClassMethodBinder(self, name)

    def _execute_node(self, input_args, input_kwargs, cache):
        return self._get_actor(input_args, input_kwargs, cache)


class _ClassMethodBinder:
    def __init__(self, class_node: ClassNode, method_name: str):
        self._class_node = class_node
        self._method_name = method_name

    def bind(self, *args, **kwargs) -> "ClassMethodNode":
        return ClassMethodNode(self._class_node, self._method_name, args, kwargs)


class ClassMethodNode(DAGNode):
    def __init__(self, actor_or_node, method_name, args, kwargs):
        super().__init__(args, kwargs)
        self._target = actor_or_node
        self._method_name = method_name

    def _execute_node(self, input_args, input_kwargs, cache):
        key = id(self)
        if key not in cache:
            if isinstance(self._target, ClassNode):
                handle = self._target._get_actor(input_args, input_kwargs, cache)
            else:
                handle = self._target
            args, kwargs = self._resolved_args(input_args, input_kwargs, cache)
            method = getattr(handle, self._method_name)
            cache[key] = method.remote(*args, **kwargs)
        return cache[key]


class MultiOutputNode(DAGNode):
    def __init__(self, outputs: List[DAGNode]):
        super().__init__(tuple(outputs), {})

    def _execute_node(self, input_args, input_kwargs, cache):
        return [self._resolve(o, input_args, input_kwargs, cache)
                for o in self._bound_args]


class CompiledDAGRef:
    """Handle to one in-flight compiled-graph execution (reference:
    CompiledDAGRef — results must be consumed in submission order)."""

    def __init__(self, dag: "CompiledDAG", seq: int):
        self._dag = dag
        self._seq = seq
        self._consumed = False

    def get(self, timeout: float = 300.0):
        if self._consumed:
            raise ValueError("compiled DAG result was already consumed; "
                             "results can be read once, in submission order")
        self._consumed = True
        return self._dag._get_result(self._seq, timeout)


class CompiledDAG:
    """A real compiled execution plan (reference: compiled_dag_node.py:805,
    static per-actor schedules from dag_node_operation.py:704).

    Compilation assigns every ClassMethodNode to its actor, allocates one
    shared-memory channel per cross-actor edge (acked single-writer slots,
    channels.py), and ships each actor ONE static schedule which it runs on
    a dedicated thread. After compile, an execute() is a single channel
    write and get() a single channel read — the driver and the control
    plane are out of the per-iteration loop entirely.

    Single-host scope: channels live in /dev/shm (the multi-node test
    harness shares one host); cross-host edges would ride the object plane.
    """

    def __init__(self, root: DAGNode):
        import uuid as _uuid

        self._root = root
        self._order = self._toposort(root)
        self._uuid = _uuid.uuid4().hex[:10]
        self._seq = 0
        self._results_read = 0
        self._buffer: Dict[int, Any] = {}
        self._torn_down = False
        for node in self._order:
            if isinstance(node, FunctionNode):
                raise ValueError(
                    "compiled graphs support actor methods only (bind "
                    "functions run eagerly via dag.execute())")
        # instantiate all actors up front (class nodes hang off the method
        # nodes' targets, not the arg-dependency edges)
        for node in self._order:
            if isinstance(node, ClassMethodNode) \
                    and isinstance(node._target, ClassNode):
                node._target._get_actor((), {}, {})
        self._build_plan()
        self._launch_loops()

    @staticmethod
    def _toposort(root) -> List[DAGNode]:
        seen: List[DAGNode] = []
        visiting = set()

        def visit(n: DAGNode):
            if id(n) in visiting:
                raise ValueError("cycle in DAG")
            if n in seen:
                return
            visiting.add(id(n))
            for d in n._deps():
                visit(d)
            visiting.discard(id(n))
            seen.append(n)

        visit(root)
        return seen

    # -- compilation --

    def _actor_of(self, node: "ClassMethodNode"):
        if isinstance(node._target, ClassNode):
            return node._target._actor_handle
        return node._target  # pre-existing ActorHandle

    def _build_plan(self):
        """Assign ops to actors, allocate channels, build schedules."""
        from ray_tpu_torch.dag.channels import Channel

        method_nodes = [n for n in self._order
                        if isinstance(n, ClassMethodNode)]
        self._input_chan_name = f"{self._uuid}_in"
        # node -> producing channel name (cross-actor edges only)
        chan_of: Dict[int, str] = {}
        terminals: List[DAGNode] = (
            list(self._root._bound_args)
            if isinstance(self._root, MultiOutputNode) else [self._root])
        self._num_outputs = len(terminals)
        for i, t in enumerate(terminals):
            if not isinstance(t, ClassMethodNode):
                raise ValueError("compiled DAG outputs must be actor methods")
        # channels: input + one per method node that has any cross-actor or
        # driver reader
        readers_of: Dict[str, List[Any]] = {self._input_chan_name: []}
        for n in method_nodes:
            chan_of[id(n)] = f"{self._uuid}_{len(chan_of)}"
            readers_of[chan_of[id(n)]] = []

        def note_reader(chan_name, party):
            lst = readers_of[chan_name]
            if all(p is not party for p in lst):
                lst.append(party)

        # who reads what
        schedules: Dict[Any, dict] = {}  # actor handle -> schedule

        def sched_for(actor):
            key = actor.actor_id
            if key not in schedules:
                schedules[key] = {"actor": actor, "chan_readers": {},
                                  "ops": [], "node_idx": {}}
            return schedules[key]

        for n in method_nodes:
            actor = self._actor_of(n)
            sched = sched_for(actor)
            arg_spec = []
            for v in list(n._bound_args) + list(n._bound_kwargs.values()):
                if isinstance(v, InputNode):
                    note_reader(self._input_chan_name, sched)
                    arg_spec.append(("chan_idx",
                                     (self._input_chan_name, v._index)))
                elif isinstance(v, ClassMethodNode):
                    if self._actor_of(v) == actor:
                        arg_spec.append(("local", sched["node_idx"][id(v)]))
                    else:
                        cname = chan_of[id(v)]
                        note_reader(cname, sched)
                        arg_spec.append(("chan", cname))
                elif isinstance(v, DAGNode):
                    raise ValueError(
                        f"unsupported node type in compiled DAG: {type(v)}")
                else:
                    arg_spec.append(("const", v))
            op_idx = len(sched["ops"])
            sched["node_idx"][id(n)] = op_idx
            sched["ops"].append({"method": n._method_name, "args": arg_spec,
                                 "out": None})
        # driver reads the terminal channels
        self._out_chans_names: List[str] = []
        for t in terminals:
            cname = chan_of[id(t)]
            note_reader(cname, "driver")
            self._out_chans_names.append(cname)
        # wire out-channels for ops with readers
        for n in method_nodes:
            cname = chan_of[id(n)]
            if readers_of[cname]:
                actor = self._actor_of(n)
                sched = sched_for(actor)
                sched["ops"][sched["node_idx"][id(n)]]["out"] = cname
        # channel TYPE per edge: same-node parties share a /dev/shm seqlock
        # slot; any cross-node reader switches the channel to the
        # cross-host mailbox tier (reference: shared-memory channels vs the
        # cross-node mutable-object provider). Party placement comes from
        # the GCS actor directory; the driver is its own party.
        import ray_tpu_torch as _rt

        w = _rt._private.worker.global_worker()
        driver_node, driver_addr = w.node_hex, w.address
        placements: Dict[Any, tuple] = {}  # schedule-key -> (node, addr)
        # actors may still be starting at compile time: wait until the GCS
        # has a live placement for each — CONCURRENTLY, so a cold cluster
        # costs max(actor ready time), not the sum
        async def _all_ready():
            import asyncio as _aio

            scheds = list(schedules.values())
            infos = await _aio.gather(*[
                w._gcs_call("WaitActorReady", {
                    "actor_id": s["actor"].actor_id.binary(),
                    "timeout": 120.0}, timeout=130.0)
                for s in scheds])
            return {id(s): r["info"] for s, r in zip(scheds, infos)}

        for sid, info in w._run(_all_ready(), 140.0).items():
            placements[sid] = ((info or {}).get("node_id", ""),
                               (info or {}).get("address", ""))

        def party_place(party):
            if party == "driver":
                return driver_node, driver_addr
            return placements[id(party)]

        writer_of: Dict[str, Any] = {self._input_chan_name: "driver"}
        for n in method_nodes:
            writer_of[chan_of[id(n)]] = sched_for(self._actor_of(n))

        self._chan_specs: Dict[str, dict] = {}
        for cname, readers in readers_of.items():
            if cname != self._input_chan_name and not readers:
                continue
            wnode, _ = party_place(writer_of[cname])
            if any(party_place(p)[0] != wnode or not party_place(p)[0]
                   for p in readers):
                self._chan_specs[cname] = {"type": "xhost"}

        # allocate channels (driver creates shm ones; actors attach).
        # Cross-host channels have no shared segment: each reader owns a
        # mailbox named <chan>@<slot> at its worker; the writer pushes to
        # every mailbox.
        self._channels: List[Any] = []
        self._driver_slots: Dict[str, int] = {}
        for cname, readers in readers_of.items():
            if cname != self._input_chan_name and not readers:
                continue  # unconsumed intermediate: no channel needed
            spec = self._chan_specs.get(cname)
            num = max(1, len(readers))
            if spec is None:
                self._channels.append(Channel(cname, create=True,
                                              num_readers=num))
            else:
                spec["push"] = []
            for slot, party in enumerate(readers):
                if party == "driver":
                    self._driver_slots[cname] = slot
                else:
                    party["chan_readers"][cname] = slot
                if spec is not None:
                    spec["push"].append(
                        (f"{cname}@{slot}", party_place(party)[1]))
        for sched in schedules.values():
            sched["chan_specs"] = {
                c: {"type": "xhost", "push": self._chan_specs[c]["push"]}
                for c in set(list(sched["chan_readers"]) +
                             [op["out"] for op in sched["ops"] if op["out"]])
                if c in self._chan_specs}

        from ray_tpu_torch.dag.channels import open_reader, open_writer

        in_spec = self._chan_specs.get(self._input_chan_name)
        if in_spec is None:
            self._in_chan = next(
                c for c in self._channels
                if getattr(c, "name", "").endswith("_in"))
        else:
            self._in_chan = open_writer(self._input_chan_name, in_spec)
            self._channels.append(self._in_chan)
        self._out_chans: Dict[str, Any] = {}
        for cname in self._out_chans_names:
            self._out_chans[cname] = open_reader(
                cname, self._driver_slots[cname], self._chan_specs.get(cname))
            if self._chan_specs.get(cname) is not None:
                self._channels.append(self._out_chans[cname])
        self._schedules = list(schedules.values())
        # the input channel is fed from a dedicated thread so execute() never
        # blocks the driver when the pipeline is full (the driver must stay
        # free to drain results — otherwise submit-all-then-get deadlocks)
        import queue as _queue
        import threading as _threading

        self._submit_q: "_queue.Queue" = _queue.Queue()
        self._submit_err: Optional[BaseException] = None

        def _feed():
            while True:
                item = self._submit_q.get()
                if item is None:
                    return
                try:
                    self._in_chan.write(item)
                except BaseException as e:
                    self._submit_err = e
                    return

        self._submit_thread = _threading.Thread(
            target=_feed, name="rtpu-dag-submit", daemon=True)
        self._submit_thread.start()

    def _launch_loops(self):
        from ray_tpu_torch.actor import ActorMethod
        from ray_tpu_torch.dag.executor import DAG_LOOP_METHOD

        refs = []
        for sched in self._schedules:
            actor = sched["actor"]
            payload = {"chan_readers": sched["chan_readers"],
                       "chan_specs": sched.get("chan_specs", {}),
                       "ops": sched["ops"]}
            refs.append(ActorMethod(actor, DAG_LOOP_METHOD).remote(payload))
        for r in refs:
            out = ray_tpu_torch.get(r, timeout=120)
            if out != "started":
                raise RuntimeError(f"dag loop failed to start: {out}")

    # -- execution --

    def execute(self, *args, **kwargs):
        if kwargs:
            raise TypeError("compiled DAG execute() takes positional inputs "
                            "only (the plan is index-based)")
        if self._torn_down:
            raise RuntimeError("compiled DAG was torn down")
        if self._submit_err is not None:
            raise RuntimeError(f"compiled DAG input feed failed: "
                               f"{self._submit_err}")
        self._submit_q.put(tuple(args))
        ref = CompiledDAGRef(self, self._seq)
        self._seq += 1
        return ref

    def _get_result(self, seq: int, timeout: float):
        from ray_tpu_torch.dag.channels import ChannelError, _Stop

        if seq in self._buffer:
            value = self._buffer.pop(seq)
        else:
            while self._results_read <= seq:
                outs = [self._out_chans[c].read(timeout)
                        for c in self._out_chans_names]
                value = outs[0] if self._num_outputs == 1 else outs
                got = self._results_read
                self._results_read += 1
                if got != seq:
                    self._buffer[got] = value
        for v in (value if isinstance(value, list) else [value]):
            if isinstance(v, ChannelError):
                raise RuntimeError(f"compiled DAG stage failed: {v.err}")
            if isinstance(v, _Stop):
                raise RuntimeError("compiled DAG torn down mid-execution")
        return value

    # -- teardown --

    def teardown(self, kill_actors: bool = True):
        from ray_tpu_torch.dag.channels import _Stop

        if self._torn_down:
            return
        self._torn_down = True
        self._submit_q.put(_Stop())  # flows after any queued inputs
        self._submit_q.put(None)  # then stop the feeder thread
        self._submit_thread.join(timeout=30.0)
        # drain the output channels until the sentinel arrives on each:
        # this acks the final stage's _Stop write (so its loop thread exits
        # instead of spinning in an ack wait for its full timeout) and
        # proves propagation through every stage before unlinking
        deadline = time.monotonic() + 30.0
        pending_out = set(self._out_chans_names)
        last_progress = time.monotonic()
        while pending_out and time.monotonic() < deadline:
            progressed = False
            for c in list(pending_out):
                try:
                    v = self._out_chans[c].read(timeout=1.0)
                except Exception:  # raylint: disable=EXC001 drain poll: timeout and writer-death both just mean retry
                    continue
                progressed = True
                if isinstance(v, _Stop):
                    pending_out.discard(c)
            if progressed:
                last_progress = time.monotonic()
            elif time.monotonic() - last_progress > 3.0:
                break  # a dead stage will never flush its sentinel
        for ch in self._channels:
            try:
                ch.close(unlink=True)
            except Exception:  # raylint: disable=EXC001 teardown: segment may already be unlinked by a peer
                pass
        if kill_actors:
            for node in self._order:
                if isinstance(node, ClassMethodNode) \
                        and isinstance(node._target, ClassNode) \
                        and node._target._actor_handle is not None:
                    try:
                        ray_tpu_torch.kill(node._target._actor_handle)
                    except Exception:  # raylint: disable=EXC001 teardown: actor may already be dead
                        pass
                    node._target._actor_handle = None
