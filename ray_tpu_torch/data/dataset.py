"""Dataset: lazy logical plan -> streaming physical execution, the port of
``ray_tpu/data/dataset.py``.

Reference: python/ray/data — ``Dataset`` (data/dataset.py) holds a logical
plan; consumption compiles it to a physical operator DAG executed by a
streaming executor thread (_internal/execution/streaming_executor.py:66)
with operator fusion (consecutive map-family stages fuse into one task per
block), actor pools for class-UDFs, two-phase hash shuffles for
sort/groupby/join/random_shuffle, bounded buffers for backpressure, and
early-stop limits. Blocks live in the shared-memory object store and move
as RefBundles; only small metadata reaches the driver.

Differences from the JAX package, by design: blocks are the port's own
columnar :class:`~ray_tpu_torch.data.block.Table` (no pyarrow on the card's
machine); CSV and JSON go through the standard library, while parquet
(``read_parquet`` / ``write_parquet``) and pandas (``from_pandas`` /
``to_pandas``) import their package at call time and raise ImportError
naming it where it is missing; ``iter_device_batches`` takes ``device=``
(the card by default) where the JAX one takes ``sharding=``. UDFs cross
to the tasks through the port's by-value pickler. The Dataset's tasks and
actors take no ``GPU`` lease and load neither torch nor CUDA.
"""

from __future__ import annotations

import builtins
import functools
import math
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

import ray_tpu_torch
from ray_tpu_torch._private.serialization import dumps
from ray_tpu_torch.data._internal.executor import Edge, StreamingExecutor
from ray_tpu_torch.data._internal.operators import (
    ActorPoolMapOperator,
    AllToAllOperator,
    InputDataOperator,
    LimitOperator,
    PhysicalOperator,
    ReadOperator,
    RefBundle,
    TaskPoolMapOperator,
    UnionOperator,
    WriteOperator,
    ZipOperator,
)
from ray_tpu_torch.data._internal import tasks as T
from ray_tpu_torch.data.block import (_NUMERIC, Block, BlockAccessor, Column,
                                     Table, _pandas, _pyarrow, widened_batch)
from ray_tpu_torch.data.context import DataContext

_MAP_KINDS = ("map_rows", "flat_map", "filter", "map_batches")


# ---------------------------------------------------------------------------
# logical ops
# ---------------------------------------------------------------------------


class _Op:
    """Logical plan node. kind: read | input | map-family | all2all | limit |
    union | zip | join | write."""

    __slots__ = ("kind", "args")

    def __init__(self, kind: str, **args):
        self.kind = kind
        self.args = args


class Dataset:
    def __init__(self, ops: List[_Op]):
        self._ops = ops
        self._materialized: Optional[List[RefBundle]] = None
        self._last_stats = ""

    # ------------------------------------------------------------------
    # transforms (lazy)
    # ------------------------------------------------------------------

    def _base_ops(self) -> List[_Op]:
        """Plan prefix for derived datasets: a materialized parent is reused
        as an input op so its reads/UDFs never re-execute."""
        if self._materialized is not None:
            return [_Op("input", bundles=list(self._materialized))]
        return self._ops

    def _extend(self, op: _Op) -> "Dataset":
        return Dataset(self._base_ops() + [op])

    def map(self, fn, *, num_cpus: Optional[float] = None,
            concurrency: Optional[int] = None, **kw) -> "Dataset":
        return self._map_family("map_rows", fn, None, num_cpus, concurrency, kw)

    def flat_map(self, fn, *, num_cpus: Optional[float] = None,
                 concurrency: Optional[int] = None, **kw) -> "Dataset":
        return self._map_family("flat_map", fn, None, num_cpus, concurrency, kw)

    def filter(self, fn, *, num_cpus: Optional[float] = None,
               concurrency: Optional[int] = None, **kw) -> "Dataset":
        return self._map_family("filter", fn, None, num_cpus, concurrency, kw)

    def map_batches(self, fn, *, batch_size: Optional[int] = None,
                    num_cpus: Optional[float] = None,
                    concurrency: Optional[int] = None,
                    fn_constructor_args: tuple = (),
                    fn_constructor_kwargs: Optional[dict] = None,
                    **kw) -> "Dataset":
        return self._map_family("map_batches", fn, batch_size, num_cpus,
                                concurrency,
                                dict(kw, fn_constructor_args=fn_constructor_args,
                                     fn_constructor_kwargs=fn_constructor_kwargs or {}))

    def _map_family(self, kind, fn, batch_size, num_cpus, concurrency, kw):
        is_class = isinstance(fn, type)
        return self._extend(_Op(
            "map", stage=kind, fn=fn, batch_size=batch_size,
            num_cpus=num_cpus, concurrency=concurrency, is_class=is_class,
            ctor_args=kw.get("fn_constructor_args", ()),
            ctor_kwargs=kw.get("fn_constructor_kwargs", {})))

    # -- all-to-all ----------------------------------------------------

    def repartition(self, num_blocks: int) -> "Dataset":
        return self._extend(_Op("all2all", mode="repartition",
                                num_partitions=num_blocks))

    def random_shuffle(self, seed: Optional[int] = None) -> "Dataset":
        return self._extend(_Op("all2all", mode="random_shuffle", seed=seed,
                                num_partitions=None))

    def sort(self, key, descending: bool = False) -> "Dataset":
        return self._extend(_Op("all2all", mode="sort", key=key,
                                descending=descending, num_partitions=None))

    def groupby(self, key) -> "GroupedData":
        return GroupedData(self, key)

    def join(self, other: "Dataset", on: str, how: str = "inner",
             num_partitions: Optional[int] = None,
             suffix: str = "_right") -> "Dataset":
        return Dataset(self._base_ops() + [
            _Op("join", right=other, on=on, how=how,
                num_partitions=num_partitions, suffix=suffix)])

    def union(self, *others: "Dataset") -> "Dataset":
        return Dataset(self._base_ops() + [_Op("union", others=list(others))])

    def zip(self, other: "Dataset") -> "Dataset":
        return Dataset(self._base_ops() + [_Op("zip", right=other)])

    def limit(self, n: int) -> "Dataset":
        return self._extend(_Op("limit", n=n))

    # ------------------------------------------------------------------
    # compile logical -> physical
    # ------------------------------------------------------------------

    def _compile(self, extra_op: Optional[_Op] = None
                 ) -> Tuple[List[PhysicalOperator], List[Edge], PhysicalOperator]:
        ctx = DataContext.get_current()
        ops_logical = self._ops + ([extra_op] if extra_op else [])
        phys: List[PhysicalOperator] = []
        edges: List[Edge] = []

        def link(src, dst, port="in"):
            edges.append(Edge(src, dst, port))

        def compile_into(logical: List[_Op], phys_out, edges_out):
            """Returns the tail physical op of this chain."""
            tail: Optional[PhysicalOperator] = None
            pending_maps: List[_Op] = []

            def flush_maps():
                nonlocal tail
                if not pending_maps:
                    return
                chain = []
                ctors: Dict[str, tuple] = {}
                any_class = False
                num_cpus = ctx.num_cpus_per_task
                concurrency = None
                for i, m in enumerate(pending_maps):
                    fn = m.args["fn"]
                    if m.args["is_class"]:
                        any_class = True
                        name = f"udf_{i}"
                        ctors[name] = (fn, m.args["ctor_args"], m.args["ctor_kwargs"])
                        chain.append((m.args["stage"], name, m.args["batch_size"]))
                    else:
                        chain.append((m.args["stage"], fn, m.args["batch_size"]))
                    if m.args["num_cpus"] is not None:
                        num_cpus = m.args["num_cpus"]
                    if m.args["concurrency"] is not None:
                        concurrency = m.args["concurrency"]
                label = "+".join(m.args["stage"] for m in pending_maps)
                if any_class:
                    op = ActorPoolMapOperator(
                        f"ActorMap[{label}]", chain, ctors,
                        pool_size=concurrency or 2, num_cpus=num_cpus)
                else:
                    op = TaskPoolMapOperator(
                        f"Map[{label}]", chain, num_cpus=num_cpus,
                        concurrency=concurrency)
                phys_out.append(op)
                if tail is not None:
                    link(tail, op)
                tail = op
                pending_maps.clear()

            for lop in logical:
                if lop.kind == "read":
                    op = ReadOperator(lop.args["thunks"],
                                      num_cpus=ctx.num_cpus_per_task)
                    phys_out.append(op)
                    tail = op
                elif lop.kind == "input":
                    op = InputDataOperator(lop.args["bundles"])
                    phys_out.append(op)
                    tail = op
                elif lop.kind == "map":
                    pending_maps.append(lop)
                elif lop.kind == "all2all":
                    flush_maps()
                    op = _build_all2all(lop, ctx)
                    phys_out.append(op)
                    link(tail, op)
                    tail = op
                elif lop.kind == "limit":
                    flush_maps()
                    op = LimitOperator(lop.args["n"])
                    phys_out.append(op)
                    if tail is not None:
                        link(tail, op)
                    tail = op
                elif lop.kind == "union":
                    flush_maps()
                    op = UnionOperator()
                    phys_out.append(op)
                    link(tail, op)
                    for other in lop.args["others"]:
                        other_tail = compile_into(other._ops, phys_out, edges_out)
                        link(other_tail, op)
                    tail = op
                elif lop.kind == "zip":
                    flush_maps()
                    op = ZipOperator()
                    phys_out.append(op)
                    link(tail, op, "left")
                    right_tail = compile_into(lop.args["right"]._ops,
                                              phys_out, edges_out)
                    link(right_tail, op, "right")
                    tail = op
                elif lop.kind == "join":
                    flush_maps()
                    op = _JoinOperator(lop.args["on"], lop.args["how"],
                                       lop.args["suffix"],
                                       lop.args["num_partitions"],
                                       num_cpus=ctx.num_cpus_per_task)
                    phys_out.append(op)
                    link(tail, op, "left")
                    right_tail = compile_into(lop.args["right"]._ops,
                                              phys_out, edges_out)
                    link(right_tail, op, "right")
                    tail = op
                elif lop.kind == "write":
                    flush_maps()
                    op = WriteOperator(lop.args["write_fn"],
                                       num_cpus=ctx.num_cpus_per_task)
                    phys_out.append(op)
                    link(tail, op)
                    tail = op
                else:
                    raise ValueError(lop.kind)
            flush_maps()
            assert tail is not None, "empty dataset plan"
            return tail

        tail = compile_into(ops_logical, phys, edges)
        return phys, edges, tail

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------

    def _stream(self, extra_op: Optional[_Op] = None) -> Iterator[RefBundle]:
        if self._materialized is not None and extra_op is None:
            yield from self._materialized
            return
        phys, edges, tail = self._compile(extra_op)
        executor = StreamingExecutor(phys, edges, tail).start()
        try:
            yield from executor.iter_output()
            self._last_stats = executor.stats_summary()
            self._last_stats_data = executor.stats_data()
            self._publish_stats()
        finally:
            executor.stop()

    def materialize(self) -> "Dataset":
        if self._materialized is None:
            self._materialized = list(self._stream())
        return self

    def stats(self) -> str:
        return self._last_stats

    def stats_data(self) -> list:
        """Structured per-op metrics from the last execution (reference:
        data/_internal/stats.py DatasetStats)."""
        return getattr(self, "_last_stats_data", [])

    def _publish_stats(self):
        """Surface the last run's stats through the state API / dashboard
        (GCS KV ns="data_stats"); best-effort, skipped in local mode."""
        try:
            from ray_tpu_torch._private import worker as worker_mod

            core = worker_mod.global_worker()
            if getattr(core, "mode", "") == "local" \
                    or not hasattr(core, "_gcs_call"):
                return
            import time as _t

            from ray_tpu_torch._private import wire

            core._run(core._gcs_call("KVPut", {
                "ns": "data_stats", "key": self._stats_key(),
                "value": wire.dumps({"ts": _t.time(),
                                     "ops": self._last_stats_data})}),
                5.0)
        except Exception:
            pass

    def _stats_key(self) -> str:
        if not hasattr(self, "_stats_uuid"):
            import uuid as _uuid

            self._stats_uuid = _uuid.uuid4().hex[:12]
        return self._stats_uuid

    # ------------------------------------------------------------------
    # consumption
    # ------------------------------------------------------------------

    def iter_blocks(self) -> Iterator[Block]:
        for bundle in self._stream():
            block = ray_tpu_torch.get(bundle.block, timeout=600)
            if bundle.rows is not None:
                actual = BlockAccessor(block).num_rows()
                if actual != bundle.rows:
                    raise RuntimeError(
                        f"object-plane consistency bug: block "
                        f"{bundle.block.id.hex()} produced {bundle.rows} rows "
                        f"but fetched {actual}")
            yield block

    def iter_rows(self) -> Iterator[Any]:
        for block in self.iter_blocks():
            yield from BlockAccessor(block).to_rows()

    def iter_batches(self, batch_size: int = 256, drop_last: bool = False,
                     prefetch_batches: int = 1) -> Iterator[Dict[str, np.ndarray]]:
        """Batches of ``batch_size`` rows across block boundaries, each the
        batch of a block rebuilt from its rows (as in the JAX package);
        where the blocks are numeric tables the batch is cut from their
        columns directly (``block.widened_batch``), to the same arrays."""
        carry: List[Block] = []  # block slices not yet yielded
        held = 0
        for block in self.iter_blocks():
            n = BlockAccessor(block).num_rows()
            start = 0
            while held + (n - start) >= batch_size:
                take = batch_size - held
                carry.append(BlockAccessor(block).slice(start, start + take))
                start += take
                yield _batch_of(carry)
                carry, held = [], 0
            if start < n:
                carry.append(BlockAccessor(block).slice(start, n))
                held += n - start
        if held and not drop_last:
            yield _batch_of(carry)

    def iter_device_batches(self, batch_size: int = 256,
                            drop_last: bool = False,
                            device_prefetch: int = 2,
                            device=None) -> Iterator[Dict[str, Any]]:
        """Device-fed iteration (reference: data/iterator.py
        iter_torch_batches:106,269 — the Train ingestion path): a producer
        thread pulls host batches (``iter_batches``), copies each into
        pinned host memory and starts its copy to the card on a side
        stream (``non_blocking``), ``device_prefetch`` batches ahead, so
        the consumer's step overlaps the next batch's transfer instead of
        waiting on it. The consumer's stream waits on each copy's event;
        nothing syncs the host per batch. Yields dicts of tensors on
        ``device`` (the card by default; the CPU only when named), of the
        host batches' dtypes."""
        import queue as _q
        import threading as _th

        import torch

        from ray_tpu_torch.utils import resolve_device

        dev = resolve_device(device)
        cuda = dev.type == "cuda"
        side = torch.cuda.Stream(dev) if cuda else None
        depth = max(1, int(device_prefetch))
        q: _q.Queue = _q.Queue(maxsize=depth)
        stop = _th.Event()
        _END, _ERR = object(), object()

        def _put_device(batch):
            """(dict of tensors on ``dev``, the copies' event or None)."""
            if not cuda:
                return {k: torch.as_tensor(v) for k, v in batch.items()}, None
            with torch.cuda.stream(side):
                out = {k: torch.as_tensor(v).pin_memory().to(
                    dev, non_blocking=True) for k, v in batch.items()}
                done = torch.cuda.Event()
                done.record(side)
            return out, done

        def _enqueue(item) -> bool:
            # every block is bounded so an early-exiting consumer (break
            # mid-epoch) releases this thread instead of stranding it on a
            # full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.25)
                    return True
                except _q.Full:
                    continue
            return False

        def _producer():
            try:
                for batch in self.iter_batches(batch_size=batch_size,
                                               drop_last=drop_last):
                    if not _enqueue(_put_device(batch)):
                        return
                _enqueue(_END)
            except BaseException as e:  # surface in the consumer
                _enqueue((_ERR, e))

        t = _th.Thread(target=_producer, daemon=True,
                       name="ray_tpu_torch-device-prefetch")
        t.start()
        from ray_tpu_torch.util import goodput

        try:
            while True:
                # consumer-side queue wait IS the input stall: with the
                # prefetch pipeline keeping up this get returns
                # immediately; time spent blocked here is wall the step
                # loop lost to input
                with goodput.region("input_stall"):
                    item = q.get()
                goodput.count("input_waits")
                if item is _END:
                    break
                if item[0] is _ERR:
                    raise item[1]
                out, done = item
                if done is not None:
                    # the consumer's stream waits for the copies, and the
                    # allocator keeps their memory until its work is done
                    cur = torch.cuda.current_stream(dev)
                    cur.wait_event(done)
                    for tensor in out.values():
                        tensor.record_stream(cur)
                yield out
        finally:
            stop.set()
            while not q.empty():  # unblock a producer parked on put
                try:
                    q.get_nowait()
                except _q.Empty:
                    break
            t.join(timeout=2.0)

    def take(self, n: int = 20) -> List[Any]:
        out: List[Any] = []
        for bundle in self.limit(n)._stream():
            block = ray_tpu_torch.get(bundle.block, timeout=600)
            out.extend(BlockAccessor(block).to_rows())
            if len(out) >= n:
                break
        return out[:n]

    def take_all(self) -> List[Any]:
        return list(self.iter_rows())

    def count(self) -> int:
        # row counts ride the meta stream; blocks are never fetched
        return sum(b.rows or 0 for b in self._stream())

    def num_blocks(self) -> int:
        self.materialize()
        return len(self._materialized)

    def schema(self):
        for block in self.iter_blocks():
            acc = BlockAccessor(block)
            if acc._is_table():
                return acc.block.schema
            rows = acc.to_rows()
            if rows:
                return type(rows[0])
        return None

    def show(self, n: int = 20):
        for row in self.take(n):
            print(row)

    def to_pandas(self):
        pd = _pandas("Dataset.to_pandas")
        frames = [BlockAccessor(b).to_pandas() for b in self.iter_blocks()]
        return pd.concat(frames, ignore_index=True) if frames else pd.DataFrame()

    def split(self, n: int) -> List["Dataset"]:
        """Equal row-count splits (used by Train dataset sharding)."""
        self.materialize()
        bundles = self._materialized
        counts = [b.rows or 0 for b in bundles]
        total = sum(counts)
        per = total // n if n else 0
        # build row-range views over the materialized blocks
        out: List[Dataset] = []
        starts = [i * per for i in builtins.range(n)]
        ends = [(i + 1) * per if i < n - 1 else total for i in builtins.range(n)]
        for s, e in builtins.zip(starts, ends):
            refs: List[RefBundle] = []
            pos = 0
            for b, cnt in builtins.zip(bundles, counts):
                lo, hi = max(s - pos, 0), min(e - pos, cnt)
                if lo < hi:
                    if lo == 0 and hi == cnt:
                        refs.append(b)
                    else:
                        block_ref, meta_ref = T.slice_block.options(
                            num_returns=2).remote(b.block, lo, hi)
                        refs.append(RefBundle(block_ref, hi - lo, 0))
                pos += cnt
            ds = Dataset([_Op("input", bundles=refs)])
            ds._materialized = refs
            out.append(ds)
        return out

    def train_test_split(self, test_size: float, *, shuffle: bool = False,
                         seed: Optional[int] = None):
        ds: Dataset = self.random_shuffle(seed) if shuffle else self
        ds.materialize()
        total = ds.count()
        n_test = int(total * test_size)
        train, test = ds.split_at([total - n_test])
        return train, test

    def split_at(self, indices: List[int]) -> List["Dataset"]:
        self.materialize()
        bounds = [0] + list(indices) + [self.count()]
        out = []
        for s, e in builtins.zip(bounds[:-1], bounds[1:]):
            sliced = self._slice_rows(s, e)
            out.append(sliced)
        return out

    def _slice_rows(self, s: int, e: int) -> "Dataset":
        bundles = self._materialized
        refs: List[RefBundle] = []
        pos = 0
        for b in bundles:
            cnt = b.rows or 0
            lo, hi = max(s - pos, 0), min(e - pos, cnt)
            if lo < hi:
                if lo == 0 and hi == cnt:
                    refs.append(b)
                else:
                    block_ref, _ = T.slice_block.options(
                        num_returns=2).remote(b.block, lo, hi)
                    refs.append(RefBundle(block_ref, hi - lo, 0))
            pos += cnt
        ds = Dataset([_Op("input", bundles=refs)])
        ds._materialized = refs
        return ds

    # -- writes --------------------------------------------------------

    def _write(self, write_fn) -> List[str]:
        paths = []
        for bundle in self._stream(_Op("write", write_fn=write_fn)):
            block = ray_tpu_torch.get(bundle.block, timeout=600)
            paths.extend(r["path"] for r in BlockAccessor(block).to_rows())
        return paths

    def write_parquet(self, path: str) -> List[str]:
        _pyarrow("write_parquet")  # raise here, not in every write task
        return self._write(functools.partial(_write_parquet_block, path))

    def write_csv(self, path: str) -> List[str]:
        return self._write(functools.partial(_write_csv_block, path))

    def write_json(self, path: str) -> List[str]:
        return self._write(functools.partial(_write_json_block, path))

    def __repr__(self):
        n = len(self._materialized) if self._materialized else "?"
        return f"Dataset(blocks={n}, ops={[o.kind for o in self._ops]})"


# ---------------------------------------------------------------------------
# groupby / aggregates
# ---------------------------------------------------------------------------


class GroupedData:
    """ds.groupby(key) -> aggregations over a hash shuffle (reference:
    grouped_data.py riding operators/hash_shuffle.py)."""

    def __init__(self, ds: Dataset, key):
        self._ds = ds
        self._key = key

    def _agg(self, spec: List[Tuple[str, Optional[str]]],
             num_partitions: Optional[int] = None) -> Dataset:
        key = self._key
        return self._ds._extend(_Op(
            "all2all", mode="groupby", key=key, agg_spec=spec,
            num_partitions=num_partitions))

    def count(self) -> Dataset:
        return self._agg([("count", None)])

    def sum(self, column: str) -> Dataset:
        return self._agg([("sum", column)])

    def mean(self, column: str) -> Dataset:
        return self._agg([("mean", column)])

    def min(self, column: str) -> Dataset:
        return self._agg([("min", column)])

    def max(self, column: str) -> Dataset:
        return self._agg([("max", column)])

    def std(self, column: str) -> Dataset:
        return self._agg([("std", column)])

    def aggregate(self, *specs: Tuple[str, Optional[str]]) -> Dataset:
        return self._agg(list(specs))

    def map_groups(self, fn) -> Dataset:
        key = self._key
        return self._ds._extend(_Op(
            "all2all", mode="map_groups", key=key, fn=fn, num_partitions=None))



def _batch_of(parts: List[Block]) -> Dict[str, np.ndarray]:
    """The batch of these block slices' rows, rebuilt as one block (the
    JAX package's route), or cut from their columns where that gives the
    same arrays."""
    fast = widened_batch(parts)
    if fast is not None:
        return fast
    rows: List[Any] = []
    for p in parts:
        rows.extend(BlockAccessor(p).to_rows())
    return BlockAccessor(BlockAccessor.build_from_rows(rows)).to_batch()


def _stable_hash(value) -> int:
    """Deterministic across processes (plain hash() is salted per process,
    which would scatter equal keys across shuffle partitions)."""
    import zlib

    if isinstance(value, (int, np.integer)):
        return int(value) & 0x7FFFFFFF
    return zlib.crc32(repr(value).encode()) & 0x7FFFFFFF


def _group_reduce(rows: List[dict], key, agg_spec):
    groups: Dict[Any, List[dict]] = {}
    keyfn = key if callable(key) else (lambda r: r[key])
    for r in rows:
        groups.setdefault(keyfn(r), []).append(r)
    key_name = key if isinstance(key, str) else "key"
    out = []
    for k, members in sorted(groups.items(), key=lambda kv: repr(kv[0])):
        row = {key_name: k}
        for op, col in agg_spec:
            vals = [m[col] for m in members] if col else None
            if op == "count":
                row["count()"] = len(members)
            elif op == "sum":
                s = sum(vals)
                row[f"sum({col})"] = float(s) if isinstance(s, float) else s
            elif op == "mean":
                row[f"mean({col})"] = float(np.mean(vals))
            elif op == "min":
                row[f"min({col})"] = min(vals)  # works for any comparable
            elif op == "max":
                row[f"max({col})"] = max(vals)
            elif op == "std":
                row[f"std({col})"] = float(np.std(vals, ddof=1)) \
                    if len(vals) > 1 else 0.0
            else:
                raise ValueError(op)
        out.append(row)
    return out


def _map_groups_reduce(rows: List[dict], key, fn):
    groups: Dict[Any, List[dict]] = {}
    keyfn = key if callable(key) else (lambda r: r[key])
    for r in rows:
        groups.setdefault(keyfn(r), []).append(r)
    out = []
    for k in sorted(groups.keys(), key=repr):
        res = fn(groups[k])
        out.extend(res if isinstance(res, list) else [res])
    return out


def _build_all2all(lop: _Op, ctx: DataContext) -> AllToAllOperator:
    mode = lop.args["mode"]
    nparts = lop.args.get("num_partitions") or ctx.default_shuffle_partitions

    if mode == "repartition":
        def part_factory(_state):
            # fresh per-process entropy (pickled closures would replay the
            # same counter/rng state in every map task, skewing partitions)
            def part(row, _c={}):
                rng = _c.get("rng")
                if rng is None:
                    import random as _random

                    rng = _c["rng"] = _random.Random()
                return rng.randrange(1 << 30)
            return part

        return AllToAllOperator("Repartition", nparts, part_factory,
                                lambda _s: (lambda rows: rows),
                                num_cpus=ctx.num_cpus_per_task)

    if mode == "random_shuffle":
        seed = lop.args.get("seed")

        def part_factory(_state, seed=seed):
            if seed is not None:
                # deterministic: partition by content hash mixed with seed
                def part(row, seed=seed):
                    return _stable_hash((seed, repr(row)))
                return part

            def part(row, _c={}):
                rng = _c.get("rng")
                if rng is None:
                    import random as _random

                    rng = _c["rng"] = _random.Random()
                return rng.randrange(1 << 30)
            return part

        def reduce_factory(_state, seed=seed):
            def red(rows, seed=seed):
                rng = np.random.default_rng(seed)
                perm = rng.permutation(len(rows))
                return [rows[i] for i in perm]
            return red

        return AllToAllOperator("RandomShuffle", nparts, part_factory,
                                reduce_factory, num_cpus=ctx.num_cpus_per_task)

    if mode == "sort":
        key = lop.args["key"]
        descending = lop.args["descending"]
        keyfn = key if callable(key) else (lambda r, k=key: r[k])

        def prepare(bundles, n_parts, keyfn=keyfn):
            return T.sample_boundaries.remote(
                dumps(keyfn), n_parts,
                *[b.block for b in bundles])

        def part_factory(boundaries, keyfn=keyfn):
            import bisect

            def part(row, b=boundaries, keyfn=keyfn):
                return bisect.bisect_left(b, keyfn(row)) if b else 0
            return part

        def reduce_factory(_state, keyfn=keyfn, descending=descending):
            def red(rows):
                return sorted(rows, key=keyfn, reverse=descending)
            return red

        op = AllToAllOperator("Sort", nparts, part_factory, reduce_factory,
                              prepare=prepare, num_cpus=ctx.num_cpus_per_task)
        op.ordered = True
        if descending:
            op.reverse_order = True
        return op

    if mode == "groupby":
        key = lop.args["key"]
        spec = lop.args["agg_spec"]
        keyfn = key if callable(key) else (lambda r, k=key: r[k])

        def part_factory(_state, keyfn=keyfn):
            def part(row, keyfn=keyfn):
                return _stable_hash(keyfn(row))
            return part

        def reduce_factory(_state, key=key, spec=spec):
            return functools.partial(_group_reduce, key=key, agg_spec=spec)

        return AllToAllOperator("GroupBy", nparts, part_factory,
                                reduce_factory, num_cpus=ctx.num_cpus_per_task)

    if mode == "map_groups":
        key = lop.args["key"]
        fn = lop.args["fn"]
        keyfn = key if callable(key) else (lambda r, k=key: r[k])

        def part_factory(_state, keyfn=keyfn):
            def part(row, keyfn=keyfn):
                return _stable_hash(keyfn(row))
            return part

        def reduce_factory(_state, key=key, fn=fn):
            return functools.partial(_map_groups_reduce, key=key, fn=fn)

        return AllToAllOperator("MapGroups", nparts, part_factory,
                                reduce_factory, num_cpus=ctx.num_cpus_per_task)

    raise ValueError(mode)


class _JoinOperator(AllToAllOperator):
    """Two-sided barrier: hash-partition both inputs on the key, then join
    each partition (reference: join via hash shuffle)."""

    def __init__(self, on: str, how: str, suffix: str,
                 num_partitions: Optional[int], num_cpus: float = 1.0):
        def part_factory(_state, on=on):
            def part(row, on=on):
                return _stable_hash(row.get(on))
            return part

        super().__init__(f"Join[{how} on {on}]", num_partitions, part_factory,
                         lambda _s: (lambda rows: rows), num_cpus=num_cpus)
        self._join_blob = dumps((on, how, suffix))
        self._left_bundles: List[RefBundle] = []
        self._right_bundles: List[RefBundle] = []
        self._left_ids: set = set()
        self._left_outputs: List = []
        self._right_outputs: List = []
        self._left_map_count = 0

    def add_left(self, bundle: RefBundle):
        self._left_bundles.append(bundle)
        self._left_ids.add(id(bundle))
        self._input_bundles.append(bundle)

    def add_right(self, bundle: RefBundle):
        self._right_bundles.append(bundle)

    # left + right both shuffled with the same key partitioner
    def _advance_phase(self):
        if self._phase == "collect" and self.inputs_done:
            self._input_bundles = self._left_bundles + self._right_bundles
            self._position = {id(b): i
                              for i, b in enumerate(self._input_bundles)}
            self._start_map(None)

    def _on_map_done(self, map_ref, bundle):
        # maps finish in arbitrary order: split by side here so the reduce
        # can tell left parts from right parts, and keep each map's input
        # position
        out = (self._left_outputs if id(bundle) in self._left_ids
               else self._right_outputs)
        out.append((self._position[id(bundle)], map_ref))

    def _on_all_maps_done(self):
        # the reduce sees each side's parts in input order, not completion
        # order: a partition's first row fixes its block's columns (as
        # arrow's from_pylist does), so completion order would decide
        # whether a left or outer join keeps the right side's columns
        self._left_map_count = len(self._left_outputs)
        self._map_outputs = [ref for _, ref in sorted(
            self._left_outputs, key=lambda e: e[0])] + [
            ref for _, ref in sorted(self._right_outputs, key=lambda e: e[0])]

    def _n_parts(self) -> int:
        if self._num_partitions:
            return self._num_partitions
        return max(1, len(self._left_bundles) + len(self._right_bundles))

    def dispatch_one(self):
        if self._map_pending:
            return super().dispatch_one()
        part_index = self._reduce_pending.popleft()
        block_ref, meta_ref = T.join_reduce.options(
            num_returns=2, num_cpus=self.num_cpus).remote(
                self._join_blob, part_index, self._left_map_count,
                *self._map_outputs)
        self._active[meta_ref] = ("reduce", block_ref, part_index)
        return [meta_ref]


# ---------------------------------------------------------------------------
# writers
# ---------------------------------------------------------------------------


def _write_parquet_block(path: str, block: Block, index: int) -> str:
    import os

    pq = _pyarrow("write_parquet").parquet
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, f"part-{index:05d}.parquet")
    pq.write_table(_to_arrow(block), out)
    return out


def _csv_field(value) -> str:
    """One CSV field as pyarrow's writer puts it: strings quoted (quotes
    doubled), numbers and booleans bare, null empty."""
    if value is None:
        return ""
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, (int, float)):
        return repr(value)
    if isinstance(value, bytes):
        value = value.decode("utf-8", "replace")
    if isinstance(value, str):
        return '"' + value.replace('"', '""') + '"'
    raise TypeError(f"CSV cannot hold a {type(value).__name__} value")


def _write_csv_block(path: str, block: Block, index: int) -> str:
    import os

    rows = BlockAccessor(block).to_rows()
    names = list(rows[0]) if rows else (
        block.column_names if isinstance(block, Table) else [])
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, f"part-{index:05d}.csv")
    with open(out, "w", newline="") as f:
        f.write(",".join(_csv_field(n) for n in names) + "\n")
        for row in rows:
            f.write(",".join(_csv_field(row.get(n)) for n in names) + "\n")
    return out


def _write_json_block(path: str, block: Block, index: int) -> str:
    import json
    import os

    acc = BlockAccessor(block)
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, f"part-{index:05d}.jsonl")
    with open(out, "w") as f:
        for row in acc.to_rows():
            f.write(json.dumps(row, default=str) + "\n")
    return out


# ---------------------------------------------------------------------------
# arrow interchange (parquet, HuggingFace datasets)
# ---------------------------------------------------------------------------


def _to_arrow(block: Block):
    """A block as a pyarrow Table (the column types kept)."""
    pa = _pyarrow("write_parquet")
    acc = BlockAccessor(block)
    if not acc._is_table():
        return pa.Table.from_pylist(acc.to_rows())
    arrays = {}
    for name, col in block.columns.items():
        if col.type in _NUMERIC:
            arrays[name] = pa.array(
                col.data, mask=None if col.valid is None else ~col.valid)
        else:
            arrays[name] = pa.array(col.to_pylist())
    return pa.table(arrays)


def _from_arrow(table) -> Table:
    """A pyarrow Table as the port's Table, each column in its arrow
    type."""
    cols = {}
    for name in table.column_names:
        chunked = table.column(name)
        typ = str(chunked.type)
        typ = {"halffloat": "float16", "float": "float32",
               "double": "float64"}.get(typ, typ)
        if typ not in _NUMERIC:
            cols[name] = Column.from_values(chunked.to_pylist())
        elif chunked.null_count:
            cols[name] = Column.from_values(chunked.to_pylist(), typ)
        else:
            cols[name] = Column(typ, np.asarray(chunked.to_numpy(), dtype=typ))
    return Table(cols)


# ---------------------------------------------------------------------------
# sources (reference: python/ray/data/read_api.py)
# ---------------------------------------------------------------------------


def _make_dataset(thunks: List[Callable[[], Block]]) -> Dataset:
    return Dataset([_Op("read", thunks=[dumps(t) for t in thunks])])


def from_blocks(blocks: List[Block]) -> Dataset:
    bundles = [RefBundle(ray_tpu_torch.put(b), BlockAccessor(b).num_rows(),
                         BlockAccessor(b).size_bytes()) for b in blocks]
    ds = Dataset([_Op("input", bundles=bundles)])
    ds._materialized = bundles
    return ds


def range(n: int, parallelism: int = 8) -> Dataset:  # noqa: A001
    parallelism = max(1, min(parallelism, n or 1))
    per = math.ceil(n / parallelism)
    thunks = []
    for i in builtins.range(parallelism):
        start, end = i * per, min((i + 1) * per, n)
        if start >= end:
            continue
        thunks.append(functools.partial(_range_block, start, end))
    return _make_dataset(thunks)


def _range_block(start: int, end: int) -> Block:
    return BlockAccessor.build_from_rows(
        [{"id": i} for i in builtins.range(start, end)])


def from_items(items: List[Any], parallelism: int = 8) -> Dataset:
    items = list(items)
    parallelism = max(1, min(parallelism, len(items) or 1))
    per = math.ceil(len(items) / parallelism)
    thunks = []
    for i in builtins.range(parallelism):
        chunk = items[i * per:(i + 1) * per]
        if chunk:
            thunks.append(functools.partial(BlockAccessor.build_from_rows, chunk))
    return _make_dataset(thunks)


def from_pandas(df) -> Dataset:
    """One block of ``df``'s columns, as ``pyarrow.Table.from_pandas``
    makes it: a float NaN or a missing object becomes null, and an index
    other than a RangeIndex becomes a column."""
    pd = _pandas("from_pandas")
    cols = {}
    for name in df.columns:
        cols[str(name)] = _pandas_column(df[name].to_numpy())
    if not isinstance(df.index, pd.RangeIndex):
        name = df.index.name if df.index.name is not None \
            else "__index_level_0__"
        cols[str(name)] = _pandas_column(df.index.to_numpy())
    table = Table(cols)
    return _make_dataset([lambda t=table: t])


def _pandas_column(arr: np.ndarray) -> Column:
    if arr.dtype.kind == "f":
        nan = np.isnan(arr)
        return Column(arr.dtype.name, arr, ~nan if nan.any() else None)
    if arr.dtype.kind == "O":
        return Column.from_values([
            None if v is None or (isinstance(v, float) and v != v) else v
            for v in arr])
    return Column.from_array(arr)


def from_numpy(arr: np.ndarray) -> Dataset:
    return from_items([{"data": row} for row in arr])


def read_parquet(paths, parallelism: int = 8) -> Dataset:
    _pyarrow("read_parquet")  # raise here, not in every read task
    files = _expand_paths(paths, (".parquet",))
    return _make_dataset([functools.partial(_read_parquet_file, f) for f in files])


def _read_parquet_file(path: str) -> Block:
    pq = _pyarrow("read_parquet").parquet
    return _from_arrow(pq.read_table(path))


def read_csv(paths, parallelism: int = 8) -> Dataset:
    files = _expand_paths(paths, (".csv",))
    return _make_dataset([functools.partial(_read_csv_file, f) for f in files])


# values pyarrow's CSV reader takes as null in a column that is not text
_CSV_NULLS = frozenset((
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "N/A", "NA", "NULL", "NaN", "n/a", "nan", "null"))
_CSV_TRUE = frozenset(("true", "True", "TRUE"))
_CSV_FALSE = frozenset(("false", "False", "FALSE"))


def _csv_column(cells: List[str]) -> Column:
    """One CSV column in the first type pyarrow's reader would take for
    all of its cells: null, int64, float64, bool, else string."""
    present = [c for c in cells if c not in _CSV_NULLS]
    if not present:
        return Column.from_values([None] * len(cells), "null")
    for typ, parse in (("int64", int), ("float64", float)):
        try:
            vals = [None if c in _CSV_NULLS else parse(c) for c in cells]
        except ValueError:
            continue
        if typ != "int64" or all(-(1 << 63) <= v < (1 << 63)
                                 for v in vals if v is not None):
            return Column.from_values(vals, typ)
    if all(c in _CSV_TRUE or c in _CSV_FALSE for c in present):
        return Column.from_values(
            [None if c in _CSV_NULLS else c in _CSV_TRUE for c in cells],
            "bool")
    return Column.from_values(cells, "string")


def _read_csv_file(path: str) -> Block:
    import csv

    with open(path, newline="") as f:
        records = list(csv.reader(f))
    if not records:
        return Table({})
    names, body = records[0], records[1:]
    return Table({name: _csv_column([r[i] if i < len(r) else ""
                                     for r in body])
                  for i, name in enumerate(names)})


def read_json(paths, parallelism: int = 8) -> Dataset:
    files = _expand_paths(paths, (".json", ".jsonl"))
    return _make_dataset([functools.partial(_read_json_file, f) for f in files])


def _read_json_file(path: str) -> Block:
    """Newline-delimited JSON objects; the columns are every key in the
    order first seen, as pyarrow's JSON reader makes them."""
    import json

    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    names: Dict[str, None] = {}
    for r in rows:
        for k in r:
            names.setdefault(k, None)
    return Table({k: Column.from_values([r.get(k) for r in rows])
                  for k in names})


def read_text(paths, parallelism: int = 8) -> Dataset:
    files = _expand_paths(paths, (".txt", ".text", ".log", ""))
    return _make_dataset([functools.partial(_read_text_file, f) for f in files])


def _read_text_file(path: str) -> Block:
    with open(path, "r", errors="replace") as f:
        return BlockAccessor.build_from_rows(
            [{"text": line.rstrip("\n")} for line in f])


def read_binary_files(paths, parallelism: int = 8) -> Dataset:
    files = _expand_paths(paths, ("",))
    return _make_dataset([functools.partial(_read_binary_file, f) for f in files])


def _read_binary_file(path: str) -> Block:
    with open(path, "rb") as f:
        return BlockAccessor.build_from_rows([{"path": path, "bytes": f.read()}])


def _expand_paths(paths, suffixes) -> List[str]:
    import os

    if isinstance(paths, str):
        paths = [paths]
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            files.extend(
                os.path.join(p, f) for f in sorted(os.listdir(p))
                if f.endswith(tuple(s for s in suffixes if s)) or "" in suffixes)
        else:
            files.append(p)
    if not files:
        raise FileNotFoundError(f"no files found for {paths}")
    return files
