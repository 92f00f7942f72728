"""Bucketed asynchronous gradient collectives and the cross-replica sharded
update: the port of ``ray_tpu/collective/bucketed.py``, on tensors.

The explicit-collective tier of the overlapped train step: a size-bounded
bucket plan over the gradient leaves, a reducer that runs each bucket's
collective on a background thread (so bucket i is reduced while the caller
produces bucket i+1 or applies bucket i-1's update), and a cross-replica
sharded optimizer (arxiv 2004.13336): each rank owns about 1/N of the
buckets, keeps optimizer state only for them, updates them, and broadcasts
the new values.

Trees are flat dicts keyed by flax path (``layer_0.attn.q_proj.kernel``),
the port's parameter layout. Their leaf order is the JAX package's:
``jax.tree_util.tree_flatten_with_path`` sorts dict keys at every level, so
``leaf_meta`` orders the paths by their dotted components (``layer_0``,
``layer_1``, ``layer_10``, ``layer_11``, ``layer_2``, ...), and a plan here
has the JAX plan's buckets, bytes, owners and leaf order.

Bucketing rule: leaves in that order are packed greedily into buckets of at
most ``bucket_bytes``; a leaf larger than the bound is a bucket of its own
(leaves are never split at this tier). Owners go greedily to the
least-loaded rank (ties to the lower rank).

The reduce of a bucket packs its same-dtype leaves into one vector. Without
a codec the vector's sum is the rank-ordered sum, as the JAX package's
collective store computes it: each rank receives every rank's copy of its
segment (an all-to-all), folds them in rank order, and the segments are
all-gathered; the bytes are a ring all-reduce's, and the result is the same
bits on every rank and for every algorithm the backend would pick. With a
codec the contribution is encoded with error feedback, and
``allreduce_quantized`` dequantizes every rank's payload, sums in fp32 in
rank order and encodes the sum once for the way back.

Every bucket lands as a ``train.bucket_allreduce`` span whose parent is the
span active where it was submitted, and in the
``ray_tpu.train.allreduce_seconds`` histogram.

On the card the reducer's thread runs on a side CUDA stream: it waits for an
event recorded on the submitter's stream, so it reads the gradients only
once they are written, and ``BucketHandle.result()`` makes the caller's
stream wait for the bucket's own event, so later work never reads a bucket
in flight. Its NCCL group must be dedicated to it, as the JAX package
requires of its group: collectives of other threads on the same group would
interleave with its own.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

_metrics_lock = threading.Lock()
_metrics: Optional[dict] = None

DEFAULT_BUCKET_BYTES = 32 << 20

Tree = Dict[str, torch.Tensor]


def _obs() -> dict:
    """The bucket collectives' metrics on the shared registry."""
    global _metrics
    with _metrics_lock:
        if _metrics is None:
            from ray_tpu_torch.util.metrics import Counter, Histogram

            _metrics = {
                "allreduce": Histogram(
                    "ray_tpu.train.allreduce_seconds",
                    "wall time of one grad-bucket collective (allreduce/"
                    "reduce/broadcast) on the async reducer thread",
                    boundaries=[0.0001, 0.001, 0.01, 0.1, 1, 10]),
                "bucket_bytes": Histogram(
                    "ray_tpu.train.bucket_bytes",
                    "payload bytes of one grad bucket shipped through the "
                    "collective layer",
                    boundaries=[1 << 10, 1 << 16, 1 << 20, 1 << 24, 1 << 28]),
                "buckets": Counter(
                    "ray_tpu.train.buckets_reduced",
                    "grad buckets reduced through the async bucketed "
                    "collective path"),
                "quant_saved": Counter(
                    "ray_tpu.train.quant_bytes_saved",
                    "wire bytes saved by the quantized collective tier vs "
                    "shipping fp32 on both legs (contribute + broadcast)"),
                "quant_encode": Histogram(
                    "ray_tpu.train.quant_encode_seconds",
                    "CPU time spent encoding/decoding one quantized bucket "
                    "payload (quantize + error-feedback + dequantize)",
                    boundaries=[0.00001, 0.0001, 0.001, 0.01, 0.1]),
            }
        return _metrics


@dataclass(frozen=True)
class Bucket:
    """One size-bounded group of gradient leaves reduced as a unit."""

    index: int
    paths: Tuple[str, ...]
    nbytes: int
    owner: int  # the rank that owns this bucket's optimizer shard


@dataclass
class BucketPlan:
    """The bucket partition of a gradient tree, in leaf order."""

    buckets: List[Bucket]
    bucket_bytes: int
    world_size: int
    leaf_order: Tuple[str, ...] = ()  # global leaf order (the clip's fold)

    @property
    def num_buckets(self) -> int:
        return len(self.buckets)

    def owned(self, rank: int) -> List[Bucket]:
        return [b for b in self.buckets if b.owner == rank]

    def total_bytes(self) -> int:
        return sum(b.nbytes for b in self.buckets)

    def bytes_per_rank(self) -> List[int]:
        out = [0] * self.world_size
        for b in self.buckets:
            out[b.owner] += b.nbytes
        return out

    def stats(self) -> Dict[str, Any]:
        sizes = [b.nbytes for b in self.buckets] or [0]
        return {
            "num_buckets": self.num_buckets,
            "bucket_bytes": self.bucket_bytes,
            "total_bytes": self.total_bytes(),
            "max_bucket_bytes": max(sizes),
            "min_bucket_bytes": min(sizes),
            "bytes_per_rank": self.bytes_per_rank(),
        }


def tree_order(paths) -> List[str]:
    """Flax paths in the JAX package's leaf order: sorted by their dotted
    components, as ``tree_flatten_with_path`` sorts dict keys at every
    level."""
    return sorted(paths, key=lambda p: tuple(p.split(".")))


def leaf_meta(tree: Mapping[str, Any]
              ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """``{path: (shape, dtype)}`` of every leaf (a tensor, or anything with
    a shape and a torch dtype), in the JAX package's leaf order."""
    return {p: (tuple(tree[p].shape), tree[p].dtype)
            for p in tree_order(tree)}


def plan_buckets(meta: Mapping[str, Tuple[Tuple[int, ...], torch.dtype]],
                 bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                 world_size: int = 1) -> BucketPlan:
    """Pack the leaves (in the given order) into size-bounded buckets: small
    leaves fill a bucket until the next would pass ``bucket_bytes``; a leaf
    larger than the bound is a bucket of its own; owners balance bytes
    greedily across ``world_size`` ranks."""
    if bucket_bytes <= 0:
        raise ValueError(f"bucket_bytes must be positive, got {bucket_bytes}")
    groups: List[Tuple[List[str], int]] = []
    cur: List[str] = []
    cur_bytes = 0
    for path, (shape, dtype) in meta.items():
        nbytes = math.prod(shape) * dtype.itemsize
        if cur and cur_bytes + nbytes > bucket_bytes:
            groups.append((cur, cur_bytes))
            cur, cur_bytes = [], 0
        cur.append(path)
        cur_bytes += nbytes
        if cur_bytes >= bucket_bytes:  # a giant leaf or a full pack
            groups.append((cur, cur_bytes))
            cur, cur_bytes = [], 0
    if cur:
        groups.append((cur, cur_bytes))
    load = [0] * max(world_size, 1)
    buckets = []
    for i, (paths, nbytes) in enumerate(groups):
        owner = min(range(len(load)), key=lambda r: (load[r], r))
        load[owner] += nbytes
        buckets.append(Bucket(index=i, paths=tuple(paths), nbytes=nbytes,
                              owner=owner))
    return BucketPlan(buckets=buckets, bucket_bytes=bucket_bytes,
                      world_size=max(world_size, 1),
                      leaf_order=tuple(meta.keys()))


Packed = List[Tuple[torch.dtype, torch.Tensor, List[Tuple[str, tuple]]]]


def _pack(leaves: Mapping[str, torch.Tensor]) -> Packed:
    """Same-dtype leaves concatenated into flat vectors (one collective a
    dtype, not one a leaf), in first-seen dtype order."""
    by_dtype: Dict[torch.dtype, list] = {}
    for path, x in leaves.items():
        by_dtype.setdefault(x.dtype, []).append((path, x))
    return [(dtype, torch.cat([x.reshape(-1) for _, x in items]),
             [(p, tuple(x.shape)) for p, x in items])
            for dtype, items in by_dtype.items()]


def _unpack(packed: Packed) -> Tree:
    out = {}
    for _, flat, layout in packed:
        off = 0
        for path, shape in layout:
            n = math.prod(shape)
            out[path] = flat[off:off + n].reshape(shape)
            off += n
    return out


def rank_ordered_allreduce(group, flat: torch.Tensor) -> torch.Tensor:
    """The sum over ``group`` of a flat vector, folded in rank order
    (``((x_0 + x_1) + x_2) + ...``) on every rank: an all-to-all hands each
    rank every rank's copy of its segment, the rank folds them, and the
    folded segments are all-gathered. A ring all-reduce's bytes, with the
    JAX package's store sum, bit for bit."""
    n = group.world_size
    if n == 1:
        return flat.clone()
    length = flat.numel()
    seg = -(-length // n)
    x = torch.nn.functional.pad(flat, (0, n * seg - length))
    rows = group.alltoall(x).reshape(n, seg)
    acc = rows[0]
    for row in rows[1:]:
        acc = acc + row
    return group.allgather(acc)[:length]


def _is_float(dtype: torch.dtype) -> bool:
    return dtype.is_floating_point


class BucketHandle:
    """The future of one submitted bucket collective."""

    def __init__(self, bucket: Bucket):
        self.bucket = bucket
        self._done = threading.Event()
        self._result: Optional[Tree] = None
        self._error: Optional[BaseException] = None
        self._event = None  # CUDA: recorded on the reducer's stream

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: float = 300.0) -> Tree:
        """The bucket's reduced leaves; raises what the collective raised.
        On the card the caller's stream then waits for the bucket."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"bucket {self.bucket.index} collective did not complete "
                f"within {timeout}s")
        if self._error is not None:
            raise self._error
        if self._event is not None:
            stream = torch.cuda.current_stream()
            stream.wait_event(self._event)
            for x in self._result.values():
                x.record_stream(stream)
        return self._result

    def _set(self, result=None, error=None, event=None):
        self._result, self._error, self._event = result, error, event
        self._done.set()


class AsyncBucketReducer:
    """Reduce gradient buckets over the collective group ``group_name`` on a
    background thread, in submission order (every rank must submit the same
    buckets in the same order).

    The group must be dedicated to this reducer: other collectives on it
    from other threads would interleave with the reducer's. ``average``
    divides the sums by the world size; ``compression`` (a codec spec, see
    ``quant.resolve_codec``) sends float buckets quantized, with error
    feedback kept per bucket and dtype."""

    def __init__(self, group_name: str, plan: BucketPlan, *,
                 average: bool = False, compression: Any = None):
        from ray_tpu_torch import collective as col
        from ray_tpu_torch.collective.quant import (ErrorFeedback,
                                                    resolve_codec)

        self.group_name = group_name
        self.group = col.get_group(group_name)
        self.plan = plan
        self.average = average
        self.codec = resolve_codec(compression)
        self._ef = ErrorFeedback(self.codec) if self.codec else None
        self._cuda = self.group.device.type == "cuda"
        self._stream = (torch.cuda.Stream(self.group.device) if self._cuda
                        else None)
        self._wire_lock = threading.Lock()
        self._wire = {"bytes_fp32_equiv": 0, "bytes_wire": 0,
                      "buckets_quantized": 0, "encode_s": 0.0}
        self._queue: List[tuple] = []
        self._cv = threading.Condition()
        self._stop = False
        self._thread = threading.Thread(
            target=self._run, name=f"bucket-reducer-{group_name}", daemon=True)
        self._thread.start()

    # -- submission ----------------------------------------------------------

    def submit(self, bucket: Bucket, leaves: Mapping[str, torch.Tensor]
               ) -> BucketHandle:
        """Queue one bucket's reduce and return at once; the caller goes on
        computing while the collective runs."""
        from ray_tpu_torch.util import tracing

        handle = BucketHandle(bucket)
        ctx = tracing.current_context()
        ready = None
        if self._cuda:  # the gradients are written on the caller's stream
            ready = torch.cuda.Event()
            ready.record()
        with self._cv:
            if self._stop:
                raise RuntimeError("reducer is shut down")
            self._queue.append((bucket, dict(leaves), ctx, ready, handle))
            self._cv.notify()
        return handle

    def reduce_tree(self, tree: Mapping[str, torch.Tensor],
                    timeout: float = 300.0) -> Tree:
        """Submit every bucket of the plan from a whole gradient tree, wait
        for all, and give the reduced tree (in the tree's key order)."""
        handles = [self.submit(b, {p: tree[p] for p in b.paths})
                   for b in self.plan.buckets]
        reduced: Tree = {}
        for h in handles:
            reduced.update(h.result(timeout))
        return {k: reduced[k] for k in tree}

    # -- the worker ----------------------------------------------------------

    def _run(self):
        while True:
            with self._cv:
                while not self._queue and not self._stop:
                    self._cv.wait(1.0)
                if self._stop and not self._queue:
                    return
                bucket, leaves, ctx, ready, handle = self._queue.pop(0)
            try:
                if self._cuda:
                    with torch.cuda.stream(self._stream):
                        self._stream.wait_event(ready)
                        for x in leaves.values():
                            x.record_stream(self._stream)
                        result = self._reduce(bucket, leaves, ctx)
                        done = torch.cuda.Event()
                        done.record(self._stream)
                    handle._set(result=result, event=done)
                else:
                    handle._set(result=self._reduce(bucket, leaves, ctx))
            except BaseException as e:  # surfaced by handle.result()
                handle._set(error=e)

    def _sync(self) -> None:
        """Wait for the reducer's stream (on the card), so that host clocks
        bound the work."""
        if self._cuda:
            self._stream.synchronize()

    def _reduce(self, bucket: Bucket, leaves: Tree, ctx) -> Tree:
        from ray_tpu_torch.util import tracing

        obs = _obs()
        t0 = time.time()
        out = []
        wire_up = wire_down = 0
        for dtype, flat, layout in _pack(leaves):
            if self.codec is not None and _is_float(dtype):
                reduced, up, down = self._reduce_quantized(bucket, dtype,
                                                           flat)
                reduced = reduced.to(dtype)
                wire_up += up
                wire_down += down
            else:
                reduced = rank_ordered_allreduce(self.group, flat)
            if self.average:
                reduced = reduced / self.plan.world_size
            out.append((dtype, reduced, layout))
        result = _unpack(out)
        self._sync()
        end = time.time()
        span_extra = {}
        if self.codec is not None:
            span_extra = {"compression": self.codec.name,
                          "wire_bytes": wire_up + wire_down}
        tracing.record_span(
            "train.bucket_allreduce", t0, end, category="train",
            trace_id=ctx[0] if ctx else tracing.new_trace_id(),
            span_id=tracing.new_span_id(),
            parent_id=ctx[1] if ctx else None,
            bucket=bucket.index, nbytes=bucket.nbytes, owner=bucket.owner,
            leaves=len(bucket.paths), **span_extra)
        obs["allreduce"].observe(end - t0)
        obs["bucket_bytes"].observe(bucket.nbytes)
        obs["buckets"].inc()
        return result

    def _reduce_quantized(self, bucket: Bucket, dtype: torch.dtype,
                          flat: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
        """One dtype vector's quantized allreduce: the error-fed encode of
        the contribution, the fp32 dequantize-and-sum in rank order, and the
        decode of the sum encoded once."""
        from ray_tpu_torch.collective import quant

        obs = _obs()
        t0 = time.perf_counter()
        qt = self._ef.encode((bucket.index, str(dtype)), flat)
        wire = quant.to_wire(qt)
        self._sync()
        enc_s = time.perf_counter() - t0
        out_wire = self.group.allreduce_quantized(wire, self.codec)
        self._sync()
        t1 = time.perf_counter()
        reduced = quant.dequantize(quant.from_wire(out_wire)).float()
        self._sync()
        enc_s += time.perf_counter() - t1
        up, down = quant.wire_nbytes(wire), quant.wire_nbytes(out_wire)
        fp32_equiv = flat.numel() * 4 * 2
        obs["quant_encode"].observe(enc_s)
        obs["quant_saved"].inc(max(fp32_equiv - (up + down), 0))
        with self._wire_lock:
            self._wire["bytes_fp32_equiv"] += fp32_equiv
            self._wire["bytes_wire"] += up + down
            self._wire["buckets_quantized"] += 1
            self._wire["encode_s"] += enc_s
        return reduced, up, down

    def wire_stats(self) -> Dict[str, Any]:
        """The quantized path's wire bytes so far, both legs, beside what the
        same traffic costs in fp32 (``bytes_fp32_equiv``)."""
        with self._wire_lock:
            s = dict(self._wire)
        s["compression"] = self.codec.name if self.codec else None
        if s["bytes_wire"]:
            s["wire_reduction_x"] = round(
                s["bytes_fp32_equiv"] / s["bytes_wire"], 2)
        return s

    def shutdown(self, timeout: float = 30.0):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout)


def init_sharded_optimizer_groups(world_size: int, rank: int,
                                  backend: Optional[str] = None,
                                  base_name: str = "train.grads",
                                  device=None,
                                  init_method: Optional[str] = None) -> str:
    """The two collective groups a ``ShardedBucketOptimizer`` uses in this
    process: ``base_name`` (the reducer's own) and ``base_name + ".norm"``
    (the clip's all-gather and the broadcasts, on the caller's thread).
    ``device`` and ``init_method`` as ``init_collective_group`` takes
    them."""
    from ray_tpu_torch import collective as col

    for name in (base_name, f"{base_name}.norm"):
        col.init_collective_group(world_size, rank, backend=backend,
                                  group_name=name, device=device,
                                  init_method=init_method)
    return base_name


class ShardedBucketOptimizer:
    """The cross-replica sharded update over a bucket plan (the
    multi-controller tier of arxiv 2004.13336).

    Rank r keeps optimizer state only for the buckets it owns. One
    ``step``:

    1. every bucket's gradients are reduced (``AsyncBucketReducer``, in
       order, on its thread);
    2. the coordinated clip: owners take each owned leaf's sum of squares,
       the per-leaf sums are all-gathered in one vector by global leaf
       index and folded in leaf order on every rank, so every rank scales
       by the same factor;
    3. owners update their buckets (``optimizer``, bucket by bucket);
    4. owners broadcast the new values: fp32, or with a codec the
       quantized change (new - old) with error feedback, which every rank,
       the owner too, adds to its copy, so the ranks stay identical.

    ``optimizer`` is the port's per-leaf optimizer, ``parallel.AdamW``
    built with ``clip=None`` (``make_optimizer(clip=None)``: the JAX
    package's adamw without its clip; with ``weight_decay=0``, ``b2=0.999``
    and no warmup it is ``optax.adam``'s algebra, which the JAX class is
    given in its tests). A clip inside it would take each bucket's norm, so
    it is refused; ``clip_global_norm`` takes the global one. ``params``
    is a flat dict by flax path; the ranks must pass the same values."""

    def __init__(self, group_name: str, plan: BucketPlan, rank: int,
                 optimizer, params: Mapping[str, torch.Tensor], *,
                 clip_global_norm: Optional[float] = None,
                 grad_scale: float = 1.0, compression: Any = None):
        from ray_tpu_torch import collective as col
        from ray_tpu_torch.collective.quant import (ErrorFeedback,
                                                    resolve_codec)

        if getattr(optimizer, "clip", None) is not None:
            raise ValueError("the per-leaf optimizer must not clip (its "
                             "clip would take each bucket's norm); pass "
                             "clip_global_norm=")
        self.group_name = group_name
        self.plan = plan
        self.rank = rank
        self.optimizer = optimizer
        self.clip = clip_global_norm
        self.grad_scale = grad_scale
        self.codec = resolve_codec(compression)
        self._bcast_ef = ErrorFeedback(self.codec) if self.codec else None
        self._norm_group = col.get_group(f"{group_name}.norm")
        self._paths = tree_order(params)
        self._leaf_idx = {p: i for i, p in enumerate(self._paths)}
        self._by_path: Tree = {p: params[p].detach().clone()
                               for p in self._paths}
        self.opt_state = {b.index: optimizer.init(self._subtree(b))
                          for b in plan.owned(rank)}
        self._reducer = AsyncBucketReducer(group_name, plan,
                                           compression=compression)

    def _subtree(self, bucket: Bucket) -> Tree:
        return {p: self._by_path[p] for p in bucket.paths}

    def opt_state_bytes(self) -> int:
        return sum(x.numel() * x.element_size()
                   for state in self.opt_state.values()
                   for moments in (state.mu, state.nu)
                   for x in moments.values())

    def step(self, grads: Mapping[str, torch.Tensor]
             ) -> Tuple[Tree, Dict[str, Any]]:
        """One sharded update from this rank's local gradients (summed over
        the ranks by the reducer; ``grad_scale`` multiplies the sums, 1 /
        world for a mean). Returns the new parameters (the same on every
        rank) and the step's stats."""
        if set(grads) != set(self._paths):
            raise ValueError("grad tree does not match the param tree the "
                             "sharded optimizer was built over")
        t0 = time.perf_counter()
        handles = [self._reducer.submit(b, {p: grads[p] for p in b.paths})
                   for b in self.plan.buckets]
        reduced: Dict[int, Tree] = {}
        for h in handles:
            res = h.result()
            if self.grad_scale != 1.0:
                res = {p: x * self.grad_scale for p, x in res.items()}
            reduced[h.bucket.index] = res
        allreduce_s = time.perf_counter() - t0
        device = self._norm_group.device
        scale = torch.ones((), device=device)
        gnorm = None
        owned = self.plan.owned(self.rank)
        if self.clip is not None:
            # each owner's per-leaf sums of squares, gathered and folded in
            # leaf order: every rank computes the same factor
            local = torch.zeros(len(self._paths), device=device)
            for b in owned:
                for p in b.paths:
                    local[self._leaf_idx[p]] = torch.sum(torch.square(
                        reduced[b.index][p].float()))
            gathered = self._norm_group.allgather(local).reshape(
                self._norm_group.world_size, -1)
            per_leaf = gathered.sum(dim=0)  # disjoint: the sum is the union
            acc = per_leaf[0]
            for v in per_leaf[1:]:
                acc = acc + v
            gnorm = torch.sqrt(acc)
            scale = self.clip / torch.clamp(gnorm, min=self.clip)
        t1 = time.perf_counter()
        updated: Tree = {}
        for b in owned:
            g = [(reduced[b.index][p] * scale).to(reduced[b.index][p].dtype)
                 for p in b.paths]
            new = {p: self._by_path[p].clone() for p in b.paths}
            self.optimizer.update(new, g, self.opt_state[b.index])
            updated.update(new)
        optimizer_s = time.perf_counter() - t1
        t2 = time.perf_counter()
        bcast_wire = bcast_fp32 = 0
        for b in self.plan.buckets:
            if self.codec is not None:
                up, down = self._broadcast_bucket_quantized(b, updated)
                bcast_wire += up + down
                bcast_fp32 += b.nbytes
                continue
            src = updated if b.owner == self.rank else self._by_path
            out = [(dtype, self._norm_group.broadcast(flat, b.owner), layout)
                   for dtype, flat, layout in _pack(
                       {p: src[p] for p in b.paths})]
            self._by_path.update(_unpack(out))
        broadcast_s = time.perf_counter() - t2
        stats = {
            "allreduce_s": allreduce_s,
            "optimizer_s": optimizer_s,
            "broadcast_s": broadcast_s,
            "grad_norm": None if gnorm is None else float(gnorm),
            "clip_scale": float(scale),
            "opt_state_bytes": self.opt_state_bytes(),
            "owned_buckets": sorted(b.index for b in owned),
        }
        if self.codec is not None:
            stats["compression"] = self.codec.name
            stats["broadcast_wire_bytes"] = bcast_wire
            stats["broadcast_fp32_bytes"] = bcast_fp32
            stats["reduce_wire"] = self._reducer.wire_stats()
        return dict(self._by_path), stats

    def _broadcast_bucket_quantized(self, bucket: Bucket, updated: Tree
                                    ) -> Tuple[int, int]:
        """The compressed refresh of one bucket: the owner encodes the
        change of its float leaves (new - old, fp32) with error feedback
        and broadcasts codes and scales; every rank, the owner too, adds the
        decoded change to its copy. Other leaves go as they are. Returns
        the bytes this rank sent and received."""
        from ray_tpu_torch.collective import quant

        group = self._norm_group
        float_paths = [p for p in bucket.paths
                       if _is_float(self._by_path[p].dtype)]
        raw_paths = [p for p in bucket.paths if p not in set(float_paths)]
        mine = bucket.owner == self.rank
        n = sum(self._by_path[p].numel() for p in float_paths)
        enc_s = 0.0
        up = down = 0
        if float_paths:
            t0 = time.perf_counter()
            if mine:
                deltas = torch.cat([(updated[p].float()
                                     - self._by_path[p].float()).reshape(-1)
                                    for p in float_paths])
                qt = self._bcast_ef.encode(("bcast", bucket.index), deltas)
                codes, scales = qt.codes, qt.scales
            else:  # the sizes follow from the codec and the leaves
                per = 2 if self.codec.name == "bf16" else 1
                nb = 0 if self.codec.name == "bf16" else max(
                    1, -(-n // self.codec.block))
                codes = torch.empty(per * n, dtype=torch.uint8,
                                    device=group.device)
                scales = torch.empty(nb, dtype=torch.float32,
                                     device=group.device)
            enc_s += time.perf_counter() - t0
            codes = group.broadcast(codes, bucket.owner)
            scales = group.broadcast(scales, bucket.owner)
            t1 = time.perf_counter()
            nbytes = codes.numel() + 4 * scales.numel()
            down += nbytes
            up += nbytes if mine else 0
            delta = quant.dequantize(quant.QuantizedTensor(
                self.codec.name, self.codec.block, (n,), "float32", codes,
                scales))
            off = 0
            for p in float_paths:
                base = self._by_path[p]
                k = base.numel()
                self._by_path[p] = (base.float() + delta[off:off + k]
                                    .reshape(base.shape)).to(base.dtype)
                off += k
            enc_s += time.perf_counter() - t1
        for p in raw_paths:
            src = updated[p] if mine else self._by_path[p]
            self._by_path[p] = group.broadcast(src, bucket.owner)
            nbytes = src.numel() * src.element_size()
            down += nbytes
            up += nbytes if mine else 0
        obs = _obs()
        obs["quant_encode"].observe(enc_s)
        # float leaves would go at 4 bytes a value; the others at their own
        fp32 = 4 * n + sum(self._by_path[p].numel()
                           * self._by_path[p].element_size()
                           for p in raw_paths)
        obs["quant_saved"].inc(max(fp32 - down, 0))
        return up, down

    def shutdown(self):
        self._reducer.shutdown()


__all__ = ["AsyncBucketReducer", "Bucket",
           "BucketHandle", "BucketPlan", "DEFAULT_BUCKET_BYTES",
           "ShardedBucketOptimizer", "init_sharded_optimizer_groups",
           "leaf_meta", "plan_buckets", "rank_ordered_allreduce",
           "tree_order"]
