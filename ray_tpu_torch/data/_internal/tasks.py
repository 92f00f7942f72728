"""Remote task bodies for the data layer (execute on workers), the port of
``ray_tpu/data/_internal/tasks.py``.

Reference: the fused map transform of
python/ray/data/_internal/planner/plan_udf_map_op.py and the two-phase
shuffle tasks of operators/hash_shuffle.py. Every map-family task returns
``(block, meta)`` where meta is a small dict — the executor waits on the
meta ref (inlined into the owner's memory store) for completion/stats and
streams the block ref downstream without fetching it. These tasks load
neither torch nor CUDA: a map task holds no ``GPU`` lease."""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

import ray_tpu_torch
# driver-authored UDF/spec blobs: every decode goes through the audited
# serialization boundary
from ray_tpu_torch._private.serialization import loads_trusted
from ray_tpu_torch.data.block import Block, BlockAccessor


def _meta(block: Block, t0: float) -> dict:
    acc = BlockAccessor(block)
    return {"rows": acc.num_rows(), "bytes": acc.size_bytes(),
            "wall_s": time.perf_counter() - t0}


def apply_chain(block: Block, chain: List[tuple], init_state: dict) -> Block:
    """Run a fused chain of (kind, fn, batch_size) stages over one block.
    ``fn`` entries may be callables or constructed-class instances from
    ``init_state`` (actor-pool path)."""
    for kind, fn, batch_size in chain:
        if isinstance(fn, str):  # class-UDF: look up the constructed instance
            fn = init_state[fn]
        acc = BlockAccessor(block)
        if kind == "map_rows":
            block = BlockAccessor.build_from_rows([fn(r) for r in acc.to_rows()])
        elif kind == "flat_map":
            out: List[Any] = []
            for r in acc.to_rows():
                out.extend(fn(r))
            block = BlockAccessor.build_from_rows(out)
        elif kind == "filter":
            block = BlockAccessor.build_from_rows(
                [r for r in acc.to_rows() if fn(r)])
        elif kind == "map_batches":
            n = acc.num_rows()
            bs = batch_size or n or 1
            rows: List[Any] = []
            arrow_parts = []
            for start in range(0, n, bs):
                batch = BlockAccessor(acc.slice(start, min(start + bs, n))).to_batch()
                result = fn(batch)
                part = (BlockAccessor.build_from_batch(result)
                        if isinstance(result, dict)
                        else BlockAccessor.build_from_rows(list(result)))
                arrow_parts.append(part)
            if len(arrow_parts) == 1:
                block = arrow_parts[0]
            else:
                rows = []
                for p in arrow_parts:
                    rows.extend(BlockAccessor(p).to_rows())
                block = BlockAccessor.build_from_rows(rows)
        else:
            raise ValueError(f"unknown stage kind {kind!r}")
    return block


@ray_tpu_torch.remote
def map_block(chain_blob: bytes, block: Block) -> Tuple[Block, dict]:
    t0 = time.perf_counter()
    chain = loads_trusted(chain_blob)
    out = apply_chain(block, chain, {})
    return out, _meta(out, t0)


@ray_tpu_torch.remote
def read_block(thunk_blob: bytes) -> Tuple[Block, dict]:
    t0 = time.perf_counter()
    thunk = loads_trusted(thunk_blob)
    out = thunk()
    return out, _meta(out, t0)


@ray_tpu_torch.remote
class MapWorker:
    """Actor-pool map worker: holds constructed class-UDF instances
    (reference: ActorPoolMapOperator's _MapWorker)."""

    def __init__(self, ctors_blob: bytes):
        ctors: Dict[str, tuple] = loads_trusted(ctors_blob)
        self._state = {name: cls(*args, **kwargs)
                       for name, (cls, args, kwargs) in ctors.items()}

    def map_block(self, chain_blob: bytes, block: Block) -> Tuple[Block, dict]:
        t0 = time.perf_counter()
        chain = loads_trusted(chain_blob)
        out = apply_chain(block, chain, self._state)
        return out, _meta(out, t0)

    def ping(self) -> bool:
        return True


# ---------------------------------------------------------------------------
# all-to-all phase tasks (hash shuffle / sort / repartition)
# ---------------------------------------------------------------------------


@ray_tpu_torch.remote
def shuffle_map(block: Block, part_fn_blob: bytes, num_parts: int) -> List[Block]:
    """Partition one block into ``num_parts`` sub-blocks (hash/range/random).
    Returns a list-block of sub-blocks (kept as ONE object; the reduce task
    indexes into it) — avoids num_returns fan-out on the object store."""
    part_fn = loads_trusted(part_fn_blob)
    acc = BlockAccessor(block)
    rows = acc.to_rows()
    parts: List[List[Any]] = [[] for _ in range(num_parts)]
    for r in rows:
        parts[part_fn(r) % num_parts].append(r)
    return [BlockAccessor.build_from_rows(p) for p in parts]


@ray_tpu_torch.remote
def shuffle_reduce(reduce_fn_blob: bytes, part_index: int,
                   *map_outputs: List[Block]) -> Tuple[Block, dict]:
    """Concatenate partition ``part_index`` from every map output and apply
    the reduce fn (sort slice, aggregate, identity...)."""
    t0 = time.perf_counter()
    reduce_fn = loads_trusted(reduce_fn_blob)
    rows: List[Any] = []
    for parts in map_outputs:
        rows.extend(BlockAccessor(parts[part_index]).to_rows())
    out = reduce_fn(rows)
    block = BlockAccessor.build_from_rows(out) if isinstance(out, list) else out
    return block, _meta(block, t0)


@ray_tpu_torch.remote
def sample_boundaries(key_blob: bytes, num_parts: int,
                      *blocks: Block) -> List[Any]:
    """Sample sort keys to pick range-partition boundaries."""
    key = loads_trusted(key_blob)
    samples: List[Any] = []
    for b in blocks:
        rows = BlockAccessor(b).to_rows()
        step = max(1, len(rows) // 64)
        samples.extend(key(r) for r in rows[::step])
    samples.sort()
    if not samples:
        return [None] * (num_parts - 1)
    return [samples[int(len(samples) * i / num_parts)]
            for i in range(1, num_parts)]


@ray_tpu_torch.remote
def join_reduce(join_spec_blob: bytes, part_index: int,
                left_outputs_count: int,
                *map_outputs: List[Block]) -> Tuple[Block, dict]:
    """Hash-join one partition: the first ``left_outputs_count`` map outputs
    are the left side, the rest the right (reference: joins ride the same
    hash shuffle as groupby — operators/join.py)."""
    t0 = time.perf_counter()
    on, how, suffix = loads_trusted(join_spec_blob)
    left_rows: List[dict] = []
    right_rows: List[dict] = []
    for i, parts in enumerate(map_outputs):
        rows = BlockAccessor(parts[part_index]).to_rows()
        (left_rows if i < left_outputs_count else right_rows).extend(rows)
    index: Dict[Any, List[dict]] = {}
    for r in right_rows:
        index.setdefault(r.get(on), []).append(r)
    out: List[dict] = []
    matched_right = set()
    for l in left_rows:
        matches = index.get(l.get(on), [])
        if matches:
            for r in matches:
                matched_right.add(id(r))
                merged = dict(l)
                for k, v in r.items():
                    if k == on:
                        continue
                    merged[k + suffix if k in l and k != on else k] = v
                out.append(merged)
        elif how in ("left", "outer"):
            out.append(dict(l))
    if how in ("right", "outer"):
        for r in right_rows:
            if id(r) not in matched_right:
                out.append(dict(r))
    block = BlockAccessor.build_from_rows(out)
    return block, _meta(block, t0)


@ray_tpu_torch.remote
def zip_aligned(left: Block, spans_blob: bytes,
                *right_blocks: Block) -> Tuple[Block, dict]:
    """Zip one left block against the right-side row ranges covering it
    ((skip, take) per right block, planned from row counts)."""
    t0 = time.perf_counter()
    spans: List[Tuple[int, int]] = loads_trusted(spans_blob)
    lrows = BlockAccessor(left).to_rows()
    rrows: List[Any] = []
    for rb, (skip, take) in zip(right_blocks, spans):
        rrows.extend(BlockAccessor(rb).to_rows()[skip:skip + take])
    if len(lrows) != len(rrows):
        raise ValueError(
            f"zip alignment bug: {len(lrows)} left vs {len(rrows)} right rows")
    out = []
    for l, r in zip(lrows, rrows):
        merged = dict(l) if isinstance(l, dict) else {"left": l}
        rd = r if isinstance(r, dict) else {"right": r}
        for k, v in rd.items():
            merged[k if k not in merged else k + "_right"] = v
        out.append(merged)
    block = BlockAccessor.build_from_rows(out)
    return block, _meta(block, t0)


@ray_tpu_torch.remote
def slice_block(block: Block, start: int, end: int) -> Tuple[Block, dict]:
    t0 = time.perf_counter()
    out = BlockAccessor(block).slice(start, end)
    return out, _meta(out, t0)


@ray_tpu_torch.remote
def write_block(block: Block, write_fn_blob: bytes,
                index: int) -> Tuple[Block, dict]:
    t0 = time.perf_counter()
    write_fn = loads_trusted(write_fn_blob)
    path = write_fn(block, index)
    out = BlockAccessor.build_from_rows([{"path": path}])
    return out, _meta(out, t0)
