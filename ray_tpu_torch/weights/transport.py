"""Transport tier: lower a TransferPlan onto real data movement. The port
of ``ray_tpu/weights/transport.py``'s object-plane and collective tiers.

- **Object plane** (:func:`publish_host_shards` / ``WeightStore.pull_shards``):
  the general cross-mesh path. Each source host cuts exactly the plan's
  intersection chunks out of its resident shards and publishes them through
  the store; destination hosts pull only the chunks overlapping their boxes.
  Owner-tracked refs ride the normal object plane (chunked, spillable,
  location-directed) — no host ever sees a gathered array.

- **Collective tier** (:func:`collective_reshard`): when src and dst are the
  SAME mesh (same hosts), edges lower to point-to-point transfers over a
  ``TorchGroup`` (``collective/collective_group.py`` ``send``/``recv``:
  gloo on the CPU, NCCL on the card) and the store is never touched.

The JAX package's third tier, ``jax_reshard`` (one ``jax.device_put`` of a
live tree onto a new sharding of one process's devices), stands on live
devices in one process: it goes with the compiled-DAG slice (ROADMAP.md),
and calling it raises until then. ``reshard_lowering_stats`` counts that
tier's outcomes, so its counters stay 0 here.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from ray_tpu_torch.weights.plan import (
    RedistributionProgram,
    TransferPlan,
    maybe_lower_collective,
    plan_reshard,
)
from ray_tpu_torch.weights.spec import (
    Box,
    ShardedTreeSpec,
    box_slices,
    flatten_tree,
    host_boxes,
    rel_slices,
    unflatten_tree,
    unique_boxes,
)
from ray_tpu_torch.weights.store import (WeightStore, _as_numpy, _chunk_key,
                                         _tensor)


def local_shards_of(tree: Any, spec: ShardedTreeSpec, host: str
                    ) -> Dict[str, Dict[Box, np.ndarray]]:
    """Cut ``host``'s resident shards out of a locally-held full tree.
    Test/bootstrap convenience — in SPMD deployments each host already holds
    only its shards and passes them directly."""
    _, leaves = flatten_tree(tree)
    out: Dict[str, Dict[Box, np.ndarray]] = {}
    for leaf, value in leaves.items():
        arr = _as_numpy(value)
        shape, _ = spec.meta[leaf]
        out[leaf] = {box: arr[box_slices(box)]
                     for box in host_boxes(spec.mesh, spec.part_of(leaf),
                                           arr.shape, host)}
    return out


def _cut(chunk_box: Box, src_box: Box, shard: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(shard[rel_slices(chunk_box, src_box)])


def publish_host_shards(store: WeightStore, version: int,
                        spec: ShardedTreeSpec, host: str,
                        shards: Dict[str, Dict[Box, np.ndarray]],
                        *, skeleton: Any = None,
                        dst_spec: Optional[ShardedTreeSpec] = None,
                        durable: bool = False,
                        timeout: float = 300.0,
                        delta_from: Optional[int] = None,
                        compression=None) -> int:
    """One source host's side of a mesh publish.

    Every host of ``spec.mesh`` calls this with the same ``version``; the
    store commits once all expected chunks arrive. With ``dst_spec`` the
    plan's exact intersection chunks are published (minimal bytes for a
    known destination); without it, the host's unique shard boxes are
    published as-is (subscriber-agnostic; consumers slice on pull).

    ``delta_from``/``compression`` behave as in :meth:`WeightStore.publish`
    (each host deltas its own chunk set against the base manifest;
    quantized encodings land per chunk in the shared manifest).

    Returns the number of chunks this host contributed.
    """
    if skeleton is None:
        skeleton = {leaf: leaf for leaf in sorted(spec.meta)}
    if dst_spec is not None:
        plan = plan_reshard(spec, dst_spec)
        mine: Dict[str, np.ndarray] = {}
        for e in plan.sends_from(host):
            key = _chunk_key(e.leaf, e.box)
            if key in mine:
                continue
            mine[key] = _cut(e.box, e.src_box, shards[e.leaf][e.src_box])
        # chunk count must be identical on every publisher: the full set of
        # distinct non-local chunk keys, plus local-only chunks a dst host
        # already holds (those never cross, so they are NOT published;
        # consumers satisfy them from their own shards)
        expected = len({e.chunk_key() for e in plan.edges if not e.local})
    else:
        mine = {}
        for leaf, boxes in shards.items():
            grid = unique_boxes(spec.mesh, spec.part_of(leaf),
                                spec.meta[leaf][0])
            for box, arr in boxes.items():
                # first replica holder publishes; others stand down
                if grid.get(box, (host,))[0] != host:
                    continue
                mine[_chunk_key(leaf, box)] = np.ascontiguousarray(arr)
        expected = sum(len(unique_boxes(spec.mesh, spec.part_of(leaf),
                                        spec.meta[leaf][0]))
                       for leaf in spec.meta)
    store._publish_chunks(version, skeleton, spec, mine,
                          num_chunks=expected, durable=durable,
                          timeout=timeout, delta_from=delta_from,
                          compression=compression)
    return len(mine)


def pull_with_locals(store: WeightStore, version: Optional[int],
                     src_spec: ShardedTreeSpec, dst_spec: ShardedTreeSpec,
                     host: str,
                     local: Dict[str, Dict[Box, np.ndarray]],
                     timeout: float = 300.0
                     ) -> Dict[str, Dict[Box, np.ndarray]]:
    """Destination-side assembly when this host is ALSO a source host (a
    same-cluster reshard): plan-local chunks are copied from ``local``
    shards, only the rest is pulled from the store."""
    plan = plan_reshard(src_spec, dst_spec)
    pulled = store.pull_shards(dst_spec, host, version, timeout=timeout)
    for e in plan.locals_on(host):
        shard = pulled[e.leaf][e.dst_box]
        shard[rel_slices(e.box, e.dst_box)] = \
            local[e.leaf][e.src_box][rel_slices(e.box, e.src_box)]
    return pulled


# ---------------------------------------------------------------------------
# Collective tier: same-mesh reshard without touching the store
# ---------------------------------------------------------------------------


def _alloc_dst(plan: TransferPlan, host: str
               ) -> Dict[str, Dict[Box, np.ndarray]]:
    out: Dict[str, Dict[Box, np.ndarray]] = {}
    for leaf, (shape, dtype) in plan.dst.meta.items():
        out[leaf] = {
            dbox: np.empty(tuple(b - a for a, b in dbox),
                           dtype=np.dtype(dtype))
            for dbox in host_boxes(plan.dst.mesh, plan.dst.part_of(leaf),
                                   shape, host)}
    return out


def _fill_locals(plan: TransferPlan, host: str,
                 shards: Dict[str, Dict[Box, np.ndarray]],
                 out: Dict[str, Dict[Box, np.ndarray]]) -> None:
    for e in plan.edges:
        if e.local and e.dst_host == host:
            out[e.leaf][e.dst_box][rel_slices(e.box, e.dst_box)] = \
                shards[e.leaf][e.src_box][rel_slices(e.box, e.src_box)]


def redistribute(program: RedistributionProgram, group, host: str,
                 shards: Dict[str, Dict[Box, np.ndarray]],
                 ) -> Dict[str, Dict[Box, np.ndarray]]:
    """Execute a lowered :class:`RedistributionProgram` over an initialized
    collective group whose rank i is host i of BOTH meshes (src and dst
    host sets must coincide — validated before any byte moves). The
    program's rounds bound each host's in-flight bytes: within a round a
    host posts its sends then drains its recvs, and a group barrier
    between rounds keeps every host in lock-step — without it, a host
    whose recv edges all pack into late rounds would race ahead and post
    its entire send set eagerly, which is exactly the unbounded behavior
    the program exists to kill. A trailing barrier fences call N from
    call N+1 on the same group: tags are global edge indices, reused
    verbatim by the next reshard, and the eager p2p tier OVERWRITES an
    unconsumed slot — without the fence a fast host's next-epoch send
    could clobber a message a slow peer has not drained yet.

    Deterministic pairing: the global edge index is the p2p tag, so the
    round structure can change without perturbing sender/receiver match-up.

    Where the JAX tier posts a round's sends before draining its receives
    (its CPU sends never block), a ``TorchGroup`` send may block until its
    receiver posts: every host walks a round's edges in the one global
    order, sending or receiving each edge it is an end of. Each edge's two
    ends then meet without a cycle of waits, whatever the backend.
    """
    plan = program.plan
    if tuple(plan.dst.mesh.hosts) != tuple(plan.src.mesh.hosts):
        raise ValueError(
            "redistribute needs identical src/dst host sets (rank i is "
            "host i of both meshes); use the object-plane transport for "
            "cross-mesh moves")
    rank_of = {h: i for i, h in enumerate(plan.src.mesh.hosts)}
    me = rank_of[host]
    out = _alloc_dst(plan, host)
    _fill_locals(plan, host, shards, out)
    for i, rnd in enumerate(program.rounds):
        if i:
            group.barrier()
        for tag in rnd:
            e = plan.edges[tag]
            if e.local:
                continue
            if rank_of[e.src_host] == me:
                chunk = _cut(e.box, e.src_box, shards[e.leaf][e.src_box])
                group.send(_tensor(chunk), rank_of[e.dst_host], tag=tag)
            elif e.dst_host == host:
                chunk = group.recv(rank_of[e.src_host], tag=tag).cpu().numpy()
                out[e.leaf][e.dst_box][rel_slices(e.box, e.dst_box)] = \
                    chunk.reshape(tuple(b - a for a, b in e.box))
    if program.rounds:
        group.barrier()  # epoch fence: tags are reusable after this
    return out


def collective_reshard(plan: TransferPlan, group, host: str,
                       shards: Dict[str, Dict[Box, np.ndarray]],
                       program: Optional[RedistributionProgram] = None,
                       ) -> Dict[str, Dict[Box, np.ndarray]]:
    """Execute ``plan`` over an initialized collective group whose rank i is
    host i of BOTH meshes (src and dst hosts must coincide — the
    same-mesh/live-reshard case). Edges lower to the group's point-to-point
    transfers (no store, no driver relay).

    The plan is lowered to a :class:`RedistributionProgram` first (pass a
    pre-computed ``program`` lowered from this SAME plan to share one
    lowering across the gang) — ``no_gather()`` is asserted before any
    byte moves and the rounds bound in-flight bytes. A plan that cannot
    be lowered falls back to a single unbounded round (everything posted,
    then drained) with a rate-limited warning, never silently.
    """
    import time as _time

    from ray_tpu_torch.util import tracing
    from ray_tpu_torch.weights.store import _obs

    src_hosts = plan.src.mesh.hosts
    if tuple(plan.dst.mesh.hosts) != tuple(src_hosts):
        raise ValueError(
            "collective_reshard needs identical src/dst host sets; use the "
            "object-plane transport for cross-mesh moves")
    if program is not None and program.plan is not plan:
        raise ValueError(
            "collective_reshard: the pre-computed program was lowered from "
            "a DIFFERENT plan — executing it would move the stale plan's "
            "geometry; re-lower with lower_collective(plan)")
    if program is None:
        program = maybe_lower_collective(plan)  # logs on fallback
        if program is None:
            # plan refuses no-gather lowering (logged above): execute as
            # one unbounded round — all sends posted, then drained
            tags = [i for i, e in enumerate(plan.edges) if not e.local]
            program = RedistributionProgram(plan=plan,
                                            rounds=[tags] if tags else [])
    t0 = _time.perf_counter()
    with tracing.profile("weights.reshard", category="weights", host=host):
        out = redistribute(program, group, host, shards)
    _obs()["reshard"].observe(_time.perf_counter() - t0)
    return out


# ---------------------------------------------------------------------------
# XLA tier: not ported
# ---------------------------------------------------------------------------

# the per-leaf outcome counters of the JAX package's device-tier reshard;
# that tier is not ported, so nothing counts here yet
_LOWER_OUTCOMES = ("lowered", "noop", "host_put", "fallback")


def reshard_lowering_stats() -> Dict[str, int]:
    return dict.fromkeys(_LOWER_OUTCOMES, 0)


def jax_reshard(tree: Any, mesh_axes: Dict[str, int],
                parts: Dict[str, Tuple[Optional[str], ...]],
                default_part: Tuple[Optional[str], ...] = ()) -> Any:
    """The JAX package's in-process device reshard; not ported yet."""
    from ray_tpu_torch._private.common import not_ported

    raise not_ported("the XLA reshard tier")
