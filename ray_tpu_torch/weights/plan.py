"""Resharding planner: (src spec, dst spec) -> minimal shard-exchange plan.
The port of ``ray_tpu/weights/plan.py``, which the checkpoint plane's
restore uses to read onto another mesh.

Reference: "Memory-efficient array redistribution through portable
collective communication" (PAPERS.md) — a reshard is a set of slice
exchanges computed from the two index geometries; no step of the exchange
may materialize the full array on one participant. The planner works purely
on :mod:`ray_tpu_torch.weights.spec` geometry:

- For every leaf, the distinct source shard boxes form a disjoint grid and
  so do the destination boxes; each (dst box ∩ src box) intersection becomes
  exactly ONE :class:`TransferEdge` per destination host that needs it.
- A destination host that already holds the bytes (it is also a source
  replica of the intersecting box) gets a ``local`` edge — zero bytes moved.
- When an intersection has several source replicas, the source host is
  chosen by a stable hash of the chunk key, so (a) fan-out spreads across
  replicas instead of hammering host 0 and (b) every destination of the
  same chunk pulls from the SAME source — the chunk is published once.

The resulting plan is transport-agnostic. The lowering helpers below turn
it into rounds of point-to-point exchanges; the transports that run them
(the JAX package's ``weights/transport.py``) wait for the runtime's port.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ray_tpu_torch.weights.spec import (
    Box,
    ShardedTreeSpec,
    box_nbytes,
    host_boxes,
    intersect_box,
    unique_boxes,
)

logger = logging.getLogger("ray_tpu_torch.weights")


@dataclass(frozen=True)
class TransferEdge:
    """One chunk movement: ``box`` (global coords) of ``leaf`` travels from
    ``src_host`` to ``dst_host``. ``src_box`` is the source shard the chunk
    is cut from; ``dst_box`` the destination shard it lands in."""

    leaf: str
    src_host: str
    dst_host: str
    box: Box
    src_box: Box
    dst_box: Box
    nbytes: int
    local: bool

    def chunk_key(self) -> str:
        """Deterministic manifest key for this chunk's bytes. Keyed by leaf
        + box only: replicated destinations share one published chunk."""
        flat = ",".join(f"{a}:{b}" for a, b in self.box)
        return f"{self.leaf}|{flat}"


@dataclass
class TransferPlan:
    src: ShardedTreeSpec
    dst: ShardedTreeSpec
    edges: List[TransferEdge] = field(default_factory=list)

    # -- per-host views (what transports consume) --

    def sends_from(self, host: str) -> List[TransferEdge]:
        return [e for e in self.edges if e.src_host == host and not e.local]

    def recvs_to(self, host: str) -> List[TransferEdge]:
        return [e for e in self.edges if e.dst_host == host and not e.local]

    def locals_on(self, host: str) -> List[TransferEdge]:
        return [e for e in self.edges if e.dst_host == host and e.local]

    # -- stats / invariants --

    def bytes_moved(self) -> int:
        return sum(e.nbytes for e in self.edges if not e.local)

    def bytes_local(self) -> int:
        return sum(e.nbytes for e in self.edges if e.local)

    def unique_chunk_bytes(self) -> int:
        """Bytes published once per distinct chunk (replicated destinations
        share chunks)."""
        seen = {}
        for e in self.edges:
            if not e.local:
                seen[e.chunk_key()] = e.nbytes
        return sum(seen.values())

    def fanout(self) -> int:
        """Max destinations any single published chunk feeds."""
        counts: Dict[str, int] = {}
        for e in self.edges:
            if not e.local:
                counts[e.chunk_key()] = counts.get(e.chunk_key(), 0) + 1
        return max(counts.values(), default=0)

    def max_host_leaf_bytes(self, leaf: str) -> int:
        """The most bytes of ``leaf`` any single host holds at any point of
        the exchange: its resident source shards plus everything it
        receives. The no-gather property is
        ``max_host_leaf_bytes(leaf) < leaf_nbytes`` (unless a side
        legitimately replicates the leaf)."""
        import numpy as np

        shape, dtype = (self.src.meta.get(leaf) or self.dst.meta[leaf])
        item = np.dtype(dtype).itemsize
        held: Dict[str, int] = {}
        for host in set(self.src.mesh.hosts) | set(self.dst.mesh.hosts):
            total = 0
            if host in self.src.mesh.hosts:
                boxes = host_boxes(self.src.mesh, self.src.part_of(leaf),
                                   shape, host)
                total += sum(box_nbytes(b, item) for b in boxes)
            total += sum(e.nbytes for e in self.edges
                         if e.leaf == leaf and e.dst_host == host
                         and not e.local)
            held[host] = total
        return max(held.values(), default=0)

    def no_gather(self) -> bool:
        """True iff no host ever holds a full copy of any leaf that neither
        side declares replicated (a replicated side holds full copies by
        declaration — that is a broadcast, not a gather)."""
        import numpy as np

        for leaf, (shape, dtype) in self.dst.meta.items():
            full = box_nbytes(tuple((0, s) for s in shape),
                              np.dtype(dtype).itemsize)
            src_rep = all(a is None for a in self.src.part_of(leaf))
            dst_rep = all(a is None for a in self.dst.part_of(leaf))
            if src_rep or dst_rep:
                continue
            if self.max_host_leaf_bytes(leaf) >= full:
                return False
        return True

    def stats(self) -> Dict[str, float]:
        return {
            "num_edges": len(self.edges),
            "num_local_edges": sum(1 for e in self.edges if e.local),
            "bytes_moved": self.bytes_moved(),
            "bytes_local": self.bytes_local(),
            "unique_chunk_bytes": self.unique_chunk_bytes(),
            "fanout": self.fanout(),
            "num_leaves": len(self.dst.meta),
            "src_hosts": len(self.src.mesh.hosts),
            "dst_hosts": len(self.dst.mesh.hosts),
        }


def plan_reshard(src: ShardedTreeSpec, dst: ShardedTreeSpec) -> TransferPlan:
    """Compute the shard-exchange plan from ``src`` to ``dst``.

    Guarantees, by construction:

    - every destination shard's bytes arrive exactly once (the source boxes
      are a disjoint grid, so intersections tile each destination box);
    - total moved bytes <= sum of unique destination shard bytes;
    - no edge carries bytes its destination already holds (those become
      ``local`` edges).
    """
    import numpy as np

    if set(src.meta) != set(dst.meta):
        missing = set(src.meta) ^ set(dst.meta)
        raise ValueError(f"src/dst trees differ on leaves: {sorted(missing)}")
    import zlib

    plan = TransferPlan(src=src, dst=dst)
    for leaf in sorted(dst.meta):
        shape, dtype = dst.meta[leaf]
        if src.meta[leaf][0] != shape:
            raise ValueError(
                f"leaf {leaf!r} shape mismatch: src {src.meta[leaf][0]} vs "
                f"dst {shape}")
        item = np.dtype(dtype).itemsize
        src_grid = unique_boxes(src.mesh, src.part_of(leaf), shape)
        dst_grid = unique_boxes(dst.mesh, dst.part_of(leaf), shape)
        for dbox in sorted(dst_grid):
            for sbox in sorted(src_grid):
                inter = intersect_box(dbox, sbox)
                if inter is None:
                    continue
                nbytes = box_nbytes(inter, item)
                replicas = src_grid[sbox]
                for dhost in dst_grid[dbox]:
                    if dhost in replicas:
                        plan.edges.append(TransferEdge(
                            leaf=leaf, src_host=dhost, dst_host=dhost,
                            box=inter, src_box=sbox, dst_box=dbox,
                            nbytes=nbytes, local=True))
                        continue
                    flat = f"{leaf}|{inter}".encode()
                    shost = replicas[zlib.crc32(flat) % len(replicas)]
                    plan.edges.append(TransferEdge(
                        leaf=leaf, src_host=shost, dst_host=dhost,
                        box=inter, src_box=sbox, dst_box=dbox,
                        nbytes=nbytes, local=False))
    return plan


# ---------------------------------------------------------------------------
# Collective lowering: plan -> redistribution program
#
# Reference: "Memory-efficient array redistribution through portable
# collective communication" (PAPERS.md, arxiv 2112.01075) — a sharding
# transition is a *program* of cheap point-to-point exchanges, never a
# replicate-then-slice (XLA's "involuntary full rematerialization"
# fallback). The lowering here turns a TransferPlan into ordered rounds of
# edges such that (a) the plan is proven no-gather BEFORE any byte moves
# and (b) no host's in-flight send+recv bytes in one round exceed a bound,
# so the peak working set stays a constant factor over the resident shards
# regardless of how adversarial the (src, dst) geometry pair is.
# ---------------------------------------------------------------------------


class ReshardLoweringError(ValueError):
    """The plan cannot be lowered to a no-gather collective program (some
    host would materialize a full non-replicated leaf)."""


@dataclass(frozen=True)
class DcnCostModel:
    """Two-tier bandwidth model for redistribution edges.

    Hosts mapping to the same node (``node_of``; default: every host its
    own node, i.e. everything is DCN) exchange over the fast tier (ICI /
    intra-slice); everything else crosses the data-center network. Costs
    are advisory — they order edges (long DCN transfers first, so they
    overlap the cheap intra-node ones) and price programs for the
    transport picker; they never change what bytes move.
    """

    ici_bytes_per_s: float = 40e9
    dcn_bytes_per_s: float = 3e9
    latency_s: float = 200e-6
    node_of: Optional[Callable[[str], str]] = None

    def _node(self, host: str) -> str:
        return self.node_of(host) if self.node_of is not None else host

    def is_dcn(self, edge: TransferEdge) -> bool:
        return self._node(edge.src_host) != self._node(edge.dst_host)

    def edge_seconds(self, edge: TransferEdge) -> float:
        if edge.local:
            return 0.0
        bw = self.dcn_bytes_per_s if self.is_dcn(edge) \
            else self.ici_bytes_per_s
        return self.latency_s + edge.nbytes / bw


@dataclass
class RedistributionProgram:
    """A lowered TransferPlan: ordered rounds of non-local edge indices.

    Within a round every sender posts its sends then drains its recvs; a
    host does not enter round ``r+1`` before finishing round ``r``, which
    is what bounds its in-flight bytes. The program is computed (and its
    invariants assertable) before any data movement."""

    plan: TransferPlan
    rounds: List[List[int]] = field(default_factory=list)
    est_seconds: float = 0.0
    dcn_bytes: int = 0
    ici_bytes: int = 0

    def max_round_host_bytes(self) -> int:
        """Peak per-(host, round) in-flight bytes (sends + recvs)."""
        peak = 0
        for rnd in self.rounds:
            per_host: Dict[str, int] = {}
            for i in rnd:
                e = self.plan.edges[i]
                per_host[e.src_host] = per_host.get(e.src_host, 0) + e.nbytes
                per_host[e.dst_host] = per_host.get(e.dst_host, 0) + e.nbytes
            peak = max(peak, max(per_host.values(), default=0))
        return peak

    def stats(self) -> Dict[str, float]:
        return {
            "num_rounds": len(self.rounds),
            "num_edges": sum(len(r) for r in self.rounds),
            "est_seconds": self.est_seconds,
            "dcn_bytes": self.dcn_bytes,
            "ici_bytes": self.ici_bytes,
            "max_round_host_bytes": self.max_round_host_bytes(),
        }


def lower_collective(plan: TransferPlan,
                     cost_model: Optional[DcnCostModel] = None,
                     inflight_limit_bytes: int = 64 << 20,
                     ) -> RedistributionProgram:
    """Lower ``plan`` into a :class:`RedistributionProgram`.

    Asserts ``plan.no_gather()`` BEFORE lowering — a plan that would
    gather must never reach a transport (raising here is what keeps the
    XLA replicate-then-slice rematerialization fallback dead; see
    :func:`maybe_lower_collective` for the logged fallback).

    Edge order inside the round stream: DCN edges first (they are the
    long poles — issuing them early overlaps them with the intra-node
    traffic), then by descending size. Greedy round packing keeps every
    host's per-round send+recv bytes under ``inflight_limit_bytes``
    (a single edge larger than the limit gets a round of its own rather
    than being rejected — it must move regardless).
    """
    if not plan.no_gather():
        raise ReshardLoweringError(
            "reshard plan is not no-gather: some host would materialize a "
            "full copy of a non-replicated leaf; refusing to lower to "
            "collectives (and never falling back to replicate-then-slice)")
    cm = cost_model or DcnCostModel()
    indexed = [(i, e) for i, e in enumerate(plan.edges) if not e.local]
    indexed.sort(key=lambda ie: (not cm.is_dcn(ie[1]), -ie[1].nbytes,
                                 ie[0]))
    rounds: List[List[int]] = []
    loads: List[Dict[str, int]] = []  # per-round per-host in-flight bytes
    for i, e in indexed:
        placed = False
        for rnd, load in zip(rounds, loads):
            if (load.get(e.src_host, 0) + e.nbytes <= inflight_limit_bytes
                    and load.get(e.dst_host, 0) + e.nbytes
                    <= inflight_limit_bytes):
                rnd.append(i)
                load[e.src_host] = load.get(e.src_host, 0) + e.nbytes
                load[e.dst_host] = load.get(e.dst_host, 0) + e.nbytes
                placed = True
                break
        if not placed:
            rounds.append([i])
            # non-local edges always cross hosts (a same-host intersection
            # is a local edge by construction), so two distinct keys
            loads.append({e.src_host: e.nbytes, e.dst_host: e.nbytes})
    dcn = sum(e.nbytes for _, e in indexed if cm.is_dcn(e))
    ici = sum(e.nbytes for _, e in indexed if not cm.is_dcn(e))
    # est: per round, the slowest host's serialized send time; rounds are
    # sequential by construction
    est = 0.0
    for rnd in rounds:
        per_host: Dict[str, float] = {}
        for i in rnd:
            e = plan.edges[i]
            per_host[e.src_host] = per_host.get(e.src_host, 0.0) \
                + cm.edge_seconds(e)
        est += max(per_host.values(), default=0.0)
    return RedistributionProgram(plan=plan, rounds=rounds, est_seconds=est,
                                 dcn_bytes=dcn, ici_bytes=ici)


# fallback accounting: every place the collective lowering is bypassed is
# counted and logged (rate-limited): a silent rematerialization on a
# sharding transition is the failure this guards against
_fallback_lock = threading.Lock()
_fallback_counts: Dict[str, int] = {}
_fallback_last_log: Dict[str, float] = {}
_FALLBACK_LOG_INTERVAL_S = 60.0


def note_lowering_fallback(reason: str, detail: str = "") -> None:
    """Record (and rate-limited-log) one lowering fallback. Never silent:
    the first occurrence of each reason logs immediately, repeats at most
    once per minute per reason."""
    now = time.time()
    with _fallback_lock:
        _fallback_counts[reason] = _fallback_counts.get(reason, 0) + 1
        count = _fallback_counts[reason]
        last = _fallback_last_log.get(reason, 0.0)
        if now - last < _FALLBACK_LOG_INTERVAL_S:
            return
        _fallback_last_log[reason] = now
    logger.warning(
        "weights reshard: collective lowering fell back (%s, %d so far)%s",
        reason, count, f": {detail}" if detail else "")


def lowering_fallback_counts() -> Dict[str, int]:
    with _fallback_lock:
        return dict(_fallback_counts)


def reset_lowering_fallback_counts() -> None:
    with _fallback_lock:
        _fallback_counts.clear()
        _fallback_last_log.clear()


def maybe_lower_collective(plan: TransferPlan,
                           cost_model: Optional[DcnCostModel] = None,
                           inflight_limit_bytes: int = 64 << 20,
                           ) -> Optional[RedistributionProgram]:
    """Best-effort lowering: returns None (after a rate-limited log, never
    silently) when the plan cannot be lowered no-gather. Callers that get
    None fall back to their legacy path knowingly."""
    try:
        return lower_collective(plan, cost_model, inflight_limit_bytes)
    except ReshardLoweringError as e:
        note_lowering_fallback("plan_not_no_gather", str(e))
        return None
