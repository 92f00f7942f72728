"""1F1B pipeline schedules (plain + interleaved) and an analytic simulator:
a copy of ``ray_tpu/train/pipeline/schedule.py`` (pure Python).

Reference: "Scaling Deep Learning Training with MPMD Pipeline Parallelism"
(PAPERS.md, arxiv 2412.14374) — the classic one-forward-one-backward
schedule (PipeDream-flush / Megatron "1F1B"): stage ``s`` of ``S`` runs
``S-1-s`` warmup forwards, then alternates one forward with one backward
until microbatches run out, then drains the remaining backwards. Peak
in-flight activations per stage are bounded by ``S-s`` (not ``M``), and
the bubble fraction is ``(S-1)/(S-1+M)`` with equal fwd/bwd-per-microbatch
costs.

Interleaved virtual stages (Megatron-LM, arxiv 2104.04473): each rank
hosts ``V`` non-contiguous model chunks, giving ``P = S*V`` virtual stages
where virtual stage ``q`` lives on rank ``q % S`` as local chunk ``q // S``.
The rank-level schedule walks *virtual microbatches* ``k`` in groups of
``S`` per chunk — forward order ``chunk(k) = (k % (S*V)) // S``,
``mb(k) = (k // (S*V)) * S + k % S`` — with warmup
``min(M*V, 2*(S-1-rank) + (V-1)*S)``. The pipeline flush shrinks by the
extra chunk turnover: bubble ``(S-1)/(S-1+V*M)`` at equal per-chunk costs.
Requires ``M % S == 0`` (the chunk rotation closes only on whole groups).

Everything here is pure geometry: the schedule is a list of
:class:`Op` per stage, wire-encodable (plain tuples), golden-testable,
and executable by :mod:`ray_tpu_torch.train.pipeline.stage` against real
channels or by :func:`simulate` against a cost model with finite channel
depth and per-edge FIFO-order checking.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

# op kinds, in the vocabulary the stage executor understands
RECV_F = "recv_f"  # read activations for microbatch mb from upstream
FWD = "fwd"        # run this chunk's forward for mb (stash input for bwd)
SEND_F = "send_f"  # write mb's activations downstream
RECV_B = "recv_b"  # read mb's output-gradient from downstream
BWD = "bwd"        # run this chunk's backward for mb (accumulate grads)
SEND_B = "send_b"  # write mb's input-gradient upstream

KINDS = (RECV_F, FWD, SEND_F, RECV_B, BWD, SEND_B)


class Op(NamedTuple):
    kind: str
    mb: int
    chunk: int = 0  # LOCAL chunk index on the rank (virtual stage chunk*S+rank)


def _stage_ops(stage: int, num_stages: int, num_microbatches: int
               ) -> List[Op]:
    S, M, s = num_stages, num_microbatches, stage
    first, last = s == 0, s == S - 1
    ops: List[Op] = []

    def fwd(i: int):
        if not first:
            ops.append(Op(RECV_F, i))
        ops.append(Op(FWD, i))
        if not last:
            ops.append(Op(SEND_F, i))

    def bwd(i: int):
        if not last:
            ops.append(Op(RECV_B, i))
        ops.append(Op(BWD, i))
        if not first:
            ops.append(Op(SEND_B, i))

    warmup = min(S - 1 - s, M)
    for i in range(warmup):
        fwd(i)
    for i in range(warmup, M):  # steady 1F1B
        fwd(i)
        bwd(i - warmup)
    for i in range(M - warmup, M):  # cooldown
        bwd(i)
    return ops


def build_schedule(num_stages: int, num_microbatches: int
                   ) -> List[List[Op]]:
    """Per-stage op lists for a 1F1B step. ``num_microbatches`` >= 1;
    stages with fewer microbatches than warmup slots degrade gracefully
    (pure fwd-then-bwd)."""
    if num_stages < 1 or num_microbatches < 1:
        raise ValueError(
            f"need >=1 stage and >=1 microbatch, got S={num_stages} "
            f"M={num_microbatches}")
    return [_stage_ops(s, num_stages, num_microbatches)
            for s in range(num_stages)]


def _interleaved_rank_ops(rank: int, S: int, M: int, V: int) -> List[Op]:
    total = M * V  # virtual microbatches this rank processes each direction
    P = S * V

    def fwd_ids(k: int):
        grp, pos = divmod(k, S * V)
        return pos // S, grp * S + pos % S  # (local chunk, mb)

    def bwd_ids(k: int):
        grp, pos = divmod(k, S * V)
        return V - 1 - pos // S, grp * S + pos % S

    ops: List[Op] = []

    def fwd(c: int, mb: int):
        q = c * S + rank
        if q > 0:
            ops.append(Op(RECV_F, mb, c))
        ops.append(Op(FWD, mb, c))
        if q < P - 1:
            ops.append(Op(SEND_F, mb, c))

    def bwd(c: int, mb: int):
        q = c * S + rank
        if q < P - 1:
            ops.append(Op(RECV_B, mb, c))
        ops.append(Op(BWD, mb, c))
        if q > 0:
            ops.append(Op(SEND_B, mb, c))

    # deeper warmup than plain 1F1B: (V-1)*S extra forwards keep every
    # chunk's pipeline leg full across the rotation (Megatron eq. warmup)
    warmup = min(total, 2 * (S - 1 - rank) + (V - 1) * S)
    for k in range(warmup):
        fwd(*fwd_ids(k))
    for k in range(warmup, total):  # steady 1F1B over virtual microbatches
        fwd(*fwd_ids(k))
        bwd(*bwd_ids(k - warmup))
    for k in range(total - warmup, total):  # cooldown
        bwd(*bwd_ids(k))
    return ops


def build_interleaved_schedule(num_stages: int, num_microbatches: int,
                               num_chunks: int) -> List[List[Op]]:
    """Per-RANK op lists for an interleaved 1F1B step with ``num_chunks``
    (V) model chunks per rank. ``Op.chunk`` is the rank-local chunk index;
    virtual stage = ``chunk * S + rank``. V=1 degenerates to the plain
    1F1B schedule. V>1 requires ``M % S == 0``."""
    S, M, V = num_stages, num_microbatches, num_chunks
    if V < 1:
        raise ValueError(f"need >=1 chunk per stage, got V={V}")
    if V == 1:
        return build_schedule(S, M)
    if S < 1 or M < 1:
        raise ValueError(
            f"need >=1 stage and >=1 microbatch, got S={S} M={M}")
    if M % S != 0:
        raise ValueError(
            f"interleaved schedule needs num_microbatches divisible by "
            f"num_stages (chunk rotation closes on groups of S), got "
            f"M={M} S={S}")
    return [_interleaved_rank_ops(r, S, M, V) for r in range(S)]


def max_inflight_activations(stage: int, num_stages: int,
                             num_chunks: int = 1) -> int:
    """Upper bound on microbatch inputs rank ``stage`` holds at once:
    its warmup depth + the one in flight."""
    if num_chunks == 1:
        return num_stages - stage
    return 2 * (num_stages - 1 - stage) + (num_chunks - 1) * num_stages + 1


def bubble_upper_bound(num_stages: int, num_microbatches: int,
                       num_chunks: int = 1) -> float:
    """The analytic 1F1B bubble fraction with equal per-microbatch chunk
    costs: (S-1)/(S-1+V*M) — interleaving divides the flush by V."""
    S, M, V = num_stages, num_microbatches, num_chunks
    return (S - 1) / float(S - 1 + V * M)


def simulate(num_stages: int, num_microbatches: int,
             t_fwd: float = 1.0, t_bwd: float = 2.0,
             t_comm: float = 0.0, num_chunks: int = 1,
             channel_depth: int = 0) -> Dict[str, object]:
    """Event-driven dry run of the (interleaved) schedule under the real
    channel semantics: a recv waits for the matching send's completion
    time, sends complete ``t_comm`` after being posted, and — with
    ``channel_depth`` > 0 — send #k on an edge additionally waits for the
    completion of recv #(k-depth) on that edge (ring backpressure).
    ``t_fwd``/``t_bwd`` are per-CHUNK op costs.

    Each rank pair shares one FIFO channel per direction (the executor's
    ring): the simulator asserts that every recv consumes the head of its
    channel — an out-of-order schedule raises instead of silently
    reordering, and a blocked head (or exhausted ring) with no progress
    anywhere raises a deadlock error. Returns the makespan, per-stage busy
    fractions, and the overall bubble fraction (idle compute across
    stages / total stage-time) — the number PIPE_r* reports and the
    acceptance bound checks against."""
    S, V = num_stages, num_chunks
    sched = build_interleaved_schedule(S, num_microbatches, V)
    P = S * V
    cost = {FWD: t_fwd, BWD: t_bwd,
            RECV_F: 0.0, RECV_B: 0.0, SEND_F: t_comm, SEND_B: t_comm}
    # one FIFO channel per (direction, writer rank); self-loops (S==1 wrap
    # edges) are the executor's unbounded in-memory handoff
    sends: Dict[object, list] = {}      # ch -> [((src_q, mb), ready_t), ...]
    consumed: Dict[object, int] = {}    # ch -> next unread send index
    recv_done: Dict[object, list] = {}  # ch -> completion time per recv
    clock = [0.0] * S
    busy = [0.0] * S
    pos = [0] * S
    remaining = sum(len(ops) for ops in sched)

    def _ch(kind: str, src_q: int):
        src_rank = src_q % S
        return ("f" if kind in (SEND_F, RECV_F) else "b", src_rank)

    while remaining:
        progressed = False
        for s, ops in enumerate(sched):
            while pos[s] < len(ops):
                kind, mb, c = ops[pos[s]]
                q = c * S + s
                if kind in (RECV_F, RECV_B):
                    src_q = q - 1 if kind == RECV_F else q + 1
                    ch = _ch(kind, src_q)
                    idx = consumed.get(ch, 0)
                    posted = sends.get(ch, [])
                    if idx >= len(posted):
                        break  # blocked on an unposted send; try next stage
                    key, ready_t = posted[idx]
                    if key != (src_q, mb):
                        raise RuntimeError(
                            f"channel FIFO desync on edge {ch}: rank {s} "
                            f"expects (virtual stage {src_q}, mb {mb}) but "
                            f"head of channel is {key} — schedule emits "
                            f"sends and recvs in different orders")
                    clock[s] = max(clock[s], ready_t)
                    consumed[ch] = idx + 1
                    recv_done.setdefault(ch, []).append(clock[s])
                elif kind in (SEND_F, SEND_B):
                    dst_q = q + 1 if kind == SEND_F else q - 1
                    ch = _ch(kind, q)
                    k = len(sends.setdefault(ch, []))
                    if channel_depth > 0 and dst_q % S != s:
                        done = recv_done.get(ch, [])
                        if k - channel_depth >= len(done):
                            break  # ring full: wait for a reader ack
                        if k >= channel_depth:
                            clock[s] = max(clock[s],
                                           done[k - channel_depth])
                    clock[s] += cost[kind]
                    sends[ch].append(((q, mb), clock[s]))
                    pos[s] += 1
                    remaining -= 1
                    progressed = True
                    continue
                clock[s] += cost[kind]
                if kind in (FWD, BWD):
                    busy[s] += cost[kind]
                pos[s] += 1
                remaining -= 1
                progressed = True
        if not progressed:
            raise RuntimeError(
                "schedule deadlocked in simulation — a recv waits on a "
                "send no stage will post, or every ring is full "
                "(schedule generator / channel depth bug)")
    makespan = max(clock)
    total_busy = sum(busy)
    bubble = 1.0 - total_busy / (makespan * S) if makespan else 0.0
    return {
        "makespan": makespan,
        "busy_per_stage": busy,
        "busy_fraction_per_stage": [b / makespan if makespan else 0.0
                                    for b in busy],
        "bubble_fraction": bubble,
    }
