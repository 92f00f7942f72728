"""PipelineStage: one actor gang member executing a 1F1B op stream, the port
of ``ray_tpu/train/pipeline/stage.py``.

Each stage is an actor owning one or more chunks of the model (see
partition.py; with interleaved schedules a rank hosts ``V`` non-contiguous
chunks — virtual stage ``q = chunk*S + rank``), per-chunk optimizer state,
and the channel endpoints to its neighbor ranks. It computes on the
``device`` it is given (the card unless the caller names the CPU; it
raises where the card is asked for and absent). Microbatch activations flow
rank->rank over the compiled-graph channel plane (``dag/channels.py``): a
ring of shm seqlock slots on one node — writer-creates, reader-attaches,
and the depth-``d`` reader-ack backpressure keeps the no-drop rendezvous
the 1F1B schedule needs while letting a SEND overlap the next compute op.
A tensor on the card is copied into the slot by one device-to-host copy;
the receiving stage moves it onto its own device. With ``V`` chunks the
physical topology is a ring: rank ``r`` writes ``f<r>`` read by rank
``(r+1)%S`` (the wrap edge carries chunk transitions) and reads ``b<r>``
written by rank ``(r+1)%S``; every hop is FIFO on its edge, and the
schedule emits sends and recvs in matching order (simulate() asserts it).

Observability: every op lands as a built-in span — ``pipe.fwd`` /
``pipe.bwd`` bound the compute (the device synchronised inside them),
``pipe.send`` / ``pipe.recv`` bound the channel hops, all tagged
``stage``/``mb``/``chunk``/``step`` plus the channel's per-hop breakdown
(encode/copy/ack-wait on the send side, copy/decode on the recv side). The
sender ships its span context in the payload and the receiver parents
``pipe.recv`` onto it, so the timeline renders every microbatch hand-off as
a matched cross-process flow arrow. Aggregated channel time also lands on
the ``ray_tpu.pipe.*`` metric instruments once per schedule run.

Failure model: stages are stateless between steps modulo (params,
opt_state, step) per chunk, which the controller checkpoints per stage
through the ckpt plane. A dead stage kills the step (channel reads time
out / actor death surfaces on the controller's wait); recovery re-forms
the whole gang at a fresh channel generation and restores every stage from
its manifest — mid-schedule partial work is discarded by construction
(grads only apply at the step boundary).
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.dag.channels import SHM_PREFIX
from ray_tpu_torch.train.pipeline import schedule as sched


def _chan_names(run: str, generation: int, stage: int, num_stages: int,
                num_chunks: int = 1) -> Dict[str, Optional[str]]:
    """Channel names for this rank's four possible endpoints. ``f<r>``
    carries rank r -> (r+1)%S activations, ``b<r>`` carries (r+1)%S -> r
    gradients; the writer side creates the ring. With one chunk per rank
    the wrap edges don't exist (plain chain); with V>1 every edge exists
    (chunk transitions ride the wrap). S==1 needs no channels at all (the
    executor hands chunks off in-process)."""
    g = f"{run}.g{generation}"
    S = num_stages
    if S == 1:
        return {"fwd_out": None, "bwd_out": None,
                "fwd_in": None, "bwd_in": None}
    if num_chunks == 1:
        return {
            "fwd_out": f"{g}.f{stage}" if stage < S - 1 else None,
            "bwd_out": f"{g}.b{stage - 1}" if stage > 0 else None,
            "fwd_in": f"{g}.f{stage - 1}" if stage > 0 else None,
            "bwd_in": f"{g}.b{stage}" if stage < S - 1 else None,
        }
    return {
        "fwd_out": f"{g}.f{stage}",
        "bwd_out": f"{g}.b{(stage - 1) % S}",
        "fwd_in": f"{g}.f{(stage - 1) % S}",
        "bwd_in": f"{g}.b{stage}",
    }


def channel_shm_paths(run: str, generation: int, num_stages: int,
                      num_chunks: int = 1) -> List[str]:
    """The /dev/shm paths a same-node gang's channels occupy (the
    controller unlinks them after killing a gang — a dead writer cannot)."""
    out = []
    for s in range(num_stages):
        names = _chan_names(run, generation, s, num_stages, num_chunks)
        for key in ("fwd_out", "bwd_out"):
            if names[key]:
                path = f"/dev/shm/{SHM_PREFIX}{names[key]}"
                if path not in out:
                    out.append(path)
    return out


_PIPE_METRICS = None


def _pipe_metrics():
    """Lazy ``ray_tpu.pipe.*`` channel-plane instruments (one registration
    per process; recorded once per schedule run, not per hop)."""
    global _PIPE_METRICS
    if _PIPE_METRICS is None:
        from ray_tpu_torch.util.metrics import Counter, Histogram

        _PIPE_METRICS = {
            "send_seconds": Histogram(
                "ray_tpu.pipe.send_seconds",
                description="Per-step channel send wall time on one rank "
                            "(encode + copy + downstream ack wait).",
                boundaries=[0.001, 0.01, 0.1, 1.0, 10.0],
                tag_keys=("stage",)),
            "recv_wait_seconds": Histogram(
                "ray_tpu.pipe.recv_wait_seconds",
                description="Per-step time a rank spent blocked on "
                            "upstream/downstream activations (the realized "
                            "pipeline bubble).",
                boundaries=[0.001, 0.01, 0.1, 1.0, 10.0],
                tag_keys=("stage",)),
            "wire_bytes": Counter(
                "ray_tpu.pipe.wire_bytes",
                description="Bytes written to activation channels (post-"
                            "compression framing, headers included).",
                tag_keys=("stage",)),
            "encode_seconds": Histogram(
                "ray_tpu.pipe.encode_seconds",
                description="Per-step activation framing cost on one rank "
                            "(leaf extraction + optional quantization + "
                            "skeleton pickle).",
                boundaries=[0.0001, 0.001, 0.01, 0.1, 1.0],
                tag_keys=("stage",)),
        }
    return _PIPE_METRICS


_HOP_SEND_KEYS = ("encode_s", "pickle_s", "copy_s", "ack_wait_s")
_HOP_RECV_KEYS = ("copy_s", "decode_s")


@ray_tpu_torch.remote
class PipelineStage:
    def __init__(self, stage: int, num_stages: int, cfg_blob: bytes,
                 opt_blob: Optional[bytes], run_name: str, generation: int,
                 channel_capacity: int = 4 << 20,
                 boundaries: Optional[list] = None,
                 bucket_bytes: Optional[int] = None,
                 dp_group: Optional[Dict[str, Any]] = None,
                 num_chunks: int = 1, channel_depth: int = 2,
                 activation_compression: Optional[str] = None,
                 device: Optional[str] = None):
        # driver-authored blobs: decode only through the audited
        # serialization boundary
        from ray_tpu_torch._private.serialization import loads_trusted
        from ray_tpu_torch.utils import resolve_device

        self.device = resolve_device(device)  # raises without the card
        self.stage = stage
        self.num_stages = num_stages
        self.num_chunks = num_chunks
        # global virtual-stage ids this rank hosts, local chunk order
        self.chunks = [v * num_stages + stage for v in range(num_chunks)]
        self.num_virtual = num_stages * num_chunks
        self.cfg = loads_trusted(cfg_blob)
        self._opt_factory = (loads_trusted(opt_blob) if opt_blob
                             else None)
        self.run_name = run_name
        self.generation = generation
        self.channel_capacity = channel_capacity
        self.channel_depth = channel_depth
        self.activation_compression = activation_compression
        self.boundaries = ([tuple(b) for b in boundaries]
                           if boundaries else None)
        # bucketed optimizer apply (None = the whole-tree apply): grads
        # partition into size-bounded layer-order buckets, each with its
        # own optimizer state, applied as a pipeline — and, with
        # ``dp_group`` (name/world_size/rank/backend/init_method of a
        # data-parallel replica set of THIS stage), each bucket's grads
        # allreduce asynchronously across replicas as soon as the schedule
        # finishes, overlapping the controller's coordination round-trip.
        # Bucket-wise apply is bit-identical to whole-tree apply for
        # per-leaf transforms (adam family).
        self.dp_group = dict(dp_group) if dp_group else None
        if num_chunks > 1 and (bucket_bytes or dp_group):
            raise ValueError(
                "interleaved stages (num_chunks > 1) do not compose with "
                "bucket_bytes/dp_group yet — the bucket plan is keyed on a "
                "single param tree per rank")
        if self.dp_group is not None and not bucket_bytes:
            # the replica allreduce rides the bucket plan — a dp group
            # without an explicit bound gets the default bucket size
            from ray_tpu_torch.collective.bucketed import DEFAULT_BUCKET_BYTES

            bucket_bytes = DEFAULT_BUCKET_BYTES
        self.bucket_bytes = bucket_bytes
        self._bucket_plan = None
        self._reducer = None
        self._pending_reduce: Optional[List[Any]] = None
        self.programs: Optional[Dict[int, Any]] = None  # chunk id -> programs
        self.params: Optional[Dict[int, Any]] = None    # chunk id -> state dict
        self.opt_state: Optional[Dict[int, Any]] = None
        self.step = 0
        self._chans: Dict[str, Any] = {}
        self._acc: Dict[int, Any] = {}  # chunk id -> accumulated grads
        self._inputs: Dict[Tuple[int, int], Any] = {}  # (chunk, mb) -> input
        self._ibuf_f: Dict[Tuple[int, int], Any] = {}  # S==1 in-proc handoff
        self._ibuf_b: Dict[Tuple[int, int], Any] = {}
        self._last_losses: List[float] = []

    # -- single-chunk compatibility accessors -----------------------------

    def _q0(self) -> int:
        return self.chunks[0]

    def _p0(self):
        return self.params[self._q0()]

    def _sync(self):
        """Wait for this stage's work on the card (nothing on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- gang formation -------------------------------------------------

    def ready(self) -> float:
        """Up, with this rank's programs built: its modules allocated on
        its device (the card's context made here, while the driver still
        publishes the weights). Returns the time (``time.time()``) they
        were first built."""
        if self.programs is None:
            self._build_programs()
            self._ready_at = time.time()
        return self._ready_at

    def create_channels(self) -> bool:
        """Writer side: create this rank's outgoing rings. Runs on every
        stage BEFORE any reader attaches. The forward ring optionally
        streams quantized (``activation_compression``); gradients stay
        exact."""
        from ray_tpu_torch.dag.channels import Channel

        names = _chan_names(self.run_name, self.generation, self.stage,
                            self.num_stages, self.num_chunks)
        for key in ("fwd_out", "bwd_out"):
            if names[key] is not None:
                self._chans[key] = Channel(
                    names[key], capacity=self.channel_capacity,
                    create=True, num_readers=1, depth=self.channel_depth)
        if self.activation_compression and "fwd_out" in self._chans:
            self._chans["fwd_out"].set_codec(self.activation_compression)
        return True

    def open_channels(self, timeout: float = 30.0) -> bool:
        """Reader side: attach to the neighbors' rings (they were created
        by create_channels on every stage first; the retry only covers
        filesystem visibility)."""
        from ray_tpu_torch.dag.channels import Channel

        names = _chan_names(self.run_name, self.generation, self.stage,
                            self.num_stages, self.num_chunks)
        deadline = time.monotonic() + timeout
        for key in ("fwd_in", "bwd_in"):
            if names[key] is None:
                continue
            while True:
                try:
                    self._chans[key] = Channel(names[key], reader_slot=0)
                    break
                except FileNotFoundError:
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.05)
        return True

    def _build_programs(self):
        if self.programs is None:
            from ray_tpu_torch.train.pipeline.partition import (
                StagePrograms, make_stage_optimizer)

            opt = (self._opt_factory() if self._opt_factory
                   else make_stage_optimizer())
            self.programs = {
                q: StagePrograms(self.cfg, q, self.num_virtual, opt,
                                 boundaries=self.boundaries,
                                 device=self.device)
                for q in self.chunks
            }

    def _bucketing(self):
        """Build (lazily, params must exist) the bucket plan and — with a
        dp group — the async reducer. Single-chunk ranks only (guarded at
        construction)."""
        if self._bucket_plan is None and self.bucket_bytes:
            from ray_tpu_torch.collective.bucketed import (
                AsyncBucketReducer, leaf_meta, plan_buckets)

            self._bucket_plan = plan_buckets(
                leaf_meta(self._p0()), bucket_bytes=self.bucket_bytes,
                world_size=(self.dp_group or {}).get("world_size", 1))
            if self.dp_group is not None:
                from ray_tpu_torch import collective as col

                name = f"{self.dp_group['name']}.s{self.stage}"
                col.init_collective_group(
                    self.dp_group["world_size"], self.dp_group["rank"],
                    backend=self.dp_group.get("backend"),
                    group_name=name, device=self.device,
                    init_method=self.dp_group.get("init_method"))
                self._reducer = AsyncBucketReducer(name, self._bucket_plan)
        return self._bucket_plan

    def _init_opt_state(self, q: int):
        """Whole-tree state, or one optimizer state per bucket (keyed by
        bucket index as str so ckpt manifests serialize it plainly)."""
        if self.bucket_bytes:
            self._bucketing()
            return {
                str(b.index): self.programs[q].opt_init(
                    self._subtree(b.paths))
                for b in self._bucket_plan.buckets
            }
        return self.programs[q].opt_init(self.params[q])

    def _subtree(self, paths) -> Dict[str, Any]:
        by_path = self._p0()
        return {p: by_path[p] for p in paths}

    def init_weights(self, store_name: str,
                     version: Optional[int] = None) -> int:
        """Pull this rank's parameter subtree from its weight-plane store
        (the per-stage weight placement path), cut it into this rank's
        chunks, and init fresh optimizer state for each."""
        from ray_tpu_torch.train.pipeline.partition import (rank_chunk_keys,
                                                            select_keys)
        from ray_tpu_torch.weights import WeightStore

        self._build_programs()
        tree, version = WeightStore(store_name).pull(version,
                                                     return_version=True)
        merged = tree["params"]
        self.params = {
            q: self.programs[q].bind(select_keys(merged, keys))
            for q, keys in rank_chunk_keys(
                self.cfg, self.stage, self.num_stages, self.num_chunks,
                self.boundaries).items()
        }
        del tree, merged
        self.opt_state = {q: self._init_opt_state(q) for q in self.chunks}
        self.step = 0
        return version

    # -- schedule execution ---------------------------------------------

    def _send(self, key: str, chunk: int, mb: int, payload, step: int,
              nbytes: int, hop: Dict[str, float]):
        from ray_tpu_torch.util import tracing

        ctx = tracing.current_context()
        span_id = tracing.new_span_id()
        trace_id = ctx[0] if ctx else tracing.new_trace_id()
        t0 = time.time()
        chan = self._chans[key]
        chan.write({"mb": mb, "chunk": chunk, "data": payload,
                    "trace": (trace_id, span_id)})
        st = chan.last_write_stats
        for k in _HOP_SEND_KEYS:
            hop["send_" + k] += st.get(k, 0.0)
        hop["send_wire_bytes"] += st.get("wire_bytes", 0)
        hop["send_skel_bytes"] += st.get("skel_bytes", 0)
        tracing.record_span(
            "pipe.send", t0, time.time(), category="pipe",
            trace_id=trace_id, span_id=span_id,
            parent_id=ctx[1] if ctx else None,
            stage=self.stage, mb=mb, chunk=chunk, step=step, nbytes=nbytes,
            wire_bytes=st.get("wire_bytes", 0),
            encode_s=st.get("encode_s", 0.0), copy_s=st.get("copy_s", 0.0),
            ack_wait_s=st.get("ack_wait_s", 0.0))

    def _recv(self, key: str, chunk: int, mb: int, step: int,
              hop: Dict[str, float]):
        from ray_tpu_torch.util import tracing

        t0 = time.time()
        chan = self._chans[key]
        msg = chan.read()
        if msg["mb"] != mb or msg.get("chunk", 0) != chunk:
            raise RuntimeError(
                f"stage {self.stage} expected (chunk {chunk}, microbatch "
                f"{mb}) on {key}, got (chunk {msg.get('chunk')}, mb "
                f"{msg['mb']}) — schedule/channel desync")
        st = chan.last_read_stats
        for k in _HOP_RECV_KEYS:
            hop["recv_" + k] += st.get(k, 0.0)
        hop["recv_wire_bytes"] += st.get("wire_bytes", 0)
        data = msg["data"].to(self.device)  # the host copy onto this stage
        tr = msg.get("trace")
        tracing.record_span(
            "pipe.recv", t0, time.time(), category="pipe",
            trace_id=tr[0] if tr else tracing.new_trace_id(),
            span_id=tracing.new_span_id(),
            parent_id=tr[1] if tr else None,
            stage=self.stage, mb=mb, chunk=chunk, step=step,
            copy_s=st.get("copy_s", 0.0), decode_s=st.get("decode_s", 0.0))
        return data

    def run_schedule(self, step: int, ops: List,
                     microbatches: Optional[List[dict]] = None
                     ) -> Dict[str, Any]:
        """Execute one step's op stream (``schedule.build_schedule`` /
        ``build_interleaved_schedule`` row for this rank; op tuples are
        ``(kind, mb[, chunk])``). ``microbatches`` carries the
        per-microbatch host data this rank consumes: ``tokens`` on the
        rank hosting virtual stage 0, ``targets``/``mask`` on the rank
        hosting the last."""
        from ray_tpu_torch.util import tracing

        self._build_programs()
        if self.params is None:
            raise RuntimeError(
                f"stage {self.stage}: init_weights/restore before running")
        S = self.num_stages
        wall0 = time.perf_counter()
        compute_s = send_s = recv_s = 0.0
        send_bytes = recv_bytes = 0
        hop = {("send_" + k): 0.0 for k in _HOP_SEND_KEYS}
        hop.update({("recv_" + k): 0.0 for k in _HOP_RECV_KEYS})
        hop["send_wire_bytes"] = 0
        hop["send_skel_bytes"] = 0
        hop["recv_wire_bytes"] = 0
        losses: List[float] = []
        auxes: List[float] = []
        aux_by_mb: Dict[int, float] = {}
        self._acc = {}
        self._inputs.clear()
        self._ibuf_f.clear()
        self._ibuf_b.clear()
        for op in ops:
            kind, mb = op[0], op[1]
            c = op[2] if len(op) > 2 else 0
            q = c * S + self.stage  # global virtual stage
            p = self.programs[q]
            if kind == sched.RECV_F:
                t0 = time.perf_counter()
                if S == 1:
                    x = self._ibuf_f.pop((c, mb))
                else:
                    x = self._recv("fwd_in", c, mb, step, hop)
                recv_s += time.perf_counter() - t0
                recv_bytes += x.nbytes
                self._inputs[(c, mb)] = x
            elif kind == sched.FWD:
                if p.first:
                    self._inputs[(c, mb)] = microbatches[mb]["tokens"]
                x = self._inputs[(c, mb)]
                t0 = time.perf_counter()
                with tracing.profile("pipe.fwd", category="pipe",
                                     stage=self.stage, mb=mb, chunk=c,
                                     step=step):
                    if p.last:
                        # stash only: the BWD computes the loss — F and B
                        # are adjacent here, a separate forward would
                        # double this stage's compute
                        self._y = None
                    else:
                        y, aux = p.fwd(self.params[q], x)
                        aux = float(aux)  # syncs the device
                        auxes.append(aux)
                        aux_by_mb[mb] = aux_by_mb.get(mb, 0.0) + aux
                        self._y = y
                compute_s += time.perf_counter() - t0
            elif kind == sched.SEND_F:
                t0 = time.perf_counter()
                if S == 1:
                    self._ibuf_f[((q + 1) // S, mb)] = self._y
                else:
                    self._send("fwd_out", (q + 1) // S, mb, self._y, step,
                               self._y.nbytes, hop)
                send_bytes += self._y.nbytes
                self._y = None
                send_s += time.perf_counter() - t0
            elif kind == sched.RECV_B:
                t0 = time.perf_counter()
                if S == 1:
                    dy = self._ibuf_b.pop((c, mb))
                else:
                    dy = self._recv("bwd_in", c, mb, step, hop)
                recv_s += time.perf_counter() - t0
                recv_bytes += dy.nbytes
                self._dy = dy
            elif kind == sched.BWD:
                x = self._inputs.pop((c, mb))
                t0 = time.perf_counter()
                with tracing.profile("pipe.bwd", category="pipe",
                                     stage=self.stage, mb=mb, chunk=c,
                                     step=step):
                    if p.last:
                        loss, aux, dparams, dx = p.bwd(
                            self.params[q], x, microbatches[mb]["targets"],
                            microbatches[mb]["mask"])
                        losses.append(float(loss))
                        auxes.append(float(aux))
                        # NOT folded into aux_by_mb: the last virtual
                        # stage's aux is already inside its loss
                    elif p.first:
                        dparams, dx = p.bwd(self.params[q], x,
                                            self._dy), None
                        self._dy = None
                    else:
                        dparams, dx = p.bwd(self.params[q], x, self._dy)
                        self._dy = None
                    acc = self._acc.get(q)
                    self._acc[q] = (dparams if acc is None
                                    else p.acc_grads(acc, dparams))
                    self._sync()
                    self._dx = dx
                compute_s += time.perf_counter() - t0
            elif kind == sched.SEND_B:
                t0 = time.perf_counter()
                if S == 1:
                    self._ibuf_b[((q - 1) // S, mb)] = self._dx
                else:
                    self._send("bwd_out", (q - 1) // S, mb, self._dx, step,
                               self._dx.nbytes, hop)
                send_bytes += self._dx.nbytes
                self._dx = None
                send_s += time.perf_counter() - t0
            else:
                raise ValueError(f"unknown schedule op {kind!r}")
        self._last_losses = losses
        reduce_launched = False
        if self.dp_group is not None and self._acc.get(self._q0()) is not None:
            # kick every bucket's cross-replica allreduce NOW, async: the
            # collectives run while the controller is still collecting
            # results and coordinating the clip across stages
            self._launch_reduce()
            reduce_launched = True
        # goodput attribution from the per-op timers this schedule already
        # keeps: recv waits are the pipeline bubble (idle until a neighbor
        # produces), send waits block on channel backpressure
        from ray_tpu_torch.util import goodput

        goodput.set_job(self.run_name)
        goodput.add("step_compute", compute_s)
        goodput.add("bubble", recv_s)
        goodput.add("collective_wait", send_s)
        goodput.count("steps")
        m = _pipe_metrics()
        tags = {"stage": str(self.stage)}
        m["send_seconds"].observe(send_s, tags=tags)
        m["recv_wait_seconds"].observe(recv_s, tags=tags)
        m["encode_seconds"].observe(
            hop["send_encode_s"] + hop["send_pickle_s"], tags=tags)
        if hop["send_wire_bytes"]:
            m["wire_bytes"].inc(hop["send_wire_bytes"], tags=tags)
        return {
            "stage": self.stage,
            "losses": losses,
            "aux": auxes,
            "aux_by_mb": aux_by_mb,
            "wall_s": time.perf_counter() - wall0,
            "compute_s": compute_s,
            "send_s": send_s,
            "recv_wait_s": recv_s,
            "send_bytes": send_bytes,
            "recv_bytes": recv_bytes,
            "hop": hop,
            "reduce_launched": reduce_launched,
        }

    def _launch_reduce(self):
        """Submit every bucket's grad allreduce to the async reducer (one
        ``train.bucket_allreduce`` span per bucket lands as each
        completes)."""
        self._bucketing()
        acc = self._acc[self._q0()]
        self._pending_reduce = [
            self._reducer.submit(b, {p: acc[p] for p in b.paths})
            for b in self._bucket_plan.buckets
        ]

    def _collect_reduced(self):
        """Fold completed bucket allreduces back into the accumulated
        grad tree (idempotent; no-op without a dp group)."""
        if self._pending_reduce is None:
            return
        from ray_tpu_torch.util import goodput

        q0 = self._q0()
        reduced: Dict[str, torch.Tensor] = {}
        with goodput.region("collective_wait"):
            for handle in self._pending_reduce:
                reduced.update(handle.result())
        self._pending_reduce = None
        self._acc[q0] = {p: reduced[p] for p in self._acc[q0]}

    # -- step boundary ---------------------------------------------------

    def grad_sqnorm(self) -> float:
        if not self._acc:
            raise RuntimeError(f"stage {self.stage}: no accumulated grads")
        self._collect_reduced()  # clip must see the cross-replica sum
        return float(sum(float(self.programs[q].grad_sqnorm(g))
                         for q, g in self._acc.items()))

    def apply_grads(self, scale: float) -> int:
        """Scale the accumulated grads (1/M and the coordinated global
        clip, folded into one factor by the controller) and step each
        chunk's optimizer. With ``bucket_bytes`` set the update applies
        bucket by bucket (per-bucket optimizer state, ``pipe.bucket_apply``
        spans) — bit-identical to the whole-tree apply for per-leaf
        transforms."""
        if not self._acc:
            raise RuntimeError(f"stage {self.stage}: no accumulated grads")
        self._collect_reduced()
        if not self.bucket_bytes:
            for q in self.chunks:
                self.programs[q].opt_apply(self._acc[q], scale,
                                           self.opt_state[q], self.params[q])
            self._acc = {}
            self._sync()
            self.step += 1
            return self.step
        from ray_tpu_torch.util import tracing

        q0 = self._q0()
        self._bucketing()
        params, grads = self.params[q0], self._acc[q0]
        for b in self._bucket_plan.buckets:
            with tracing.profile("pipe.bucket_apply", category="pipe",
                                 stage=self.stage, bucket=b.index,
                                 nbytes=b.nbytes, step=self.step):
                self.programs[q0].opt_apply(
                    {p: grads[p] for p in b.paths}, scale,
                    self.opt_state[q0][str(b.index)],
                    {p: params[p] for p in b.paths})
        self._acc = {}
        self._sync()
        self.step += 1
        return self.step

    # -- ckpt plane -------------------------------------------------------

    def save_ckpt(self, ckpt_root: str, step: int) -> str:
        """Per-stage checkpoint through the ckpt plane: one manifest over
        content-addressed chunks per stage, spec-tagged with this stage's
        geometry so a restore onto a different gang shape reshards
        no-gather (ckpt.restore_shards). Single-chunk ranks keep the
        pre-interleaving layout (params/opt_state at the top level);
        multi-chunk ranks nest per virtual stage under ``chunks``."""
        from ray_tpu_torch import ckpt
        from ray_tpu_torch.weights.spec import MeshSpec, ShardedTreeSpec

        if self.num_chunks == 1:
            q0 = self._q0()
            tree = {"params": self.params[q0],
                    "opt_state": self.opt_state[q0],
                    "step": np.int64(step)}
        else:
            tree = {"chunks": {str(q): {"params": self.params[q],
                                        "opt_state": self.opt_state[q]}
                               for q in self.chunks},
                    "step": np.int64(step)}
        spec = ShardedTreeSpec.from_tree(
            tree, MeshSpec.host_mesh([f"stage{self.stage}"]))
        store = ckpt.CheckpointStore(
            os.path.join(ckpt_root, f"stage{self.stage}"),
            name=f"{self.run_name}-s{self.stage}")
        man = ckpt.save_checkpoint(store, tree, step=step, spec=spec)
        return man.ckpt_id

    def _adopt(self, q: int, params: Dict[str, Any], opt_state: Any):
        """Restored chunk state (numpy leaves) onto this stage's device."""
        from ray_tpu_torch.ckpt.restore import to_torch

        self.params[q] = self.programs[q].bind(params)
        self.opt_state[q] = to_torch(opt_state, self.device)

    def restore_ckpt(self, ckpt_root: str,
                     target_step: Optional[int] = None) -> Optional[int]:
        """Restore per-chunk (params, opt_state) + step from this stage's
        latest manifest — or, with ``target_step``, the newest manifest at
        or below it (the controller's rollback when a crash mid-save left
        stages disagreeing). None when no usable checkpoint exists (the
        caller falls back to weight-plane init)."""
        from ray_tpu_torch import ckpt

        self._build_programs()
        store = ckpt.CheckpointStore(
            os.path.join(ckpt_root, f"stage{self.stage}"),
            name=f"{self.run_name}-s{self.stage}")
        manifest = store.latest()
        if target_step is not None:
            cands = [m for m in store.list() if m.step <= target_step]
            manifest = max(cands, key=lambda m: m.step) if cands else None
        if manifest is None:
            return None
        tree = ckpt.restore_tree(store, manifest.ckpt_id)
        self.params = self.params or {}
        self.opt_state = self.opt_state or {}
        if "chunks" in tree:
            saved = set(tree["chunks"])
            expect = {str(q) for q in self.chunks}
            if saved != expect:
                raise RuntimeError(
                    f"stage {self.stage}: checkpoint holds chunks "
                    f"{sorted(saved)} but this rank hosts {sorted(expect)} "
                    f"— restore with the run's original num_chunks")
            for q in self.chunks:
                sub = tree["chunks"][str(q)]
                self._adopt(q, sub["params"], sub["opt_state"])
            self.step = int(tree["step"])
            return self.step
        if self.num_chunks > 1:
            raise RuntimeError(
                f"stage {self.stage}: checkpoint is single-chunk but this "
                f"rank hosts {self.num_chunks} chunks — restore with the "
                f"run's original num_chunks")
        restored = tree["opt_state"]
        # bucketed opt state serializes as {bucket_index_str: state}; a
        # mode/bucket_bytes change between save and restore cannot be
        # silently adopted (apply_grads would index the wrong shape)
        was_bucketed = isinstance(restored, dict) and all(
            isinstance(k, str) and k.isdigit() for k in restored)
        if bool(self.bucket_bytes) != was_bucketed:
            raise RuntimeError(
                f"stage {self.stage}: checkpoint opt state is "
                f"{'bucketed' if was_bucketed else 'whole-tree'} but this "
                f"stage is configured "
                f"{'bucketed' if self.bucket_bytes else 'whole-tree'} "
                f"— restore with the run's original bucket_bytes setting")
        q0 = self._q0()
        self._adopt(q0, tree["params"], restored)
        if was_bucketed:
            plan = self._bucketing()
            expect = {str(b.index) for b in plan.buckets}
            if set(restored) != expect:
                raise RuntimeError(
                    f"stage {self.stage}: checkpoint has buckets "
                    f"{sorted(restored)} but the current plan has "
                    f"{sorted(expect)} — bucket_bytes changed between "
                    f"save and restore")
        self.step = int(tree["step"])
        return self.step

    # -- introspection / teardown ----------------------------------------

    def state_digest(self) -> Dict[str, float]:
        """Cheap content fingerprint for tests (param/opt sums + step)."""
        psum = float(sum(
            a.detach().double().sum().item()
            for q in self.chunks for a in self.params[q].values()))
        return {"step": self.step, "param_sum": psum}

    def pull_params(self) -> Dict[str, Any]:
        """This rank's parameters (all chunks merged — top-level keys
        partition disjointly) as CPU tensors (tests, small models;
        production consumers go through the weight plane)."""
        out: Dict[str, Any] = {}
        for q in self.chunks:
            out.update({k: v.detach().cpu()
                        for k, v in self.params[q].items()})
        return out

    def kernel_launches(self, reset: bool = False) -> Dict[str, int]:
        """This process's launch count of each attention kernel wrapper
        (``ops/attention.py:launch_counts``)."""
        from ray_tpu_torch.ops.attention import launch_counts

        return launch_counts(reset)

    def memory_stats(self, reset: bool = False) -> Dict[str, int]:
        """Peak and current bytes allocated on this stage's card (zeros on
        the CPU); ``reset`` restarts the peak."""
        if self.device.type != "cuda":
            return {"peak_bytes": 0, "allocated_bytes": 0}
        out = {"peak_bytes": torch.cuda.max_memory_allocated(self.device),
               "allocated_bytes": torch.cuda.memory_allocated(self.device)}
        if reset:
            torch.cuda.reset_peak_memory_stats(self.device)
        return out

    def close_channels(self, unlink: bool = False) -> bool:
        for chan in self._chans.values():
            try:
                chan.close(unlink=unlink)
            except Exception:  # raylint: disable=EXC001 teardown: a peer may have unlinked the segment
                pass
        self._chans.clear()
        return True

    def shutdown(self) -> bool:
        if self._reducer is not None:
            try:
                self._reducer.shutdown()
            except Exception:  # raylint: disable=EXC001 teardown: the reducer thread may already be gone
                pass
            self._reducer = None
        if self.dp_group is not None:
            from ray_tpu_torch import collective as col

            col.destroy_collective_group(
                f"{self.dp_group['name']}.s{self.stage}")
        self.close_channels(unlink=True)
        return True
