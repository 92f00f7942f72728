"""PipelineTrainer: MPMD pipeline-parallel training across stage actors, the
port of ``ray_tpu/train/pipeline/controller.py``.

One actor (gang member) per stage, microbatches streamed between stages
over the channel plane under a 1F1B schedule (schedule.py), per-stage
weight placement through the weight plane, per-stage checkpoints through
the ckpt plane, and gang re-formation + manifest restore on stage death.
The driver stays a pure conductor: it ships the op streams and the step's
host-side microbatch data, coordinates the cross-stage global-norm clip,
and never touches an activation byte.

Stages compute on the card unless ``device="cpu"``: on the card each stage
asks for ``num_gpus=1/num_stages`` (two stages of a one-card machine
share it, each in a worker forked for its half-card lease); on the CPU
each asks for one CPU, as the JAX package's stages do.

Loss/grad parity contract with the single-device ``TrainStepBundle``:
equal-size all-token microbatches make the mean of per-microbatch LM
losses equal the full-batch loss, grads accumulate as sums and apply with
a ``clip_scale / M`` factor, and the coordinated clip (sqrt of the summed
per-stage sqnorms) reproduces the optimizer's global-norm clip.
"""

from __future__ import annotations

import os
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.models.transformer import TransformerConfig
from ray_tpu_torch.train.pipeline import schedule as sched
from ray_tpu_torch.train.pipeline.partition import (
    partition_layers,
    rank_chunk_keys,
    select_keys,
    stage_param_keys,
)
from ray_tpu_torch.train.pipeline.stage import PipelineStage, channel_shm_paths
from ray_tpu_torch.utils import DeviceLike, resolve_device


@dataclass
class PipelineConfig:
    """Shape of the pipeline run (everything but the model itself)."""

    num_stages: int = 2
    num_microbatches: int = 4
    microbatch_size: int = 2
    seq_len: int = 128
    clip_global_norm: Optional[float] = 1.0
    ckpt_every: int = 0  # steps between per-stage checkpoints (0 = off)
    channel_capacity: int = 4 << 20
    # interleaved virtual stages (Megatron-style): each rank hosts this
    # many non-contiguous model chunks; bubble shrinks to
    # (S-1)/(S-1+V*M). V>1 requires num_microbatches % num_stages == 0.
    virtual_stages: int = 1
    # slots per channel edge: depth>=2 lets SEND_F overlap the next
    # compute op instead of blocking on the downstream ack
    channel_depth: int = 2
    # quantized activation streaming over the forward channels (None /
    # "int8" / "fp8" / "bf16" / "int8:128"-style spec). Gradients and
    # non-float leaves always stream exact; None is bitwise-identical to
    # the uncompressed path.
    activation_compression: Optional[str] = None
    step_timeout_s: float = 120.0
    max_recoveries: int = 3
    boundaries: Optional[List] = None  # explicit [start, stop) per stage
    # size-bounded bucketed optimizer apply on every stage (None = the
    # whole-tree apply). Per-bucket opt state + `pipe.bucket_apply` spans;
    # bit-identical to whole-tree apply for per-leaf transforms, and the
    # hook the stage-level dp_group replica allreduce rides on.
    bucket_bytes: Optional[int] = None

    @property
    def batch_size(self) -> int:
        return self.num_microbatches * self.microbatch_size


def make_microbatches(cfg: TransformerConfig, pipe: PipelineConfig,
                      seed: int, step: int) -> List[Dict[str, np.ndarray]]:
    """Deterministic synthetic LM microbatches for ``step``: the JAX
    package's numpy draws (the parity tests regenerate the identical batch
    for the single-device side)."""
    rng = np.random.default_rng(seed * 1_000_003 + step)
    out = []
    for _ in range(pipe.num_microbatches):
        tok = rng.integers(0, cfg.vocab_size,
                           (pipe.microbatch_size, pipe.seq_len + 1),
                           dtype=np.int32)
        out.append({
            "tokens": tok[:, :-1],
            "targets": tok[:, 1:],
            "mask": np.ones((pipe.microbatch_size, pipe.seq_len),
                            np.float32),
        })
    return out


class PipelineTrainer:
    """Drive S stage actors through 1F1B steps with recovery.

    ``params`` is the full model's state dict (flax paths; tensors or numpy
    arrays), or None to draw it from ``seed`` (``convert.init_params``).
    ``optimizer_factory`` (a zero-arg callable returning the port's
    ``AdamW``, shipped to every stage) must exclude global-norm clipping —
    pass ``pipe.clip_global_norm`` instead and the controller coordinates
    it across stages. ``device`` is where the stages compute: the card by
    default (raises when there is none), or ``"cpu"``.
    """

    def __init__(self, cfg: TransformerConfig, pipe: PipelineConfig,
                 *, params: Optional[Dict[str, Any]] = None,
                 optimizer_factory: Optional[Callable] = None,
                 ckpt_root: Optional[str] = None,
                 run_name: Optional[str] = None, seed: int = 0,
                 device: DeviceLike = None):
        from ray_tpu_torch._private.serialization import dumps

        self.device = resolve_device(device)  # raises without the card
        self.cfg = cfg
        self.pipe = pipe
        self.seed = seed
        self.run_name = run_name or f"pipe_{uuid.uuid4().hex[:8]}"
        self.ckpt_root = ckpt_root
        self.generation = 0
        self.step = 0
        self.last_saved_step: Optional[int] = None
        self.recoveries = 0
        self.restored_steps: List[int] = []
        self.history: List[Dict[str, Any]] = []  # per-step stats
        self.timings: Dict[str, float] = {}  # seeding and gang formation
        self._cfg_blob = dumps(cfg)
        self._opt_blob = dumps(optimizer_factory) if optimizer_factory \
            else None
        # with interleaving the partition cut is at virtual-stage (chunk)
        # granularity: P = S*V boundary ranges, chunk q living on rank q%S
        self.num_virtual = pipe.num_stages * pipe.virtual_stages
        self._bounds = (pipe.boundaries
                        or partition_layers(cfg.n_layers, self.num_virtual))
        self._schedule = sched.build_interleaved_schedule(
            pipe.num_stages, pipe.num_microbatches, pipe.virtual_stages)
        self.actors: List[Any] = []
        # the stage actors start while the driver publishes their weights
        self._start_gang()
        try:
            self._seed_weight_plane(params, seed)
            self._join_gang(restore=False)
        except BaseException:
            self.shutdown()
            raise

    # -- weight plane: per-stage placement -------------------------------

    def _stage_store_name(self, stage: int) -> str:
        return f"{self.run_name}_s{stage}"

    def _seed_weight_plane(self, params: Optional[Dict[str, Any]],
                           seed: int):
        """Initialize the full model once on the driver (unless given), cut
        it at the stage boundaries, and publish each subtree durable into
        that stage's weight store — stages pull only their own slice."""
        from ray_tpu_torch.weights import WeightStore

        if params is None:
            from ray_tpu_torch.models.convert import init_params

            params = init_params(self.cfg, seed=seed, device="cpu")
        self.init_params = params
        # cut at chunk granularity, publish per RANK (a rank's store holds
        # the merge of its chunks' disjoint key sets; the stage re-splits);
        # the ranks' stores take their publishes at once, one thread each
        S = self.pipe.num_stages
        subs = []
        for s in range(S):
            keys = [k for ks in rank_chunk_keys(
                self.cfg, s, S, self.pipe.virtual_stages,
                self._bounds).values() for k in ks]
            subs.append(select_keys(params, keys))

        def publish(s: int):
            store = WeightStore(self._stage_store_name(s))
            store.publish({"params": subs[s]}, durable=True)
            return store

        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=S) as pool:
            self._stores = list(pool.map(publish, range(S)))
        self.timings["publish_s"] = time.perf_counter() - t0
        self.timings["publish_bytes"] = sum(
            v.nbytes for sub in subs for v in sub.values())

    # -- gang lifecycle ---------------------------------------------------

    def _stage_options(self) -> Dict[str, Any]:
        if self.device.type == "cuda":
            return {"num_cpus": 1, "num_gpus": 1.0 / self.pipe.num_stages}
        return {"num_cpus": 1}

    def _form_gang(self, restore: bool):
        self._start_gang()
        self._join_gang(restore)

    def _start_gang(self):
        """Create the stage actors (without waiting for them)."""
        from ray_tpu_torch.util.scheduling_strategies import (
            NodeAffinitySchedulingStrategy,
        )

        pipe = self.pipe
        self._gang_t0 = time.time()
        # stage hand-offs ride the shm channel slots, which only exist on
        # one node: pin the gang to the driver's node
        here = ray_tpu_torch.get_runtime_context().get_node_id()
        self.actors = [
            PipelineStage.options(
                max_restarts=0,
                scheduling_strategy=NodeAffinitySchedulingStrategy(
                    node_id=here, soft=False),
                **self._stage_options()).remote(
                s, pipe.num_stages, self._cfg_blob, self._opt_blob,
                self.run_name, self.generation,
                channel_capacity=pipe.channel_capacity,
                boundaries=[list(b) for b in self._bounds],
                bucket_bytes=pipe.bucket_bytes,
                num_chunks=pipe.virtual_stages,
                channel_depth=pipe.channel_depth,
                activation_compression=pipe.activation_compression,
                device=str(self.device.type))
            for s in range(pipe.num_stages)
        ]

    def _join_gang(self, restore: bool):
        """Wait for the started stages, wire their channels, and give them
        their state: the per-stage checkpoints where ``restore`` finds
        them, else the weight plane's seed."""
        ready_at = ray_tpu_torch.get([a.ready.remote() for a in self.actors],
                                     timeout=180)
        self.timings["ready_s"] = max(ready_at) - self._gang_t0
        ray_tpu_torch.get([a.create_channels.remote() for a in self.actors],
                          timeout=60)
        ray_tpu_torch.get([a.open_channels.remote() for a in self.actors],
                          timeout=60)
        restored: Optional[int] = None
        if restore and self.ckpt_root:
            steps = ray_tpu_torch.get(
                [a.restore_ckpt.remote(self.ckpt_root)
                 for a in self.actors], timeout=300)
            if all(s is not None for s in steps):
                restored = min(steps)
                if len(set(steps)) != 1:
                    # a crash raced the per-stage saves: roll every stage
                    # back to the newest step ALL of them committed
                    steps = ray_tpu_torch.get(
                        [a.restore_ckpt.remote(self.ckpt_root, restored)
                         for a in self.actors], timeout=300)
                    if set(steps) != {restored}:
                        raise RuntimeError(
                            f"per-stage checkpoints cannot agree on a "
                            f"common step (got {steps}); the run needs a "
                            f"manual prune under {self.ckpt_root}")
        if restored is None:
            t1 = time.perf_counter()
            ray_tpu_torch.get(
                [a.init_weights.remote(self._stage_store_name(s))
                 for s, a in enumerate(self.actors)], timeout=600)
            self.timings["pull_s"] = time.perf_counter() - t1
            restored = 0
        self.step = restored

    def _kill_gang(self):
        for a in self.actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:  # raylint: disable=EXC001 teardown: the actor may already be dead
                pass
        self.actors = []
        # a dead writer cannot unlink its shm slots; reclaim them here so
        # generations never accumulate segments
        for path in channel_shm_paths(self.run_name, self.generation,
                                      self.pipe.num_stages,
                                      self.pipe.virtual_stages):
            try:
                os.unlink(path)
            except OSError:
                pass

    def _recover(self, err: Exception):
        from ray_tpu_torch.util import goodput

        self.recoveries += 1
        if self.recoveries > self.pipe.max_recoveries:
            raise RuntimeError(
                f"pipeline gang failed {self.recoveries}x "
                f"(max {self.pipe.max_recoveries}); last: {err}") from err
        t0 = time.monotonic()
        self._kill_gang()
        self.generation += 1
        self._form_gang(restore=True)
        self.restored_steps.append(self.step)
        goodput.set_job(self.run_name)
        goodput.add("reform_downtime", time.monotonic() - t0)
        goodput.count("reforms")

    # -- training ---------------------------------------------------------

    def _wait_all(self, refs: List, timeout: float) -> List[Any]:
        """wait-any loop (the TrainController idiom): a failure on ANY
        stage surfaces immediately instead of blocking behind stage 0."""
        by_idx: Dict[int, Any] = {}
        pending = {ref: i for i, ref in enumerate(refs)}
        deadline = time.monotonic() + timeout
        while pending:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"{len(pending)} pipeline stages stuck past "
                    f"{timeout}s — a dead neighbor wedges the schedule")
            ready, _ = ray_tpu_torch.wait(list(pending), num_returns=1,
                                          timeout=remaining)
            for ref in ready:
                by_idx[pending.pop(ref)] = ray_tpu_torch.get(ref, timeout=60)
        return [by_idx[i] for i in range(len(refs))]

    def _run_step(self, microbatches: List[Dict[str, np.ndarray]]
                  ) -> Dict[str, Any]:
        pipe = self.pipe
        S = pipe.num_stages
        t0 = time.perf_counter()
        refs = []
        for s, actor in enumerate(self.actors):
            data = None
            if s == 0 or s == S - 1:
                data = microbatches
            refs.append(actor.run_schedule.remote(
                self.step, [tuple(op) for op in self._schedule[s]], data))
        results = self._wait_all(refs, pipe.step_timeout_s)
        # coordinated global-norm clip: one scale for every stage
        scale = 1.0 / pipe.num_microbatches
        gnorm = None
        if pipe.clip_global_norm:
            sq = self._wait_all(
                [a.grad_sqnorm.remote() for a in self.actors], 60.0)
            gnorm = float(np.sqrt(sum(sq))) / pipe.num_microbatches
            clip = pipe.clip_global_norm
            scale *= clip / max(gnorm, clip)
        self._wait_all([a.apply_grads.remote(scale) for a in self.actors],
                       60.0)
        last = results[-1]
        coef = self.cfg.moe_aux_coef
        # the final virtual stage's loss already includes ITS aux term;
        # fold in every other chunk's aux so the reported loss matches the
        # single-device objective. Keyed by microbatch (aux_by_mb) — with
        # interleaving a rank's aux arrives in virtual-microbatch order,
        # not microbatch order.
        upstream_aux = float(np.mean([
            sum(r["aux_by_mb"].get(i, 0.0) for r in results)
            for i in range(pipe.num_microbatches)])) \
            if self.num_virtual > 1 else 0.0
        loss = float(np.mean(last["losses"])) + coef * upstream_aux
        stats = {
            "step": self.step,
            "loss": loss,
            "losses_mb": last["losses"],
            "grad_norm": gnorm,
            "step_s": time.perf_counter() - t0,
            "wall_s": max(r["wall_s"] for r in results),
            "compute_s": [r["compute_s"] for r in results],
            "send_s": [r["send_s"] for r in results],
            "recv_wait_s": [r["recv_wait_s"] for r in results],
            "send_bytes": [r["send_bytes"] for r in results],
            "hop": [r["hop"] for r in results],
            "activation_bytes_per_mb": (
                results[0]["send_bytes"] // pipe.num_microbatches
                if S > 1 else 0),
        }
        return stats

    def train(self, num_steps: int) -> List[Dict[str, Any]]:
        """Run until ``self.step == num_steps`` (absolute), recovering
        from stage death by re-forming the gang and restoring the last
        per-stage checkpoints. Returns the per-step stats appended this
        call."""
        out = []
        while self.step < num_steps:
            microbatches = make_microbatches(self.cfg, self.pipe, self.seed,
                                             self.step)
            try:
                stats = self._run_step(microbatches)
            except Exception as e:  # stage death / wedged schedule
                self._recover(e)
                continue  # re-run from the restored step
            self.step += 1
            self.history.append(stats)
            out.append(stats)
            if (self.pipe.ckpt_every and self.ckpt_root
                    and self.step % self.pipe.ckpt_every == 0):
                try:
                    self.save()
                except Exception as e:  # a stage died mid-save: the
                    # re-formed gang rolls back to the newest step ALL
                    # stages committed (partial manifests are ignored)
                    self._recover(e)
        return out

    def save(self) -> List[str]:
        ids = self._wait_all(
            [a.save_ckpt.remote(self.ckpt_root, self.step)
             for a in self.actors], 300.0)
        self.last_saved_step = self.step
        return ids

    def merged_params(self) -> Dict[str, Any]:
        """Pull and merge every stage's params (tests/small models)."""
        from ray_tpu_torch.train.pipeline.partition import merge_params

        return merge_params(self._wait_all(
            [a.pull_params.remote() for a in self.actors], 120.0))

    def shutdown(self):
        for a in self.actors:
            try:
                ray_tpu_torch.get(a.shutdown.remote(), timeout=10)
            except Exception:  # raylint: disable=EXC001 teardown: the stage may already be dead
                pass
        self._kill_gang()
        for store in getattr(self, "_stores", []):
            store.shutdown()


def repartition_manifest_leaves(ckpt_root: str, cfg: TransformerConfig,
                                old_stages: int, new_stages: int
                                ) -> List[List[str]]:
    """Stage-granularity resharding map: for each NEW stage, which leaf
    paths to read from which OLD stage manifests. Pure planning (the
    actual reads go through ckpt.restore_shards per stage, chunk-sliced —
    no stage ever reads a byte outside its slice; the plan is no-gather
    by construction because param keys partition disjointly)."""
    old_keys = [set(stage_param_keys(cfg, s, old_stages))
                for s in range(old_stages)]
    out = []
    for s in range(new_stages):
        need = stage_param_keys(cfg, s, new_stages)
        rows = []
        for key in need:
            src = next(i for i, ks in enumerate(old_keys) if key in ks)
            rows.append(f"stage{src}:{key}")
        out.append(rows)
    return out
