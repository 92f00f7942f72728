#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

1. device: the card's name, count, and ``nvidia-smi``'s name and power limit;
2. build: every kernel of the training and serving paths built from
   ``ray_tpu_torch/csrc`` with nvcc for sm_90a (one nvcc per source, all
   at once), with nvcc's ``-Xptxas -v`` report;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the two paths give it, in bf16 and fp32, causal and full, and
   the bf16 forward on q, k, v sliced from one fused tensor; its time, the
   plain version's, one PyTorch library call's, and the bound: the flash
   forward at the serving and training shapes (timed in turns with
   ``flash_fwd_mma``, the forward's earlier ``mma.sync`` design, kept in the
   library as a yardstick only); the backward at the 1b training shape, at
   350m's head dims and at ragged S: bf16 ``flash_bwd`` (dQ, dK, dV in one
   kernel, what training runs), the bf16 dK/dV kernel and dQ kernel on
   their own, the fp32 pair, and the prep ``flash_bwd_prep`` (Delta, and
   the dQ accumulator and counters cleared, exactly zero also over NaN
   and -1) beside the earlier Delta kernel ``flash_bwd_delta``, with
   ``flash_bwd`` timed in turns with the dK/dV kernel, the earlier
   ``mma.sync`` pair (``mma_ms``), the whole bf16 backward as
   ``flash_attention_bwd`` runs it (``backward_ms``: prep, kernel, cast)
   and the library's backward (``library_ms``); the prep timed against
   the earlier design (``flash_bwd_delta`` and the two ``torch.zeros``)
   over PREP_ROUNDS rounds in turns, through the wrapper, as C-entry
   launches back to back and replayed from a CUDA graph, beside vecdot and
   vecdot with the zeros (``time_prep``);
4. training: ``TrainStepBundle`` at the 1b config's full width and depth
   (random weights from a seed) takes steps on one batch of 4 x 2048
   tokens; the loss must fall, the kernels must launch 2 x n_layers
   (forward and remat) and n_layers (``flash_bwd`` and the prep; the pair
   never) times a step, and one step's loss and gradients are held against
   the same step with plain attention; step time, tokens/s, MFU, peak
   memory, and where a step's device time goes (``torch.profiler``);
5. head_dim-64 kernels: the forward and the whole bf16 backward (the prep
   and ``flash_bwd``) against plain at the MoE and ViT training shapes, moe-1b
   (4 x 2048, 16 query and 16 KV heads, causal) and ViT-B/16 (64 images x
   197 tokens, 12 heads, full), each timed beside its bound and the
   library's call;
6. MoE layer: one ``MoEMLP`` at moe-1b width on the training's 4 x 2048
   tokens (two groups), fp32, on the card and on the CPU from the same
   weights and input, at moe-1b's capacity and at one that drops slots:
   the same routing (experts, slots, keep), outputs and aux within fp32's
   sums;
7. MoE training: ``TrainStepBundle`` at moe-1b's full width and depth
   (random weights from a seed) on one batch of 4 x 2048, as phase 4: the
   loss must fall, the kernels launch as for the 1b model, one step's loss
   and gradients are held against plain attention running the same
   routing (the share of tokens its own router would route otherwise is
   bounded apart), and a profiled step books the router, the
   dispatch and combine, and the expert products by name;
8. ViT training: ``VisionTransformer`` at vit-b16-224 on a batch of 64
   synthetic images (the brightest-quadrant task of tests/test_moe_vit.py
   at 224 x 224) with ``make_optimizer``: the loss must fall below a
   quarter of ln 4 and the batch be fitted, where the head alone trained
   the same way stays above it, the kernels launch once a layer each
   (forward, the prep, ``flash_bwd``), one step's logits and gradients are
   held against plain attention; step time, images/s, peak memory;
9. serving: ``LLMServer`` over ``TorchLLMEngine`` at the 1b config's full
   width (random weights from a seed, default engine geometry) answers
   concurrent completion requests; the kernel launch counts of that run
   are held against the prefill calls, and one admitted batch's prefill
   logits against the same batch with plain attention;
10. parallel: a collective group of world size 1 over NCCL (the machine
   has one card) with every ``TorchGroup`` op checked exactly;
   ``ring_attention`` and ``ulysses_attention`` through it against
   ``FlashAttention``; the ring's per-step math for 4 and 8 virtual ranks
   on one 16384-token sequence (16 heads, head_dim 128, bf16, causal and
   full) through the kernels, against the unsharded kernels and the plain
   version within bounds derived from theirs, with each block kind's time
   (the ``ring_attention`` path of the launch counts); the int8 and fp8
   codecs on the card at the 1b's parameter count against the CPU's; and
   the 1b trained on a ``data=1`` mesh (the ``mesh_training`` path) and
   on a world-1 mesh of every axis, its fsdp gathers and reduce-scatters,
   its tensor axis's reductions and its seq axis's one-rank ring running
   as one-rank collectives (the ``mesh_fsdp_tensor`` path), and moe-1b at
   full width and depth on a world-1 mesh of every axis (the
   ``mesh_seq_expert`` path: also the MoE layers' routing exchange, global
   statistics and expert collectives), each against the single-device
   step, with step times, busy share, peak memory and device ms by part
   (NCCL's kernels by kind) side by side; a ``parallel metrics:`` line;
11. tensor parallel: the tensor axis's per-rank math at full width for
   virtual ranks in one process: the 1b's block at 4 x 2048 over 2, 4
   and 8 ranks (8: 2 query heads and 1 KV head a rank) and one block of
   the 7b at 1 x 4096 over 4 and 8, each rank's attention and MLP through
   the port's modules and the flash kernels, the reductions summed
   in-process, forward and backward held against the unsharded block
   within a derived bound (the ``tensor_parallel`` path); the
   vocabulary-parallel cross entropy at V = 32000 against ``lm_loss``;
   the kernels and the library's attention at each rank's shape, beside
   the bounds; a ``tensor parallel metrics:`` line;
12. seq and expert parallel: the seq axis's per-rank math at full width
   for virtual ranks in one process: the 1b's block at 4 x 2048 over 2
   and 4 seq ranks (ring blocks of 4 x 1024 and 4 x 512 at 16/16 heads,
   K/V repeated; global RoPE positions), through the ring's per-step
   functions and the flash kernels, forward and backward held against the
   whole block with plain attention within a derived bound (the
   ``seq_parallel`` path), and the kernels at each block shape, diagonal
   and off-diagonal, against plain and timed beside the bounds and sdpa;
   moe-1b's MoE layer in fp32 at 4 x 2048 on 2, 4 and 8 virtual expert
   ranks and 2 and 4 token ranks (``MoEMLP.forward_ranks`` over
   ``expert_parallel.VirtualRanks``) against the whole layer: the same
   routing, and out, aux and gradients within fp32's sums; ``seq parallel
   metrics:`` and ``expert parallel metrics:`` lines;
13. traced training: the 1b at full width and depth on one batch of 4 x
   2048, untraced then traced (``util.tracing`` on: ``train.step`` >
   ``train.fwd_bwd``, ``train.optimizer``) from the same parameters, the
   traced run's launches counted (the ``traced_training`` path): losses
   equal to a stated rounding, the span tree, each phase's span beside a
   profiled traced step's device ms, the ``ray_tpu.train.*`` histograms and
   the goodput ledger's shares; the explicit bucketed tier over NCCL at
   world 1 on the 1b's gradients (``AsyncBucketReducer`` with each codec
   against its rounding, with wire bytes and rates;
   ``ShardedBucketOptimizer`` against ``make_optimizer``'s AdamW); and the
   traced sharded step's per-bucket math on 2 and 4 virtual data ranks in
   one process (the ranks' backwards on their rows, every bucket's
   reduce-scatters as list operations on fp32, the bf16 wire, int8 and
   fp8, the sharded update) against the single-device step within derived
   bounds; a ``traced training metrics:`` line;
14. checkpointed training: the 1b at full width and depth fed by the
   native ``TokenFileLoader`` from a synthetic 2^26-token uint16 file
   (its first batches equal to the numpy route's), 6 steps uninterrupted,
   then 6 steps with ``CheckpointSaver.save`` after step 3 committing in
   the background, then ``restore_tree`` into a fresh bundle (every tensor
   equal to the state at the save, bit for bit) resuming steps 4-6 on a
   fresh loader, each run's losses held against the uninterrupted one's
   (the ``checkpointed_training`` path); the pause, the host copy's rate,
   the commit, the bytes written, the restore and the step times with the
   save in flight on a ``checkpoint metrics:`` line;
15. runtime serving: the port's runtime on this machine
   (``ray_tpu_torch.init(num_cpus=4)``, no GPU count given), whose raylet
   must advertise as ``GPU`` the cards torch and ``nvidia-smi`` see; a
   ``num_gpus=1`` task returns a 256 MiB bf16 tensor made on the card,
   bit-equal to the driver's own; an actor with ``num_gpus=1`` builds
   phase 9's 1b ``LLMServer`` (seed 0) and answers phase 9's 12 greedy
   requests in one call, token for token as phase 9 did, its ``flash_fwd``
   launches (counted in the actor, read back through it: the
   ``runtime_serving`` path) equal to phase 9's; a second ``num_gpus=1``
   actor pends until the first is killed; init time, empty-task round
   trips, actor calls, put/get rates of a 256 MiB CPU tensor, the actor's
   start-to-ready time and its decode rate beside phase 9's on a ``runtime
   metrics:`` line;
16. runtime training: ``TorchTrainer.fit()`` on a new port cluster
   (``ray_tpu_torch.init(num_cpus=4)``, the card as ``GPU``) with one
   ``num_gpus=1`` worker (``ScalingConfig(use_gpu=True)``) and
   ``FailureConfig(max_failures=1)``; the loop (``runtime_training_loop``,
   sent by value) builds phase 4's 1b bundle (seed 0) at full width and 4
   of its 16 layers on the worker's card and trains on phase 4's batch for
   6 steps, reporting each step's loss, seconds and kernel launches
   (counted in the worker: the ``runtime_training`` path); after step 3 a
   report carries a ``Checkpoint`` directory of the whole 3.84 GB state
   (the phase's host seconds scale with its bytes); the first worker
   ``os._exit``s after step 4 once that checkpoint is committed, the
   controller re-forms the group in a fresh process that resumes from step
   3. Checks: one re-form (the controller's goodput ``reforms``), two pids,
   each worker's ``CUDA_VISIBLE_DEVICES`` a card, the card at least 90 %
   free as the second worker starts, step 1's loss equal to the same 6
   steps' at the same depth in the driver (``cut_training_reference``) and
   every step within CKPT_LOSS_RTOL of it, the kernels' launches a step
   those of 4 layers in each incarnation; a ``runtime training metrics:``
   line (time to the first report, each group's formation, the worker's
   median step beside the reference's, the report's round trip, the checkpointed
   report's pause and the commit, the controller's ``reform_downtime``,
   the restore and host-to-device seconds, the whole fit);
17. serve and weights: a new port cluster whose object store is sized
   from ``/dev/shm`` (the version spills to disk where it does not fit), a
   detached ``WeightStore``, the HTTP proxy, and ``build_openai_app`` of
   the 1b at full width and 4 of its 16 layers (seed 0, the default
   ``EngineConfig``) on two replicas of ``num_gpus=0.5`` each, bound to
   shares of the one card; phase 9's 12 greedy requests over HTTP, one at
   a time, 32 new tokens each, equal token for token (ids, text and finish
   reason) to an in-process ``LLMServer`` at the same depth answering them
   the same way; then 4 client threads keep sending requests while the
   driver publishes seed-1 weights as version 1 (``WeightStore.publish``,
   1.28 GB of fp32) and
   ``handle.broadcast("update_weights", ...)`` makes each replica pull
   them, build its compute copies on the card and swap them in between
   steps: both acknowledge version 1, no request fails and more than 20
   are answered; the 12 requests again equal in-process serving of the
   seed-1 weights token for token; each replica's ``flash_fwd`` launches
   (counted in the replica, set to 0 before the first HTTP round and read
   after the last: the ``serve`` path) are above 0; a ``serve weights
   metrics:`` line (replicas ready, HTTP latency and the engine's TTFT,
   decode tokens/s, publish and each replica's pull and swap, the
   broadcast's acknowledgement, requests answered during the swap and
   dropped, each replica's peak memory, ``/dev/shm``, the card); then the
   port's gRPC ingress (``serve/grpc_ingress.py`` on the port's own
   HTTP/2) started in its detached actor: the 12 requests through
   ``ServeGrpcClient.call`` to the same deployment, equal to in-process
   serving of the seed-1 weights token for token, and streamed through
   ``ServeGrpcClient.stream`` from a small generator deployment
   (``GrpcStreamer``) that asks the 1b deployment for each answer in turn,
   every chunk equal as well and the first in before half the stream's
   wall; the replicas' counts, set to 0 before the gRPC rounds and read
   after them, are the ``serve_grpc`` path (``flash_fwd`` above 0); a
   ``serve grpc:`` line (the proxy's start seconds, the gRPC p50 and max
   latency beside the HTTP round's for the same requests, the stream's
   first chunk and wall); the proxy actor is killed with the phase;
18. pd and batch inference: a new port cluster; ``build_pd_openai_app``
   of the 1b at full width and depth (seed-0 weights drawn in each
   worker, the default ``EngineConfig``) with one prefill and one decode
   worker of ``num_gpus=0.5`` each; a prefill reply seen by the driver is
   a ``DeviceObjectMarker``; phase 9's 12 greedy prompts, one at a time,
   32 new tokens each, equal token for token to an in-process
   ``LLMServer`` of the whole 1b answering them one at a time
   (``in_process_answers``), each request's KV pulled once by the decode worker from the
   prefill worker; the prefill worker's ``flash_fwd`` launches above 0 and
   the decode worker's 0 (the ``pd`` path); then ``build_llm_processor``
   of the 1b over ``from_items`` of the same prompts in 3 blocks: 12 rows
   in order, each block equal token for token to an in-process
   ``generate`` of its prompts, the engine actor's ``flash_fwd`` launches
   above 0 (the ``batch_inference`` path); ``iter_device_batches`` on the
   card equal to ``iter_batches``; a ``pd batch metrics:`` line (workers
   and engine actor ready, each PD request's latency and TTFT, KV bytes
   and pull seconds a request, the decode worker's tokens/s, batch
   inference rows/s and tokens/s, device-batch GB/s and ``input_stall``
   share, each worker's peak memory, the card);
19. runtime faults: a new port cluster with tracing on in every process;
   a ``num_gpus=1`` actor of the 1b at full width and depth (seed 0) with
   ``max_restarts=1`` answers phase 9's 12 greedy prompts at once, 32
   tokens each, token for token as phase 18's in-process serving; killed
   with ``kill(actor, no_restart=False)``, it comes back on a detected
   card once the old worker has exited and answers again the same way,
   its ``flash_fwd`` launches above 0 (the ``runtime_restart`` path); one
   prompt's tokens streamed from it (``num_returns="streaming"``) equal
   phase 9's, a second stream cancelled after 4 tokens raises
   ``TaskCancelledError`` and the actor answers again; a span recorded in
   the actor is in the driver's ``get_spans()`` and the GCS timeline; the
   1b's fp32 params at 4 of its 16 layers (1.28 GB: the seconds of the
   host paths below scale with the tree's bytes) checkpointed through the
   object-plane tier
   (``ObjectPlaneBackend``), evicted locally, restored from the vault
   bit-equal, and the store listed by ``state.list_checkpoints()``; then a
   ``cluster_utils.Cluster`` of two nodes, the card on the second: a
   ``num_gpus=1`` task there returns the same params, pulled across the
   raylets to the driver on the head bit-equal; then a store of 1 GiB
   takes the tree's leaves (they spill to local disk) and gives them back
   bit-equal; a ``runtime ft metrics:`` line (kill-to-ready and
   kill-to-first-answer seconds, each round's wall, stream and cancel
   seconds, the checkpoint's save, mirror and restore, the pull's and the
   spill's and restore's GB/s, each worker's peak memory, the card);
20. pipeline: the one-device ``TrainStepBundle`` of the 1b at full width
   and depth (seed 0, ``make_stage_optimizer``'s AdamW with a global-norm
   clip of 1.0) takes 3 steps on the concatenation of
   ``make_microbatches``' four 1 x 2048 microbatches, each step's
   microbatching delta and gradient measured on its params, and a second
   copy of the same params takes 3 steps on the mean of the microbatches'
   gradients; then a new port cluster, and a ``PipelineTrainer`` of the
   same 1b from the same initial params: two stage actors of
   ``num_gpus=0.5`` on the one card (8 layers each, remat), seeded through
   their weight stores, 1F1B over shared-memory channels of depth 2 (8 MiB
   bf16 activations and gradients a hop), the controller's coordinated
   clip; 3 steps whose losses, gradient norms at steps 0 and 1, and each
   stage's params after the last step lie within the bounds derived from
   the reference (PIPE_*'s notes), and each stage's ``flash_fwd``,
   ``flash_bwd`` and prep launches (counted in the stage: the
   ``pipeline`` path) equal to its layers' count a microbatch; before it,
   a compiled graph of three host actors whose values equal the eager
   chain's; a ``pipeline metrics:`` line (stages ready, the seeding's
   publish and pulls, the median step beside the reference's, each
   stage's idle and receive-wait share beside the 1F1B bubble bound, the
   activation bytes a microbatch, send and receive seconds a hop, each
   stage's peak memory, the compiled and eager chains' p50 ms);
21. rl: the RL library (the ``rl`` path: its nets are MLPs and it
   launches no kernel, so the kernels line is unchanged). (a) Each
   learner on the card and on the CPU from the same params (drawn on the
   CPU from the config's seed) and the same seeded batch, at the JAX
   defaults' sizes: PPO's default update (8 epochs x 4 minibatches, 32
   clipped Adam steps on 1024 samples), one IMPALA V-trace step, one
   double-Q DQN step, one SAC step (128 x 128) on 256 samples with the
   same noise: every parameter within ``rl_bound`` (fp32 sums over the
   batch in other orders, each step's rounding), each update's ms on both;
   (b) a new port cluster: PPO at the JAX defaults (seed 1, 2 runners x 4
   envs x 128 steps) for tests/test_rl.py's 21 iterations with its
   learner on the card, its best return past 60 and its env runners never
   initialising CUDA; (c) a ``LearnerGroup`` of two ``num_gpus=0.5`` PPO
   learners over gloo on one fixed batch stream, fp32 then int8: ranks
   bit-equal, fp32 within the bound of one learner on the card, int8's
   losses within 2 % of fp32's; an ``rl metrics:`` line (env steps/s,
   sample and update s an iteration, first and best return, the
   learner's peak memory, each update's ms on card and CPU, the groups'
   ready and update s);
22. cluster services and tune (the ``tune`` path): a head started by the
   port's CLI (``start --head --include-dashboard``, a subprocess) whose
   ``/api/nodes`` shows the card as ``GPU: 1.0``; a job ``POST``ed to the
   dashboard's ``/api/jobs`` with a ``working_dir`` holding its entrypoint,
   a ``Tuner`` sweep of 4 learning rates (phase 4's 1e-4 among them) under
   ASHA (grace 2, reduction 2, max_t 6, loss, min), 2 trials at a time of
   ``{"CPU": 1, "GPU": 0.5}``, each training the 1b at full width and
   depth from phase 4's seed, optimizer and batch for up to 6 steps and
   reporting each loss and its kernels' launches; the job must succeed,
   every trial's first loss equal phase 4's, the 1e-4 trial's losses lie
   within TUNE_LOSS_RTOL of phase 4's, each trial launch ``flash_fwd`` 32,
   ``flash_bwd`` 16 and the prep 16 times a step, stop where ASHA replayed on
   the logged report stream stops it, and the grid's best be the argmin of
   the final losses; ``/metrics`` parses as Prometheus text and counts
   each trial's steps, ``/api/timeline`` holds the ``_run_trial`` tasks,
   ``/api/health`` and ``/api/goodput`` answer, the agent
   (``get_node_stats(agent=True)``) lists each trial's worker with an RSS,
   the CLI's ``status``, ``job list``, ``timeline`` and a 1 s a benchmark
   ``microbenchmark`` exit 0; SIGINT stops the head and the card's memory
   comes back; a ``cluster services metrics:`` line (head ready s,
   submit-to-``RUNNING`` s, each trial's worker-ready s, steps, losses and
   peak memory, the sweep's wall, the endpoints' and the CLI's seconds, the
   microbenchmark's rates);
23. autoscaler and client (the ``autoscaled_serving`` path): a host
   process (``AUTOSCALE_HOST``) starts a port ``cluster_utils.Cluster``
   whose head advertises ``{"CPU": 4, "GPU": 0}``, an ``Autoscaler`` over
   ``FakeMultiNodeProvider`` with one node type ``gpu_worker`` of ``{"CPU":
   2, "GPU": 1}`` (at most one node: a second would bind the same card),
   idle timeout 5 s, polled every 0.5 s, and ``start_client_server``; this
   process reaches it only through ``ray_tpu_torch.init(address=
   "ray-tpu://...")``: a ``util.multiprocessing.Pool`` maps phase 9's 12
   prompts through the port's tokenizer as CPU tasks, every id list equal
   to the driver's own; a ``num_gpus=1`` actor (``RuntimeServer``, sent by
   value from the client) pends until the autoscaler launches exactly one
   ``gpu_worker``, builds phase 9's 1b ``LLMServer`` at full width and
   depth there on the card and answers phase 9's 12 greedy requests in one
   call, token for token as phase 9 did, its ``flash_fwd`` launches
   (counted in the actor) equal to phase 9's; ``nodes()`` seen from the
   client shows the new node's ``GPU: 1.0`` and its ``ray.io/node-type``;
   once the actor is killed the autoscaler drains and terminates the idle
   node, the provider holds none, only the head is alive and the card's
   used memory (``nvidia-smi``) comes back within 1 GiB; an ``autoscaler
   client metrics:`` line (connect s, the Pool map's s, creation to launch,
   to registration and to a ready actor, the requests' wall and decode
   tokens/s beside phase 9's, kill to termination, the actor's peak
   memory, the card); every process the phase started is gone within
   ``AUTOSCALE_GONE_S`` of the host's exit (the terminated node's raylet
   is killed, so its forked workers exit only once they find it gone;
   ``processes_gone_s``).

Every process the script starts inherits ``CHIP_SMOKE_RUN`` in its
environment. At the end, passed or failed, the script waits for those
still alive and kills any left after ``STRAGGLER_GRACE_S`` (named on
standard error), so it leaves no process running.

The prep's rows, and the forward's at each rank's shape, also carry the
kernel's time without the wrapper's host path: 20 launches of the C entry
back to back, and the same replayed from a CUDA graph (``time_launches``,
``time_prep``).

Each path's launch counts are set to 0 just before it runs and read just
after, so the comparisons with the plain versions do not count.

The line before the last is ``{"kernels": [...]}`` (a kernel's ``launches``
is the sum over the paths it lies on, ``launches_by_path`` splits it; its
times are at the serving shape for the forward, with ``flash_fwd_mma``'s as
``mma_ms`` and the training shape's under ``train_shape``, and at the
training shape for the backward, ``flash_bwd`` with ``backward_ms`` and
``mma_ms``, the prep with the earlier design's times beside its own
(``earlier_*``), its min and spread, ``back_to_back_ms`` and ``graph_ms``,
``vecdot_ms`` and ``vecdot_zeros_ms``; ``d64_shapes`` holds the
forward's, ``flash_bwd``'s, the prep's and the earlier Delta kernel's at
the MoE and ViT shapes, ``tensor_parallel_shapes`` theirs at each rank's
shape of phase 11, ``seq_parallel_shapes`` at each ring block of phase
12; the earlier Delta kernel ``flash_bwd_delta`` has no wrapper, and its
launches are its C entry's, counted in ``_launch`` and read through
``launch_counts`` like the wrappers'; every path wants them 0); the last
line is ``{"ok": true, "device": {...}}``. With no card, or outside a
checkout of the repository, it prints no result and exits non-zero.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

# Tolerances of kernel against plain, on the same inputs on the card: an
# element passes when |got - ref| <= atol + rtol * |ref| + pv * (P |V|), where
# P |V| is the plain version's output on |v| (the softmax-weighted mean of
# |v|). fp32: the reference's own flash bound (tests/test_models_ops.py);
# the kernel's hi/lo bf16 split keeps ~16 mantissa bits per product.
# bf16: the kernel rounds each unnormalised probability to bf16 before P V
# and the plain version each normalised one, each within 2^-8 of its value
# (8 significant bits), so their P V differ by at most 2^-7 * P |V| when
# the two roundings fall on opposite sides; the term is set at 2^-8, as the
# independent roundings part by far less, and has held at every shape on
# the card (PERF.md); both round o to bf16 (under rtol). The atol is slack
# for fp32 sums in other orders.
# lse is an fp32 sum of exact bf16 products in both, so 1e-3.
TOL = {"float32": {"o": (2e-3, 2e-2, 0.0), "lse": (1e-3, 0.0, 0.0)},
       "bfloat16": {"o": (1e-3, 2e-2, 2.0 ** -8), "lse": (1e-3, 0.0, 0.0)}}
# prefill logits of the 16-layer 1b model, kernel vs plain attention, bf16:
# both round attention's output to bf16 at different points; the logits are
# ~N(0, 1) fp32 products of the final bf16 hidden state.
LOGITS_TOL = (5e-2, 2e-2)
# The backward kernels against the plain backward, per element of dq, dk,
# dv: |got - ref| <= atol + rtol * |ref| + m * M, with M the same product on
# absolute values (|dS| |K|, |dS|^T |Q|, P^T |dO|, from
# ``ops.attention.bwd_products``). bf16: the kernel rounds P and dS to bf16
# (8 significant bits: within 2^-8 of the value) before the products that
# take them, where the plain version keeps them in fp32, which moves a
# product by at most 2^-8 M; both round the result to bf16 (within 2^-8 of
# it each, under rtol). The atol is slack for fp32 sums in other orders:
# dP - Delta cancels in rows that see few keys, and its fp32 rounding
# (~1e-6 of sum |dO| |V| ~ 1e2 at D = 128) times scale and |K| stays under
# 1e-4. fp32: the reference's own flash bound (tests/test_models_ops.py), as
# for the forward; the hi/lo split keeps ~16 bits of every operand.
BWD_TOL = {"float32": (2e-3, 2e-2, 0.0), "bfloat16": (1e-4, 2e-2, 2.0 ** -8)}
# Delta = rowsum(dO * O), kernel against plain: both sum D exact products
# (bf16 or fp32 operands) in fp32, in other orders; with D = 128 and
# sum |dO O| up to ~1e2 that parts them by at most 128 * 2^-24 * 1e2 ~ 8e-4.
DELTA_TOL = (1e-3, 0.0, 0.0)
# One training step of the 1b model with the kernels against the same step
# with plain attention (``attention_impl="xla"``), bf16, same params and
# batch. Loss: a token's NLL moves by at most twice the largest logit change,
# and prefill logits of kernel vs plain attention agree within LOGITS_TOL's
# 5e-2, so 0.1. Gradients, per leaf ||g_kernel - g_plain|| / ||g_plain||: the
# two differ by a few bf16 roundings (2^-8 each) in each layer's attention,
# its output in the forward and P, dS in the backward; summed with no
# cancellation over 16 layers and 2 passes, 32 * 2^-8 = 0.125.
TRAIN_LOSS_TOL = 0.1
TRAIN_GRAD_TOL = 32 * 2.0 ** -8
# moe-1b's step, kernels against plain attention: the plain step replays
# the kernel step's routing (each MoE layer's experts), so the two run the
# same discrete choices and their gradients are held at TRAIN_GRAD_TOL as
# the dense model's. How many tokens the plain step's own router would
# route otherwise is bounded apart: the router logits spread ~0.64 (std
# 0.02 weights on 1024 unit inputs), a token's 8 about 0.2 apart. Kernel
# and plain attention round P to bf16 at other points, which moves a
# layer's attention output by ~2^-9 of its size and the normalised router
# input by ~1e-3 (attention is about half the residual stream at these
# weights), so the logits by ~1e-3 x 0.64: a token flips where its two
# boundary logits are that close, ~0.3 % of tokens a layer, a few times
# that where earlier layers' changes add up. Bound: 5 % of the tokens of
# all MoE layers.
MOE_ROUTE_TOL = 0.05
# One MoE layer in fp32 on the card against the CPU, same weights and
# input, at moe-1b's capacity factor and at MOE_DROP_CAPACITY (about half
# the slots of a balanced router's load, so slots are dropped): routing
# must be equal (fp32 products, TF32 off); outputs to the
# rounding of fp32 sums of up to F = 2816 products in other orders (F x
# 2^-24 = 1.7e-4 of the largest value), the aux (a mean of 2^16 fp32
# probabilities) to 1e-5.
MOE_LAYER_TOL = 2e-4
MOE_AUX_RTOL = 1e-5
MOE_DROP_CAPACITY = 0.5
# vit-b16-224 through the kernels against plain attention, bf16, one step:
# the logits as the 1b prefill logits (LOGITS_TOL); per-leaf gradients as
# the 1b step's, 12 layers x 2 passes of a few 2^-8 roundings.
VIT_GRAD_TOL = 2 * 12 * 2.0 ** -8
# vit-b16-224 fitting its batch: after VIT_STEPS steps at VIT_LR (AdamW, a
# rate low enough that the loss falls without spiking in the first steps)
# the loss must be below VIT_FIT_LOSS
# and the accuracy of the last 5 steps above 0.9 (tests/test_moe_vit.py's
# criterion). ln 4 is the loss of a head that has learnt only which 4 of
# its 1000 classes occur; a quarter of it needs the images told apart. The
# control, the head alone trained the same way from the same weights, must
# stay above the bound, so that passing it takes the encoder's gradients.
VIT_LR = 3e-5
VIT_FIT_LOSS = 0.25 * 1.3862943611198906  # ln(4) / 4

H100_BF16_FLOPS = 989e12   # dense tensor-core peak (data sheet, 700 W)
H100_HBM_BYTES = 3.35e12   # HBM3 bytes/s (data sheet)

TRAIN_SHAPE = (4, 16, 8, 128, 2048)  # (B, H, KVH, D, S): 1b, batch 4 x 2048
KERNEL_SHAPES = (  # the 1b prefill buckets, 350m's D, the 1b training shape
    [(8, 16, 8, 128, s) for s in (32, 77, 128, 1000, 2048)]
    + [(8, 16, 16, 64, 1024), TRAIN_SHAPE])
MAIN_SHAPE = (8, 16, 8, 128, 2048)  # 1b, 8 slots, the longest bucket
FUSED_SHAPE = (2, 16, 8, 128, 1000)  # q, k, v sliced from one tensor
TIME_ROUNDS = 5  # the forward's timings, in turns with its yardsticks
# the backward kernels: 1b training, and 350m's head dims (batch 8 x 1024);
# then the ragged shapes of tests/test_torch_gpu.py (S = 77, 256, 1000, 1,
# 200; GQA and MHA; both head dims)
BWD_SHAPES = (TRAIN_SHAPE, (8, 16, 16, 64, 1024))
BWD_RAGGED = ((2, 4, 2, 64, 77), (1, 4, 4, 128, 256), (1, 16, 8, 128, 1000),
              (3, 4, 1, 64, 1), (2, 16, 16, 64, 200))
# the head_dim-64 training shapes: moe-1b (MHA) at batch 4 x 2048, causal;
# ViT-B/16 at batch 64 (196 patches + the class token), full
D64_SHAPES = {"moe-1b": ((4, 16, 16, 64, 2048), True),
              "vit-b16-224": ((64, 12, 12, 64, 197), False)}
TRAIN_CONFIG, TRAIN_BATCH, TRAIN_SEQ = "1b", 4, 2048
MOE_CONFIG = "moe-1b"  # trained at TRAIN_BATCH x TRAIN_SEQ
TRAIN_STEPS, TRAIN_WARMUP = 7, 2  # steps on one batch; the first 2 untimed
VIT_CONFIG, VIT_BATCH, VIT_STEPS = "vit-b16-224", 64, 30
PROMPT_LENS = (20, 100, 300, 700, 1200, 1900) * 2
OUT_DIR = "chiprun_out"  # long reports (the profiler's table) go here
# Every process the script starts inherits RUN_MARK=<this run's token>;
# a phase's own processes RUN_MARK=<token>/<path>.
RUN_MARK = "CHIP_SMOKE_RUN"
STRAGGLER_GRACE_S = 30.0  # at the end, before the script kills what is left


def log(msg: str) -> None:
    print(msg, flush=True)


def started_processes(mark: str) -> list:
    """``(pid, command line)`` of every live process, this one excepted,
    whose environment holds ``RUN_MARK`` at ``mark`` or below it: what the
    script (or one of its phases) started, orphans included."""
    needle = f"{RUN_MARK}={mark}".encode()
    found = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit() or int(entry) == os.getpid():
            continue
        try:
            with open(f"/proc/{entry}/stat", "rb") as f:
                if f.read().rsplit(b")", 1)[1].split()[0] == b"Z":
                    continue
            with open(f"/proc/{entry}/environ", "rb") as f:
                env = f.read().split(b"\0")
            if not any(v == needle or v.startswith(needle + b"/")
                       for v in env):
                continue
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(
                    errors="replace").strip()
        except (OSError, IndexError):
            continue  # exited meanwhile, or not ours to read
        found.append((int(entry), cmd))
    return found


def wait_started_processes(mark: str, timeout_s: float) -> list:
    """Wait up to ``timeout_s`` for every process under ``mark`` to exit;
    returns those left."""
    deadline = time.perf_counter() + timeout_s
    while True:
        left = started_processes(mark)
        if not left or time.perf_counter() > deadline:
            return left
        time.sleep(0.2)


def stop_started_processes() -> None:
    """At the script's end: wait for every process it started, then kill
    any left. Named on standard error, so the last line of standard output
    stays the result."""
    import signal

    mark = os.environ.get(RUN_MARK)
    if not mark:
        return
    left = wait_started_processes(mark, STRAGGLER_GRACE_S)
    if not left:
        return
    print(f"chip_smoke: {len(left)} processes still running "
          f"{STRAGGLER_GRACE_S:.0f} s after the end, killed: {left}",
          file=sys.stderr, flush=True)
    for pid, _ in left:
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass
    left = wait_started_processes(mark, 10.0)
    if left:
        print(f"chip_smoke: still running after SIGKILL: {left}",
              file=sys.stderr, flush=True)


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def roofline(flops, nbytes):
    """(ms, what bounds it): the larger of the work at the bf16 tensor-core
    peak and the bytes at the HBM rate."""
    t_ops = flops / H100_BF16_FLOPS * 1e3
    t_bytes = nbytes / H100_HBM_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")


def _pairs(S, causal):
    return S * (S + 1) // 2 if causal else S * S


def flash_bound(B, H, KVH, D, S, causal, itemsize):
    flops = 4.0 * D * _pairs(S, causal) * B * H  # Q K^T, P V: 2 FLOPs a MAC
    nbytes = B * S * (2 * H + 2 * KVH) * D * itemsize + B * H * S * 4
    return roofline(flops, nbytes)


def bwd_bound(kernel, B, H, KVH, D, S, causal, itemsize):
    """flash_bwd: S, dP, dV, dK, dQ (10 D FLOPs a pair); reads q, k, v, dO,
    lse, Delta, writes dk, dv and the fp32 dQ accumulator. flash_bwd_dq: Q
    K^T, dO V^T, dS K (6 D); the same reads, writes dq. flash_bwd_dkv: K
    Q^T, V dO^T, P^T dO, dS^T Q (8 D); the same reads, writes dk and dv.
    flash_bwd_delta: rowsum(dO * O), 2 D FLOPs a row; reads o and dO, writes
    Delta. flash_bwd_prep: the same, and writes the fp32 dQ accumulator
    (rows x D) and its int32 counters (one a 64-row q tile of each (b, h))
    as zeros."""
    rows = B * H * S
    if kernel == "flash_bwd_delta":
        return roofline(2.0 * D * rows, 2 * rows * D * itemsize + rows * 4)
    if kernel == "flash_bwd_prep":
        counters = B * H * -(-S // 64)
        return roofline(2.0 * D * rows, 2 * rows * D * itemsize + rows * 4
                        + rows * D * 4 + counters * 4)
    products = {"flash_bwd": 5, "flash_bwd_dq": 3, "flash_bwd_dkv": 4}[kernel]
    flops = 2.0 * products * D * _pairs(S, causal) * B * H
    reads = B * S * (2 * H + 2 * KVH) * D * itemsize + 2 * rows * 4
    writes = {"flash_bwd": B * S * 2 * KVH * D * itemsize + rows * D * 4,
              "flash_bwd_dq": rows * D * itemsize,
              "flash_bwd_dkv": B * S * 2 * KVH * D * itemsize}[kernel]
    return roofline(flops, reads + writes)


# -- phases ----------------------------------------------------------------


def phase_device() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    try:
        from ray_tpu_torch.utils import device_report
    except ModuleNotFoundError as e:
        # the script alone, outside a checkout: there is no port to drive
        raise SystemExit(f"chip_smoke: {e}; run it from the root of a "
                         "checkout of the repository") from None

    report = device_report()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"device: {report['kind']} x{report['count']} "
        f"(torch {torch.__version__}, CUDA {torch.version.cuda})")
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"report": report, "card": smi}


def phase_build() -> None:
    from ray_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build_all(["flash_fwd", "flash_bwd"])
    log(f"build: {len(built)} sources in {time.perf_counter() - t0:.2f} s")
    for name, lib in built.items():
        log(f"build: {name} (nvcc {lib.seconds:.2f} s) -> {lib.path}")
        log(f"nvcc -Xptxas -v for {name}:")
        log(lib.log.strip())


def phase_kernels(card: str) -> dict:
    import torch

    from ray_tpu_torch.ops.attention import (flash_attention_fwd,
                                             flash_attention_fwd_plain)

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {"o": 0.0, "lse": 0.0}

    def check(q, k, v, causal, what):
        o, lse = flash_attention_fwd(q, k, v, causal)
        torch.cuda.synchronize()
        o_ref, lse_ref = flash_attention_fwd_plain(q, k, v, causal)
        pv = flash_attention_fwd_plain(q, k, v.abs(), causal)[0]
        name = str(q.dtype).split(".")[-1]
        where = f"{what} {name:8s} causal={int(causal)}"
        errs = {key: compare("flash_fwd", key, got, ref, TOL[name][key],
                             where, pv)
                for key, got, ref in (("o", o, o_ref), ("lse", lse, lse_ref))}
        log(f"check flash_fwd {where}: o {errs['o']}; lse {errs['lse']} "
            f"[tol {TOL[name]}]")
        for key in worst:
            worst[key] = max(worst[key], errs[key]["max_abs"])

    for (B, H, KVH, D, S) in KERNEL_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn(B, S, H, D, generator=gen, device="cuda", dtype=dtype)
            k = torch.randn(B, S, KVH, D, generator=gen, device="cuda", dtype=dtype)
            v = torch.randn(B, S, KVH, D, generator=gen, device="cuda", dtype=dtype)
            for causal in (True, False):
                check(q, k, v, causal, f"B={B} S={S} H={H} KVH={KVH} D={D}")
            if dtype == torch.bfloat16:
                ms = cuda_time_ms(lambda: flash_attention_fwd(q, k, v, True), 20)
                bound, by = flash_bound(B, H, KVH, D, S, True, 2)
                log(f"time flash_fwd B={B} S={S} H={H} KVH={KVH} D={D} bf16 "
                    f"causal: {ms:.4f} ms, bound {bound:.4f} ms ({by}), "
                    f"{100 * bound / ms:.1f}% of bound [{card}]")
            del q, k, v
    # q, k and v as slices of one fused projection: not contiguous, read
    # through the tensor maps' strides
    B, H, KVH, D, S = FUSED_SHAPE
    qkv = torch.randn(B, S, H + 2 * KVH, D, generator=gen, device="cuda",
                      dtype=torch.bfloat16)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KVH], qkv[:, :, H + KVH:]
    for causal in (True, False):
        check(q, k, v, causal,
              f"fused qkv slices B={B} S={S} H={H} KVH={KVH} D={D}")
    del qkv, q, k, v

    entry = time_fwd(MAIN_SHAPE, card, gen)
    entry["max_abs_err"] = worst["o"]
    entry["max_err"] = {"o": worst["o"], "lse": worst["lse"]}
    entry["train_shape"] = time_fwd(TRAIN_SHAPE, card, gen)
    return entry


def time_fwd(shape, card, gen) -> dict:
    """At one shape, bf16 causal: the kernel, ``flash_fwd_mma`` (the earlier
    ``mma.sync`` design, checked against plain here first) and the library
    call, timed in turns over TIME_ROUNDS rounds (median of each), then the
    plain version once; each beside the bound."""
    import importlib

    import torch
    import torch.nn.functional as F

    att = importlib.import_module("ray_tpu_torch.ops.attention")
    B, H, KVH, D, S = shape
    q = torch.randn(B, S, H, D, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    k = torch.randn(B, S, KVH, D, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    v = torch.randn(B, S, KVH, D, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    o = torch.empty_like(q)
    lse = torch.empty(B * H, S, 1, device="cuda")

    def mma():  # the yardstick's C entry, called directly: no counter
        att._launch("flash_fwd", "flash_fwd_mma", (q, k, v, o, lse), True)

    mma()
    torch.cuda.synchronize()
    o_ref, lse_ref = att.flash_attention_fwd_plain(q, k, v, True)
    pv = att.flash_attention_fwd_plain(q, k, v.abs(), True)[0]
    where = f"B={B} S={S} H={H} KVH={KVH} D={D} bf16 causal=1"
    for key, got, ref in (("o", o, o_ref), ("lse", lse, lse_ref)):
        compare("flash_fwd_mma", key, got, ref, TOL["bfloat16"][key], where,
                pv)
    del o_ref, lse_ref, pv
    # yardstick only: one library call on the same inputs (K/V repeated to
    # H heads outside the timed region); the port never calls it
    rep = H // KVH
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(rep, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    runs = {"kernel": lambda: att.flash_attention_fwd(q, k, v, True),
            "flash_fwd_mma": mma,
            "library": lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)}
    times = {name: [] for name in runs}
    for r in range(TIME_ROUNDS):
        for name in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            times[name].append(cuda_time_ms(runs[name], 20))
    ms = {name: sorted(t)[len(t) // 2] for name, t in times.items()}
    ms["plain"] = cuda_time_ms(
        lambda: att.flash_attention_fwd_plain(q, k, v, True), 5, warmup=1)
    bound, by = flash_bound(B, H, KVH, D, S, True, 2)
    for name, t in ms.items():
        label = {"kernel": "flash_fwd (TMA, wgmma)",
                 "flash_fwd_mma": "flash_fwd_mma (mma.sync, yardstick)",
                 "library": "library (sdpa forward)",
                 "plain": "plain"}[name]
        rounds = f" rounds {times[name]}" if name in times else ""
        log(f"time at {shape} bf16 causal: {label} {t:.4f} ms, bound "
            f"{bound:.4f} ms ({by}), {100 * bound / t:.1f}% of bound"
            f"{rounds} [{card}]")
    return {"ms": ms["kernel"], "plain_ms": ms["plain"],
            "library_ms": ms["library"], "mma_ms": ms["flash_fwd_mma"],
            "bound_ms": bound, "bound_by": by}


O_BINS = (0.0, 0.125, 0.5, 2.0, float("inf"))  # |ref| ranges of the report


def compare(kernel, key, got, ref, tol, where, mag) -> dict:
    """Kernel against plain: raises beyond ``atol + rtol * |ref| + m * mag``
    (see ``TOL``, ``BWD_TOL``). Returns the max abs error, the least atol
    that passes with this rtol and mag term, and for the attention outputs
    (not lse or Delta) the max abs error in each range of |ref|."""
    import torch

    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{kernel} {key} not finite at {where}")
    atol, rtol, m = tol
    diff = (got - ref).abs()
    size = ref.abs()
    rel = rtol * size + (m * mag.float() if m else 0.0)
    out = {"max_abs": diff.max().item(),
           "needs_atol": (diff - rel).max().item()}
    if key not in ("lse", "delta"):
        for lo, hi in zip(O_BINS, O_BINS[1:]):
            sel = (size >= lo) & (size < hi)
            out[f"|{key}| in [{lo}, {hi})"] = (
                diff[sel].max().item() if bool(sel.any()) else None)
    if not bool((diff <= atol + rel).all()):
        raise AssertionError(f"{kernel} {key} disagrees with plain at "
                             f"{where}: {out} (tol {tol})")
    return out


def phase_bwd_kernels(card: str) -> dict:
    """The backward kernels against the plain backward on the same inputs
    (the forward kernel's o and lse, a random dO), at BWD_SHAPES and the
    ragged BWD_RAGGED, causal and full: bf16 ``flash_bwd`` (through
    ``flash_attention_bwd``: the prep, then ``flash_bwd``), the bf16 dK/dV
    kernel and the bf16 dQ kernel (``flash_bwd_dq``, the earlier design) on
    their own, the fp32 pair, and the prep ``flash_bwd_prep`` (Delta, the
    accumulator and counters cleared) and the earlier Delta kernel
    ``flash_bwd_delta`` against their plain versions (``check_prep``). Then
    their times at the training shape. Returns the entries of the kernels
    line."""
    import torch

    from ray_tpu_torch.ops.attention import (attention_delta,
                                             bwd_products, bwd_softmax_grads,
                                             flash_attention_bwd,
                                             flash_attention_bwd_dkv,
                                             flash_attention_bwd_dq,
                                             flash_attention_fwd)

    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = {"flash_bwd": {"dq": 0.0, "dk": 0.0, "dv": 0.0},
             "flash_bwd_dq": {"dq": 0.0},
             "flash_bwd_dkv": {"dk": 0.0, "dv": 0.0},
             "flash_bwd_prep": {"delta": 0.0},
             "flash_bwd_delta": {"delta": 0.0}}
    entries = {}
    for (B, H, KVH, D, S) in BWD_SHAPES + BWD_RAGGED:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do = (torch.randn(B, S, h, D, generator=gen,
                                       device="cuda", dtype=dtype)
                           for h in (H, KVH, KVH, H))
            name = str(dtype).split(".")[-1]
            for causal in (True, False):
                o, lse = flash_attention_fwd(q, k, v, causal)
                delta = attention_delta(o, do)
                outs = []  # (kernel, key, tensor)
                if dtype == torch.bfloat16:
                    dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do,
                                                     causal)
                    outs += [("flash_bwd", "dq", dq), ("flash_bwd", "dk", dk),
                             ("flash_bwd", "dv", dv)]
                    # two runs of the fused kernel give the same bits: dK
                    # and dV stay in one block's registers, and dQ's adds
                    # go in a fixed order
                    dq2, dk2, dv2 = flash_attention_bwd(q, k, v, o, lse, do,
                                                        causal)
                    if not (torch.equal(dq, dq2) and torch.equal(dk, dk2)
                            and torch.equal(dv, dv2)):
                        raise AssertionError("flash_bwd's dq, dk, dv differ "
                                             "between two runs")
                    del dq2, dk2, dv2
                outs.append(("flash_bwd_dq", "dq", flash_attention_bwd_dq(
                    q, k, v, do, lse, delta, causal)))
                dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                 causal)
                outs += [("flash_bwd_dkv", "dk", dk),
                         ("flash_bwd_dkv", "dv", dv)]
                torch.cuda.synchronize()
                where = (f"B={B} S={S} H={H} KVH={KVH} D={D} {name:8s} "
                         f"causal={int(causal)}")
                prep = check_prep(o, do, where)
                for kernel, key in (("flash_bwd_prep", "delta"),
                                    ("flash_bwd_delta", "earlier_delta")):
                    worst[kernel]["delta"] = max(worst[kernel]["delta"],
                                                 prep[key]["max_abs"])
                # the plain backward on the same o, lse and Delta, and the
                # same products on absolute values (the tolerance's M)
                p, ds = bwd_softmax_grads(q, k, v, do, lse, delta, causal)
                ref = dict(zip(("dq", "dk", "dv"), (
                    x.to(dtype) for x in bwd_products(p, ds, q, k, do))))
                mag = dict(zip(("dq", "dk", "dv"), bwd_products(
                    p, ds.abs(), q.abs(), k.abs(), do.abs())))
                del p, ds
                for kernel, key, got in outs:
                    err = compare(kernel, key, got, ref[key], BWD_TOL[name],
                                  where, mag[key])
                    log(f"check {kernel} {key} {where}: {err} "
                        f"[tol {BWD_TOL[name]}]")
                    worst[kernel][key] = max(worst[kernel][key],
                                             err["max_abs"])
                del o, lse, delta, outs, dk, dv, ref, mag
            if (B, H, KVH, D, S) == TRAIN_SHAPE and dtype == torch.bfloat16:
                entries = time_bwd(q, k, v, do, card)
            del q, k, v, do
    for kernel, errs in worst.items():
        entries[kernel]["max_abs_err"] = max(errs.values())
        entries[kernel]["max_err"] = errs
    return entries


def time_bwd(q, k, v, do, card) -> dict:
    """At the training shape, bf16, causal, timed in turns over TIME_ROUNDS
    rounds (median of each): the ``flash_bwd`` kernel alone, the dK/dV
    kernel, the earlier ``mma.sync`` pair (``flash_bwd_dq`` and
    ``flash_bwd_dkv_mma``, checked against plain here first), the whole bf16
    backward as ``flash_attention_bwd`` runs it (prep, kernel, cast), and
    the library's backward, which computes its own Delta; then the plain
    backward once, and the prep against the earlier design
    (``prep_entries``)."""
    import importlib

    import torch
    import torch.nn.functional as F

    att = importlib.import_module("ray_tpu_torch.ops.attention")
    B, S, H, D = q.shape
    KVH = k.shape[2]
    o, lse = att.flash_attention_fwd(q, k, v, True)
    delta = att.attention_delta(o, do)
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device="cuda")
    dq_count = att.dq_counters(q)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))

    # the C entries called directly: no counter, no Delta, no zeros but
    # the order's counters (a launch counts in them)
    def fused():
        dq_count.zero_()
        att._launch("flash_bwd", "flash_bwd",
                    (q, k, v, do, lse, delta, dk, dv, dq_acc, dq_count), True)

    def mma():
        att._launch("flash_bwd", "flash_bwd_dq",
                    (q, k, v, do, lse, delta, dq), True)
        att._launch("flash_bwd", "flash_bwd_dkv_mma",
                    (q, k, v, do, lse, delta, dk, dv), True)

    mma()
    torch.cuda.synchronize()
    p, ds = att.bwd_softmax_grads(q, k, v, do, lse, delta, True)
    ref = [x.to(q.dtype) for x in att.bwd_products(p, ds, q, k, do)]
    mag = att.bwd_products(p, ds.abs(), q.abs(), k.abs(), do.abs())
    del p, ds
    where = f"B={B} S={S} H={H} KVH={KVH} D={D} bf16 causal=1"
    for key, got, r, m in zip(("dq", "dk", "dv"), (dq, dk, dv), ref, mag):
        compare("mma pair", key, got, r, BWD_TOL["bfloat16"], where, m)
    del ref, mag
    # yardstick only: the backward of one library call on the same inputs
    # (K/V repeated to H heads outside the timed region; the forward is not
    # timed); it computes dQ, dK, dV and its own Delta. The port never
    # calls it.
    rep = H // KVH
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k.repeat_interleave(rep, dim=2),
                            v.repeat_interleave(rep, dim=2)))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    runs = {
        "flash_bwd": fused,
        "flash_bwd_dkv": lambda: att.flash_attention_bwd_dkv(
            q, k, v, do, lse, delta, True),
        "mma": mma,
        "backward": lambda: att.flash_attention_bwd(q, k, v, o, lse, do,
                                                    True),
        "library": lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                               retain_graph=True),
    }
    times = {name: [] for name in runs}
    for r in range(TIME_ROUNDS):
        for name in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            times[name].append(cuda_time_ms(runs[name], 20))
    ms = {name: sorted(t)[len(t) // 2] for name, t in times.items()}
    ms["plain"] = cuda_time_ms(
        lambda: att.flash_attention_bwd_plain(q, k, v, o, lse, do, True), 5,
        warmup=1)
    # the earlier pair's dQ kernel alone, for its own entry
    ms["flash_bwd_dq"] = cuda_time_ms(lambda: att._launch(
        "flash_bwd", "flash_bwd_dq", (q, k, v, do, lse, delta, dq), True), 20)
    for name, t in times.items():
        log(f"time at {TRAIN_SHAPE} bf16 causal: {name} rounds {t} median "
            f"{ms[name]:.4f} ms [{card}]")
    entries = {}
    for kernel in ("flash_bwd", "flash_bwd_dkv", "flash_bwd_dq"):
        bound, by = bwd_bound(kernel, B, H, KVH, D, S, True, q.element_size())
        t = ms[kernel]
        plain = ms["plain"]
        entries[kernel] = {"ms": t, "plain_ms": plain, "bound_ms": bound,
                           "bound_by": by, "library_ms": None}
        log(f"time {kernel} at the training shape {TRAIN_SHAPE} bf16 causal:"
            f" kernel {t:.4f} ms, bound {bound:.4f} ms ({by}), "
            f"{100 * bound / t:.1f}% of bound; plain {plain:.4f} ms [{card}]")
    # the library call computes what flash_bwd's backward does (all of
    # dQ, dK, dV and Delta); the pair's and the dK/dV kernel's function is
    # a part of it, so they get it for reference
    for kernel in ("flash_bwd", "flash_bwd_dkv", "flash_bwd_dq"):
        entries[kernel]["library_ms"] = ms["library"]
    entries["flash_bwd"].update(backward_ms=ms["backward"],
                                mma_ms=ms["mma"])
    log(f"time bf16 backward at {TRAIN_SHAPE} causal: flash_attention_bwd "
        f"(prep + flash_bwd + cast) {ms['backward']:.4f} ms, "
        f"{ms['backward'] - ms['flash_bwd']:.4f} ms beyond flash_bwd alone; "
        f"library (sdpa backward) {ms['library']:.4f} ms; the earlier "
        f"mma.sync pair {ms['mma']:.4f} ms; plain {ms['plain']:.4f} ms "
        f"[{card}]")
    where = f"at the training shape {TRAIN_SHAPE} bf16"
    entries.update(prep_entries(o, do, check_prep(o, do, where), card,
                                where))
    return entries


def kernel_launches(reset: bool = False) -> dict:
    """Every kernel wrapper's launch count, by wrapper name, and the earlier
    Delta kernel's (``flash_bwd_delta``, counted where its C entry is
    launched: no wrapper owns it); set to 0 after reading when ``reset``."""
    from ray_tpu_torch.ops.attention import launch_counts

    return launch_counts(reset)


def check_attention(q, k, v, do, causal: bool, where: str):
    """The forward kernel, the prep (``check_prep``) and the whole bf16
    backward (the prep and ``flash_bwd``) at one shape against their plain
    versions on the same inputs (TOL, BWD_TOL, DELTA_TOL; ``compare``
    raises beyond them). Returns the kernels' o, lse and Delta, and the
    errors by output."""
    import importlib

    import torch

    att = importlib.import_module("ray_tpu_torch.ops.attention")
    o, lse = att.flash_attention_fwd(q, k, v, causal)
    delta = att.attention_delta(o, do)
    dq, dk, dv = att.flash_attention_bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    o_ref, lse_ref = att.flash_attention_fwd_plain(q, k, v, causal)
    pv = att.flash_attention_fwd_plain(q, k, v.abs(), causal)[0]
    errs = {key: compare("flash_fwd", key, got, ref, TOL["bfloat16"][key],
                         where, pv)
            for key, got, ref in (("o", o, o_ref), ("lse", lse, lse_ref))}
    del o_ref, lse_ref, pv
    errs.update(check_prep(o, do, where))
    p, ds = att.bwd_softmax_grads(q, k, v, do, lse, delta, causal)
    ref = [x.to(q.dtype) for x in att.bwd_products(p, ds, q, k, do)]
    mag = att.bwd_products(p, ds.abs(), q.abs(), k.abs(), do.abs())
    del p, ds
    for key, got, r, m in zip(("dq", "dk", "dv"), (dq, dk, dv), ref, mag):
        errs[key] = compare("flash_bwd", key, got, r, BWD_TOL["bfloat16"],
                            where, m)
    del ref, mag, dq, dk, dv
    log(f"check {where}: {errs} [tol fwd {TOL['bfloat16']}, bwd "
        f"{BWD_TOL['bfloat16']}, delta {DELTA_TOL}]")
    return o, lse, delta, errs


def phase_d64_kernels(card: str) -> dict:
    """The forward and the whole bf16 backward at the MoE and ViT training
    shapes (``D64_SHAPES``), against their plain versions on the same
    inputs (TOL, BWD_TOL, DELTA_TOL); then, timed in turns over
    TIME_ROUNDS rounds (median of each): the forward kernel and the
    library's forward, ``flash_bwd`` alone, the backward as
    ``flash_attention_bwd`` runs it (prep, kernel, cast) and the library's
    backward; the plain versions once; and the prep against the earlier
    design (``prep_entries``). Returns each kernel's entries by shape
    name."""
    import importlib

    import torch

    att = importlib.import_module("ray_tpu_torch.ops.attention")
    gen = torch.Generator(device="cuda").manual_seed(2)
    out = {"flash_fwd": {}, "flash_bwd": {}, "flash_bwd_prep": {},
           "flash_bwd_delta": {}}
    for name, ((B, H, KVH, D, S), causal) in D64_SHAPES.items():
        q, k, v, do = (torch.randn(B, S, h, D, generator=gen, device="cuda",
                                   dtype=torch.bfloat16)
                       for h in (H, KVH, KVH, H))
        where = (f"{name} B={B} S={S} H={H} KVH={KVH} D={D} bf16 "
                 f"causal={int(causal)}")
        o, lse, delta, errs = check_attention(q, k, v, do, causal,
                                              f"d64 {where}")

        times, ms = time_attention(q, k, v, do, o, lse, delta, causal)
        ms["plain_fwd"] = cuda_time_ms(
            lambda: att.flash_attention_fwd_plain(q, k, v, causal), 5,
            warmup=1)
        ms["plain_bwd"] = cuda_time_ms(
            lambda: att.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                  causal), 5, warmup=1)
        shape = {"shape": [B, S, H, KVH, D], "causal": causal}
        fb, fby = flash_bound(B, H, KVH, D, S, causal, 2)
        bb, bby = bwd_bound("flash_bwd", B, H, KVH, D, S, causal, 2)
        out["flash_fwd"][name] = {
            **shape, "ms": ms["flash_fwd"], "plain_ms": ms["plain_fwd"],
            "library_ms": ms["library_fwd"], "bound_ms": fb, "bound_by": fby,
            "max_abs_err": errs["o"]["max_abs"]}
        out["flash_bwd"][name] = {
            **shape, "ms": ms["flash_bwd"], "backward_ms": ms["backward"],
            "plain_ms": ms["plain_bwd"], "library_ms": ms["library_bwd"],
            "bound_ms": bb, "bound_by": bby,
            "max_abs_err": max(errs[key]["max_abs"]
                               for key in ("dq", "dk", "dv"))}
        for kernel, e in prep_entries(o, do, errs, card,
                                      f"d64 {where}").items():
            out[kernel][name] = {**shape, **e}
        for key, t in times.items():
            log(f"time d64 {where}: {key} rounds {t} median {ms[key]:.4f} "
                f"ms [{card}]")
        log(f"time d64 {where}: flash_fwd {ms['flash_fwd']:.4f} ms, bound "
            f"{fb:.4f} ms ({fby}), {100 * fb / ms['flash_fwd']:.1f}% of "
            f"bound, sdpa forward {ms['library_fwd']:.4f} ms, plain "
            f"{ms['plain_fwd']:.4f} ms; flash_bwd {ms['flash_bwd']:.4f} ms, "
            f"bound {bb:.4f} ms ({bby}), {100 * bb / ms['flash_bwd']:.1f}% "
            f"of bound; whole bf16 backward {ms['backward']:.4f} ms, sdpa "
            f"backward {ms['library_bwd']:.4f} ms, plain "
            f"{ms['plain_bwd']:.4f} ms [{card}]")
        del q, k, v, do, o, lse, delta
    return out


LAUNCH_BURST = 20  # launches back to back between two events


def time_launches(lib: str, fn: str, tensors, causal: bool, card: str,
                  where: str) -> dict:
    """A kernel at one shape without its wrapper's host path: LAUNCH_BURST
    launches of the C entry ``fn`` of ``lib`` on ``tensors`` (outputs
    preallocated) back to back between two events, divided by LAUNCH_BURST
    (``back_to_back_ms``: still the host's pace where a launch takes longer
    to issue than to run), and the same launches captured once in a CUDA
    graph and replayed (``graph_ms``: the device's time alone). Beside the
    wrapper's time (``ms``), they tell whether a time is the kernel's or
    the launch path's. A graph that cannot be captured is reported as
    None."""
    import importlib

    import torch

    att = importlib.import_module("ray_tpu_torch.ops.attention")
    burst = launch_burst(lambda: att._launch(lib, fn, tensors, causal))
    result = {"back_to_back_ms": cuda_time_ms(burst, 5) / LAUNCH_BURST,
              "graph_ms": None}
    try:
        graph = burst_graph(burst)
        result["graph_ms"] = cuda_time_ms(graph.replay, 5) / LAUNCH_BURST
    except RuntimeError as e:
        log(f"time {fn} {where}: no CUDA graph ({e})")
    log(f"time {fn} {where}: {LAUNCH_BURST} C-entry launches back to back "
        f"{result['back_to_back_ms']:.4f} ms a launch, replayed from a "
        f"graph {result['graph_ms']} ms a launch [{card}]")
    return result


def launch_burst(launch):
    """LAUNCH_BURST calls of ``launch`` in a row."""
    def burst():
        for _ in range(LAUNCH_BURST):
            launch()
    return burst


def burst_graph(burst):
    """``burst`` captured once in a CUDA graph, after one run outside the
    capture that warms its launch path; raises RuntimeError if it cannot
    be captured."""
    import torch

    graph = torch.cuda.CUDAGraph()
    burst()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        burst()
    return graph


# The prep's timings: at least 20 rounds a way, in turns with the earlier
# design and the yardsticks
PREP_ROUNDS = 20


def check_prep(o, do, where: str) -> dict:
    """The prep (``attention_bwd_prep``: one ``flash_bwd_prep`` launch)
    against its plain version on the same o and dO: Delta within DELTA_TOL
    and the dQ accumulator and counters exactly zero, both from the
    wrapper's fresh buffers and from the C entry on buffers first filled
    with NaN and -1 (so no zero comes from the allocator); Delta alone
    (``attention_delta``: the same kernel without the accumulator) and the
    poisoned launch's Delta bit-equal to the wrapper's (each row is summed
    in a fixed order). The earlier design (``flash_bwd_delta``'s C entry,
    which no path launches) within DELTA_TOL too, and whether its bits are
    the prep's. Returns the errors."""
    import importlib

    import torch

    att = importlib.import_module("ray_tpu_torch.ops.attention")
    delta, acc, counts = att.attention_bwd_prep(o, do)
    alone = att.attention_delta(o, do)
    poisoned = (torch.empty_like(delta), torch.full_like(acc, float("nan")),
                torch.full_like(counts, -1))
    att._launch("flash_bwd", "flash_bwd_prep", (o, do, *poisoned), False)
    earlier = torch.empty_like(delta)
    att._launch("flash_bwd", "flash_bwd_delta", (o, do, earlier), False)
    torch.cuda.synchronize()
    ref = att.attention_delta_plain(o, do)
    errs = {"delta": compare("flash_bwd_prep", "delta", delta, ref,
                             DELTA_TOL, where, None),
            "earlier_delta": compare("flash_bwd_delta", "delta", earlier,
                                     ref, DELTA_TOL, where, None)}
    for name, x in (("accumulator", acc), ("counters", counts),
                    ("poisoned accumulator", poisoned[1]),
                    ("poisoned counters", poisoned[2])):
        if bool((x != 0).any()):  # NaN != 0 too
            raise AssertionError(f"flash_bwd_prep left its {name} "
                                 f"non-zero at {where}")
    if not (torch.equal(alone, delta) and torch.equal(poisoned[0], delta)):
        raise AssertionError(f"flash_bwd_prep's Delta differs from launch "
                             f"to launch at {where}")
    errs["bits_as_earlier"] = torch.equal(earlier, delta)
    log(f"check flash_bwd_prep {where}: Delta {errs['delta']}, the "
        f"accumulator {tuple(acc.shape)} and {counts.numel()} counters zero "
        f"(also over NaN and -1), repeatable; the earlier flash_bwd_delta "
        f"{errs['earlier_delta']}, bit-equal to the prep's: "
        f"{errs['bits_as_earlier']} [tol {DELTA_TOL}]")
    del delta, acc, counts, alone, poisoned, earlier, ref
    return errs


def _stats(ts) -> dict:
    ts = sorted(ts)
    return {"median_ms": ts[len(ts) // 2], "min_ms": ts[0],
            "spread_ms": ts[-1] - ts[0], "rounds": len(ts)}


def time_prep(o, do, card: str, where: str, rounds: int = PREP_ROUNDS):
    """The prep against the earlier design at one shape, each timed three
    ways over ``rounds`` rounds in turns (order reversed every other
    round), as median, min and spread (max - min) in ms:

    - ``wrapper``: ``attention_bwd_prep`` (``prep``) against the earlier
      design as the backward ran it: ``flash_bwd_delta``'s C entry on a
      fresh Delta and the two ``torch.zeros`` (``earlier``); Delta alone,
      ``attention_delta`` (``delta``) against that C entry alone
      (``earlier_delta``); and the yardsticks the port never calls,
      ``torch.linalg.vecdot`` (Delta, rounded to bf16 where the kernels
      write fp32) and vecdot with the two ``torch.zeros``
      (``vecdot_zeros``: Delta with the fill);
    - ``back_to_back``: LAUNCH_BURST C-entry launches between two events
      (the earlier design's fill as ``zero_()`` of preallocated buffers);
    - ``graph``: those launches replayed from a CUDA graph (the device's
      time alone); a capture that fails raises.

    The plain versions once. The earlier design's launches use the same
    shortened launch path as the prep's, so the wrapper times part the
    kernels and the fill, not two launch paths."""
    import importlib

    import torch

    att = importlib.import_module("ray_tpu_torch.ops.attention")
    B, S, H, D = o.shape
    n_count = B * H * -(-S // 64)
    dev = o.device
    delta = torch.empty((B * H, S), dtype=torch.float32, device=dev)
    acc = torch.empty(o.shape, dtype=torch.float32, device=dev)
    counts = torch.empty(n_count, dtype=torch.int32, device=dev)

    def zeros():
        return (torch.zeros(o.shape, dtype=torch.float32, device=dev),
                torch.zeros(n_count, dtype=torch.int32, device=dev))

    def earlier_delta():
        out = torch.empty((B * H, S), dtype=torch.float32, device=dev)
        att._launch("flash_bwd", "flash_bwd_delta", (o, do, out), False)
        return out

    def c_prep():
        att._launch("flash_bwd", "flash_bwd_prep", (o, do, delta, acc,
                                                    counts), False)

    def c_earlier():
        att._launch("flash_bwd", "flash_bwd_delta", (o, do, delta), False)
        acc.zero_()
        counts.zero_()

    wrapper = {
        "prep": lambda: att.attention_bwd_prep(o, do),
        "earlier": lambda: (earlier_delta(), zeros()),
        "delta": lambda: att.attention_delta(o, do),
        "earlier_delta": earlier_delta,
        "vecdot": lambda: torch.linalg.vecdot(o, do, dim=-1),
        "vecdot_zeros": lambda: (torch.linalg.vecdot(o, do, dim=-1),
                                 zeros())}
    c_entry = {
        "prep": c_prep, "earlier": c_earlier,
        "delta": lambda: att._launch("flash_bwd", "flash_bwd_prep",
                                     (o, do, delta, None, None), False),
        "earlier_delta": lambda: att._launch(
            "flash_bwd", "flash_bwd_delta", (o, do, delta), False)}
    runs = {("wrapper", key): (fn, 1) for key, fn in wrapper.items()}
    for key, fn in c_entry.items():
        runs["back_to_back", key] = (launch_burst(fn), LAUNCH_BURST)
    for key, fn in c_entry.items():
        # the replay is the device's time that the shares of bound read: a
        # capture that fails fails the phase
        runs["graph", key] = (burst_graph(launch_burst(fn)).replay,
                              LAUNCH_BURST)
    times = {key: [] for key in runs}
    for r in range(rounds):
        for key in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            fn, per = runs[key]
            times[key].append(cuda_time_ms(fn, 20 if per == 1 else 3,
                                           warmup=1) / per)
    out = {way: {} for way in ("wrapper", "back_to_back", "graph")}
    for (way, key), ts in times.items():
        out[way][key] = _stats(ts)
    out["plain_ms"] = cuda_time_ms(
        lambda: att.attention_bwd_prep_plain(o, do), 5, warmup=1)
    out["plain_delta_ms"] = cuda_time_ms(
        lambda: att.attention_delta_plain(o, do), 5, warmup=1)
    del runs
    log(f"time flash_bwd_prep {where} (B={B} S={S} H={H} D={D} "
        f"{str(o.dtype).split('.')[-1]}), median / min / spread ms of "
        f"{rounds} rounds: " + "; ".join(
            f"{way} {key} {st['median_ms']:.4f} / {st['min_ms']:.4f} / "
            f"{st['spread_ms']:.4f}"
            for way in ("wrapper", "back_to_back", "graph")
            for key, st in out[way].items())
        + f"; plain {out['plain_ms']:.4f}, plain Delta "
        f"{out['plain_delta_ms']:.4f} [{card}]")
    return out


def prep_entries(o, do, errs: dict, card: str, where: str) -> dict:
    """The kernels line's entries of ``flash_bwd_prep`` and of the earlier
    design ``flash_bwd_delta`` at one shape, from ``time_prep`` and the
    errors of ``check_prep``. The prep's ``library_ms`` is None: no one
    PyTorch call computes Delta with the fill (``vecdot_ms`` and
    ``vecdot_zeros_ms`` stand beside it); Delta's is vecdot."""
    B, S, H, D = o.shape
    t = time_prep(o, do, card, where)
    w, b2b, g = t["wrapper"], t["back_to_back"], t["graph"]

    def ms(way, key):
        return way[key]["median_ms"]

    entries = {}
    for kernel, key, plain in (("flash_bwd_prep", "prep", "plain_ms"),
                               ("flash_bwd_delta", "earlier_delta",
                                "plain_delta_ms")):
        bound, by = bwd_bound(kernel, B, H, H, D, S, False, o.element_size())
        entries[kernel] = {
            "shape": [B, S, H, D], "ms": w[key]["median_ms"],
            "min_ms": w[key]["min_ms"], "spread_ms": w[key]["spread_ms"],
            "rounds": w[key]["rounds"], "back_to_back_ms": ms(b2b, key),
            "graph_ms": ms(g, key), "plain_ms": t[plain], "bound_ms": bound,
            "bound_by": by, "library_ms": None,
            "max_abs_err": errs["delta" if kernel == "flash_bwd_prep"
                                else "earlier_delta"]["max_abs"]}
    prep = entries["flash_bwd_prep"]
    prep.update(
        vecdot_ms=w["vecdot"]["median_ms"],
        vecdot_zeros_ms=w["vecdot_zeros"]["median_ms"],
        delta_alone_ms=w["delta"]["median_ms"],
        earlier_ms=w["earlier"]["median_ms"],
        earlier_min_ms=w["earlier"]["min_ms"],
        earlier_spread_ms=w["earlier"]["spread_ms"],
        earlier_back_to_back_ms=ms(b2b, "earlier"),
        earlier_graph_ms=ms(g, "earlier"),
        bits_as_earlier=errs["bits_as_earlier"])
    entries["flash_bwd_delta"]["library_ms"] = w["vecdot"]["median_ms"]
    log(f"time flash_bwd_prep {where}: prep {prep['ms']:.4f} ms (min "
        f"{prep['min_ms']:.4f}, graph {prep['graph_ms']}), bound "
        f"{prep['bound_ms']:.4f} ms ({prep['bound_by']}), "
        f"{100 * prep['bound_ms'] / prep['ms']:.1f}% of bound through the "
        f"wrapper, {100 * prep['bound_ms'] / prep['graph_ms']:.1f}% "
        f"replayed; "
        f"earlier design (flash_bwd_delta + zeros) "
        f"{prep['earlier_ms']:.4f} ms (graph {prep['earlier_graph_ms']}); "
        f"vecdot {prep['vecdot_ms']:.4f}, vecdot + zeros "
        f"{prep['vecdot_zeros_ms']:.4f} ms [{card}]")
    return entries


def time_attention(q, k, v, do, o, lse, delta, causal: bool,
                   rounds: int = TIME_ROUNDS, iters: int = 20):
    """The kernels at one shape, bf16, timed in turns over ``rounds``
    rounds (CUDA events, ``iters`` launches a time): the forward kernel and
    the library's forward, ``flash_bwd`` alone (its C entry: no prep), the
    backward as ``flash_attention_bwd`` runs it (prep, kernel, cast) and
    the library's backward (which computes its own Delta). The library
    calls are yardsticks only, on the same inputs with K/V repeated to H
    heads outside the timed region; the port never calls them. The prep
    is timed on its own (``time_prep``). Returns each run's round times
    and their medians."""
    import importlib

    import torch
    import torch.nn.functional as F

    att = importlib.import_module("ray_tpu_torch.ops.attention")
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device="cuda")
    dq_count = att.dq_counters(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)

    def fused():  # the C entry called directly: no counter, no prep but
        dq_count.zero_()  # the order's counters (a launch counts in them)
        att._launch("flash_bwd", "flash_bwd",
                    (q, k, v, do, lse, delta, dk, dv, dq_acc, dq_count),
                    causal)

    rep = q.shape[2] // k.shape[2]
    qt, kt, vt = (x.transpose(1, 2) for x in (
        q, k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)))
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
    lib_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
    dot = do.transpose(1, 2)
    runs = {
        "flash_fwd": lambda: att.flash_attention_fwd(q, k, v, causal),
        "library_fwd": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal),
        "flash_bwd": fused,
        "backward": lambda: att.flash_attention_bwd(q, k, v, o, lse, do,
                                                    causal),
        "library_bwd": lambda: torch.autograd.grad(
            lib_out, (qg, kg, vg), dot, retain_graph=True),
    }
    times = {key: [] for key in runs}
    for r in range(rounds):
        for key in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            times[key].append(cuda_time_ms(runs[key], iters))
    return times, {key: sorted(t)[len(t) // 2] for key, t in times.items()}


def phase_moe_layer(card: str) -> list:
    """One ``MoEMLP`` at moe-1b width (E 8, K 2, D 1024, F 2816) on the
    training's TRAIN_BATCH x TRAIN_SEQ tokens (two groups of 4096), fp32,
    on the card and on the CPU from the same weights (seed 0, the model's
    init laws) and input, at moe-1b's capacity factor and at
    MOE_DROP_CAPACITY, where slots are dropped: the routing must be equal,
    the outputs and aux within MOE_LAYER_TOL, MOE_AUX_RTOL."""
    import torch

    from ray_tpu_torch.models import CONFIGS, MoEMLP

    base = dataclasses.replace(CONFIGS[MOE_CONFIG], dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(TRAIN_BATCH, TRAIN_SEQ, base.d_model, generator=gen)
    checks = []
    for capacity_factor in (base.capacity_factor, MOE_DROP_CAPACITY):
        cfg = dataclasses.replace(base, capacity_factor=capacity_factor)
        cpu = MoEMLP(cfg, device="cpu", seed=0)
        gpu = MoEMLP(cfg)  # on the card, the default
        gpu.load_state_dict(cpu.state_dict())
        N = x.shape[0] * x.shape[1]
        g = cpu.group_size(N)
        res = {}
        with torch.no_grad():
            for name, layer, xs in (("cpu", cpu, x), ("cuda", gpu, x.cuda())):
                routing = layer.route(xs.reshape(-1, g, cfg.d_model))
                out, aux = layer(xs)
                res[name] = (routing, out.cpu(), aux.item())
        torch.cuda.synchronize()
        (r_c, o_c, a_c), (r_g, o_g, a_g) = res["cpu"], res["cuda"]
        for key in ("expert", "pos", "keep"):
            if not torch.equal(getattr(r_c, key), getattr(r_g, key).cpu()):
                raise AssertionError(f"MoE layer: routing ({key}) differs "
                                     "between the card and the CPU")
        scale = o_c.abs().max().item()
        err = (o_g - o_c).abs().max().item()
        check = {"tokens": N, "groups": N // g, "group": g,
                 "capacity_factor": capacity_factor,
                 "capacity": r_c.capacity,
                 "dropped_share": 1.0 - r_c.keep.float().mean().item(),
                 "out_max_abs_err": err, "out_max_abs": scale,
                 "aux_cpu": a_c, "aux_cuda": a_g}
        log(f"moe layer: {cfg.n_experts} experts, top "
            f"{cfg.experts_per_token}, fp32 on the card against the CPU: "
            f"routing equal; {check} [tol {MOE_LAYER_TOL} of max|out|, aux "
            f"rtol {MOE_AUX_RTOL}] [{card}]")
        if not err <= MOE_LAYER_TOL * scale:
            raise AssertionError(f"MoE layer output differs by {err}")
        if not abs(a_g - a_c) <= MOE_AUX_RTOL * abs(a_c):
            raise AssertionError(f"MoE layer aux differs: {a_g} vs {a_c}")
        if check["groups"] < 2:
            raise AssertionError("the MoE layer check ran one group only")
        if capacity_factor == MOE_DROP_CAPACITY and not check["dropped_share"]:
            raise AssertionError(f"no slot was dropped at capacity factor "
                                 f"{capacity_factor}")
        checks.append(check)
    return checks


def quadrant_batch(rng, n: int, size: int):
    """tests/test_moe_vit.py's task at ``size`` pixels: noise, and the
    quadrant named by the label (4 classes) brightened by 2."""
    import numpy as np

    images = rng.normal(0, 0.3, (n, size, size, 3)).astype(np.float32)
    labels = rng.integers(0, 4, n)
    half = size // 2
    for i, lab in enumerate(labels):
        y0, x0 = (lab // 2) * half, (lab % 2) * half
        images[i, y0:y0 + half, x0:x0 + half] += 2.0
    return images, labels


def phase_vit_training(card: str) -> dict:
    """vit-b16-224 trained for VIT_STEPS steps on one batch of VIT_BATCH
    synthetic images with ``make_optimizer``, through the kernels. Returns
    each kernel's launches in that run."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import (VIT_CONFIGS, VisionTransformer,
                                      classification_loss)
    from ray_tpu_torch.parallel import make_optimizer

    cfg = VIT_CONFIGS[VIT_CONFIG]
    t0 = time.perf_counter()
    model = VisionTransformer(cfg, device="cuda", seed=0)
    params = dict(model.named_parameters())
    opt = make_optimizer(learning_rate=VIT_LR, warmup_steps=1)
    state = opt.init(params)
    images, labels = quadrant_batch(np.random.default_rng(0), VIT_BATCH,
                                    cfg.image_size)
    images = torch.from_numpy(images).cuda()
    labels = torch.from_numpy(labels).cuda()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.values())
    log(f"vit training: {VIT_CONFIG} up in {time.perf_counter() - t0:.2f} s "
        f"({n_params / 1e6:.3f} M params, {cfg.n_layers} layers, head_dim "
        f"{cfg.head_dim}, {cfg.num_patches + 1} tokens), batch {VIT_BATCH}")

    # one step's logits and grads against plain attention, same weights
    plain = VisionTransformer(dataclasses.replace(cfg, attention_impl="xla"),
                              device="cuda", params=params)
    got = {}
    for name, m in (("kernel", model), ("plain", plain)):
        logits = m(images)
        loss = classification_loss(logits, labels)
        got[name] = (logits.detach(), loss.item(), torch.autograd.grad(
            loss, list(m.parameters())))
    del plain
    (lk, loss_k, gk), (lp, loss_p, gp) = got["kernel"], got["plain"]
    diff = (lk - lp).abs()
    atol, rtol = LOGITS_TOL
    rel = leaf_rel_errors(list(params), gk, gp)
    worst = max(rel, key=rel.get)
    check = {"loss_kernel": loss_k, "loss_plain": loss_p,
             "logits_max_abs_err": diff.max().item(),
             "max_leaf_rel_err": rel[worst], "worst_leaf": worst,
             "median_leaf_rel_err": sorted(rel.values())[len(rel) // 2]}
    del got, gk, gp
    log(f"vit training: one step, kernels vs plain attention: {check} "
        f"[logits tol {LOGITS_TOL}, grads {VIT_GRAD_TOL}]")
    if not bool((diff <= atol + rtol * lp.abs()).all()):
        raise AssertionError("ViT logits differ beyond LOGITS_TOL")
    if not rel[worst] <= VIT_GRAD_TOL:
        raise AssertionError(f"ViT gradient of {worst} differs by "
                             f"{rel[worst]}, beyond {VIT_GRAD_TOL}")

    def step():
        logits = model(images)
        loss = classification_loss(logits, labels)
        opt.update(params, torch.autograd.grad(loss, list(params.values())),
                   state)
        return {"loss": loss.detach(),
                "accuracy": (logits.argmax(-1) == labels).float().mean()}

    L = cfg.n_layers
    launches, run = run_steps(step, VIT_STEPS, {
        "flash_attention_fwd": L, "attention_bwd_prep": L,
        "flash_attention_bwd": L, "flash_attention_bwd_dq": 0,
        "flash_attention_bwd_dkv": 0,
        "flash_bwd_delta": 0}, "vit training")
    fit = check_vit_fit(cfg, run, images, labels, model)
    totals = step_totals(profiled(step)[1], "vit training")
    log(f"vit training: one profiled step {totals}")
    metrics = {"card": card, "config": VIT_CONFIG, "batch": VIT_BATCH,
               "steps": VIT_STEPS, **run,
               "images_per_s": VIT_BATCH / run["step_s_median"],
               "device_busy_share": totals["total"] / 1e3
               / run["step_s_median"],
               "profiled_step": totals, "grad_check": check, "fit": fit}
    log("vit training metrics: " + json.dumps(metrics))
    return launches


def check_vit_fit(cfg, run, images, labels, model) -> dict:
    """Whether the ViT's run fitted its batch (VIT_FIT_LOSS), beside the
    control: the head alone trained from the same weights with the same
    optimizer and steps. Also reports the trained model's accuracy on
    another batch of the task, unchecked."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import VisionTransformer, classification_loss
    from ray_tpu_torch.parallel import make_optimizer

    control = VisionTransformer(cfg, device="cuda", seed=0)
    head = {k: p for k, p in control.named_parameters()
            if k.startswith("head.")}
    opt = make_optimizer(learning_rate=VIT_LR, warmup_steps=1)
    state = opt.init(head)
    for _ in range(VIT_STEPS):
        loss = classification_loss(control(images), labels)
        opt.update(head, torch.autograd.grad(loss, list(head.values())),
                   state)
    held_images, held_labels = quadrant_batch(np.random.default_rng(1),
                                              VIT_BATCH, cfg.image_size)
    with torch.no_grad():
        held = model(torch.from_numpy(held_images).cuda()).argmax(-1).cpu()
    tail = run["accuracy"][-5:]
    fit = {"final_loss": run["loss"][-1],
           "accuracy_last5": sum(tail) / len(tail),
           "head_only_final_loss": loss.item(),
           "held_out_accuracy": (held.numpy() == held_labels).mean().item(),
           "bound": VIT_FIT_LOSS}
    log(f"vit training: fit of the batch {fit}")
    if not fit["final_loss"] < VIT_FIT_LOSS < fit["head_only_final_loss"]:
        raise AssertionError(f"vit training: the loss {fit['final_loss']} "
                             f"is not below {VIT_FIT_LOSS}, or the head "
                             "alone reached it")
    if not fit["accuracy_last5"] > 0.9:
        raise AssertionError(f"vit training did not fit its batch: {tail}")
    return fit


def phase_training(card: str, config: str = TRAIN_CONFIG,
                   label: str = "training"):
    """An LM config (the dense 1b, or moe-1b) trained for TRAIN_STEPS steps
    on one batch through ``TrainStepBundle`` with the kernels, at full
    width and depth. Returns each kernel's launches in that run, and the
    run's record (``run_steps``)."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import CONFIGS
    from ray_tpu_torch.parallel import TrainStepBundle, make_optimizer

    cfg = CONFIGS[config]
    t0 = time.perf_counter()
    bundle = TrainStepBundle(cfg, device="cuda", optimizer=make_optimizer(
        learning_rate=1e-4, warmup_steps=1))
    params, opt_state = bundle.init(seed=0)
    batch = bundle.make_batch(np.random.default_rng(0), TRAIN_BATCH,
                              TRAIN_SEQ)
    torch.cuda.synchronize()
    log(f"{label}: {config} bundle up in {time.perf_counter() - t0:.2f}"
        f" s ({cfg.num_params() / 1e9:.3f} B params, "
        f"{cfg.active_params() / 1e9:.3f} B active a token, {cfg.n_layers} "
        f"layers, {cfg.n_experts} experts, remat={cfg.remat}), batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}")
    grad_check = check_training_grads(bundle, params, batch, label)

    # bf16: one prep and one flash_bwd a layer, never the earlier pair
    launches, run = run_steps(
        lambda: {"loss": bundle.step(params, opt_state, batch)[2]},
        TRAIN_STEPS, {
            "flash_attention_fwd": (2 if cfg.remat else 1) * cfg.n_layers,
            "attention_bwd_prep": cfg.n_layers,
            "flash_attention_bwd": cfg.n_layers,
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
            "flash_bwd_delta": 0},
        label)
    tokens_per_s = TRAIN_BATCH * TRAIN_SEQ / run["step_s_median"]
    breakdown = profile_step(bundle, params, opt_state, batch, label)
    metrics = {
        "card": card, "config": config, "batch": TRAIN_BATCH,
        "seq": TRAIN_SEQ, "steps": TRAIN_STEPS, **run,
        "device_busy_share": breakdown["total"] / 1e3
        / run["step_s_median"],
        "tokens_per_s": tokens_per_s,
        "mfu": tokens_per_s * cfg.flops_per_token() / H100_BF16_FLOPS,
        "flops_per_token": cfg.flops_per_token(),
        "grad_check": grad_check, "device_ms_by_part": breakdown,
    }
    if cfg.n_experts:
        metrics["mfu_counts"] = (
            "6 x active params (K of E experts a token) + 12 L d S, the JAX "
            "formula; the experts' capacity padding (capacity_factor "
            f"{cfg.capacity_factor}) and the router are not counted")
    log(f"{label} metrics: " + json.dumps(metrics))
    return launches, run


def run_steps(step, n_steps: int, per_step: dict, label: str):
    """``step()`` (one training step; it returns a dict of 0-d tensors,
    ``loss`` among them) ``n_steps`` times, with every launch counter set
    to 0 just before and read just after; each step timed to its end on the
    card, beside the host's share (the time to enqueue it). Raises unless
    the loss is finite and falls and each kernel launched ``per_step`` times
    a step. Returns the launches, and the run's record: each value by step,
    the step times, their medians over the steps after TRAIN_WARMUP, and
    the peak memory."""
    import numpy as np
    import torch

    torch.cuda.reset_peak_memory_stats()
    kernel_launches(reset=True)
    values, times, enqueue = [], [], []
    for _ in range(n_steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        values.append(step())
        enqueue.append(time.perf_counter() - t)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    launches = kernel_launches()
    peak_bytes = torch.cuda.max_memory_allocated()
    record = {key: [v[key].item() for v in values] for key in values[0]}
    losses = record["loss"]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{label} loss not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{label} loss did not fall: {losses}")
    want = {k: n * n_steps for k, n in per_step.items()}
    if launches != want:
        raise AssertionError(f"{label} launched {launches}, want {want} "
                             f"({per_step} a step x {n_steps} steps)")
    log(f"{label}: {n_steps} steps, losses {losses}; launches {launches} = "
        f"{per_step} a step")

    def median(xs):
        xs = sorted(xs[TRAIN_WARMUP:])
        return xs[len(xs) // 2]

    return launches, {**record, "step_s": times,
                      "step_s_median": median(times),
                      "enqueue_s_median": median(enqueue),
                      "max_memory_allocated_bytes": peak_bytes,
                      "launches_per_step": per_step}


def leaf_rel_errors(names, got, want) -> dict:
    """||got - want|| / ||want|| for each leaf. A key projection's bias has
    an exact gradient of 0 (it adds one constant to each query's scores,
    which softmax ignores), so both sides hold only rounding noise there:
    its difference is measured against its kernel's gradient instead."""
    norms = {n: w.float().norm() for n, w in zip(names, want)}
    out = {}
    for n, g, w in zip(names, got, want):
        ref = norms[n[:-len("bias")] + "kernel" if n.endswith(".key.bias")
                    else n]
        out[n] = ((g.float() - w.float()).norm()
                  / ref.clamp_min(1e-30)).item()
    return out


def _record_routing(model, chosen: dict) -> list:
    """Forward pre-hooks on every ``MoEMLP`` of ``model`` that keep, per
    layer, the top-K experts its router picks on its first call's input
    (remat calls it again in the backward), whatever routing the layer then
    runs. Returns the hooks' handles."""
    import torch

    from ray_tpu_torch.models.transformer import MoEMLP

    def hook(module, args):
        if module not in chosen:
            x = args[0]
            g = module.group_size(x.shape[0] * x.shape[1])
            with torch.no_grad():
                routing = MoEMLP.route(module, x.reshape(-1, g, x.shape[-1]))
            chosen[module] = routing.expert
    return [m.register_forward_pre_hook(hook) for m in model.modules()
            if isinstance(m, MoEMLP)]


def check_training_grads(bundle, params, batch, label: str) -> dict:
    """One step's loss (with the MoE aux, as the bundle's) and gradients
    through the kernels against the same step with plain attention
    (``attention_impl="xla"``), from the same params and batch (see
    TRAIN_LOSS_TOL, TRAIN_GRAD_TOL). For a MoE config the plain step
    replays the kernel step's routing (each layer's experts, so its slots
    and drops; gates and aux from its own router), and the share of tokens
    whose own top-K differs from the replayed one is bounded apart
    (MOE_ROUTE_TOL)."""
    import functools

    import torch

    from ray_tpu_torch.models import Transformer, lm_loss
    from ray_tpu_torch.models.transformer import MoEMLP

    cfg = bundle.cfg
    plain = Transformer(dataclasses.replace(cfg, attention_impl="xla"),
                        device=bundle.device, params=params)
    pairs = list(zip(
        (m for m in bundle.model.modules() if isinstance(m, MoEMLP)),
        (m for m in plain.modules() if isinstance(m, MoEMLP))))
    result, chosen = {}, {}
    for name, model in (("kernel", bundle.model), ("plain", plain)):
        weights = [p for _, p in model.named_parameters()]
        hooks = _record_routing(model, chosen)
        logits, aux = model(batch["tokens"], return_aux=True)
        loss = lm_loss(logits, batch["targets"], batch["mask"])
        if aux:
            loss = loss + cfg.moe_aux_coef * sum(aux.values())
        del logits
        grads = torch.autograd.grad(loss, weights)
        for h in hooks:
            h.remove()
        result[name] = (loss.detach(), grads)
        if name == "kernel":  # the plain step runs the kernel step's routing
            for mk, mp in pairs:
                mp.route = functools.partial(MoEMLP.route, mp,
                                             expert=chosen[mk])
    for _, mp in pairs:  # the partial refers to its module: free the cycle
        del mp.route
    (loss_k, grads_k), (loss_p, grads_p) = result["kernel"], result["plain"]
    rel = leaf_rel_errors(list(params), grads_k, grads_p)
    worst = max(rel, key=rel.get)
    check = {"loss_kernel": loss_k.item(), "loss_plain": loss_p.item(),
             "max_leaf_rel_err": rel[worst], "worst_leaf": worst,
             "median_leaf_rel_err": sorted(rel.values())[len(rel) // 2]}
    if cfg.n_experts:
        n_moe = sum(1 for k in params if k.endswith(".router.kernel"))
        if not len(pairs) == n_moe or not all(
                mk in chosen and mp in chosen for mk, mp in pairs):
            raise AssertionError("a MoE layer's routing was not recorded")
        flipped = [(chosen[mk].sort(-1).values != chosen[mp].sort(-1).values)
                   .any(-1).float().mean().item() for mk, mp in pairs]
        share = sum(flipped) / len(flipped)
        check.update(routed_otherwise_share=share,
                     routed_otherwise_by_layer=flipped)
        if not share <= MOE_ROUTE_TOL:
            raise AssertionError(f"{share:.4f} of the tokens are routed "
                                 f"otherwise, beyond {MOE_ROUTE_TOL}")
    del plain, pairs, chosen
    log(f"{label}: one step, kernels vs plain attention: {check}")
    if not abs(check["loss_kernel"] - check["loss_plain"]) <= TRAIN_LOSS_TOL:
        raise AssertionError(f"{label} loss differs beyond {TRAIN_LOSS_TOL}")
    if not rel[worst] <= TRAIN_GRAD_TOL:
        raise AssertionError(f"gradient of {worst} differs by {rel[worst]} "
                             f"(relative), beyond {TRAIN_GRAD_TOL}")
    return check


MM_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::matmul")


KERNEL_NAMES = ("flash_fwd", "flash_bwd", "flash_bwd_dq", "flash_bwd_dkv",
                "flash_bwd_prep", "flash_bwd_delta")


# the ops of MoEMLP's dispatch and combine (and their backward): the copy
# of each slot's token into its buffer row, the gathers of rows, the
# index_add of the combine's backward, the slot count's cumsum. The
# combine's fp32 weighted sum is booked as elementwise work ("other").
MOE_INDEX_OPS = ("aten::index_copy", "aten::index_select", "aten::index_add_",
                 "aten::cumsum")
# the router's own ops beside its fp32 product: softmax and top-K (the
# model's only softmax; the loss takes log_softmax)
MOE_ROUTER_OPS = ("aten::_softmax", "aten::_softmax_backward_data",
                  "aten::topk")


# the autograd nodes of attention's backward: one device's, and the ring's
# (the seq axis, at any size)
ATTN_BWD_NODES = ("FlashAttentionBackward", "RingAttentionBackward")
# NCCL's device events (``nccl:<op>``, or a kernel ``ncclDevKernel_<Op>``)
# by the collective their name holds, lower-cased: the fsdp gathers, the
# MoE routing exchange and expert gather (all_gather); the gradients' sums,
# the tensor axis's reductions and the MoE statistics and copy-to-region
# backward (all_reduce); the fsdp gradients (reduce_scatter); the ring's
# sends (send, recv). At world 1 NCCL runs some of them as copies, which
# the profiler books as memcpy ("other").
NCCL_KINDS = {"all_gather": "collectives_all_gather",
              "allgather": "collectives_all_gather",
              "all_reduce": "collectives_all_reduce",
              "allreduce": "collectives_all_reduce",
              "reduce_scatter": "collectives_reduce_scatter",
              "reducescatter": "collectives_reduce_scatter",
              "send": "collectives_send_recv",
              "recv": "collectives_send_recv"}


# the backward nodes of the MoE layers' collectives (parallel/
# expert_parallel.py); the tensor axis's copy also runs in attention and
# the MLP
MOE_COLLECTIVE_NODES = ("_SumOverBackward", "_GatherFromRegionBackward",
                        "_CopyToRegionBackward")
# the profiler ranges that ``expert_parallel.GroupAxes`` opens; the trace
# also shows each as a span on the device, which is no kernel
ANNOTATION = "expert_parallel."


def is_annotation(evt) -> bool:
    """A device-side span of a profiler range: booked as no device time."""
    import torch

    return (evt.device_type == torch.autograd.DeviceType.CUDA
            and evt.key.startswith(ANNOTATION))


def profile_step(bundle, params, opt_state, batch, label: str) -> dict:
    """One more step under ``torch.profiler``: device ms of the flash
    kernels, the prep ``flash_bwd_prep`` (Delta and the cleared dQ
    accumulator) among them; of the rest of the attention backward
    (``attn_bwd_glue``: the device time under ``FlashAttention``'s backward
    other than those kernels, i.e. dQ's cast to bf16); of the matrix
    products by the layer their shapes
    name (attention projections, MLP, lm_head; for a MoE config the expert
    products, batched over E, and the router's, with E columns); of a MoE
    config's router ops and its dispatch and combine (``MOE_ROUTER_OPS``,
    ``MOE_INDEX_OPS``); of the optimizer's foreach ops; of NCCL's kernels
    by kind (``NCCL_KINDS``, on a mesh); and of the rest. Beside them, the
    MoE layers' collectives by op (``moe_collectives_by_op``, on a mesh).
    The full table goes to OUT_DIR."""
    import torch

    cfg = bundle.cfg
    prof, averages = profiled(lambda: bundle.step(params, opt_state, batch))
    parts = {**dict.fromkeys(KERNEL_NAMES, 0.0), "attn_bwd_glue": 0.0,
             "attn_projections": 0.0, "mlp": 0.0, "lm_head": 0.0,
             "other_matmul": 0.0, "optimizer": 0.0,
             **dict.fromkeys(NCCL_KINDS.values(), 0.0)}
    if cfg.n_experts:
        parts.update(moe_router=0.0, moe_dispatch_combine=0.0,
                     moe_expert_gemms=0.0)
    total = 0.0
    for evt in averages:
        ms = evt.self_device_time_total / 1e3
        if is_annotation(evt):
            continue
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            total += ms
            for kernel in KERNEL_NAMES:
                if f"{kernel}_kernel" in evt.key:
                    parts[kernel] += ms
            if "nccl" in evt.key.lower():
                kind = next((part for name, part in NCCL_KINDS.items()
                             if name in evt.key.lower()),
                            "collectives_other")
                parts.setdefault(kind, 0.0)
                parts[kind] += ms
            continue
        if cfg.n_experts and evt.key in MOE_INDEX_OPS:
            parts["moe_dispatch_combine"] += ms
        elif cfg.n_experts and evt.key in MOE_ROUTER_OPS:
            parts["moe_router"] += ms
        elif evt.key in MM_OPS:
            dims = {d for shape in evt.input_shapes for d in shape}
            if cfg.n_experts and evt.key == "aten::bmm":
                parts["moe_expert_gemms"] += ms
            elif cfg.n_experts and cfg.n_experts in dims:
                parts["moe_router"] += ms
            elif cfg.vocab_size in dims:
                parts["lm_head"] += ms
            elif cfg.d_ff in dims:
                parts["mlp"] += ms
            elif cfg.d_model in dims:
                parts["attn_projections"] += ms
            else:
                parts["other_matmul"] += ms
        elif evt.key.startswith("aten::_foreach"):
            parts["optimizer"] += ms
    # the attention backward's own device time: its autograd node's
    # (outermost events only), less the kernels booked by name above
    def attn_node(name):
        return any(node in name for node in ATTN_BWD_NODES)

    node_ms = sum(evt.device_time_total / 1e3 for evt in prof.events()
                  if attn_node(evt.name) and not (
                      evt.cpu_parent is not None
                      and attn_node(evt.cpu_parent.name)))
    parts["attn_bwd_glue"] = node_ms - sum(parts[k] for k in KERNEL_NAMES
                                           if k != "flash_fwd")
    parts["other"] = total - sum(parts.values())
    # the MoE layers' collectives by op (already booked above by kind and
    # as copies): the kernels of the ops inside each op's forward range
    # (not the range's span on the device, which holds the gaps between
    # them) and of its backward's autograd node
    by_op = {}
    for evt in prof.events():
        if evt.name in MOE_COLLECTIVE_NODES:
            ms = evt.device_time_total / 1e3
        elif evt.name.startswith(ANNOTATION) and not is_annotation(evt):
            ms = sum(c.device_time_total for c in evt.cpu_children) / 1e3
        else:
            continue
        by_op[evt.name] = by_op.get(evt.name, 0.0) + ms
    parts.update(step_totals(averages, label))
    if by_op:
        parts["moe_collectives_by_op"] = by_op
    log(f"{label}: one profiled step, device ms by part {parts}")
    return parts


def profiled(step):
    """``step()`` once under ``torch.profiler`` (CPU and CUDA activity, op
    shapes recorded): the profiler and its key averages by op and shape."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        step()
        torch.cuda.synchronize()
    return prof, prof.key_averages(group_by_input_shape=True)


def step_totals(averages, label: str) -> dict:
    """A profiled step's device ms in all, the host ms spent issuing it
    (inflated by the profiler's own bookkeeping) and the device kernels it
    launched; its table goes to OUT_DIR/<label>_step_profile.txt."""
    import torch

    device = [e for e in averages if not is_annotation(e)
              and e.device_type == torch.autograd.DeviceType.CUDA]
    host = [e for e in averages
            if e.device_type != torch.autograd.DeviceType.CUDA]
    os.makedirs(OUT_DIR, exist_ok=True)
    name = label.replace(" ", "_")
    with open(os.path.join(OUT_DIR, f"{name}_step_profile.txt"), "w") as f:
        f.write(averages.table(sort_by="self_device_time_total",
                               row_limit=60))
    return {"total": sum(e.self_device_time_total for e in device) / 1e3,
            "host_ms_profiled": sum(e.self_cpu_time_total
                                    for e in host) / 1e3,
            "kernels_launched": sum(e.count for e in device)}


def make_prompt(rng, n_tokens: int) -> str:
    # byte tokenizer: one token per ASCII byte, plus BOS
    letters = "abcdefghijklmnopqrstuvwxyz     "
    return "".join(letters[i] for i in rng.integers(0, len(letters),
                                                    n_tokens - 1))


def phase_serving(card: str) -> dict:
    import numpy as np
    import torch

    from ray_tpu_torch.llm import LLMConfig, LLMServer
    from ray_tpu_torch.ops.attention import flash_attention_fwd

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = LLMServer(LLMConfig(model_id="1b"), seed=0, device="cuda")
    engine = server.engine
    torch.cuda.synchronize()
    log(f"serving: 1b engine up in {time.perf_counter() - t0:.2f} s "
        f"({engine.mcfg.num_params() / 1e9:.3f} B params, "
        f"{engine.ecfg.max_num_seqs} slots x {engine.ecfg.max_model_len} "
        f"tokens, page {engine.ecfg.page_size})")

    rng = np.random.default_rng(0)
    prompts = [make_prompt(rng, n) for n in PROMPT_LENS]

    async def request(prompt, max_tokens):
        t = time.perf_counter()
        out = await server.completions(prompt, max_tokens=max_tokens)
        return out, time.perf_counter() - t

    async def serve_all(max_tokens):
        return await asyncio.gather(*(request(p, max_tokens)
                                      for p in prompts))

    # warm-up: the same prompts, 2 tokens each, so the measured run does not
    # pay first-use costs (cuBLAS handles and kernel selection per shape)
    t0 = time.perf_counter()
    asyncio.run(serve_all(2))
    torch.cuda.synchronize()
    log(f"serving: warm-up round (same prompts, 2 tokens) took "
        f"{time.perf_counter() - t0:.3f} s")

    flash_attention_fwd.launches = 0
    engine.metrics = dict.fromkeys(engine.metrics, 0)
    t0 = time.perf_counter()
    answered = asyncio.run(serve_all(32))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_attention_fwd.launches
    metrics = server.engine_metrics()
    peak_bytes = torch.cuda.max_memory_allocated()  # init + warm-up + run

    if len(answered) != len(prompts):
        raise AssertionError(f"{len(answered)} of {len(prompts)} requests "
                             "answered")
    for res, _ in answered:
        if res["finish_reason"] not in ("length", "stop") or \
                not res["token_ids"] or len(res["token_ids"]) > 32:
            raise AssertionError(f"bad completion {res}")
        if any(not 0 <= t < engine.mcfg.vocab_size for t in res["token_ids"]):
            raise AssertionError("token outside the vocabulary")
    want = engine.mcfg.n_layers * metrics["prefill_calls"]
    if metrics["prefill_calls"] < 2 or launches != want:
        raise AssertionError(
            f"flash_fwd launched {launches} times in serving, want n_layers "
            f"x prefill calls = {want}")
    log(f"serving: {len(answered)} requests done in {wall:.3f} s; flash_fwd "
        f"launches {launches} = {engine.mcfg.n_layers} layers x "
        f"{metrics['prefill_calls']} prefill calls; metrics {metrics}")

    check_prefill_logits(engine, prompts[:engine.ecfg.max_num_seqs])

    ttft = sorted(res["ttft_s"] for res, _ in answered)
    lat = sorted(t for _, t in answered)
    serving = {
        "card": card,
        "requests": len(answered),
        "prefill_tokens": metrics["prefill_tokens"],
        "prefill_tokens_per_s": metrics["prefill_tokens"] / metrics["prefill_s"],
        "decode_tokens": metrics["decode_tokens"],
        "decode_tokens_per_s": metrics["decode_tokens"] / metrics["decode_s"],
        "ttft_p50_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1],
        "latency_p50_s": lat[len(lat) // 2], "latency_max_s": lat[-1],
        "wall_s": wall,
        "max_memory_allocated_bytes": peak_bytes,
        "flash_fwd_launches": launches,
        "prefill_calls": metrics["prefill_calls"],
    }
    log("serving metrics: " + json.dumps(serving))
    return {"launches": launches, "prompts": prompts,
            "token_ids": [res["token_ids"] for res, _ in answered],
            "decode_tokens_per_s": serving["decode_tokens_per_s"],
            "wall_s": wall}


def check_prefill_logits(engine, prompts) -> None:
    """One batch's prefill logits through the kernel against the same batch
    with plain attention, on the engine's weights, each into a fresh cache
    of its own (the engine's model runner, called directly)."""
    import torch

    from ray_tpu_torch.llm import model_runner

    e, mcfg = engine.ecfg, engine.mcfg
    rows = [engine.tokenizer.encode(p) for p in prompts]
    S = e.prefill_bucket_min  # the engine's bucket for the longest prompt
    while S < max(map(len, rows)):
        S *= 2
    S = min(S, e.max_model_len)
    tokens = torch.zeros(len(rows), S, dtype=torch.long)
    for i, r in enumerate(rows):
        tokens[i, :len(r)] = torch.tensor(r)
    lengths = torch.tensor([len(r) for r in rows])
    per_seq = -(-S // e.page_size)
    tables = 1 + torch.arange(len(rows) * per_seq).reshape(len(rows), per_seq)
    out = {}
    for impl in ("auto", "xla"):
        cfg = dataclasses.replace(mcfg, attention_impl=impl)
        cache = model_runner.init_cache(cfg, 1 + tables.numel(), e.page_size,
                                        device=engine.device)
        out[impl], _ = model_runner.prefill(
            engine.params, cfg, cache, tokens.to(engine.device),
            lengths.to(engine.device), tables.to(engine.device))
        del cache
    got, ref = out["auto"], out["xla"]
    if not torch.isfinite(got).all():
        raise AssertionError("prefill logits not finite")
    diff = (got - ref).abs()
    atol, rtol = LOGITS_TOL
    same_argmax = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    log(f"prefill logits, kernel vs plain attention (1b, B={len(rows)}, "
        f"bucket {S}): "
        f"max abs {diff.max().item():.3e}, |ref| max {ref.abs().max().item():.3e}, "
        f"argmax agreement {same_argmax:.3f}")
    if not bool((diff <= atol + rtol * ref.abs()).all()):
        raise AssertionError(f"prefill logits disagree beyond atol {atol} "
                             f"rtol {rtol}")


# -- parallel: the collective group, ring and Ulysses, codecs, the mesh -------

# the ring's block math at full width: one sequence of RING_SEQ tokens with
# RING_HEADS query and KV heads of head_dim RING_D, bf16, over RING_RANKS
# virtual ranks; the plain version takes RING_CHUNK query rows at a time, so
# that its fp32 scores fit on the card at that length
RING_SEQ, RING_HEADS, RING_D = 16384, 16, 128
RING_RANKS = (4, 8)
RING_CHUNK = 1024
WORLD1_SHAPE = (2, 2048, 16, 128)  # (B, S, H, D): ring, Ulysses at world 1
MESH_STEPS = 3
CODEC_CPU_SLICE = 1 << 24  # values of the card's encoding checked on the CPU


def phase_parallel(card: str) -> dict:
    """The parallel layer on the card: a collective group of world size 1
    over NCCL (``init_collective_group``, a TCP store on 127.0.0.1) with
    every ``TorchGroup`` op checked exactly; ``ring_attention`` and
    ``ulysses_attention`` through it equal to ``FlashAttention``; the
    ring's block math for RING_RANKS virtual ranks at full width against
    the unsharded kernels and the plain version, with its times; the
    codecs at the 1b's parameter count; and the 1b trained on a
    ``data=1`` mesh and on a world-1 mesh of every axis, and moe-1b on a
    world-1 mesh of every axis, against the single-device step. The
    machine has one card, and NCCL takes one rank a card, so a world larger
    than 1 runs on gloo in the CPU tests. Returns the kernel launches of
    the ring path and of the meshes' training runs."""
    import socket

    import torch

    from ray_tpu_torch import collective as col

    nccl = ".".join(map(str, torch.cuda.nccl.version()))
    log(f"parallel: torch.cuda.device_count() {torch.cuda.device_count()}, "
        f"NCCL {nccl}, torch {torch.__version__}")
    with socket.socket() as sock:  # a free port on this machine
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    group = col.init_collective_group(
        1, 0, group_name="smoke", init_method=f"tcp://127.0.0.1:{port}")
    log(f"parallel: {group.backend} group of world size 1 up in "
        f"{time.perf_counter() - t0:.2f} s")
    metrics = {"card": card, "device_count": torch.cuda.device_count(),
               "nccl": nccl, "torch": torch.__version__,
               "backend": group.backend, "world_size": group.world_size}
    try:
        metrics["group_ops"] = check_group_ops(group)
        launches, metrics["world1_attention"] = check_world1_attention(
            group, card)
        ring_launches, metrics["ring_blocks"] = phase_ring_blocks(card)
        launches = {k: launches[k] + ring_launches[k] for k in launches}
        metrics["codecs"] = check_codecs(card)
        t0 = time.perf_counter()
        mesh_launches, metrics["mesh_training"] = phase_mesh_training(card)
        log(f"mesh training: {time.perf_counter() - t0:.2f} s")
    finally:
        col.destroy_collective_group("smoke")
    log("parallel metrics: " + json.dumps(metrics))
    return {"ring_attention": launches, **mesh_launches}


def check_group_ops(group) -> list:
    """Every ``TorchGroup`` op at world size 1 on card tensors, each equal
    to its definition (at one rank: the input, or zeros where ``ppermute``
    sends nothing), and the quantized reduce-scatter and allreduce equal to
    the codec's own round trip on the CPU. ``send`` and ``recv`` need a
    second rank (a rank does not send to itself); they run on gloo in
    tests/test_torch_collective.py."""
    import torch

    from ray_tpu_torch.collective import ReduceOp, quant

    x = torch.arange(-12, 12, dtype=torch.float32, device="cuda").reshape(
        8, 3)
    checks = []

    def same(what, got, want):
        if not (got.device.type == "cuda" and torch.equal(got, want)):
            raise AssertionError(f"{group.backend} world 1: {what} is not "
                                 "its definition")
        checks.append(what)

    for op in ReduceOp:
        same(f"allreduce {op.name}", group.allreduce(x, op), x)
        same(f"reducescatter {op.name}", group.reducescatter(x, op), x)
        same(f"reduce {op.name}", group.reduce(x, 0, op), x)
    same("allgather", group.allgather(x), x)
    same("broadcast", group.broadcast(x, 0), x)
    for dtype in (torch.float32, torch.bfloat16, torch.uint8):
        same(f"alltoall {dtype}", group.alltoall(x.to(dtype)), x.to(dtype))
    same("ppermute (0, 0)", group.ppermute(x, [(0, 0)]), x)
    same("ppermute none", group.ppermute(x, []), torch.zeros_like(x))
    group.barrier()
    v = torch.randn(1 << 20, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(4))
    for name in ("int8", "fp8", "bf16"):
        codec = quant.QuantCodec(name)
        want = quant.dequantize(quant.quantize(v.cpu(), codec)).cuda()
        same(f"quantized_reduce_scatter_1d {name}",
             quant.quantized_reduce_scatter_1d(group, codec)(v), want)
    codec = quant.QuantCodec("int8")
    wire = quant.to_wire(quant.quantize(v, codec), extra=torch.ones(
        2, device="cuda"))
    got = group.allreduce_quantized(wire, codec)
    ref = quant.reduce_wire_payloads(
        [quant.to_wire(quant.quantize(v.cpu(), codec),
                       extra=torch.ones(2))], codec.spec())
    for key in ("codes", "scales", "extra"):
        same(f"allreduce_quantized {key}", got[key], ref[key].cuda())
    torch.cuda.synchronize()
    log(f"parallel: {group.backend} world 1, every op equal to its "
        f"definition: {checks}")
    return checks


def check_world1_attention(group, card: str):
    """``ring_attention`` and ``ulysses_attention`` through the NCCL group
    at world size 1 on card tensors (WORLD1_SHAPE, bf16, causal and full),
    forward and gradients against ``FlashAttention`` on the same inputs
    within TOL and BWD_TOL (at one rank each is the whole sequence, so the
    same kernels run). Returns the kernel launches of the two functions'
    runs (counted before the references run) and the errors."""
    import importlib

    import torch

    from ray_tpu_torch.ops.ring_attention import (ring_attention,
                                                  ulysses_attention)

    att = importlib.import_module("ray_tpu_torch.ops.attention")
    B, S, H, D = WORLD1_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (torch.randn(B, S, H, D, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    kernel_launches(reset=True)
    runs = {}
    for causal in (True, False):
        for name, fn in (("ring_attention", ring_attention),
                         ("ulysses_attention", ulysses_attention)):
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            o = fn(*leaves, group, causal)
            runs[name, causal] = (o.detach(), *torch.autograd.grad(
                o, leaves, do))
    torch.cuda.synchronize()
    launches = kernel_launches()
    want = {"flash_attention_fwd": 4, "attention_bwd_prep": 4,
            "flash_attention_bwd": 4, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0,
            "flash_bwd_delta": 0}
    if launches != want:
        raise AssertionError(f"ring and Ulysses at world 1 launched "
                             f"{launches}, want {want}")
    errors = {}
    for causal in (True, False):
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        o = att.FlashAttention.apply(*leaves, causal)
        ref = (o.detach(), *torch.autograd.grad(o, leaves, do))
        pv = att.flash_attention_fwd_plain(q, k, v.abs(), causal)[0]
        o_p, lse_p = att.flash_attention_fwd_plain(q, k, v, causal)
        delta = att.attention_delta_plain(o_p, do)
        p, ds = att.bwd_softmax_grads(q, k, v, do, lse_p, delta, causal)
        mag = att.bwd_products(p, ds.abs(), q.abs(), k.abs(), do.abs())
        del p, ds, o_p, lse_p
        for name in ("ring_attention", "ulysses_attention"):
            got = runs[name, causal]
            where = f"{name} world 1 {WORLD1_SHAPE} bf16 causal={int(causal)}"
            errs = {"o": compare(name, "o", got[0], ref[0],
                                 TOL["bfloat16"]["o"], where, pv)}
            for key, g, r, m in zip(("dq", "dk", "dv"), got[1:], ref[1:],
                                    mag):
                errs[key] = compare(name, key, g, r, BWD_TOL["bfloat16"],
                                    where, m)
            errors[f"{name} causal={int(causal)}"] = {
                key: e["max_abs"] for key, e in errs.items()}
        del pv, mag
    log(f"parallel: ring and Ulysses at world 1 against FlashAttention, "
        f"max abs errors {errors} [tol {TOL['bfloat16']['o']}, "
        f"{BWD_TOL['bfloat16']}]; launches {launches} [{card}]")
    return launches, errors


def ring_blocks(i: int, n: int, causal: bool) -> list:
    """The blocks rank i attends to, in the ring's order: rank (i - t) mod
    n at step t, without the future ones under a causal mask."""
    owners = [(i - t) % n for t in range(n)]
    return [j for j in owners if not (causal and j > i)]


def ring_emulate(q, k, v, do, n: int, causal: bool) -> dict:
    """The ring's forward and backward for n virtual ranks in one process,
    through the per-step functions of ``ops.ring_attention``, as
    ``ring_attention_fwd`` and ``ring_attention_bwd`` run them on each
    rank (``ring_emulate_fwd``, ``ring_emulate_bwd``). Returns the whole
    sequence's o, lse, Delta and gradients."""
    o, lse = ring_emulate_fwd(q, k, v, n, causal)
    return {"o": o, "lse": lse,
            **ring_emulate_bwd(q, k, v, do, o, lse, n, causal)}


def ring_emulate_fwd(q, k, v, n: int, causal: bool):
    """Rank i's blocks attended and merged by lse, for each of n virtual
    ranks; the whole sequence's o (q's dtype) and lse."""
    import torch

    from ray_tpu_torch.ops.ring_attention import attend_block, merge_blocks

    L = q.shape[1] // n

    def part(x, i):
        return x[:, i * L:(i + 1) * L]

    outs, lses = [], []
    for i in range(n):
        o = lse = None
        for j in ring_blocks(i, n, causal):
            o_b, lse_b = attend_block(part(q, i), part(k, j), part(v, j),
                                      causal and j == i)
            o, lse = ((o_b.float(), lse_b) if o is None
                      else merge_blocks(o, lse, o_b, lse_b))
        outs.append(o.to(q.dtype))
        lses.append(lse)
    return torch.cat(outs, dim=1), torch.cat(lses, dim=1)


def ring_emulate_bwd(q, k, v, do, o, lse, n: int, causal: bool) -> dict:
    """Each block's backward fed rank i's merged lse and Delta, its dQ added
    into rank i's one fp32 buffer (Delta and that buffer's zeros from one
    prep, as ``ring_attention_bwd`` takes them), dK and dV summed at their
    owner in fp32; the sums cast to q's dtype. Returns Delta and the
    gradients."""
    import torch

    from ray_tpu_torch.ops.attention import attention_bwd_prep
    from ray_tpu_torch.ops.ring_attention import block_backward

    L = q.shape[1] // n

    def part(x, i):
        return x[:, i * L:(i + 1) * L]

    deltas, dqs = [], []
    dkv = [torch.zeros(k.shape, dtype=torch.float32, device=k.device)
           for _ in range(2)]
    for i in range(n):
        delta, dq, _ = attention_bwd_prep(part(o, i), part(do, i))
        lse_i = part(lse, i).contiguous()  # the kernel reads it flat
        for j in ring_blocks(i, n, causal):
            dk, dv = block_backward(part(q, i), part(k, j), part(v, j),
                                    part(do, i), lse_i, delta,
                                    causal and j == i, dq)
            part(dkv[0], j).add_(dk)
            part(dkv[1], j).add_(dv)
        deltas.append(delta)
        dqs.append(dq.to(q.dtype))
    return {"delta": torch.cat(deltas, dim=1), "dq": torch.cat(dqs, dim=1),
            "dk": dkv[0].to(k.dtype), "dv": dkv[1].to(v.dtype)}


def plain_scores(qf, kf, causal: bool, r0: int, r1: int):
    """fp32 scaled scores of query rows r0:r1 against every key, (B, H,
    r1 - r0, S), masked with -1e30 above the diagonal under ``causal``."""
    import torch

    s = torch.einsum("bqhd,bkhd->bhqk", qf[:, r0:r1], kf)
    s *= 1.0 / math.sqrt(qf.shape[-1])
    if causal:
        rows = torch.arange(r0, r1, device=qf.device)[:, None]
        cols = torch.arange(kf.shape[1], device=qf.device)[None]
        s.masked_fill_(cols > rows, -1e30)
    return s


def plain_fwd_chunked(q, k, v, causal: bool, n: int = 1):
    """``flash_attention_fwd_plain`` by RING_CHUNK query rows at a time, for
    sequences whose whole fp32 scores would not fit: o, lse, P |V| (its o
    on |v|, the tolerance's magnitude) and sum_j |P_j V_j| over n equal key
    blocks j (P the whole row's probabilities in fp32: w_j o_j of block j,
    w_j its merge weight)."""
    import torch

    B, S, H, D = q.shape
    L = S // n
    qf, kf, vf = q.float(), k.float(), v.float()
    o, pv = torch.empty_like(q), torch.empty_like(q)
    blocks = torch.zeros_like(qf)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    for r0 in range(0, S, RING_CHUNK):
        r1 = min(S, r0 + RING_CHUNK)
        s = plain_scores(qf, kf, causal, r0, r1)
        lse[:, :, r0:r1] = torch.logsumexp(s, dim=-1)
        p = torch.softmax(s, dim=-1)
        del s
        probs = p.to(q.dtype)
        o[:, r0:r1] = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        pv[:, r0:r1] = torch.einsum("bhqk,bkhd->bqhd", probs, v.abs())
        for j in range(n):
            keys = slice(j * L, (j + 1) * L)
            blocks[:, r0:r1] += torch.einsum(
                "bhqk,bkhd->bqhd", p[..., keys], vf[:, keys]).abs()
    return o, lse.reshape(B * H, S, 1), pv, blocks


def plain_bwd_chunked(q, k, v, do, lse, delta, causal: bool, n: int = 1):
    """The plain backward (``bwd_softmax_grads`` and ``bwd_products``, H =
    KVH) from the given lse and Delta, by RING_CHUNK query rows at a time,
    in fp32. Returns the gradients; the same products on absolute values
    (the tolerance's M); and the sums over n equal blocks of the blocks'
    shares in absolute value: sum_j |dQ_ij| over key blocks j, sum_i
    |dK_ij|, sum_i |dV_ij| over query blocks i."""
    import torch

    B, S, H, D = q.shape
    L = S // n
    if L % RING_CHUNK and L > RING_CHUNK:
        raise ValueError(f"{RING_CHUNK}-row chunks do not tile {L}-row "
                         "blocks")
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    lse, delta = lse.reshape(B, H, S, 1), delta.reshape(B, H, S, 1)
    keys = ("dq", "dk", "dv")
    grads, mags, sums, share = ({key: torch.zeros_like(qf) for key in keys}
                                for _ in range(4))
    for r0 in range(0, S, RING_CHUNK):
        r1 = min(S, r0 + RING_CHUNK)
        rows = slice(r0, r1)
        p = torch.exp(plain_scores(qf, kf, causal, r0, r1) - lse[:, :, rows])
        dp = torch.einsum("bqhd,bkhd->bhqk", dof[:, rows], vf)
        ds = p * (dp - delta[:, :, rows]) * (1.0 / math.sqrt(D))
        del dp
        grads["dq"][:, rows] = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
        for key, x, y in (("dk", ds, qf[:, rows]), ("dv", p, dof[:, rows])):
            c = torch.einsum("bhqk,bqhd->bkhd", x, y)
            grads[key] += c
            share[key] += c
        for j in range(n):
            cols = slice(j * L, (j + 1) * L)
            sums["dq"][:, rows] += torch.einsum(
                "bhqk,bkhd->bqhd", ds[..., cols], kf[:, cols]).abs()
        if r1 % L == 0 or r1 == S:  # the end of a query block
            for key in ("dk", "dv"):
                sums[key] += share[key].abs()
                share[key].zero_()
        ds = ds.abs_()
        mags["dq"][:, rows] = torch.einsum("bhqk,bkhd->bqhd", ds, kf.abs())
        mags["dk"] += torch.einsum("bhqk,bqhd->bkhd", ds, qf[:, rows].abs())
        mags["dv"] += torch.einsum("bhqk,bqhd->bkhd", p, dof[:, rows].abs())
        del p, ds
    return grads, mags, sums


def phase_ring_blocks(card: str):
    """The ring's block math for RING_RANKS virtual ranks in one process
    (``ring_emulate``), causal and full, on one 1 x RING_SEQ sequence of
    RING_HEADS heads at head_dim RING_D in bf16; launches counted over
    those runs alone. Then held against the unsharded kernels on the whole
    sequence and against the plain version by query chunks (fp32 scores):

    - forward, ring against plain: each block's o_j is within the kernel's
      bound (TOL) of its plain value, and the merge is a convex sum with
      weights w_j = exp(lse_j - lse), so |o - o_plain| <= 1e-3 + 2e-2
      sum_j w_j |o_j| + 2^-8 P|V|, with w_j o_j = P_j V_j of the plain
      version (P the row's probabilities) and sum_j w_j P_j|V_j| = P|V|;
      the fp32 merge and the rounding of o to bf16 (2^-9 of |o|) fall
      under the rtol. lse: each block's is within 1e-3, logaddexp is a
      weighted mean of them, and the n merges round by 2^-23 of |lse|
      each: 1e-3 + n 2^-22 |lse|;
    - backward, ring against the plain backward fed the ring's own lse and
      Delta: each block's dX within BWD_TOL of its plain value, summed over
      the n blocks: n 1e-4 + 2e-2 sum_j |dX_ij| + 2^-8 M, the block shares
      dX_ij and M (a sum over the blocks too) of the plain version; the
      fp32 sums and their cast to bf16 fall under the rtol;
    - the unsharded kernels against plain: TOL and BWD_TOL as they are;
    - ring against the unsharded kernels: the two bounds above added, and
      for the backward the plain backward's own change between the ring's
      lse, Delta and the unsharded ones (measured in fp32).

    Times: each block kind, the merge, the prep at one rank's length, the
    whole emulated ring (every rank's work on this one card), the busiest
    rank's share (the last one: a real ring's step time) and the unsharded
    kernels, beside the bound."""
    import importlib

    import torch

    att = importlib.import_module("ray_tpu_torch.ops.attention")
    S, H, D = RING_SEQ, RING_HEADS, RING_D
    gen = torch.Generator(device="cuda").manual_seed(6)
    q, k, v, do = (torch.randn(1, S, H, D, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    kernel_launches(reset=True)
    runs = {(n, causal): ring_emulate(q, k, v, do, n, causal)
            for causal in (True, False) for n in RING_RANKS}
    torch.cuda.synchronize()
    launches = kernel_launches()
    blocks = sum(len(ring_blocks(i, n, causal)) for n in RING_RANKS
                 for causal in (True, False) for i in range(n))
    want = {"flash_attention_fwd": blocks, "attention_bwd_prep":
            2 * sum(RING_RANKS), "flash_attention_bwd": blocks,
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
            "flash_bwd_delta": 0}
    if launches != want:
        raise AssertionError(f"ring blocks launched {launches}, want {want}")
    log(f"ring blocks: {RING_RANKS} virtual ranks, causal and full, "
        f"launched {launches}")
    report = {"shape": [1, S, H, H, D], "ranks": list(RING_RANKS),
              "checks": {}, "times": {}}
    atol, rtol, m = TOL["bfloat16"]["o"]
    latol = TOL["bfloat16"]["lse"][0]
    batol, brtol, bm = BWD_TOL["bfloat16"]
    for causal in (True, False):
        where = f"1 x {S}, {H} heads, D {D}, bf16, causal={int(causal)}"
        o_f, lse_f = att.flash_attention_fwd(q, k, v, causal)
        delta_f = att.attention_delta(o_f, do)
        full = dict(zip(("dq", "dk", "dv"), att.flash_attention_bwd(
            q, k, v, o_f, lse_f, do, causal)))
        plain_f, mag_f, _ = plain_bwd_chunked(q, k, v, do, lse_f, delta_f,
                                              causal)
        errs = {}

        def check(label, kernel, key, got, ref, tol, at, mag):
            errs[label] = compare(kernel, key, got, ref, tol, at,
                                  mag)["max_abs"]

        for key in ("dq", "dk", "dv"):
            check(f"full {key} vs plain", "flash_bwd", key, full[key],
                  plain_f[key], BWD_TOL["bfloat16"], where, mag_f[key])
        for n in RING_RANKS:
            ring = runs[n, causal]
            at = f"{where}, {n} virtual ranks"
            o_p, lse_p, pv, o_blocks = plain_fwd_chunked(q, k, v, causal, n)
            pv = pv.float()
            merge = n * 2.0 ** -22 * lse_p.abs()
            check("full o vs plain", "flash_fwd", "o", o_f, o_p,
                  TOL["bfloat16"]["o"], where, pv)
            check("full lse vs plain", "flash_fwd", "lse", lse_f, lse_p,
                  TOL["bfloat16"]["lse"], where, None)
            check(f"{n} o vs plain", "ring", "o", ring["o"], o_p,
                  (atol, 0.0, 1.0), at, rtol * o_blocks + m * pv)
            check(f"{n} lse vs plain", "ring", "lse", ring["lse"], lse_p,
                  (latol, 0.0, 1.0), at, merge)
            check(f"{n} o vs full", "ring", "o", ring["o"], o_f,
                  (2 * atol, 0.0, 1.0), at,
                  rtol * (o_blocks + o_p.float().abs()) + 2 * m * pv)
            check(f"{n} lse vs full", "ring", "lse", ring["lse"], lse_f,
                  (2 * latol, 0.0, 1.0), at, merge)
            del o_p, lse_p, pv, o_blocks, merge
            plain_r, mag_r, sums = plain_bwd_chunked(
                q, k, v, do, ring["lse"], ring["delta"], causal, n)
            for key in ("dq", "dk", "dv"):
                check(f"{n} {key} vs plain", "ring", key, ring[key],
                      plain_r[key], (n * batol, 0.0, 1.0), at,
                      brtol * sums[key] + bm * mag_r[key])
                check(f"{n} {key} vs full", "ring", key, ring[key],
                      full[key], ((n + 1) * batol, 0.0, 1.0), at,
                      brtol * (sums[key] + plain_f[key].abs())
                      + bm * (mag_r[key] + mag_f[key])
                      + (plain_r[key] - plain_f[key]).abs())
            del plain_r, mag_r, sums
        report["checks"][f"causal={int(causal)}"] = errs
        log(f"check ring blocks {where}: max abs errors {errs} [tol fwd "
            f"{TOL['bfloat16']}, bwd {BWD_TOL['bfloat16']}, summed over "
            f"blocks, plus n 2^-22 |lse| for the merge]")
        del plain_f, mag_f
        report["times"][f"causal={int(causal)}"] = time_ring(
            q, k, v, do, o_f, lse_f, delta_f, causal, card)
        del o_f, lse_f, delta_f, full
    del runs
    torch.cuda.empty_cache()
    return launches, report


def time_ring(q, k, v, do, o_f, lse_f, delta_f, causal: bool, card: str):
    """Times of the ring's parts at each RING_RANKS (CUDA events, median of
    TIME_ROUNDS rounds in turns) beside the unsharded kernels: a diagonal
    block (causal when the ring is) and an off-diagonal one (full), forward
    and backward, a merge, the whole emulated ring (every rank's blocks on
    this one card) and the busiest rank's share (the last one, which
    attends to every block); the prep at one rank's length and at the
    whole sequence against the earlier design (``prep_entries``, in the
    causal call only: the prep does not depend on the mask). Beside each
    block kind and the unsharded kernels, the library's call on the same
    inputs (yardsticks the port never calls): one sdpa forward and the
    backward of one (with its own Delta)."""
    import importlib

    import torch
    import torch.nn.functional as F

    att = importlib.import_module("ray_tpu_torch.ops.attention")
    from ray_tpu_torch.ops.ring_attention import (attend_block,
                                                  block_backward,
                                                  merge_blocks)

    B, S, H, D = q.shape
    out = {}
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)

    def library(qs, ks, vs, dos, block_causal):
        """sdpa's forward and backward on these (B, S, H, D) blocks."""
        qt, kt, vt = (x.transpose(1, 2) for x in (qs, ks, vs))
        leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
        o = F.scaled_dot_product_attention(*leaves, is_causal=block_causal)
        dot = dos.transpose(1, 2)
        return (lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=block_causal),
                lambda: torch.autograd.grad(o, leaves, dot,
                                            retain_graph=True))

    lib_fwd, lib_bwd = library(q, k, v, do, causal)
    unsharded = {
        "fwd": lambda: att.flash_attention_fwd(q, k, v, causal),
        "bwd": lambda: att.flash_attention_bwd_rows(q, k, v, do, lse_f,
                                                    delta_f, causal,
                                                    dq_acc=dq),
        "prep": lambda: att.attention_bwd_prep(o_f, do),
        "library_fwd": lib_fwd, "library_bwd": lib_bwd}
    for n in RING_RANKS:
        L = S // n
        qs, ks, vs, dos = (x[:, :L] for x in (q, k, v, do))
        o_b, lse_b = attend_block(qs, ks, vs, False)
        o32 = o_b.float()
        delta, dq_b, _ = att.attention_bwd_prep(o_b, dos)
        diag_fwd, diag_bwd = library(qs, ks, vs, dos, causal)
        off_fwd, off_bwd = library(qs, ks, vs, dos, False)
        runs = {
            "fwd_diagonal": lambda: attend_block(qs, ks, vs, causal),
            "fwd_off_diagonal": lambda: attend_block(qs, ks, vs, False),
            "merge": lambda: merge_blocks(o32, lse_b, o_b, lse_b),
            "bwd_diagonal": lambda: block_backward(qs, ks, vs, dos, lse_b,
                                                   delta, causal, dq_b),
            "bwd_off_diagonal": lambda: block_backward(qs, ks, vs, dos,
                                                       lse_b, delta, False,
                                                       dq_b),
            "prep": lambda: att.attention_bwd_prep(o_b, dos),
            "whole_ring": lambda: ring_emulate(q, k, v, do, n, causal),
            "library_fwd_diagonal": diag_fwd,
            "library_fwd_off_diagonal": off_fwd,
            "library_bwd_diagonal": diag_bwd,
            "library_bwd_off_diagonal": off_bwd}
        times = {key: [] for key in runs}
        for r in range(TIME_ROUNDS):
            for key in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
                iters = 2 if key == "whole_ring" else 20
                times[key].append(cuda_time_ms(runs[key], iters, warmup=1))
        ms = {key: sorted(t)[len(t) // 2] for key, t in times.items()}
        # the busiest rank, the last: its diagonal, n - 1 full blocks and
        # n - 1 merges forward; the prep, the diagonal and n - 1 full blocks
        # backward
        ms["last_rank_fwd"] = (ms["fwd_diagonal"] + (n - 1)
                               * (ms["fwd_off_diagonal"] + ms["merge"]))
        ms["last_rank_bwd"] = (ms["prep"] + ms["bwd_diagonal"] + (n - 1)
                               * ms["bwd_off_diagonal"])
        # the plain versions once, at one block (the whole sequence's fp32
        # scores, 16 GB a tensor at 16384, are not timed)
        ms["plain_fwd_diagonal"] = cuda_time_ms(
            lambda: att.flash_attention_fwd_plain(qs, ks, vs, causal), 3,
            warmup=1)
        ms["plain_bwd_diagonal"] = cuda_time_ms(
            lambda: att.flash_attention_bwd_plain(qs, ks, vs, o_b, lse_b,
                                                  dos, causal), 3, warmup=1)
        if causal:
            where = f"ring rank 1 x {L}, {H} heads, D {D}"
            ms["prep_entries"] = prep_entries(
                o_b, dos, check_prep(o_b, dos, where), card, where)
        out[n] = ms
    base = {key: cuda_time_ms(fn, 20) for key, fn in unsharded.items()}
    if causal:
        where = f"ring unsharded 1 x {S}, {H} heads, D {D}"
        base["prep_entries"] = prep_entries(
            o_f, do, check_prep(o_f, do, where), card, where)
    fb, fby = flash_bound(B, H, H, D, S, causal, 2)
    bb, bby = bwd_bound("flash_bwd", B, H, H, D, S, causal, 2)
    out["unsharded"] = {**base, "fwd_bound_ms": fb, "fwd_bound_by": fby,
                        "bwd_bound_ms": bb, "bwd_bound_by": bby}
    log(f"time ring blocks 1 x {S}, {H} heads, D {D}, bf16 causal="
        f"{int(causal)}: {json.dumps(out)}; unsharded flash_fwd "
        f"{base['fwd']:.4f} ms against its bound {fb:.4f} ms ({fby}), "
        f"flash_bwd {base['bwd']:.4f} ms against {bb:.4f} ms ({bby}) "
        f"[{card}]")
    return out


def check_codecs(card: str) -> dict:
    """int8 and fp8 encode and decode on the card of a flat fp32 vector of
    the 1b's parameter count: GB/s (bytes read and written once each), the
    largest error, held within the codec's rounding (int8: half a step,
    scale / 2; fp8 e4m3: 2^-4 of the value, or half the smallest
    subnormal's step, 2^-10 scale, near 0; each plus fp32's roundings),
    and the first CODEC_CPU_SLICE values' codes and scales equal
    to the port's codec on the CPU, bit for bit."""
    import torch

    from ray_tpu_torch.collective import quant
    from ray_tpu_torch.models import CONFIGS

    n = CONFIGS[TRAIN_CONFIG].num_params()
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(n, generator=gen, device="cuda")
    out = {"values": n}
    for name in ("int8", "fp8"):
        codec = quant.QuantCodec(name)
        qt = quant.quantize(x, codec)
        y = quant.dequantize(qt)
        nb = qt.scales.numel()
        enc_ms = cuda_time_ms(lambda: quant.quantize(x, codec), 3, warmup=1)
        dec_ms = cuda_time_ms(lambda: quant.dequantize(qt), 3, warmup=1)
        wire = n + 4 * nb
        scale = qt.scales.repeat_interleave(codec.block)[:n]
        err = (y - x).abs()
        bound = (0.5 * scale if name == "int8" else
                 torch.maximum(2.0 ** -4 * x.abs(), 2.0 ** -10 * scale))
        # fp32's roundings of x / scale (up to 448 x 2^-24 of the scale)
        # and of the decoded product
        bound = bound + 2.0 ** -15 * scale + 2.0 ** -23 * x.abs()
        if not bool((err <= bound).all()):
            raise AssertionError(f"codec {name}: an error beyond the "
                                 "codec's rounding")
        cpu = quant.quantize(x[:CODEC_CPU_SLICE].cpu(), codec)
        if not (torch.equal(qt.codes[:CODEC_CPU_SLICE].cpu(), cpu.codes)
                and torch.equal(qt.scales[:CODEC_CPU_SLICE // codec.block]
                                .cpu(), cpu.scales)):
            raise AssertionError(f"codec {name}: the card's codes differ "
                                 "from the CPU's")
        out[name] = {"encode_ms": enc_ms, "decode_ms": dec_ms,
                     "encode_gb_s": (4 * n + wire) / enc_ms / 1e6,
                     "decode_gb_s": (wire + 4 * n) / dec_ms / 1e6,
                     "max_abs_err": err.max().item(),
                     "max_rel_to_bound": (err / bound).max().item(),
                     "wire_bytes": wire, "raw_bytes": 4 * n}
        del qt, y, scale, err, bound, cpu
    del x
    torch.cuda.empty_cache()
    log(f"parallel: codecs on {n} fp32 values: {json.dumps(out)}; codes "
        f"and scales of the first {CODEC_CPU_SLICE} equal to the CPU's "
        f"[{card}]")
    return out


def phase_mesh_training(card: str):
    """Training on world-1 meshes over the NCCL group, each against the
    single-device step from the same seed and batch (``mesh_runs``): the 1b
    at TRAIN_BATCH x TRAIN_SEQ on ``data=1`` alone (its loss's count, the
    loss and every gradient all-reduced; the ``mesh_training`` path) and on
    every axis at 1 (``mesh_fsdp_tensor``: the fsdp axis's gathers and
    reduce-scatters, the tensor axis's reductions and its
    vocabulary-parallel cross entropy, the seq axis's one-rank ring and the
    gradients' all-reduce over it, and the clip's gathered norm, each a
    one-rank collective); then moe-1b on every axis at 1
    (``mesh_seq_expert``: the same, and the MoE layers' routing exchange,
    global statistics and expert collectives as one-rank collectives).
    Returns the paths' launches and the report."""
    from ray_tpu_torch.parallel import AXES

    every = dict.fromkeys(AXES, 1)
    launches, report = mesh_runs(card, TRAIN_CONFIG, (
        ("mesh_training", {"data": 1}), ("mesh_fsdp_tensor", every)))
    moe_launches, report["moe"] = mesh_runs(card, MOE_CONFIG, (
        ("mesh_seq_expert", every),))
    log(f"mesh training: step s {report['mesh_training']['step_s']} (data "
        f"only) against {report['mesh_fsdp_tensor']['step_s']} (every axis "
        f"at 1); peak memory "
        f"{report['mesh_training']['max_memory_allocated_bytes']} against "
        f"{report['mesh_fsdp_tensor']['max_memory_allocated_bytes']} bytes; "
        f"moe-1b on every axis at 1: step s "
        f"{report['moe']['mesh_seq_expert']['step_s']}, peak "
        f"{report['moe']['mesh_seq_expert']['max_memory_allocated_bytes']} "
        f"bytes [{card}]")
    return {**launches, **moe_launches}, report


def mesh_runs(card: str, config: str, paths):
    """``config`` at TRAIN_BATCH x TRAIN_SEQ: MESH_STEPS steps of the
    single-device bundle, then as many on each of ``paths`` ((name, mesh
    axes), each a world-1 mesh over the NCCL group) from the same seed and
    batch. Each step's loss within TRAIN_LOSS_TOL of the single-device one;
    the step times, enqueue times, busy share, peak memory and a profiled
    step's device ms by part (NCCL's kernels by kind) side by side. Each
    mesh run's launches are counted (``run_steps``; the profiled step comes
    after)."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import CONFIGS
    from ray_tpu_torch.parallel import TrainStepBundle, create_mesh, \
        make_optimizer

    cfg = CONFIGS[config]

    def bundle(**kw):
        b = TrainStepBundle(cfg, optimizer=make_optimizer(
            learning_rate=1e-4, warmup_steps=1), **kw)
        params, opt = b.init(seed=0)
        batch = b.make_batch(np.random.default_rng(0), TRAIN_BATCH,
                             TRAIN_SEQ)
        return b, params, opt, batch

    b, params, opt, batch = bundle(device="cuda")
    single = [b.step(params, opt, batch)[2].item() for _ in range(MESH_STEPS)]
    del b, params, opt, batch
    torch.cuda.empty_cache()
    report = {"config": config, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
              "losses_single": single}
    launches = {}
    for path, axes in paths:
        mesh = create_mesh(axes)
        b, params, opt, batch = bundle(mesh=mesh)
        launches[path], run = run_steps(
            lambda: {"loss": b.step(params, opt, batch)[2]}, MESH_STEPS, {
                "flash_attention_fwd": (2 if cfg.remat else 1)
                * cfg.n_layers,
                "attention_bwd_prep": cfg.n_layers,
                "flash_attention_bwd": cfg.n_layers,
                "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
                "flash_bwd_delta": 0},
            path)
        diffs = [abs(a - s) for a, s in zip(run["loss"], single)]
        parts = profile_step(b, params, opt, batch, path)
        report[path] = {
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
            "losses": run["loss"], "max_loss_diff": max(diffs),
            "step_s": run["step_s"], "enqueue_s": run["enqueue_s_median"],
            "device_busy_share": parts["total"] / 1e3
            / run["step_s_median"],
            "max_memory_allocated_bytes": run["max_memory_allocated_bytes"],
            "device_ms_by_part": parts}
        log(f"{path}: {report[path]} [tol {TRAIN_LOSS_TOL}] [{card}]")
        if not max(diffs) <= TRAIN_LOSS_TOL:
            raise AssertionError(f"{path}: the mesh's losses part from the "
                                 f"single device's by {max(diffs)}")
        del b, params, opt, batch, mesh
        torch.cuda.empty_cache()
    return launches, report


# the tensor axis's per-rank math at full width, for virtual ranks in one
# process: (config, B, S, numbers of ranks). The 1b's block at the training
# shape (at 8 ranks 2 query heads and 1 KV head a rank); one block of the 7b
# preset (d 4096, 32/32 heads, d_ff 11008, head_dim 128) at 1 x 4096. Its
# timings take fewer rounds.
TP_CASES = (("1b", TRAIN_BATCH, TRAIN_SEQ, (2, 4, 8)), ("7b", 1, 4096, (4, 8)))
TP_TIME_ROUNDS = {"1b": TIME_ROUNDS, "7b": 3}
# The block on T virtual ranks against the whole block, bf16, the same
# weights and input, per tensor ||got - want|| / ||want|| (the output, the
# input's gradient, and each weight's, the ranks' shards concatenated). The
# two sides run the same products on the same operands and round apart at:
# - each of the four reductions of the tensor axis (the attention's and the
#   MLP's partial products forward, the gradients into the two norms'
#   outputs backward): the ranks round T partials to bf16 and T - 1 bf16
#   sums, the whole block its one product, each rounding within 2^-9 of
#   its value: at most T 2^-8 of sum_t |P_t|, whose norm is rho times the
#   sum's (rho: the forward's ratio ||sum_t |P_t| || / ||sum_t P_t||,
#   measured, and at least sqrt(T), what independent partials give);
# - elsewhere, one bf16 step (2^-8) at each rounding that may fall apart:
#   the products whose columns are split (q, k, v, gate, up) may take other
#   fp32 orders, and what follows rounds again (RoPE, the kernels' o, P and
#   dS, SiLU x up, the residual adds and the norms, their backward
#   products): at most 16 along the longest path.
# Summed with no cancellation: (4 T rho + 16) 2^-8.
TP_OTHER_ROUNDINGS = 16
# The vocabulary-parallel NLL against lm_loss's on the whole fp32 logits,
# per token: both sum the exponentials of V = 32000 logits in fp32 in a
# tree (the ranks over V / T, then T - 1 more additions), each within
# ceil(log2 V) + T roundings of 2^-24 of the sum, which move its log by as
# much, and round the NLL itself (2^-22 of it, four units of the last
# place): |d nll| <= 2 (ceil(log2 V) + T) 2^-24 + 2^-22 |nll|. The logits'
# gradient, (softmax - one-hot) / N, moves by the same relative amount:
# |d g| <= (2 (ceil(log2 V) + T) 2^-24 + 2^-22) (|g| + 1 / N).


def tp_block(cfg, seed: int):
    """One dense ``Block`` of ``cfg`` on the card with weights from ``seed``:
    the projections normal(0.02), the norm scales 1."""
    import torch

    from ray_tpu_torch.models.transformer import Block

    block = Block(cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for name, p in block.named_parameters():
            if name.endswith(".scale"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=gen)
    return block


def tp_rank_modules(block, size: int, rank: int):
    """Rank ``rank``'s ``Attention`` and ``MLP`` of a whole dense ``Block``
    on a tensor axis of ``size`` ranks: its query and KV heads and its MLP
    columns (``parallel.mesh.cut_leaf`` of the block's weights, as the train
    step cuts its pieces), with no axis bound, so that each returns its
    partial product and every rank can run in this one process."""
    import torch

    from ray_tpu_torch.parallel.mesh import cut_leaf, param_layout

    cfg = block.attn.cfg
    dims = param_layout(cfg, {"tensor": size})
    out = []
    for name in ("attn", "mlp"):
        whole = getattr(block, name)
        part = type(whole)(cfg, device="meta")
        for path, p in whole.named_parameters():
            owner, _, leaf = path.rpartition(".")
            piece = cut_leaf(p.detach(), dims[f"layer_0.{name}.{path}"],
                             {"tensor": size}, {"tensor": rank})
            setattr(part.get_submodule(owner), leaf, torch.nn.Parameter(
                piece, requires_grad=p.requires_grad))
        out.append(part)
    return tuple(out)


def tp_block_on_ranks(block, ranks, x, pos):
    """A dense ``Block``'s forward with its attention and MLP run by the
    ranks' modules (``tp_rank_modules``, in rank order) in one process,
    what the tensor axis's collectives compute: each norm's output feeds
    every rank, so autograd sums their gradients into it (copy-to-region's
    all-reduce), and the partial products are summed in rank order in their
    dtype (reduce-from-region's). The norms are the block's own. The card
    holds one rank of NCCL, and threads cannot stand in for the ranks here:
    every CUDA backward runs on the one autograd thread of the device, where
    a rank waiting for another's gradient would wait for ever."""
    import functools
    import operator

    n1 = block.attn_norm(x)
    h = x + functools.reduce(operator.add,
                             [attn(n1, pos) for attn, _ in ranks])
    n2 = block.mlp_norm(h)
    return h + functools.reduce(operator.add, [mlp(n2) for _, mlp in ranks])


def tp_block_grads(block, ranks, x, pos, dout):
    """The block's output and gradients on T virtual ranks
    (``tp_block_on_ranks``), keyed by the block's parameter names (the
    ranks' shards concatenated along the dims the tensor axis splits) and
    "x"."""
    import torch

    from ray_tpu_torch.parallel.mesh import param_layout

    out = tp_block_on_ranks(block, ranks, x, pos)
    shared = {"x": x, "attn_norm.scale": block.attn_norm.scale,
              "mlp_norm.scale": block.mlp_norm.scale}
    pieces = [(f"{name}.{k}", p) for attn, mlp in ranks
              for name, m in (("attn", attn), ("mlp", mlp))
              for k, p in m.named_parameters()]
    grads = torch.autograd.grad(out, list(shared.values())
                                + [p for _, p in pieces], dout)
    got = dict(zip(shared, grads[:len(shared)]))
    dims = param_layout(block.attn.cfg, {"tensor": len(ranks)})
    for k, _ in block.named_parameters():
        if k not in got:
            got[k] = torch.cat([g for (n, _), g in zip(
                pieces, grads[len(shared):]) if n == k],
                dims[f"layer_0.{k}"]["tensor"])
    return out.detach(), got


def tp_partials_ratio(block, ranks, x, pos) -> float:
    """rho of TP_OTHER_ROUNDINGS' note: the larger of the attention's and
    the MLP's ||sum_t |P_t| || / ||sum_t P_t|| over the ranks' partial
    products."""
    import torch

    with torch.no_grad():
        n1 = block.attn_norm(x)
        parts = [attn(n1, pos).float() for attn, _ in ranks]
        h = x + sum(parts).to(x.dtype)
        ratios = [(sum(p.abs() for p in parts).norm() / sum(parts).norm())
                  .item()]
        n2 = block.mlp_norm(h)
        parts = [mlp(n2).float() for _, mlp in ranks]
        ratios.append((sum(p.abs() for p in parts).norm()
                       / sum(parts).norm()).item())
    return max(ratios)


def check_vocab_parallel_ce(T: int, N: int, V: int, gen) -> dict:
    """The vocabulary-parallel cross entropy over T stacked ranks against
    ``lm_loss`` on N x V fp32 logits on the card (the bound above TP_CASES'
    last note). Returns the largest errors and their bounds."""
    import torch

    from ray_tpu_torch.models.transformer import lm_loss
    from ray_tpu_torch.parallel.tensor_parallel import (StackedRanks,
                                                        vocab_parallel_nll)

    logits = 2 * torch.randn(N, V, generator=gen, device="cuda")
    targets = torch.randint(0, V, (N,), generator=gen, device="cuda")
    whole = logits.clone().requires_grad_()
    ref = lm_loss(whole, targets)
    ref_nll = -torch.log_softmax(logits, -1).gather(-1, targets[:, None])[:, 0]
    want = torch.autograd.grad(ref, whole)[0]
    del whole
    axis = StackedRanks(T)
    stacked = logits.reshape(N, T, V // T).permute(1, 0, 2).contiguous() \
        .requires_grad_()
    nll = vocab_parallel_nll(stacked, targets, axis.starts(V // T, 1), axis)
    got = torch.autograd.grad(nll, stacked, torch.full_like(nll, 1.0 / N))[0]
    got = got.permute(1, 0, 2).reshape(N, V)
    eps = 2 * (math.ceil(math.log2(V)) + T) * 2.0 ** -24
    err = (nll - ref_nll).abs()
    bound = eps + 2.0 ** -22 * ref_nll.abs()
    gerr = (got - want).abs()
    gbound = (eps + 2.0 ** -22) * (want.abs() + 1.0 / N)
    out = {"nll_max_abs_err": err.max().item(),
           "nll_max_rel_to_bound": (err / bound).max().item(),
           "loss_err": abs(nll[0].mean().item() - ref.item()),
           "dlogits_max_abs_err": gerr.max().item(),
           "dlogits_max_rel_to_bound": (gerr / gbound).max().item()}
    if not (bool((err <= bound).all()) and bool((gerr <= gbound).all())
            and out["loss_err"] <= eps + 2.0 ** -22 * abs(ref.item())):
        raise AssertionError(f"vocab-parallel cross entropy over {T} ranks "
                             f"beyond its bound: {out}")
    return out


def time_rank_attention(B, H, KVH, D, S, rounds: int, card: str,
                        where: str, causal: bool = True,
                        label: str = "tensor parallel") -> dict:
    """The kernels at one rank's shape (bf16) against their plain versions
    (``check_attention``: TOL, BWD_TOL, DELTA_TOL), then ``time_attention``
    beside ``flash_bound`` and ``bwd_bound``, the forward's launches alone
    (``time_launches``), the plain versions timed, and the prep against
    the earlier design (``prep_entries``)."""
    import importlib

    import torch

    att = importlib.import_module("ray_tpu_torch.ops.attention")
    gen = torch.Generator(device="cuda").manual_seed(9)
    q, k, v, do = (torch.randn(B, S, h, D, generator=gen, device="cuda",
                               dtype=torch.bfloat16)
                   for h in (H, KVH, KVH, H))
    kind = "causal" if causal else "full"
    o, lse, delta, errs = check_attention(
        q, k, v, do, causal, f"{label} {where} B={B} S={S} H={H} "
        f"KVH={KVH} D={D} bf16 {kind}")
    _, ms = time_attention(q, k, v, do, o, lse, delta, causal, rounds)
    plain = {
        "flash_fwd": cuda_time_ms(
            lambda: att.flash_attention_fwd_plain(q, k, v, causal), 3,
            warmup=1),
        "flash_bwd": cuda_time_ms(
            lambda: att.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                  causal), 3, warmup=1)}
    bounds = {"flash_fwd": flash_bound(B, H, KVH, D, S, causal, 2),
              "flash_bwd": bwd_bound("flash_bwd", B, H, KVH, D, S, causal,
                                     2)}
    library = {"flash_fwd": "library_fwd", "flash_bwd": "library_bwd"}
    max_err = {"flash_fwd": errs["o"]["max_abs"],
               "flash_bwd": max(errs[key]["max_abs"]
                                for key in ("dq", "dk", "dv"))}
    out = {kernel: {"shape": [B, S, H, KVH, D], "causal": causal,
                    "ms": ms[kernel], "bound_ms": b, "bound_by": by,
                    "plain_ms": plain[kernel],
                    "library_ms": ms[library[kernel]],
                    "max_abs_err": max_err[kernel]}
           for kernel, (b, by) in bounds.items()}
    out["flash_bwd"]["backward_ms"] = ms["backward"]
    out["flash_fwd"].update(time_launches(
        "flash_fwd", "flash_fwd", (q, k, v, torch.empty_like(q),
                                   torch.empty_like(lse)), causal, card,
        where))
    log(f"time {label} {where} (B={B} S={S} H={H} KVH={KVH} D={D} "
        f"bf16 {kind}): " + "; ".join(
            f"{kernel} {e['ms']:.4f} ms, bound {e['bound_ms']:.4f} ms "
            f"({e['bound_by']}), {100 * e['bound_ms'] / e['ms']:.1f}% of "
            f"bound, plain {e['plain_ms']:.4f} ms, library "
            f"{e['library_ms']:.4f} ms"
            for kernel, e in out.items())
        + f"; whole bf16 backward {ms['backward']:.4f} ms [{card}]")
    out.update(prep_entries(o, do, errs, card, f"{label} {where}"))
    return out


def phase_tensor_parallel(card: str):
    """The tensor axis's per-rank math at full width (TP_CASES), for
    virtual ranks in one process on the card: each rank's ``Attention``
    and ``MLP`` (``tp_rank_modules``: its query and KV heads and MLP
    columns) run forward and backward through the flash kernels, the
    partial products and the norms' gradients summed in-process in rank
    order (``tp_block_on_ranks``), launches counted over those runs alone
    (T forward, prep and ``flash_bwd`` launches at T ranks); then held
    against the unsharded block with plain attention
    (``attention_impl="xla"``: the bound above TP_OTHER_ROUNDINGS). The
    vocabulary-parallel cross entropy over the same T at the 1b's
    vocabulary against ``lm_loss``. At each rank's shape the kernels
    against their plain versions (TOL, BWD_TOL, DELTA_TOL), then their
    times beside the library's attention. Returns the path's launches and
    each kernel's entries by shape."""
    import torch

    from ray_tpu_torch.models import CONFIGS
    from ray_tpu_torch.models.transformer import Block

    launches = dict.fromkeys(kernel_launches(), 0)
    report = {"card": card, "blocks": {}, "cross_entropy": {}}
    times = {"flash_fwd": {}, "flash_bwd": {}, "flash_bwd_prep": {},
             "flash_bwd_delta": {}}
    for name, B, S, rank_counts in TP_CASES:
        cfg = CONFIGS[name]
        block = tp_block(cfg, seed=10)
        gen = torch.Generator(device="cuda").manual_seed(11)
        x, dout = (torch.randn(B, S, cfg.d_model, generator=gen,
                               device="cuda", dtype=torch.bfloat16)
                   for _ in range(2))
        x.requires_grad_()
        pos = torch.arange(S, device="cuda")[None].expand(B, S)
        runs = {}
        for T in rank_counts:
            ranks = [tp_rank_modules(block, T, t) for t in range(T)]
            kernel_launches(reset=True)
            runs[T] = tp_block_grads(block, ranks, x, pos, dout)
            torch.cuda.synchronize()
            got = kernel_launches()
            want = {"flash_attention_fwd": T, "attention_bwd_prep": T,
                    "flash_attention_bwd": T, "flash_attention_bwd_dq": 0,
                    "flash_attention_bwd_dkv": 0,
                    "flash_bwd_delta": 0}
            if got != want:
                raise AssertionError(f"tensor parallel {name} at {T} ranks "
                                     f"launched {got}, want {want}")
            launches = {k: launches[k] + n for k, n in got.items()}
            runs[T] += (tp_partials_ratio(block, ranks, x, pos),)
            del ranks
        plain = Block(dataclasses.replace(cfg, attention_impl="xla"),
                      device="cuda")
        plain.load_state_dict(block.state_dict())
        del block
        ref = plain(x, pos)[0]
        names = ["x"] + [k for k, _ in plain.named_parameters()]
        want = dict(zip(names, torch.autograd.grad(
            ref, [x] + list(plain.parameters()), dout)))
        ref = ref.detach()
        for T, (out, grads, rho) in runs.items():
            rho = max(rho, math.sqrt(T))
            tol = (4 * T * rho + TP_OTHER_ROUNDINGS) * 2.0 ** -8
            errs = {"out": ((out.float() - ref.float()).norm()
                            / ref.float().norm()).item()}
            errs.update(leaf_rel_errors(names, [grads[k] for k in names],
                                        [want[k] for k in names]))
            worst = max(errs, key=errs.get)
            heads = f"{cfg.n_heads // T}/{cfg.n_kv_heads // T}"
            report["blocks"][f"{name} T={T}"] = {
                "shape": [B, S], "heads_per_rank": heads, "rho": rho,
                "tol": tol, "errors": errs}
            log(f"check tensor parallel {name} block {B} x {S} at {T} ranks "
                f"({heads} heads a rank): relative errors {errs}, largest "
                f"{worst} {errs[worst]:.3e} [tol (4 T rho + "
                f"{TP_OTHER_ROUNDINGS}) 2^-8 = {tol:.3e}, rho {rho:.3f}]")
            if not errs[worst] <= tol:
                raise AssertionError(f"tensor parallel {name} at {T} ranks: "
                                     f"{worst} parts by {errs[worst]:.3e} > "
                                     f"{tol:.3e}")
        del runs, ref, want, plain, x, dout
        torch.cuda.empty_cache()
        for T in rank_counts:
            if name == TRAIN_CONFIG:
                report["cross_entropy"][T] = check_vocab_parallel_ce(
                    T, B * S, cfg.vocab_size, gen)
                log(f"check vocab-parallel cross entropy {B * S} x "
                    f"{cfg.vocab_size} over {T} ranks: "
                    f"{report['cross_entropy'][T]} [{card}]")
            shape = (B, cfg.n_heads // T, cfg.n_kv_heads // T, cfg.head_dim,
                     S)
            entry = time_rank_attention(*shape, TP_TIME_ROUNDS[name], card,
                                        f"{name} T={T}")
            for kernel, e in entry.items():
                times[kernel][f"{name} T={T}"] = e
        torch.cuda.empty_cache()
    log("tensor parallel metrics: " + json.dumps(
        {**report, "times": times}))
    return launches, times


# The seq axis's per-rank math at full width, for virtual ranks in one
# process: the 1b's block at TRAIN_BATCH x TRAIN_SEQ with the sequence split
# over each of SEQ_RANKS (ring blocks of 4 x 1024 and 4 x 512, 16/16 heads
# after K and V are repeated, causal on the diagonal, full elsewhere).
SEQ_RANKS = (2, 4)
# The block on n virtual seq ranks against the whole block with plain
# attention, bf16, per tensor ||got - want|| / ||want||. Beyond the
# roundings of one block through the kernels (TP_OTHER_ROUNDINGS, as the
# tensor-parallel phase derives them), the ranks round at:
# - the forward's merge: each of up to n block outputs is rounded to bf16
#   before the fp32 merge, each within 2^-9 of its value: at most
#   2^-8 of sum_j w_j |o_j|, whose norm is rho times o's (rho: the
#   forward's ratio ||sum_j w_j |o_j| || / ||o||, measured, and at least
#   sqrt(n), what independent blocks give);
# - the backward: dK and dV of each of up to n query blocks rounded to
#   bf16 before their fp32 sum at the owner, and the sum over each KV
#   head's two repeated query heads in bf16: at most n + 1 more 2^-8 of
#   the shares' sum, taken at the same rho.
# Summed with no cancellation: (2 n rho + rho + 16) 2^-8 <= (4 n rho + 16)
# 2^-8, the tensor-parallel phase's form.
SEQ_OTHER_ROUNDINGS = TP_OTHER_ROUNDINGS
# moe-1b's MoE layer (d 1024, E 8, top 2, groups of 4096) at TRAIN_BATCH x
# TRAIN_SEQ, fp32, on virtual ranks: (rows, seq, tensor, experts) of
# ``parallel.expert_parallel.VirtualRanks``: experts over 2, 4 and 8 ranks;
# tokens over 2 and 4 row ranks (at 4 a group of 4096 spans two ranks).
EP_CASES = ((1, 1, 1, 2), (1, 1, 1, 4), (1, 1, 1, 8), (2, 1, 1, 1),
            (4, 1, 1, 1))
# Against the whole layer on the same weights and input, both on the card:
# the ranks' experts are the whole layer's (each rank's router runs on its
# own rows; fp32 products, TF32 off since ``phase_device``); the outputs,
# the input's gradient and every weight's (summed over the token ranks)
# within MOE_LAYER_TOL of the largest value (fp32 sums of up to F = 2816
# products in other orders, and R <= 4 more terms), aux within
# MOE_AUX_RTOL. A token whose
# top-K the ranks' router products round apart from the whole layer's
# (other GEMM shapes) would move its slots; the share of such tokens must
# stay within MOE_ROUTE_TOL, and the whole layer replays the ranks'
# choices (``route(..., expert=)``), so that both run the same slots.
EP_AUX_COEF = 1.0


def virtual_ring(q, k, v, n: int):
    """``ring_attention`` for n virtual seq ranks in one process,
    differentiable: q, k, v are the whole sequence's (B, S, H, D), equal
    heads, rank i's the i-th chunk of S; the forward is
    ``ring_emulate_fwd`` (each rank's blocks through ``attend_block``,
    merged by lse), the backward ``ring_emulate_bwd`` (each block's
    ``block_backward`` from its rank's merged lse and Delta)."""
    import torch

    class Ring(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            o, lse = ring_emulate_fwd(q, k, v, n, True)
            ctx.save_for_backward(q, k, v, o, lse)
            return o

        @staticmethod
        def backward(ctx, do):
            q, k, v, o, lse = ctx.saved_tensors
            g = ring_emulate_bwd(q, k, v, do.contiguous(), o, lse, n, True)
            return g["dq"], g["dk"], g["dv"]

    return Ring.apply(q, k, v)


def seq_block_on_ranks(block, x, n: int):
    """The dense ``block`` on n virtual seq ranks: rank i's chunk of each
    row through the norm and ``Attention.project`` at its tokens' global
    positions (what ``Transformer.forward`` gives a seq rank), K and V
    repeated to the query heads, the ring over every rank's q, k, v
    (``virtual_ring``), then each rank's output projection, residual and
    MLP. Returns the whole sequence's output."""
    import torch

    from ray_tpu_torch.ops.attention import _repeat_kv

    B, S, _ = x.shape
    L = S // n
    qkv, chunks = [], []
    for i in range(n):
        xi = x[:, i * L:(i + 1) * L]
        pos = torch.arange(i * L, (i + 1) * L, device=x.device)
        q, k, v = block.attn.project(block.attn_norm(xi),
                                     pos[None].expand(B, L))
        heads = q.shape[2]
        qkv.append((q, _repeat_kv(k, heads), _repeat_kv(v, heads)))
        chunks.append(xi)
    o = virtual_ring(*(torch.cat(t, 1) for t in zip(*qkv)), n)
    outs = []
    for i, xi in enumerate(chunks):
        h = xi + block.attn.o_proj(o[:, i * L:(i + 1) * L])
        outs.append(h + block.mlp(block.mlp_norm(h)))
    return torch.cat(outs, 1)


def seq_merge_ratio(block, x, n: int) -> float:
    """The forward merge's ||sum_j w_j |o_j| || / ||o|| on every rank, with
    the block's own q, k, v (no launches counted: call it outside a counted
    run)."""
    import torch

    from ray_tpu_torch.ops.attention import _repeat_kv
    from ray_tpu_torch.ops.ring_attention import attend_block, merge_blocks

    with torch.no_grad():
        B, S, _ = x.shape
        L = S // n
        pos = torch.arange(S, device=x.device)[None].expand(B, S)
        q, k, v = block.attn.project(block.attn_norm(x), pos)
        k, v = (_repeat_kv(t, q.shape[2]) for t in (k, v))
        num = den = 0.0
        for i in range(n):
            qi = q[:, i * L:(i + 1) * L]
            o = a = lse = None
            for j in ring_blocks(i, n, True):
                kj, vj = k[:, j * L:(j + 1) * L], v[:, j * L:(j + 1) * L]
                o_b, lse_b = attend_block(qi, kj, vj, j == i)
                if o is None:
                    o, a, lse = o_b.float(), o_b.float().abs(), lse_b
                else:
                    a, _ = merge_blocks(a, lse, o_b.abs(), lse_b)
                    o, lse = merge_blocks(o, lse, o_b, lse_b)
            num += a.pow(2).sum().item()
            den += o.pow(2).sum().item()
    return math.sqrt(num / den)


def phase_seq_parallel(card: str):
    """The seq axis's per-rank math at full width (SEQ_RANKS), for virtual
    ranks in one process on the card: the 1b's block on n seq ranks
    (``seq_block_on_ranks``: global RoPE positions, K/V repeated, the
    ring's blocks through the flash kernels, forward and backward), its
    launches counted over those runs alone (n(n + 1) / 2 forward and
    ``flash_bwd`` launches and n preps), held against the whole block with
    plain attention (the bound above SEQ_OTHER_ROUNDINGS). At each block
    shape, diagonal (causal) and off-diagonal (full), the kernels against
    their plain versions (TOL, BWD_TOL, DELTA_TOL), then their times beside
    the library's attention. Returns the path's launches and each kernel's
    entries by shape."""
    import torch

    from ray_tpu_torch.models import CONFIGS
    from ray_tpu_torch.models.transformer import Block

    cfg = CONFIGS[TRAIN_CONFIG]
    B, S = TRAIN_BATCH, TRAIN_SEQ
    launches = dict.fromkeys(kernel_launches(), 0)
    report = {"card": card, "blocks": {}}
    times = {"flash_fwd": {}, "flash_bwd": {}, "flash_bwd_prep": {},
             "flash_bwd_delta": {}}
    block = tp_block(cfg, seed=12)
    gen = torch.Generator(device="cuda").manual_seed(13)
    x, dout = (torch.randn(B, S, cfg.d_model, generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(2))
    x.requires_grad_()
    names = ["x"] + [k for k, _ in block.named_parameters()]
    runs = {}
    for n in SEQ_RANKS:
        kernel_launches(reset=True)
        out = seq_block_on_ranks(block, x, n)
        grads = torch.autograd.grad(out, [x] + list(block.parameters()),
                                    dout)
        torch.cuda.synchronize()
        got = kernel_launches()
        pairs = n * (n + 1) // 2
        want = {"flash_attention_fwd": pairs, "attention_bwd_prep": n,
                "flash_attention_bwd": pairs, "flash_attention_bwd_dq": 0,
                "flash_attention_bwd_dkv": 0,
                "flash_bwd_delta": 0}
        if got != want:
            raise AssertionError(f"seq parallel at {n} ranks launched {got}, "
                                 f"want {want}")
        launches = {k: launches[k] + m for k, m in got.items()}
        runs[n] = (out.detach(), dict(zip(names, grads)),
                   seq_merge_ratio(block, x, n))
    plain = Block(dataclasses.replace(cfg, attention_impl="xla"),
                  device="cuda")
    plain.load_state_dict(block.state_dict())
    del block
    pos = torch.arange(S, device="cuda")[None].expand(B, S)
    ref = plain(x, pos)[0]
    want = dict(zip(names, torch.autograd.grad(
        ref, [x] + list(plain.parameters()), dout)))
    ref = ref.detach()
    for n, (out, grads, rho) in runs.items():
        rho = max(rho, math.sqrt(n))
        tol = (4 * n * rho + SEQ_OTHER_ROUNDINGS) * 2.0 ** -8
        errs = {"out": ((out.float() - ref.float()).norm()
                        / ref.float().norm()).item()}
        errs.update(leaf_rel_errors(names, [grads[k] for k in names],
                                    [want[k] for k in names]))
        worst = max(errs, key=errs.get)
        report["blocks"][f"n={n}"] = {"shape": [B, S], "block": [B, S // n],
                                      "rho": rho, "tol": tol, "errors": errs}
        log(f"check seq parallel {TRAIN_CONFIG} block {B} x {S} at {n} ranks "
            f"(ring blocks {B} x {S // n}): relative errors {errs}, largest "
            f"{worst} {errs[worst]:.3e} [tol (4 n rho + "
            f"{SEQ_OTHER_ROUNDINGS}) 2^-8 = {tol:.3e}, rho {rho:.3f}]")
        if not errs[worst] <= tol:
            raise AssertionError(f"seq parallel at {n} ranks: {worst} parts "
                                 f"by {errs[worst]:.3e} > {tol:.3e}")
    del runs, ref, want, plain, x, dout
    torch.cuda.empty_cache()
    for n in SEQ_RANKS:
        for causal in (True, False):
            kind = "diagonal" if causal else "off-diagonal"
            entry = time_rank_attention(
                B, cfg.n_heads, cfg.n_heads, cfg.head_dim, S // n,
                TIME_ROUNDS, card, f"{TRAIN_CONFIG} n={n} {kind}", causal,
                "seq parallel")
            for kernel, e in entry.items():
                times[kernel][f"{TRAIN_CONFIG} n={n} {kind}"] = e
    log("seq parallel metrics: " + json.dumps({**report, "times": times}))
    return launches, times


def phase_expert_parallel(card: str) -> dict:
    """moe-1b's MoE layer at full width on virtual ranks (EP_CASES), fp32,
    on the card: ``MoEMLP.forward_ranks`` over ``VirtualRanks`` (each
    rank's experts, the routing exchange, the global statistics and the
    expert collectives in one process) against the whole layer (the bounds
    above EP_CASES). Returns the report."""
    import functools

    import torch

    from ray_tpu_torch.models import CONFIGS
    from ray_tpu_torch.models.transformer import MoEMLP
    from ray_tpu_torch.parallel.expert_parallel import VirtualRanks

    cfg = dataclasses.replace(CONFIGS[MOE_CONFIG], dtype=torch.float32)
    layer = MoEMLP(cfg, device="cuda", seed=14)
    gen = torch.Generator(device="cuda").manual_seed(15)
    x, dout = (torch.randn(TRAIN_BATCH, TRAIN_SEQ, cfg.d_model,
                           generator=gen, device="cuda") for _ in range(2))
    K = cfg.experts_per_token
    g = layer.group_size(TRAIN_BATCH * TRAIN_SEQ)
    own = layer.route(x.reshape(-1, g, cfg.d_model)).expert
    names = [k for k, _ in layer.named_parameters()]
    report = {"card": card, "config": MOE_CONFIG, "tokens": [TRAIN_BATCH,
              TRAIN_SEQ], "group": g, "cases": {}}
    for shape in EP_CASES:
        axes = VirtualRanks(*shape)
        got = axes.layer_grads(layer, x, dout, EP_AUX_COEF)
        experts = got["experts"]
        # the whole layer, replaying the ranks' choices
        layer.route = functools.partial(MoEMLP.route, layer,
                                        expert=experts.reshape(-1, g, K))
        xw = x.clone().requires_grad_()
        out, aux = layer(xw)
        want = dict(zip(["x"] + names, torch.autograd.grad(
            (out * dout).sum() + EP_AUX_COEF * aux,
            [xw] + list(layer.parameters()))))
        del layer.route
        flipped = (experts.reshape(own.shape).sort(-1).values
                   != own.sort(-1).values).any(-1).float().mean().item()
        errs = {"out": max((o - axes.local(i, out)).abs().max().item()
                           for i, o in enumerate(got["out"]))
                / out.abs().max().item(),
                "aux": max(abs(a.item() - aux.item()) for a in got["aux"])
                / aux.item(),
                "x": max((d - axes.local(i, want["x"])).abs().max().item()
                         for i, d in enumerate(got["dx"]))
                / want["x"].abs().max().item()}
        for (_, e, name), dw in got["dw"].items():
            w = want[name]
            if name != "router.kernel":
                w = w.chunk(shape[3], 0)[e]
            errs[name] = max(errs.get(name, 0.0), (dw - w).abs().max()
                             .item() / w.abs().max().item())
        worst = max((k for k in errs if k != "aux"), key=errs.get)
        case = f"rows={shape[0]} experts={shape[3]}"
        report["cases"][case] = {"routed_otherwise_share": flipped,
                                 "rel_errors": errs}
        log(f"check expert parallel {MOE_CONFIG} layer {TRAIN_BATCH} x "
            f"{TRAIN_SEQ} on {case}: routed otherwise {flipped:.2e}, "
            f"relative errors {errs} [tol {MOE_LAYER_TOL}, aux "
            f"{MOE_AUX_RTOL}, routing {MOE_ROUTE_TOL}] [{card}]")
        if not flipped <= MOE_ROUTE_TOL:
            raise AssertionError(f"expert parallel {case}: {flipped} of the "
                                 "tokens routed otherwise")
        if not errs[worst] <= MOE_LAYER_TOL or not errs["aux"] <= \
                MOE_AUX_RTOL:
            raise AssertionError(f"expert parallel {case}: {errs}")
        del got, want, out
        torch.cuda.empty_cache()
    log("expert parallel metrics: " + json.dumps(report))
    return report


# The traced training phase. Tolerances, each derived where it is used:
# traced against untraced on one device, the same kernels in the same
# order, each the same from run to run (flash_bwd adds dQ's key-tile shares
# in a fixed order): equal. The bound holds runs that a reordered fp32 sum
# parts (2^-24 of a partial sum an addition), which moves a gradient by
# about 1e-6 of its size. Adam's early
# steps move a parameter by about lr whatever its gradient's size, so where
# a gradient is near 0 that noise can flip its step's sign (2 lr apart);
# the loss moves by those parameters' |g| x 2 lr, small because their |g|
# is: over MESH_STEPS steps, well under 1e-4 of the loss. The first step's
# loss precedes any update: equal.
TRACED_LOSS_RTOL = 1e-4
# ShardedBucketOptimizer at world 1 (AdamW without its clip, the global clip
# folded from per-leaf sums) against make_optimizer's AdamW on the same
# parameters and gradients: one Adam step from zero moments is
# lr (c g / (|c g| + eps) + wd p) on both sides, with clip factors c that
# part only by the squares' summation order (within 2^-20 of each other),
# which moves the step by far less than 2^-10 of lr; the parameter's
# subtraction rounds within 2^-23 of it.
SBO_TOL = (2.0 ** -10, 2.0 ** -22)  # (x lr, x |p|)
SBO_LR = 1e-4  # the phase's learning rate, from its first step (warmup 0)
TRACED_RANKS = (2, 4)  # virtual data ranks of the sharded tier's math
TRACED_WIRES = {"fp32": {}, "bf16_wire": {"grad_dtype": "bf16"},
                "int8": {"codec": "int8"}, "fp8": {"codec": "fp8"}}


class VirtualAxis:
    """``n`` ranks of a data axis in one process, for the sharded tier's
    per-bucket math: ``rank(r)`` is rank r's group, whose ``allreduce``,
    ``reducescatter`` and ``alltoall`` with ``async_op=True`` post its
    tensor and return a wait; a wait gives the collective's result for its
    rank once every rank has posted that call (so every rank starts its
    calls before any waits), summing in rank order. ``reset()`` drops what
    was posted."""

    def __init__(self, n: int):
        self.n = n
        self.posts = [[] for _ in range(n)]

    def reset(self) -> None:
        self.posts = [[] for _ in range(self.n)]

    def rank(self, r: int):
        axis = self

        class Rank:
            world_size = axis.n

            def _post(self, x, combine):
                seq = len(axis.posts[r])
                axis.posts[r].append(x)
                return lambda: combine([axis.posts[q][seq]
                                        for q in range(axis.n)])

            def allreduce(self, x, async_op=False):
                wait = self._post(x, _fold_ranks)
                return wait if async_op else wait()

            def reducescatter(self, x, async_op=False):
                wait = self._post(x, lambda xs: _fold_ranks(
                    [t.chunk(axis.n, 0)[r] for t in xs]))
                return wait if async_op else wait()

            def alltoall(self, x, async_op=False):
                import torch

                wait = self._post(x, lambda xs: torch.cat(
                    [t.chunk(axis.n, 0)[r] for t in xs]))
                return wait if async_op else wait()

        return Rank()


def _fold_ranks(xs):
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x
    return acc


def phase_traced_training(card: str):
    """The traced step and the bucketed collectives at the 1b's full width
    and depth, on one card:

    - the 1b at TRAIN_BATCH x TRAIN_SEQ for MESH_STEPS untraced steps, then
      MESH_STEPS traced steps (``util.tracing`` on: the phase-split step
      under ``train.step`` > ``train.fwd_bwd``, ``train.optimizer``) from
      the same parameters, their launches counted (the ``traced_training``
      path); losses within TRACED_LOSS_RTOL (the first equal), the span
      tree, each phase's span beside a profiled traced step's device ms,
      the ``ray_tpu.train.*`` histograms and the goodput ledger's shares;
    - the explicit tier over NCCL at world 1 on the 1b's gradients
      (``explicit_tier``);
    - the sharded tier's per-bucket math on TRACED_RANKS virtual data ranks
      (``virtual_sharded``).

    Returns the path's launches."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import CONFIGS
    from ray_tpu_torch.parallel import TrainStepBundle, make_optimizer
    from ray_tpu_torch.util import goodput, metrics, tracing

    cfg = CONFIGS[TRAIN_CONFIG]
    t0 = time.perf_counter()
    # warmup 0: the first step already moves the parameters
    bundle = TrainStepBundle(cfg, device="cuda", optimizer=make_optimizer(
        learning_rate=SBO_LR, warmup_steps=0))
    params, opt_state = bundle.init(seed=0)
    batch = bundle.make_batch(np.random.default_rng(0), TRAIN_BATCH,
                              TRAIN_SEQ)
    init = {k: p.detach().clone() for k, p in params.items()}
    _, ref_grads = bundle.gradients(params, batch)
    tracing.disable()
    untraced, untraced_s, after_one = [], [], None
    for step in range(MESH_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = bundle.step(params, opt_state, batch)[2]
        torch.cuda.synchronize()
        untraced_s.append(time.perf_counter() - t)
        untraced.append(loss.item())
        if step == 0:
            after_one = {k: p.detach().clone() for k, p in params.items()}
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(init[k])
    opt_state = bundle.optimizer.init(params)
    tracing.enable()
    tracing.clear()
    goodput.reset()
    goodput.set_job("traced training")
    try:
        launches, run = run_steps(
            lambda: {"loss": bundle.step(params, opt_state, batch)[2]},
            MESH_STEPS, {
                "flash_attention_fwd": (2 if cfg.remat else 1)
                * cfg.n_layers,
                "attention_bwd_prep": cfg.n_layers,
                "flash_attention_bwd": cfg.n_layers,
                "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
                "flash_bwd_delta": 0},
            "traced training")
        ledger = goodput.snapshot()
        spans = tracing.get_spans()
        parts = profile_step(bundle, params, opt_state, batch,
                             "traced training")
    finally:
        tracing.disable()
    traced = run["loss"]
    report = {"card": card, "config": TRAIN_CONFIG, "batch": TRAIN_BATCH,
              "seq": TRAIN_SEQ, "losses_untraced": untraced,
              "losses_traced": traced,
              "step_s_untraced": untraced_s, "step_s_traced": run["step_s"],
              "bundle_up_s": time.perf_counter() - t0}
    if traced[0] != untraced[0] or not all(
            abs(a - b) <= TRACED_LOSS_RTOL * abs(b)
            for a, b in zip(traced, untraced)):
        raise AssertionError(f"traced losses {traced} part from the "
                             f"untraced {untraced}")
    report["spans"] = check_step_spans(spans, MESH_STEPS)
    report["device_ms_by_part"] = {k: parts[k] for k in (
        "total", "optimizer", "host_ms_profiled", "kernels_launched")}
    # what the spans bound beside what the profiler books on the device:
    # fwd_bwd holds every kernel but the optimizer's foreach ops
    report["device_ms_fwd_bwd"] = parts["total"] - parts["optimizer"]
    scraped = metrics.scrape_metrics()
    report["histograms"] = {name: scraped[name]["data"] for name in (
        "ray_tpu.train.step_seconds", "ray_tpu.train.fwd_bwd_seconds",
        "ray_tpu.train.optimizer_seconds")}
    report["goodput"] = {
        "wall_s": ledger["wall_s"], "counters": ledger["counters"],
        "shares": {b: v / ledger["wall_s"] for b, v in
                   ledger["buckets"].items() if v}}
    log(f"traced training: losses {traced} against untraced {untraced}; "
        f"spans {report['spans']}; device ms {report['device_ms_by_part']} "
        f"[{card}]")
    del opt_state
    torch.cuda.empty_cache()
    report["explicit"] = explicit_tier(card, init, ref_grads)
    report["virtual"] = virtual_sharded(card, bundle, init, batch, ref_grads,
                                        after_one, untraced[0])
    log("traced training metrics: " + json.dumps(report))
    del bundle, params, init, ref_grads, after_one
    torch.cuda.empty_cache()
    return launches


def check_step_spans(spans, steps: int) -> dict:
    """``steps`` phase-split span trees: each ``train.step`` the parent of
    one ``train.fwd_bwd`` then one ``train.optimizer``, inside it. Returns
    each phase's span ms by step."""
    by_id = {s["span_id"]: s for s in spans}
    roots = [s for s in spans if s["name"] == "train.step"]
    if len(roots) != steps or len(spans) != 3 * steps:
        raise AssertionError(f"{len(spans)} spans, {len(roots)} steps: "
                             f"{[s['name'] for s in spans]}")
    out = {"step": [], "fwd_bwd": [], "optimizer": []}
    for root in roots:
        kids = sorted((s for s in spans if s.get("parent_id")
                       == root["span_id"]), key=lambda s: s["ts"])
        if [k["name"] for k in kids] != ["train.fwd_bwd",
                                         "train.optimizer"]:
            raise AssertionError(f"step children {kids}")
        end = root["ts"] + root["dur"]
        if not all(root["ts"] <= k["ts"] and k["ts"] + k["dur"] <= end
                   for k in kids):
            raise AssertionError("a phase span outside its step's")
        out["step"].append(root["dur"] * 1e3)
        out["fwd_bwd"].append(kids[0]["dur"] * 1e3)
        out["optimizer"].append(kids[1]["dur"] * 1e3)
    if any(s["parent_id"] is not None and s["parent_id"] not in by_id
           for s in spans):
        raise AssertionError("a span's parent is missing")
    return out


def _codec_bound(name: str, x):
    """How far the quantized allreduce of ``x`` at world 1 may land from it:
    two roundings, the contribution's and the sum's (the sum's blocks have
    the same amax to fp32's rounding, so the same scale): int8 half a step
    each, scale = amax / 127 of the block of 256; fp8 e4m3 2^-4 of the
    value or half a subnormal step (2^-10 of amax / 448) each; bf16 2^-8 of
    the value once (the second rounding is exact). Plus fp32's roundings of
    the decoded products."""
    import torch

    if name == "bf16":
        return 2.0 ** -8 * x.abs() * (1 + 2.0 ** -20)
    n = x.numel()
    nb = -(-n // 256)
    amax = torch.nn.functional.pad(x.abs(), (0, nb * 256 - n)) \
        .reshape(nb, 256).amax(dim=1)
    scale = (amax / (127.0 if name == "int8" else 448.0)) \
        .repeat_interleave(256)[:n]
    bound = (scale if name == "int8" else
             2 * torch.maximum(2.0 ** -4 * x.abs(), 2.0 ** -10 * scale))
    return bound * (1 + 2.0 ** -10) + 2.0 ** -22 * x.abs()


def explicit_tier(card: str, init, grads) -> dict:
    """``collective.bucketed`` over NCCL at world 1 on the 1b's gradients
    (``init_sharded_optimizer_groups``, a TCP store on 127.0.0.1):
    ``AsyncBucketReducer.reduce_tree`` in 32 MiB buckets with each codec,
    fp32 equal to the gradients and the codecs within ``_codec_bound`` on
    each bucket's packed vector, with wire bytes, the reduce's wall time
    and the encode's rate; ``ShardedBucketOptimizer`` (AdamW without its
    clip, the global clip at 1.0) against make_optimizer's AdamW on the
    same parameters and gradients within SBO_TOL."""
    import socket

    import torch

    from ray_tpu_torch import collective as col
    from ray_tpu_torch.collective.bucketed import (AsyncBucketReducer,
                                                   ShardedBucketOptimizer,
                                                   init_sharded_optimizer_groups,
                                                   leaf_meta, plan_buckets)
    from ray_tpu_torch.parallel import make_optimizer

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    base = init_sharded_optimizer_groups(
        1, 0, device="cuda", init_method=f"tcp://127.0.0.1:{port}")
    out = {}
    try:
        plan = plan_buckets(leaf_meta(grads), world_size=1)
        out["plan"] = plan.stats()
        values = sum(g.numel() for g in grads.values())
        for comp in (None, "int8", "fp8", "bf16"):
            red = AsyncBucketReducer(base, plan, compression=comp)
            try:
                torch.cuda.synchronize()
                t = time.perf_counter()
                got = red.reduce_tree(grads)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
                stats = red.wire_stats()
            finally:
                red.shutdown()
            worst = 0.0
            for b in plan.buckets:
                x = torch.cat([grads[p].reshape(-1) for p in b.paths])
                y = torch.cat([got[p].reshape(-1) for p in b.paths])
                if comp is None:
                    if not torch.equal(x, y):
                        raise AssertionError(f"bucket {b.index}: the fp32 "
                                             "reduce at world 1 moved it")
                    continue
                ratio = ((y - x).abs() / _codec_bound(comp, x)
                         .clamp_min(1e-30)).max().item()
                worst = max(worst, ratio)
            if worst > 1.0:
                raise AssertionError(f"{comp}: beyond the codec's rounding "
                                     f"({worst:.3f} of the bound)")
            entry = {"reduce_s": wall, "values": values,
                     "max_err_over_bound": worst, **stats}
            if comp is not None:
                # encode_s: the error-fed encode (fp32 in, the wire out) and
                # the sum's decode (the wire in, fp32 out)
                entry["encode_decode_gb_s"] = (
                    (8 * values + stats["bytes_wire"])
                    / stats["encode_s"] / 1e9)
            out[str(comp)] = entry
            del got
        opt = ShardedBucketOptimizer(base, plan, 0, make_optimizer(
            learning_rate=SBO_LR, warmup_steps=0, clip=None), init,
            clip_global_norm=1.0)
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            new, stats = opt.step(grads)
            torch.cuda.synchronize()
            stats["step_s"] = time.perf_counter() - t
        finally:
            opt.shutdown()
        ref = {k: p.clone() for k, p in init.items()}
        adamw = make_optimizer(learning_rate=SBO_LR, warmup_steps=0)
        adamw.update(ref, [grads[k].clone() for k in ref], adamw.init(ref))
        atol, rtol = SBO_TOL
        worst = max(((new[k] - w).abs() / (atol * SBO_LR + rtol * w.abs()))
                    .max().item() for k, w in ref.items())
        del ref
        if worst > 1.0:
            raise AssertionError(f"ShardedBucketOptimizer parts from the "
                                 f"step by {worst:.3f} of SBO_TOL")
        out["sharded_optimizer"] = {"max_err_over_bound": worst, **stats}
        del new, opt
    finally:
        col.destroy_collective_group(f"{base}.norm")
        col.destroy_collective_group(base)
    torch.cuda.empty_cache()
    log(f"traced training: explicit tier at world 1 over NCCL: "
        f"{json.dumps(out)} [{card}]")
    return out


def _wire_norm_bound(name: str, local, layout, n: int) -> float:
    """||B|| of the per-element bound on one leaf's reduced gradient from
    ``n`` virtual ranks' ``local`` gradients, against their exact fp32 sum
    over n: each rank's part rounds once on the wire (int8 half a step of
    amax / 127 of its block of 256; fp8 2^-4 of the value or 2^-10 of amax
    / 448; bf16 2^-8 of the value), and the bf16 wire's sums round n - 1
    times within 2^-8 of a partial sum at most sum |x_r|."""
    import torch

    if name == "fp32":
        return 0.0
    d, _ = layout
    xs = torch.stack([x.movedim(d, 0).reshape(n, -1) for x in local])
    ax = xs.abs()
    if name == "bf16_wire":
        bound = (2.0 ** -8 + (n - 1) * 2.0 ** -8) * ax.sum(dim=0)
        return (bound / n).norm().item()
    m = xs.shape[-1]
    nb = -(-m // 256)
    amax = torch.nn.functional.pad(ax, (0, nb * 256 - m)).reshape(
        n, n, nb, 256).amax(dim=-1)
    scale = (amax / (127.0 if name == "int8" else 448.0)) \
        .repeat_interleave(256, dim=-1)[..., :m]
    step = (0.5 * scale if name == "int8" else
            torch.maximum(2.0 ** -4 * ax, 2.0 ** -10 * scale))
    return (step.sum(dim=0) / n).norm().item()


def virtual_sharded(card: str, bundle, init, batch, ref_grads, after_one,
                    loss0: float) -> dict:
    """The traced sharded step's math for n = TRACED_RANKS virtual data
    ranks in one process, through the functions the process-group path
    calls: each rank's ``rank_backward`` on its rows of the batch (its
    loss, its count and its gradients weighted by m_local n / m_global),
    then bucket by bucket of ``plan_buckets`` at world n every rank's
    ``start_leaf_reduce`` on a ``VirtualAxis`` rank (each bucket's
    reduce-scatters as list operations), the waits, and the sharded update:
    the parts laid side by side, AdamW with the pinned clip over the
    update's layout (the same sums in the same order as the ranks'
    gathered norm). For each wire (TRACED_WIRES), against the single-device
    step from the same parameters: the count-weighted loss within
    TRAIN_LOSS_TOL, each leaf's reduced gradient within TRAIN_GRAD_TOL of
    its norm plus the wire's ``_wire_norm_bound``, and the parameters after
    the update within Adam's bound 2 x 1.2 x lr."""
    import torch

    from ray_tpu_torch.collective.bucketed import leaf_meta, plan_buckets
    from ray_tpu_torch.collective.quant import resolve_codec
    from ray_tpu_torch.parallel import make_optimizer
    from ray_tpu_torch.parallel.train import start_leaf_reduce

    params = bundle._bind(init)
    lr = SBO_LR
    keys = list(params)
    out = {}
    for n in TRACED_RANKS:
        rows = TRAIN_BATCH // n
        local = [{k: x[r * rows:(r + 1) * rows] for k, x in batch.items()}
                 for r in range(n)]
        m_global = sum(loc["mask"].sum() for loc in local)
        t = time.perf_counter()
        ranks = [bundle.rank_backward(params, loc, m_global, n)
                 for loc in local]
        torch.cuda.synchronize()
        backward_s = time.perf_counter() - t
        losses = torch.stack([r[0] for r in ranks])
        counts = torch.stack([r[1] for r in ranks])
        loss = ((losses * counts).sum() / counts.sum().clamp(min=1.0)).item()
        if not abs(loss - loss0) <= TRAIN_LOSS_TOL:
            raise AssertionError(f"{n} ranks: loss {loss} against {loss0}")
        plan = plan_buckets(leaf_meta(params), world_size=n)

        def layout(shape):
            return next(((d, n) for d, s in enumerate(shape) if s % n == 0),
                        None)

        entry = {"loss": loss, "backward_s": backward_s,
                 "buckets": plan.num_buckets}
        for wire, kw in TRACED_WIRES.items():
            axis = VirtualAxis(n)
            codec = resolve_codec(kw.get("codec"))
            grad_dtype = kw.get("grad_dtype", "fp32")
            reduced = {}
            torch.cuda.synchronize()
            t = time.perf_counter()
            for bucket in plan.buckets:
                waits = [[start_leaf_reduce(axis.rank(r), ranks[r][2][k],
                                            layout(tuple(params[k].shape)),
                                            codec, grad_dtype)
                          for k in bucket.paths] for r in range(n)]
                parts = [[wait() for wait in row] for row in waits]
                for j, k in enumerate(bucket.paths):
                    lay = layout(tuple(params[k].shape))
                    reduced[k] = (parts[0][j] if lay is None else torch.cat(
                        [parts[r][j] for r in range(n)], lay[0]))
                axis.reset()
            torch.cuda.synchronize()
            reduce_s = time.perf_counter() - t
            worst = 0.0
            for k in keys:
                lay = layout(tuple(params[k].shape))
                bound = (TRAIN_GRAD_TOL * ref_grads[k].norm().item()
                         + (0.0 if lay is None else _wire_norm_bound(
                             wire, [r[2][k] for r in ranks], lay, n)))
                err = (reduced[k] - ref_grads[k]).norm().item()
                worst = max(worst, err / bound)
            if worst > 1.0:
                raise AssertionError(f"{n} ranks, {wire}: a reduced "
                                     f"gradient beyond its bound ({worst})")
            opt = make_optimizer(learning_rate=lr, warmup_steps=0,
                                 clip_spec_fn=layout)
            new = {k: init[k].clone() for k in keys}
            opt.update(new, [reduced[k] for k in keys], opt.init(new))
            param_err = max((new[k] - after_one[k]).abs().max().item()
                            for k in keys)
            if param_err > 2 * 1.2 * lr:
                raise AssertionError(f"{n} ranks, {wire}: parameters part "
                                     f"by {param_err}")
            entry[wire] = {"grad_err_over_bound": worst,
                           "param_max_err": param_err, "reduce_s": reduce_s}
            del reduced, new
        out[str(n)] = entry
        del ranks, local
        torch.cuda.empty_cache()
    log(f"traced training: sharded tier on virtual ranks: {json.dumps(out)} "
        f"[{card}]")
    return out


# -- checkpointed training (phase 14) ---------------------------------------

# The token corpus of the checkpointed run: 2^26 uint16 tokens (128 MB)
# drawn from seed 0 below the 1b's vocabulary; batches of TRAIN_BATCH x
# TRAIN_SEQ from the native loader (seed 0), whose first CKPT_LOADER_CHECK
# batches must equal the numpy route's.
CKPT_CORPUS_TOKENS = 1 << 26
CKPT_LOADER_CHECK = 8
CKPT_STEPS, CKPT_SAVE_AT = 6, 3  # steps of each run; the save after step 3
# Run B (a save in flight) and the resumed steps against run A: the same
# steps on the same batches from the same weights, which part at most by
# a reordered fp32 sum (TRACED_LOSS_RTOL's reasoning, over CKPT_STEPS
# steps); the first loss precedes any update: equal.
CKPT_LOSS_RTOL = TRACED_LOSS_RTOL


def phase_checkpointed_training(card: str):
    """The 1b at full width and depth trained from a token file with an
    asynchronous checkpoint, then resumed from it:

    1. a corpus of CKPT_CORPUS_TOKENS uint16 tokens from seed 0 in a
       temporary directory (raises unless its disk holds the corpus and
       the checkpoint);
    2. the native ``TokenFileLoader`` (seed 0): its first CKPT_LOADER_CHECK
       batches equal the numpy route's;
    3. run A: a fresh bundle (``init(seed=0)``) takes CKPT_STEPS steps on
       the loader's batches 1-6;
    4. run B: the same, with ``CheckpointSaver.save({"params", "opt"})``
       after step CKPT_SAVE_AT: the pause, the host copy's GB/s, the steps
       taken while the save is in flight, then ``wait()``'s commit
       seconds, bytes written and the manifest's stats; B's losses equal
       A's (the first exactly, the rest within CKPT_LOSS_RTOL);
    5. ``restore_tree`` into a fresh bundle on the card: every tensor equal
       to run B's state at the save (a copy on the card) bit for bit, the
       count equal to CKPT_SAVE_AT; steps 4-6 on a fresh loader after 3
       batches drawn and dropped: the first loss equal to run B's step 4,
       the rest within CKPT_LOSS_RTOL of run B's, and all within
       CKPT_LOSS_RTOL of run A's.

    Every step of the three runs is on the ``checkpointed_training`` path.
    Prints a ``checkpoint metrics:`` line and returns the path's
    launches."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from ray_tpu_torch import ckpt
    from ray_tpu_torch.data import (TokenFileLoader, to_device,
                                    write_token_file)
    from ray_tpu_torch.models import CONFIGS
    from ray_tpu_torch.parallel import TrainStepBundle, make_optimizer

    cfg = CONFIGS[TRAIN_CONFIG]
    dev = torch.device("cuda")
    n_params = cfg.num_params()
    state_bytes = 3 * 4 * n_params  # fp32 params and Adam's two moments
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    free = shutil.disk_usage(root).free
    need = int(1.05 * (2 * CKPT_CORPUS_TOKENS + state_bytes))
    log(f"checkpointed training: {root} has {free} bytes free, the phase "
        f"needs {need}")
    report = {"card": card, "config": TRAIN_CONFIG, "batch": TRAIN_BATCH,
              "seq": TRAIN_SEQ, "params": n_params,
              "state_bytes": state_bytes, "disk_free_bytes": free}
    try:
        if free < need:
            raise RuntimeError(f"{root}: {free} bytes free, the corpus and "
                               f"the checkpoint need {need}")
        t = time.perf_counter()
        corpus = os.path.join(root, "corpus.bin")
        write_token_file(corpus, np.random.default_rng(0).integers(
            0, cfg.vocab_size, CKPT_CORPUS_TOKENS, dtype=np.uint16),
            token_bytes=2)
        report["corpus_write_s"] = time.perf_counter() - t

        def loader(**kw):
            return TokenFileLoader(corpus, TRAIN_BATCH, TRAIN_SEQ, seed=0,
                                   token_bytes=2, **kw)

        with loader() as native:
            if not native.native:
                raise AssertionError("the token loader is not native")
            ref = loader(force_python=True)
            for k in range(CKPT_LOADER_CHECK):
                got, want = native.next_batch(), ref.next_batch()
                for key in got:
                    if not np.array_equal(got[key], want[key]):
                        raise AssertionError(f"native batch {k} {key} "
                                             "differs from the numpy route")
        log(f"checkpointed training: the native loader's first "
            f"{CKPT_LOADER_CHECK} batches equal the numpy route's")

        def fresh_bundle():
            return TrainStepBundle(cfg, device="cuda",
                                   optimizer=make_optimizer(
                                       learning_rate=SBO_LR, warmup_steps=0))

        def steps(bundle, params, opt_state, batches, n, saver=None):
            losses, times, in_flight = [], [], []
            for _ in range(n):
                batch = to_device(batches.next_batch(), dev)
                torch.cuda.synchronize()
                t = time.perf_counter()
                params, opt_state, loss = bundle.step(params, opt_state,
                                                      batch)
                losses.append(loss.item())
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
                if saver is not None:
                    in_flight.append(saver.in_flight())
            return params, opt_state, losses, times, in_flight

        kernel_launches(reset=True)
        # run A, uninterrupted
        bundle = fresh_bundle()
        params, opt_state = bundle.init(seed=0)
        with loader() as batches:
            _, _, losses_a, times_a, _ = steps(bundle, params, opt_state,
                                               batches, CKPT_STEPS)
        del bundle, params, opt_state
        torch.cuda.empty_cache()
        # run B: a save after step CKPT_SAVE_AT, then the rest in its shadow
        store = ckpt.CheckpointStore(os.path.join(root, "ckpt"))
        saver = ckpt.CheckpointSaver(store)
        bundle = fresh_bundle()
        params, opt_state = bundle.init(seed=0)
        with loader() as batches:
            params, opt_state, losses_b, times_b, _ = steps(
                bundle, params, opt_state, batches, CKPT_SAVE_AT)
            at_save = {"params": {k: p.detach().clone()
                                  for k, p in params.items()},
                       "mu": {k: x.clone() for k, x in opt_state.mu.items()},
                       "nu": {k: x.clone() for k, x in opt_state.nu.items()}}
            torch.cuda.synchronize()
            t = time.perf_counter()
            saver.save({"params": params, "opt": opt_state},
                       step=CKPT_SAVE_AT)
            pause = time.perf_counter() - t
            returned_at = time.time()
            in_flight_at_return = saver.in_flight()
            params, opt_state, more, times_shadow, in_flight = steps(
                bundle, params, opt_state, batches,
                CKPT_STEPS - CKPT_SAVE_AT, saver)
        t = time.perf_counter()
        manifest = saver.wait()
        report["save"] = {
            "pause_s": pause, "host_copy_gb_s": state_bytes / pause / 1e9,
            "in_flight_at_return": in_flight_at_return,
            "in_flight_after_each_step": in_flight,
            "wait_s": time.perf_counter() - t,
            "commit_s": manifest.ts - returned_at,
            "bytes_written": manifest.stats["bytes_written"],
            "manifest_stats": manifest.stats,
            "leaves": len(manifest.leaves)}
        losses_b += more
        del bundle, params, opt_state
        torch.cuda.empty_cache()
        check_losses("run B", losses_b, losses_a)
        # restore into a fresh bundle, then resume on a fresh loader
        bundle = fresh_bundle()
        t = time.perf_counter()
        tree = ckpt.restore_tree(store)
        restore_s = time.perf_counter() - t
        t = time.perf_counter()
        state = ckpt.to_torch(tree, dev)
        torch.cuda.synchronize()
        h2d_s = time.perf_counter() - t
        del tree
        opt_state = state["opt"]
        if opt_state.count != CKPT_SAVE_AT:
            raise AssertionError(f"restored count {opt_state.count}")
        for name, want, got in (("params", at_save["params"],
                                 state["params"]),
                                ("mu", at_save["mu"], opt_state.mu),
                                ("nu", at_save["nu"], opt_state.nu)):
            unequal = [k for k in want if not torch.equal(got[k], want[k])]
            if set(got) != set(want) or unequal:
                raise AssertionError(f"restored {name} differ from the "
                                     f"state at the save: {unequal[:4]}")
        del at_save
        torch.cuda.empty_cache()
        report["restore"] = {"restore_s": restore_s, "h2d_s": h2d_s,
                             "read_gb_s": state_bytes / restore_s / 1e9,
                             "bit_equal": True}
        with loader() as batches:
            for _ in range(CKPT_SAVE_AT):
                batches.next_batch()
            _, _, losses_r, times_r, _ = steps(
                bundle, state["params"], opt_state, batches,
                CKPT_STEPS - CKPT_SAVE_AT)
        launches = kernel_launches()
        # against run B, which held the same state at the save: the first
        # resumed step is B's step 4 on the same state and batch through a
        # deterministic forward, so equal; the rest at most by a reordered
        # fp32 sum from step 4 on
        check_losses("resumed run", losses_r, losses_b[CKPT_SAVE_AT:],
                     ref="run B")
        check_losses("resumed run", losses_r, losses_a[CKPT_SAVE_AT:],
                     first_equal=False)
        n_steps = 2 * CKPT_STEPS + CKPT_STEPS - CKPT_SAVE_AT
        want = {"flash_attention_fwd": (2 if cfg.remat else 1)
                * cfg.n_layers * n_steps,
                "attention_bwd_prep": cfg.n_layers * n_steps,
                "flash_attention_bwd": cfg.n_layers * n_steps,
                "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
                "flash_bwd_delta": 0}
        if launches != want:
            raise AssertionError(f"checkpointed training launched "
                                 f"{launches}, want {want}")
        report.update({
            "losses_a": losses_a, "losses_b": losses_b,
            "losses_resumed": losses_r,
            # the largest relative distance of each comparison, beside
            # CKPT_LOSS_RTOL (``loss_rtol``)
            "loss_rtol": CKPT_LOSS_RTOL,
            "rel_b_vs_a": rel_distance(losses_b, losses_a),
            "rel_resumed_vs_a": rel_distance(losses_r,
                                             losses_a[CKPT_SAVE_AT:]),
            "rel_resumed_vs_b": rel_distance(losses_r,
                                             losses_b[CKPT_SAVE_AT:]),
            "step_s_a": times_a, "step_s_b_before_save": times_b,
            "step_s_save_in_flight": times_shadow,
            "step_s_resumed": times_r, "launches": launches})
        del bundle, state, opt_state
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"checkpointed training: pause {report['save']['pause_s']:.3f} s "
        f"({report['save']['host_copy_gb_s']:.2f} GB/s), commit "
        f"{report['save']['commit_s']:.2f} s, restore "
        f"{report['restore']['restore_s']:.2f} s + H2D "
        f"{report['restore']['h2d_s']:.2f} s; losses A {losses_a}, B "
        f"{losses_b}, resumed {losses_r} [{card}]")
    log("checkpoint metrics: " + json.dumps(report))
    return launches


RUNTIME_TENSOR_ELEMS = 128 << 20  # bf16: the 256 MiB a task returns
RUNTIME_PUT_ELEMS = 64 << 20  # fp32: the 256 MiB CPU tensor put and got
RUNTIME_ROUND_TRIPS = 200  # empty tasks and actor calls, one at a time
RUNTIME_PENDING_S = 5.0  # how long the second GPU actor must stay pending
RUNTIME_TIMEOUT_S = 300.0  # each cluster call's


def card_tensor(n: int, seed: int):
    """``n`` bf16 values on the card from ``seed``: what phase 15's task
    returns and the driver makes again to compare."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(n, generator=g, device="cuda").to(torch.bfloat16)


class RuntimeServer:
    """Phase 15's actor: the serving phase's 1b ``LLMServer`` (seed 0) in a
    worker process of the port's runtime, answering phase 9's requests as
    phase 9 does."""

    def __init__(self):
        import torch

        from ray_tpu_torch.llm import LLMConfig, LLMServer

        # the driver's settings (phase_device), so products round alike
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.server = LLMServer(LLMConfig(model_id="1b"), seed=0,
                                device="cuda")
        torch.cuda.synchronize()

    def ready(self) -> int:
        return os.getpid()

    def cards(self):
        """The cards the raylet bound this actor's lease to."""
        return os.environ.get("CUDA_VISIBLE_DEVICES")

    def serve(self, prompts) -> dict:
        """Phase 9's two rounds: 2 tokens each to warm up, then 32 tokens
        each with the launch counters set to 0 just before and read just
        after."""
        import torch

        server = self.server

        async def serve_all(max_tokens):
            return await asyncio.gather(*(
                server.completions(p, max_tokens=max_tokens)
                for p in prompts))

        asyncio.run(serve_all(2))
        torch.cuda.synchronize()
        kernel_launches(reset=True)
        server.engine.metrics = dict.fromkeys(server.engine.metrics, 0)
        t0 = time.perf_counter()
        answered = asyncio.run(serve_all(32))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_launches()
        metrics = server.engine_metrics()
        return {"token_ids": [res["token_ids"] for res in answered],
                "launches": launches, "wall_s": wall, "metrics": metrics,
                "decode_tokens_per_s":
                    metrics["decode_tokens"] / metrics["decode_s"],
                "max_memory_allocated_bytes":
                    torch.cuda.max_memory_allocated()}


def percentile(values, q: float) -> float:
    values = sorted(values)
    return values[min(len(values) - 1, int(q * len(values)))]


def phase_runtime_serving(card: str, serving: dict) -> dict:
    """Phase 15: the port's runtime on this machine, its card as ``GPU``."""
    import gc

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.util.accelerators import (detect_gpu_ids,
                                                 num_gpus_on_host)

    # the driver's cached device memory from the earlier phases goes back
    # to the card before the actor builds its model
    gc.collect()
    torch.cuda.empty_cache()
    metrics = {"card": card}
    t0 = time.perf_counter()
    rt.init(num_cpus=4)
    metrics["init_s"] = time.perf_counter() - t0
    try:
        gpus = rt.cluster_resources().get("GPU")
        if gpus != torch.cuda.device_count() or gpus != num_gpus_on_host():
            raise AssertionError(
                f"the cluster advertises GPU={gpus}, torch sees "
                f"{torch.cuda.device_count()} and nvidia-smi "
                f"{num_gpus_on_host()}")
        metrics["gpu"] = gpus
        log(f"runtime: cluster up in {metrics['init_s']:.2f} s, resources "
            f"{rt.cluster_resources()}")

        # a task on the card returns a bf16 CUDA tensor of 256 MiB
        make = rt.remote(num_gpus=1)(card_tensor)
        t0 = time.perf_counter()
        got = rt.get(make.remote(RUNTIME_TENSOR_ELEMS, 0),
                     timeout=RUNTIME_TIMEOUT_S)
        metrics["gpu_task_s"] = time.perf_counter() - t0
        want = card_tensor(RUNTIME_TENSOR_ELEMS, 0).cpu()
        if (got.dtype, got.device.type, got.shape) != \
                (torch.bfloat16, "cpu", want.shape) or not torch.equal(
                    got.view(torch.int16), want.view(torch.int16)):
            raise AssertionError(
                f"the GPU task's tensor came back as {got.dtype} "
                f"{tuple(got.shape)} on {got.device}, not bit-equal")
        del got, want
        log(f"runtime: num_gpus=1 task returned {RUNTIME_TENSOR_ELEMS * 2} "
            f"bytes of bf16 from the card, bit-equal, in "
            f"{metrics['gpu_task_s']:.2f} s (worker start included)")

        @rt.remote
        def noop():
            return None

        rt.get([noop.remote() for _ in range(8)], timeout=RUNTIME_TIMEOUT_S)
        trips = []
        for _ in range(RUNTIME_ROUND_TRIPS):
            t0 = time.perf_counter()
            rt.get(noop.remote(), timeout=RUNTIME_TIMEOUT_S)
            trips.append(time.perf_counter() - t0)
        metrics["task_rtt_p50_ms"] = percentile(trips, 0.5) * 1e3
        metrics["task_rtt_p99_ms"] = percentile(trips, 0.99) * 1e3

        x = torch.randn(RUNTIME_PUT_ELEMS)
        puts, gets = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            ref = rt.put(x)
            t1 = time.perf_counter()
            y = rt.get(ref, timeout=RUNTIME_TIMEOUT_S)
            t2 = time.perf_counter()
            if not torch.equal(y, x):
                raise AssertionError("put/get changed the tensor")
            puts.append(x.numel() * 4 / (t1 - t0) / 1e9)
            gets.append(x.numel() * 4 / (t2 - t1) / 1e9)
            del y, ref
        metrics["put_gb_s"] = puts
        metrics["get_gb_s"] = gets
        del x

        # the serving actor on the card
        server_cls = rt.remote(num_gpus=1)(RuntimeServer)
        t0 = time.perf_counter()
        server = server_cls.remote()
        rt.get(server.ready.remote(), timeout=RUNTIME_TIMEOUT_S)
        metrics["actor_ready_s"] = time.perf_counter() - t0
        calls = []
        for _ in range(RUNTIME_ROUND_TRIPS):
            t0 = time.perf_counter()
            rt.get(server.ready.remote(), timeout=RUNTIME_TIMEOUT_S)
            calls.append(time.perf_counter() - t0)
        metrics["actor_call_p50_ms"] = percentile(calls, 0.5) * 1e3
        bound = rt.get(server.cards.remote(), timeout=RUNTIME_TIMEOUT_S)
        if bound not in detect_gpu_ids()[0]:
            raise AssertionError(f"the actor's CUDA_VISIBLE_DEVICES is "
                                 f"{bound!r}, not one detected card")
        metrics["actor_cuda_visible_devices"] = bound
        out = rt.get(server.serve.remote(serving["prompts"]),
                     timeout=RUNTIME_TIMEOUT_S)
        if out["token_ids"] != serving["token_ids"]:
            differ = [i for i, (a, b) in enumerate(zip(
                out["token_ids"], serving["token_ids"])) if a != b]
            raise AssertionError(f"the actor's greedy answers {differ} part "
                                 "from the in-process serving phase's")
        want = serving["launches"]
        if out["launches"]["flash_attention_fwd"] != want:
            raise AssertionError(
                f"flash_fwd launched {out['launches']['flash_attention_fwd']}"
                f" times in the actor, {want} in the serving phase")
        metrics["actor_decode_tokens_per_s"] = out["decode_tokens_per_s"]
        metrics["in_process_decode_tokens_per_s"] = \
            serving["decode_tokens_per_s"]
        metrics["actor_serve_wall_s"] = out["wall_s"]
        log(f"runtime: the actor's {len(out['token_ids'])} greedy answers "
            f"equal the serving phase's token for token; flash_fwd launches "
            f"{out['launches']['flash_attention_fwd']} (in-process {want})")

        # one card: a second GPU actor pends until the first is killed
        probe = rt.remote(num_gpus=1)(RuntimeProbe).remote()
        pending = probe.ready.remote()
        ready, _ = rt.wait([pending], timeout=RUNTIME_PENDING_S)
        if ready:
            raise AssertionError("a second num_gpus=1 actor started while "
                                 "the first held the only card")
        t0 = time.perf_counter()
        rt.kill(server)
        rt.get(pending, timeout=RUNTIME_TIMEOUT_S)
        metrics["second_actor_after_kill_s"] = time.perf_counter() - t0
        rt.kill(probe)
        log(f"runtime: a second num_gpus=1 actor pended "
            f"{RUNTIME_PENDING_S:.0f} s, then started "
            f"{metrics['second_actor_after_kill_s']:.2f} s after the first "
            f"was killed")
    finally:
        rt.shutdown()
    log("runtime metrics: " + json.dumps(metrics))
    return out["launches"]


class RuntimeProbe:
    def ready(self) -> int:
        return os.getpid()


RT_TRAIN_STEPS, RT_TRAIN_CKPT_AFTER, RT_TRAIN_CRASH_AFTER = 6, 3, 4
RT_TRAIN_LAYERS = 4  # of the 1b's 16: the checkpoint's bytes set the time
RT_TRAIN_FREE_SHARE = 0.9  # of the card's memory free as a worker starts
RT_TRAIN_FLUSH_S = "1"  # the runtime's metrics and goodput flush, seconds


def runtime_training_loop(config):
    """Phase 16's train loop, run by ``TorchTrainer`` in a worker that
    holds the card. It crosses to the worker by value, so it imports what it
    uses and takes everything else from ``config``: phase 4's 1b bundle at
    full width and ``config["n_layers"]`` of its layers (``init(seed)``,
    phase 4's optimizer) on phase 4's batch; ``config["steps"]`` steps, each reported with its loss,
    seconds and the kernels' launches in this process so far (counted from
    0 at the loop's start) and logged to ``config["log"]``; after step
    ``ckpt_after`` a report with a ``Checkpoint`` directory holding the
    whole state (``torch.save`` of params, Adam's moments and count); on
    the first incarnation, ``os._exit(1)`` after step ``crash_after`` once
    that checkpoint's manifest is committed. A resumed incarnation loads
    the state from ``get_checkpoint()`` and takes the remaining steps."""
    import dataclasses
    import json
    import os
    import shutil
    import tempfile
    import time

    import numpy as np
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models import CONFIGS
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops.attention import launch_counts
    from ray_tpu_torch.parallel import (OptState, TrainStepBundle,
                                        make_optimizer)
    from ray_tpu_torch.train.checkpoint import checkpoint_store

    started = time.time()
    # the driver's settings (phase_device), so products round alike
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    free, total = torch.cuda.mem_get_info()  # makes this process's context
    cuda_init_s = time.perf_counter() - t
    ctx = train.get_context()
    t = time.perf_counter()
    built = _build.build_all(["flash_fwd", "flash_bwd"])
    info = {"pid": os.getpid(), "started_at": started,
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "free_bytes_at_start": free, "total_bytes": total,
            "cuda_init_s": cuda_init_s,
            # the libraries the driver built, loaded (nvcc runs only where
            # the checkout has none)
            "kernel_libs_s": time.perf_counter() - t,
            "kernel_nvcc_s": sum(b.seconds for b in built.values()),
            "group_formation": dict(getattr(ctx, "group_formation", {}))}
    cfg = dataclasses.replace(CONFIGS[config["model"]],
                              n_layers=config["n_layers"])
    t = time.perf_counter()
    bundle = TrainStepBundle(cfg, device="cuda", optimizer=make_optimizer(
        learning_rate=config["learning_rate"],
        warmup_steps=config["warmup_steps"]))
    batch = bundle.make_batch(np.random.default_rng(config["batch_seed"]),
                              config["batch"], config["seq"])
    ckpt = train.get_checkpoint()
    if ckpt is None:
        params, opt_state = bundle.init(seed=config["seed"])
        start = 0
    else:
        t_load = time.perf_counter()
        state = torch.load(os.path.join(ckpt.as_directory(), "state.pt"),
                           map_location="cpu", weights_only=True)
        info["restore_s"] = time.perf_counter() - t_load
        t_h2d = time.perf_counter()
        params = {k: v.to("cuda") for k, v in state["params"].items()}
        opt_state = OptState(
            state["count"], {k: v.to("cuda") for k, v in state["mu"].items()},
            {k: v.to("cuda") for k, v in state["nu"].items()})
        torch.cuda.synchronize()
        info["h2d_s"] = time.perf_counter() - t_h2d
        start = state["step"]
        del state
    torch.cuda.synchronize()
    info["setup_s"] = time.perf_counter() - t
    info["start"] = start
    launch_counts(reset=True)
    for step in range(start, config["steps"]):
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, opt_state, loss = bundle.step(params, opt_state, batch)
        loss = loss.item()
        torch.cuda.synchronize()
        row = {"step": step + 1, "loss": loss,
               "step_s": time.perf_counter() - t,
               "launches": launch_counts(),
               "pid": os.getpid(), "start": start}
        metrics = {k: row[k] for k in ("step", "loss", "step_s", "launches")}
        if step + 1 == config["ckpt_after"]:
            d = tempfile.mkdtemp(dir=config["scratch"])
            try:
                t = time.perf_counter()
                torch.save({"params": {k: p.detach()
                                       for k, p in params.items()},
                            "count": opt_state.count, "mu": opt_state.mu,
                            "nu": opt_state.nu, "step": step + 1},
                           os.path.join(d, "state.pt"))
                row["ckpt_write_s"] = time.perf_counter() - t
                row["ckpt_report_started_at"] = time.time()
                t = time.perf_counter()
                train.report(metrics, checkpoint=train.Checkpoint(d))
                row["ckpt_report_s"] = time.perf_counter() - t
            finally:
                shutil.rmtree(d, ignore_errors=True)
        else:
            t = time.perf_counter()
            train.report(metrics)
            row["report_s"] = time.perf_counter() - t
        row["reported_at"] = time.time()
        if step == start:
            row.update(info)
        crash = (step + 1 == config["crash_after"]
                 and not os.path.exists(config["marker"]))
        if crash:
            # the checkpoint commits on the saver's background thread: die
            # only once its manifest is durable
            store = checkpoint_store(ctx.run_dir)
            while True:
                manifest = store.latest()
                if manifest is not None \
                        and manifest.step == config["ckpt_after"]:
                    break
                time.sleep(0.05)
            row["ckpt_committed_at"] = manifest.ts
            row["ckpt_bytes_written"] = manifest.stats.get("bytes_written")
            row["crashed_at"] = time.time()
        with open(config["log"], "a") as f:
            f.write(json.dumps(row) + "\n")
        if crash:
            with open(config["marker"], "w") as f:
                f.write(str(row["crashed_at"]))
            os._exit(1)
    return {"start": start}


def cluster_goodput(job: str) -> dict:
    """The GCS's goodput ledger of ``job``: its processes' buckets and
    counters, summed."""
    from ray_tpu_torch._private import worker as worker_mod

    core = worker_mod.global_worker()
    jobs = core._run(core._gcs_call("GetGoodput", {"job": job}))["jobs"]
    return jobs.get(job, {})


def cut_training_reference(layers: int, steps: int) -> dict:
    """Phase 4's run (seed 0, batch seed 0, lr 1e-4 with a warm-up of 1) at
    full width and ``layers`` of the 1b's layers, in this process: the
    reference of a phase that trains the cut 1b elsewhere. Its losses by
    step and its median step after the first."""
    import gc

    import numpy as np
    import torch

    from ray_tpu_torch.models import CONFIGS
    from ray_tpu_torch.parallel import TrainStepBundle, make_optimizer

    cfg = dataclasses.replace(CONFIGS[TRAIN_CONFIG], n_layers=layers)
    bundle = TrainStepBundle(cfg, device="cuda", optimizer=make_optimizer(
        learning_rate=1e-4, warmup_steps=1))
    params, opt_state = bundle.init(seed=0)
    batch = bundle.make_batch(np.random.default_rng(0), TRAIN_BATCH,
                              TRAIN_SEQ)
    losses, times = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, opt_state, loss = bundle.step(params, opt_state, batch)
        losses.append(loss.item())
        times.append(time.perf_counter() - t)
    del bundle, params, opt_state, batch
    gc.collect()
    torch.cuda.empty_cache()
    rest = sorted(times[1:])
    return {"loss": losses, "step_s_median": rest[len(rest) // 2]}


def phase_runtime_training(card: str, training: dict) -> dict:
    """Phase 16: ``TorchTrainer.fit()`` on the port's runtime trains the 1b
    at full width and RT_TRAIN_LAYERS of its layers in one ``num_gpus=1``
    worker (the ``runtime_training`` path): the worker dies after step 4,
    the controller re-forms the group in a fresh process, which resumes
    from the checkpoint of step 3. Held against the same steps at the same
    depth uninterrupted in this process (``cut_training_reference``);
    phase 4's full-depth median step (``training``) is logged beside."""
    import gc
    import shutil
    import tempfile

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.models import CONFIGS
    from ray_tpu_torch.train import (FailureConfig, RunConfig, ScalingConfig,
                                     TorchTrainer)
    from ray_tpu_torch.util.accelerators import detect_gpu_ids

    cfg = dataclasses.replace(CONFIGS[TRAIN_CONFIG], n_layers=RT_TRAIN_LAYERS)
    state_bytes = 3 * 4 * cfg.num_params()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    reference = cut_training_reference(RT_TRAIN_LAYERS, RT_TRAIN_STEPS)
    reference_s = time.perf_counter() - t0
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    free = shutil.disk_usage(root).free
    # the checkpoint's directory, the store's chunks and the directory the
    # controller materializes at the restart
    need = int(3.1 * state_bytes)
    metrics = {"card": card, "config": TRAIN_CONFIG,
               "n_layers": RT_TRAIN_LAYERS, "batch": TRAIN_BATCH,
               "seq": TRAIN_SEQ, "state_bytes": state_bytes,
               "reference_s": reference_s,
               "disk_free_bytes": free,
               "driver_allocated_bytes": torch.cuda.memory_allocated()}
    saved_env = os.environ.get("RAY_TPU_METRICS_FLUSH_INTERVAL_S")
    os.environ["RAY_TPU_METRICS_FLUSH_INTERVAL_S"] = RT_TRAIN_FLUSH_S
    try:
        if free < need:
            raise RuntimeError(f"{root}: {free} bytes free, the phase needs "
                               f"{need}")
        rt.init(num_cpus=4)
        try:
            name = "runtime_training"
            log_path = os.path.join(root, "steps.jsonl")
            marker = os.path.join(root, "died_once")
            trainer = TorchTrainer(
                runtime_training_loop,
                train_loop_config={
                    "model": TRAIN_CONFIG, "n_layers": RT_TRAIN_LAYERS,
                    "seed": 0, "batch_seed": 0,
                    "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
                    "learning_rate": 1e-4, "warmup_steps": 1,
                    "steps": RT_TRAIN_STEPS,
                    "ckpt_after": RT_TRAIN_CKPT_AFTER,
                    "crash_after": RT_TRAIN_CRASH_AFTER,
                    "marker": marker, "log": log_path, "scratch": root},
                scaling_config=ScalingConfig(
                    num_workers=1, use_gpu=True,
                    resources_per_worker={"CPU": 1, "GPU": 1}),
                run_config=RunConfig(
                    storage_path=root, name=name,
                    failure_config=FailureConfig(max_failures=1)))
            fit_at = time.time()
            t0 = time.perf_counter()
            result = trainer.fit()
            metrics["fit_s"] = time.perf_counter() - t0
            time.sleep(2 * float(RT_TRAIN_FLUSH_S))  # the last flushes land
            ledger = cluster_goodput(name)
        finally:
            rt.shutdown()
        rows = [json.loads(line) for line in open(log_path)]
    finally:
        if saved_env is None:
            os.environ.pop("RAY_TPU_METRICS_FLUSH_INTERVAL_S", None)
        else:
            os.environ["RAY_TPU_METRICS_FLUSH_INTERVAL_S"] = saved_env
        shutil.rmtree(root, ignore_errors=True)

    if result.metrics.get("step") != RT_TRAIN_STEPS:
        raise AssertionError(f"fit ended at {result.metrics}")
    first = [r for r in rows if r["start"] == 0]
    second = [r for r in rows if r["start"] != 0]
    steps = [r["step"] for r in rows]
    if steps != list(range(1, RT_TRAIN_CRASH_AFTER + 1)) + list(
            range(RT_TRAIN_CKPT_AFTER + 1, RT_TRAIN_STEPS + 1)):
        raise AssertionError(f"steps taken {steps}")
    if {r["start"] for r in second} != {RT_TRAIN_CKPT_AFTER}:
        raise AssertionError(f"the second incarnation started from "
                             f"{[r['start'] for r in second]}")
    pids = [first[0]["pid"], second[0]["pid"]]
    if len({r["pid"] for r in rows}) != 2 or pids[0] == pids[1]:
        raise AssertionError(f"worker pids {[r['pid'] for r in rows]}")
    reforms = ledger.get("counters", {}).get("reforms")
    if reforms != 1:
        raise AssertionError(f"the controller counted {reforms} re-forms")
    cards = detect_gpu_ids()[0]
    for inc in (first[0], second[0]):
        if inc["cuda_visible_devices"] not in cards:
            raise AssertionError(f"a worker's CUDA_VISIBLE_DEVICES is "
                                 f"{inc['cuda_visible_devices']!r}, not one "
                                 f"of the cards {cards}")
    share = second[0]["free_bytes_at_start"] / second[0]["total_bytes"]
    if share < RT_TRAIN_FREE_SHARE:
        raise AssertionError(f"the second worker found {share:.3f} of the "
                             "card free: the first one's memory was held")
    want = reference["loss"]
    losses = {r["step"]: [] for r in rows}
    for r in rows:
        losses[r["step"]].append(r["loss"])
    if first[0]["loss"] != want[0]:
        raise AssertionError(f"step 1's loss {first[0]['loss']} is not the "
                             f"same-depth reference's {want[0]}")
    worst = max(abs(r["loss"] - want[r["step"] - 1]) / abs(want[r["step"] - 1])
                for r in rows)
    if not worst <= CKPT_LOSS_RTOL:
        raise AssertionError(f"losses {losses} part from the same-depth "
                             f"reference's {want} by {worst} (relative), "
                             f"beyond {CKPT_LOSS_RTOL}")
    per_step = {"flash_attention_fwd": (2 if cfg.remat else 1) * cfg.n_layers,
                "attention_bwd_prep": cfg.n_layers,
                "flash_attention_bwd": cfg.n_layers,
                "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
                "flash_bwd_delta": 0}
    launches = dict.fromkeys(per_step, 0)
    for inc in (first, second):
        got = inc[-1]["launches"]
        n = len(inc)
        if got != {k: v * n for k, v in per_step.items()}:
            raise AssertionError(f"a worker launched {got} in {n} steps, "
                                 f"want {per_step} a step")
        for k in launches:
            launches[k] += got[k]

    def median(xs):
        xs = sorted(xs)
        return xs[len(xs) // 2]

    ckpt_row = next(r for r in first if "ckpt_report_s" in r)
    crash_row = first[-1]
    metrics.update({
        "losses": losses, "reference_losses": want,
        "max_rel_loss_err": worst,
        "loss_rtol": CKPT_LOSS_RTOL,
        "fit_to_first_report_s": first[0]["reported_at"] - fit_at,
        "fit_to_loop_start_s": first[0]["started_at"] - fit_at,
        "cuda_init_s": [inc[0]["cuda_init_s"] for inc in (first, second)],
        "kernel_libs_s": [inc[0]["kernel_libs_s"] for inc in (first, second)],
        "kernel_nvcc_s": [inc[0]["kernel_nvcc_s"]
                          for inc in (first, second)],
        # each incarnation's first step: its first launches in a fresh
        # process
        "first_step_s": [inc[0]["step_s"] for inc in (first, second)],
        "formation": [inc[0]["group_formation"] for inc in (first, second)],
        "setup_s": [inc[0]["setup_s"] for inc in (first, second)],
        # each incarnation's first step is its warm-up
        "step_s_median": median([r["step_s"] for inc in (first, second)
                                 for r in inc[1:]]),
        "step_s": [r["step_s"] for r in rows],
        "reference_step_s_median": reference["step_s_median"],
        "phase4_step_s_median": training["step_s_median"],
        "report_rtt_s_median": median([r["report_s"] for r in rows
                                       if "report_s" in r]),
        "ckpt_write_s": ckpt_row["ckpt_write_s"],
        "ckpt_report_pause_s": ckpt_row["ckpt_report_s"],
        # from the checkpointed report's start to its manifest's commit
        "ckpt_commit_s": crash_row["ckpt_committed_at"]
        - ckpt_row["ckpt_report_started_at"],
        "ckpt_bytes_written": crash_row["ckpt_bytes_written"],
        "reform_downtime_s": ledger["buckets"].get("reform_downtime"),
        "reforms": reforms,
        "crash_to_resumed_loop_s": second[0]["started_at"]
        - crash_row["crashed_at"],
        "restore_s": second[0]["restore_s"], "h2d_s": second[0]["h2d_s"],
        "free_share_at_start": [inc[0]["free_bytes_at_start"]
                                / inc[0]["total_bytes"]
                                for inc in (first, second)],
        "cuda_visible_devices": [inc[0]["cuda_visible_devices"]
                                 for inc in (first, second)],
        "pids": pids, "launches": launches,
        "goodput_buckets": ledger.get("buckets")})
    log(f"runtime training: fit {metrics['fit_s']:.2f} s, one re-form "
        f"(pids {pids}), resumed from step {RT_TRAIN_CKPT_AFTER}; losses "
        f"within {worst:.3g} of the {RT_TRAIN_LAYERS}-layer reference's; "
        f"launches {launches} [{card}]")
    log("runtime training metrics: " + json.dumps(metrics))
    return launches


SERVE_REPLICAS = 2
SERVE_GPU_SHARE = 0.5  # two replicas on the one card: a rollout could not
#                        start a whole-card replica while another holds it
SERVE_TOKENS = 32
SERVE_CLIENTS = 4  # threads sending requests through the swap
SERVE_MIN_ANSWERED = 20  # requests the clients must get answered
SERVE_STORE = "serve_1b"
SERVE_STORE_MAX = 16 << 30  # the object store: at most this, or half of
#                             /dev/shm's free bytes
SERVE_TIMEOUT_S = 600.0  # each cluster call's and HTTP request's
SERVE_AFTER_ACK_S = 3.0  # the clients go on this long after the acks
SERVE_LAYERS = 4  # of the 1b's 16: the version's bytes set the swap's time
GRPC_STREAM_NAME = "grpc_stream"  # phase 17's streaming deployment


def shm_bytes() -> dict:
    st = os.statvfs("/dev/shm")
    return {"size": st.f_frsize * st.f_blocks,
            "free": st.f_frsize * st.f_bavail}


def http_complete(port: int, name: str, prompt: str, max_tokens: int
                  ) -> dict:
    """One greedy completion over the HTTP proxy, with its token ids."""
    import urllib.request
    from urllib.parse import quote

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/{quote(name)}",
        data=json.dumps({"prompt": prompt, "max_tokens": max_tokens,
                         "return_token_ids": True}).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=SERVE_TIMEOUT_S) as resp:
        result = json.loads(resp.read())["result"]
    choice = result["choices"][0]
    return {"token_ids": choice["token_ids"], "text": choice["text"],
            "finish_reason": choice["finish_reason"],
            "ttft_s": result["usage"]["ttft_s"],
            "latency_s": time.perf_counter() - t0}


_IN_PROCESS = {}  # (seed, prompts, layers) -> in_process_answers' answers


def in_process_answers(seed: int, prompts, n_layers: int = 0) -> list:
    """The reference of phases 17 to 19: an ``LLMServer`` in this process on
    the card (the 1b at full width, at ``n_layers`` of its layers where
    given, weights from ``seed``) answering the prompts one at a time,
    after one warm-up round, as the HTTP rounds send them. Kept for the
    later phases that hold their answers to the same reference."""
    key = (seed, tuple(prompts), n_layers)
    if key not in _IN_PROCESS:
        _IN_PROCESS[key] = _in_process_answers(seed, prompts, n_layers)
    return _IN_PROCESS[key]


def llm_config(n_layers: int = 0, **kwargs):
    """The 1b's ``LLMConfig``, cut to ``n_layers`` of its layers where
    given."""
    from ray_tpu_torch.llm import LLMConfig

    overrides = {"n_layers": n_layers} if n_layers else {}
    return LLMConfig(model_id="1b", model_overrides=overrides, **kwargs)


def _in_process_answers(seed: int, prompts, n_layers: int) -> list:
    import gc

    import torch

    from ray_tpu_torch.llm import LLMServer

    server = LLMServer(llm_config(n_layers), seed=seed, device="cuda")

    async def one(prompt, max_tokens):
        return await server.completions(prompt, max_tokens=max_tokens)

    for p in prompts:
        asyncio.run(one(p, 2))
    out = [asyncio.run(one(p, SERVE_TOKENS)) for p in prompts]
    torch.cuda.synchronize()
    del server
    gc.collect()
    torch.cuda.empty_cache()
    return [{k: o[k] for k in ("token_ids", "text", "finish_reason")}
            for o in out]


def check_answers(label: str, got: list, want: list) -> None:
    for i, (g, w) in enumerate(zip(got, want)):
        if any(g[k] != w[k] for k in ("token_ids", "text", "finish_reason")):
            raise AssertionError(
                f"{label}: request {i} answered {g['token_ids'][:8]}... "
                f"({g['finish_reason']}) over HTTP, in-process "
                f"{w['token_ids'][:8]}... ({w['finish_reason']})")
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} of {len(want)} answered")


def grpc_complete(client, name: str, prompt: str, max_tokens: int) -> dict:
    """One greedy completion through the gRPC ingress, as
    ``http_complete`` reads one over HTTP."""
    t0 = time.perf_counter()
    result = client.call(name, {"prompt": prompt, "max_tokens": max_tokens,
                                "return_token_ids": True},
                         timeout=SERVE_TIMEOUT_S)
    choice = result["choices"][0]
    return {"token_ids": choice["token_ids"], "text": choice["text"],
            "finish_reason": choice["finish_reason"],
            "latency_s": time.perf_counter() - t0}


class GrpcStreamer:
    """Phase 17's streaming deployment: asks the 1b deployment for each
    prompt's answer in turn and yields each as it comes (its blocking calls
    run off the replica's loop)."""

    def __init__(self, llm_name: str):
        self._llm_name = llm_name

    async def answers(self, body):
        import ray_tpu_torch as rt
        from ray_tpu_torch.serve.api import DeploymentHandle

        handle = DeploymentHandle(self._llm_name)

        def answer(prompt):
            result = rt.get(handle.remote({
                "prompt": prompt, "max_tokens": body["max_tokens"],
                "return_token_ids": True}), timeout=body["timeout"])
            choice = result["choices"][0]
            return {k: choice[k] for k in ("token_ids", "text",
                                           "finish_reason")}

        for prompt in body["prompts"]:
            yield await asyncio.to_thread(answer, prompt)


def serve_grpc_round(handle, name: str, prompts, want: list) -> tuple:
    """Phase 17's gRPC rounds: the proxy started, the prompts answered one
    at a time through ``ServeGrpcClient.call`` and streamed through
    ``GrpcStreamer``, each held against ``want``; the replicas' launch
    counts set to 0 before and read after. Returns (launches, metrics)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.grpc_ingress import (ServeGrpcClient,
                                                  start_grpc_proxy)

    serve.run(serve.deployment(
        GrpcStreamer, name=GRPC_STREAM_NAME,
        ray_actor_options={"num_cpus": 0.1}).bind(name),
        name=GRPC_STREAM_NAME)
    handle.broadcast("kernel_launches", reset=True, timeout=SERVE_TIMEOUT_S)
    t0 = time.perf_counter()
    port = start_grpc_proxy()
    start_s = time.perf_counter() - t0
    client = ServeGrpcClient(f"127.0.0.1:{port}")
    try:
        got = [grpc_complete(client, name, p, SERVE_TOKENS) for p in prompts]
        check_answers("gRPC, seed 1", got, want)
        t0 = time.perf_counter()
        chunks, first_s = [], None
        for chunk in client.stream(
                GRPC_STREAM_NAME, {"prompts": list(prompts),
                                   "max_tokens": SERVE_TOKENS,
                                   "timeout": SERVE_TIMEOUT_S},
                method="answers", timeout=SERVE_TIMEOUT_S):
            if first_s is None:
                first_s = time.perf_counter() - t0
            chunks.append(chunk)
        stream_s = time.perf_counter() - t0
        check_answers("gRPC stream, seed 1", chunks, want)
        if not first_s < stream_s / 2:
            raise AssertionError(f"the stream's first chunk came at "
                                 f"{first_s:.3f} s of {stream_s:.3f} s")
    finally:
        client.close()
        rt.kill(rt.get_actor("serve_grpc_proxy"))
        serve.delete(GRPC_STREAM_NAME)
    launches = handle.broadcast("kernel_launches", timeout=SERVE_TIMEOUT_S)
    fwd = [c["flash_attention_fwd"] for c in launches]
    if not all(n > 0 for n in fwd):
        raise AssertionError(f"flash_fwd launches by replica over gRPC {fwd}")
    lat = sorted(g["latency_s"] for g in got)
    metrics = {"grpc_proxy_start_s": start_s,
               "grpc_latency_p50_s": percentile(lat, 0.5),
               "grpc_latency_max_s": lat[-1],
               "grpc_stream_first_chunk_s": first_s,
               "grpc_stream_s": stream_s, "grpc_flash_fwd_launches": fwd}
    return {k: sum(c[k] for c in launches) for k in launches[0]}, metrics


def phase_serve_weights(card: str, serving: dict) -> dict:
    """Phase 17: Serve and the weight plane on the port's runtime, the 1b
    at full width and SERVE_LAYERS of its layers, held against in-process
    serving at the same depth."""
    import gc
    import threading

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import build_openai_app
    from ray_tpu_torch.models.convert import init_params
    from ray_tpu_torch.weights import WeightStore

    gc.collect()
    torch.cuda.empty_cache()
    prompts = serving["prompts"]
    metrics = {"card": card, "n_layers": SERVE_LAYERS}
    t0 = time.perf_counter()
    want0 = in_process_answers(0, prompts, SERVE_LAYERS)
    want1 = in_process_answers(1, prompts, SERVE_LAYERS)
    if [w["token_ids"] for w in want0] == [w["token_ids"] for w in want1]:
        raise AssertionError("seeds 0 and 1 answer alike: the swap would "
                             "not show")
    metrics["in_process_rounds_s"] = time.perf_counter() - t0
    cfg = llm_config(SERVE_LAYERS, num_replicas=SERVE_REPLICAS,
                     ray_actor_options={"num_gpus": SERVE_GPU_SHARE})
    # the version to publish: seed 1's fp32 weights, drawn on the card as
    # in-process serving draws them, then on the host
    t0 = time.perf_counter()
    version = {k: v.cpu().numpy() for k, v in init_params(
        cfg.transformer_config(), seed=1, device="cuda").items()}
    torch.cuda.empty_cache()
    nbytes = sum(v.nbytes for v in version.values())
    metrics["version_bytes"] = nbytes
    metrics["version_on_host_s"] = time.perf_counter() - t0

    shm = shm_bytes()
    store_mem = max(1 << 30, min(SERVE_STORE_MAX, shm["free"] // 2))
    metrics.update(dev_shm_bytes=shm["size"], dev_shm_free_bytes=shm["free"],
                   object_store_memory=store_mem,
                   version_spills=nbytes > store_mem)
    log(f"serve weights: /dev/shm {shm['size'] / 2**30:.2f} GiB "
        f"({shm['free'] / 2**30:.2f} free); object store "
        f"{store_mem / 2**30:.2f} GiB for a {nbytes / 1e9:.3f} GB version"
        f"{' (it spills)' if nbytes > store_mem else ''}")
    t0 = time.perf_counter()
    rt.init(num_cpus=8, object_store_memory=store_mem)
    metrics["init_s"] = time.perf_counter() - t0
    try:
        store = WeightStore(SERVE_STORE)
        port = serve.start_http_proxy()
        t0 = time.perf_counter()
        handle = build_openai_app([cfg])[f"llm:{cfg.model_id}"]
        name = handle._name
        # each replica answers once its engine is built
        rt.get([r.health.remote() for r in handle._replicas],
               timeout=SERVE_TIMEOUT_S)
        handle.broadcast("kernel_launches", timeout=SERVE_TIMEOUT_S)
        metrics["replicas_ready_s"] = time.perf_counter() - t0
        if len(handle._replicas) != SERVE_REPLICAS:
            raise AssertionError(f"{len(handle._replicas)} replicas")
        log(f"serve weights: {SERVE_REPLICAS} replicas of num_gpus="
            f"{SERVE_GPU_SHARE} ready in {metrics['replicas_ready_s']:.2f} s;"
            f" HTTP proxy on port {port}")
        for p in prompts:  # warm-up, as the reference had
            http_complete(port, name, p, 2)
        handle.broadcast("kernel_launches", reset=True,
                         timeout=SERVE_TIMEOUT_S)

        got0 = [http_complete(port, name, p, SERVE_TOKENS) for p in prompts]
        check_answers("seed 0", got0, want0)
        log(f"serve weights: {len(got0)} HTTP answers equal in-process "
            f"serving of seed 0 token for token")

        answered, failures, during = [], [], []
        stop = threading.Event()
        window = {}

        def client(i):
            k = i
            while not stop.is_set():
                p = prompts[k % len(prompts)]
                k += SERVE_CLIENTS
                t_sub = time.perf_counter()
                try:
                    http_complete(port, name, p, SERVE_TOKENS)
                    answered.append((t_sub, time.perf_counter()))
                except Exception as e:  # a dropped request fails the phase
                    failures.append(repr(e))

        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(SERVE_CLIENTS)]
        for t in threads:
            t.start()
        deadline = time.perf_counter() + SERVE_TIMEOUT_S
        while len(answered) < SERVE_CLIENTS and not failures and \
                time.perf_counter() < deadline:
            time.sleep(0.05)
        window["start"] = time.perf_counter()
        v = store.publish(version, version=1)
        window["published"] = time.perf_counter()
        acks = handle.broadcast("update_weights", SERVE_STORE,
                                timeout=SERVE_TIMEOUT_S)
        window["acked"] = time.perf_counter()
        time.sleep(SERVE_AFTER_ACK_S)
        stop.set()
        for t in threads:
            t.join(timeout=SERVE_TIMEOUT_S)
        if [a["version"] for a in acks] != [v] * SERVE_REPLICAS or v != 1:
            raise AssertionError(f"acks {acks}, published version {v}")
        if failures:
            raise AssertionError(f"{len(failures)} requests failed during "
                                 f"the swap: {failures[:3]}")
        if len(answered) <= SERVE_MIN_ANSWERED:
            raise AssertionError(f"{len(answered)} requests answered, want "
                                 f"more than {SERVE_MIN_ANSWERED}")
        during = [a for a in answered if a[1] >= window["start"]
                  and a[0] <= window["acked"]]

        got1 = [http_complete(port, name, p, SERVE_TOKENS) for p in prompts]
        check_answers("seed 1", got1, want1)
        launches = handle.broadcast("kernel_launches",
                                    timeout=SERVE_TIMEOUT_S)
        fwd = [c["flash_attention_fwd"] for c in launches]
        if not all(n > 0 for n in fwd):
            raise AssertionError(f"flash_fwd launches by replica {fwd}")
        log(f"serve weights: broadcast acks {[a['version'] for a in acks]}; "
            f"{len(answered)} requests answered through the swap, 0 failed;"
            f" {len(got1)} HTTP answers equal in-process serving of seed 1 "
            f"token for token; flash_fwd launches by replica {fwd}")

        launched = {k: sum(c[k] for c in launches) for k in launches[0]}
        grpc_launched, grpc_metrics = serve_grpc_round(handle, name,
                                                       prompts, want1)
        http_lat = sorted(g["latency_s"] for g in got1)
        log(f"serve grpc: proxy started in "
            f"{grpc_metrics['grpc_proxy_start_s']:.3f} s; {len(prompts)} "
            f"gRPC answers and {len(prompts)} streamed chunks equal "
            f"in-process serving of seed 1 token for token; latency p50 "
            f"{grpc_metrics['grpc_latency_p50_s']:.4f} s, max "
            f"{grpc_metrics['grpc_latency_max_s']:.4f} s over gRPC, p50 "
            f"{percentile(http_lat, 0.5):.4f} s, max {http_lat[-1]:.4f} s "
            f"over HTTP for the same requests; the stream's first chunk at "
            f"{grpc_metrics['grpc_stream_first_chunk_s']:.3f} s of "
            f"{grpc_metrics['grpc_stream_s']:.3f} s; flash_fwd launches by "
            f"replica {grpc_metrics['grpc_flash_fwd_launches']} [{card}]")
        metrics.update(grpc_metrics,
                       http_seed1_latency_p50_s=percentile(http_lat, 0.5),
                       http_seed1_latency_max_s=http_lat[-1])

        engines = handle.broadcast("engine_metrics", timeout=SERVE_TIMEOUT_S)
        memory = handle.broadcast("memory_stats", timeout=SERVE_TIMEOUT_S)
        lat = sorted(g["latency_s"] for g in got0 + got1)
        ttft = sorted(g["ttft_s"] for g in got0 + got1)
        publish_s = window["published"] - window["start"]
        metrics.update(
            http_latency_p50_s=percentile(lat, 0.5),
            http_latency_max_s=lat[-1],
            engine_ttft_p50_s=percentile(ttft, 0.5), engine_ttft_max_s=ttft[-1],
            decode_tokens_per_s=[e["decode_tokens"] / e["decode_s"]
                                 for e in engines],
            publish_s=publish_s, publish_gb_s=nbytes / publish_s / 1e9,
            pull_s=[a["pull_s"] for a in acks],
            pull_gb_s=[nbytes / a["pull_s"] / 1e9 for a in acks],
            swap_s=[a["swap_s"] for a in acks],
            broadcast_ack_s=window["acked"] - window["published"],
            answered=len(answered), answered_during_swap=len(during),
            dropped=len(failures),
            peak_memory_bytes=[m["max_allocated_bytes"] for m in memory],
            flash_fwd_launches=fwd)
        serve.shutdown()
        store.shutdown()
    finally:
        rt.shutdown()
    log("serve weights metrics: " + json.dumps(metrics))
    return {"serve": launched, "serve_grpc": grpc_launched}


PD_GPU_SHARE = 0.5  # the prefill and the decode worker share the one card
PD_TIMEOUT_S = 600.0  # each cluster call's
BATCH_BLOCKS = 3  # the Dataset's blocks of phase 9's 12 prompts
DEVICE_BATCH_ROWS = 1 << 22  # rows of the device-batch Dataset
DEVICE_BATCH_SIZE = 1 << 16


def kv_bytes(cfg, prompt_tokens: int) -> int:
    """The bytes of a prompt's KV pages in the engine's cache (k and v,
    every layer, whole pages)."""
    m, e = cfg.transformer_config(), cfg.engine_config
    pages = -(-prompt_tokens // e.page_size)
    itemsize = 2  # the cache's bf16
    return 2 * m.n_layers * pages * e.page_size * m.n_kv_heads * \
        m.head_dim * itemsize


def phase_pd_batch(card: str, serving: dict) -> dict:
    """Phase 18: prefill/decode disaggregation behind Serve, batch inference
    over a Dataset, and device batches, on a new port cluster."""
    import gc

    import numpy as np
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import data as rd
    from ray_tpu_torch import serve
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.experimental.device_objects import DeviceObjectMarker
    from ray_tpu_torch.llm import (LLMConfig, SamplingParams,
                                   build_llm_processor)
    from ray_tpu_torch.llm.engine import TorchLLMEngine
    from ray_tpu_torch.llm.pd import build_pd_openai_app
    from ray_tpu_torch.util import goodput

    gc.collect()
    torch.cuda.empty_cache()
    prompts = serving["prompts"]
    metrics = {"card": card}
    sp = SamplingParams(max_tokens=SERVE_TOKENS)
    # the references: in-process serving one request at a time (phase
    # 17's), and an in-process engine's generate of each Dataset block
    t0 = time.perf_counter()
    want = in_process_answers(0, prompts)
    per = -(-len(prompts) // BATCH_BLOCKS)
    blocks = [prompts[i:i + per] for i in range(0, len(prompts), per)]
    engine = TorchLLMEngine(LLMConfig(model_id="1b"), seed=0, device="cuda")
    want_blocks = [[{"token_ids": list(o.token_ids), "text": o.text,
                     "finish_reason": o.finish_reason}
                    for o in engine.generate(b, sp)] for b in blocks]
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    metrics["in_process_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    rt.init(num_cpus=8)
    metrics["init_s"] = time.perf_counter() - t0
    try:
        if rt.cluster_resources().get("GPU") != 1:
            raise AssertionError(f"the cluster advertises "
                                 f"{rt.cluster_resources().get('GPU')} GPU")
        # --- prefill/decode disaggregation -------------------------------
        cfg = LLMConfig(model_id="1b",
                        ray_actor_options={"num_gpus": PD_GPU_SHARE})
        t0 = time.perf_counter()
        handle = build_pd_openai_app(cfg)
        workers = rt.get(handle.options(method_name="workers").remote(),
                         timeout=PD_TIMEOUT_S)
        pre, dec = workers["prefill"][0], workers["decode"][0]
        rt.get([pre.metrics.remote(), dec.metrics.remote()],
               timeout=PD_TIMEOUT_S)  # each answers once its engine is up
        metrics["pd_workers_ready_s"] = time.perf_counter() - t0
        for p in prompts:  # warm-up, as the reference had
            rt.get(handle.remote({"prompt": p, "max_tokens": 2}),
                   timeout=PD_TIMEOUT_S)
        # a prefill reply seen by the driver is a marker; the KV stays in
        # the prefill worker until the driver pulls it
        ref = pre.prefill.remote(prompts[0], sp)
        rt.wait([ref], num_returns=1, timeout=PD_TIMEOUT_S)
        raw = global_worker().memory_store.get(ref.id)
        if not isinstance(raw, DeviceObjectMarker):
            raise AssertionError(f"prefill's reply is a {type(raw)}")
        state = rt.get(ref, timeout=PD_TIMEOUT_S)
        if state["k"].device.type != "cpu":
            raise AssertionError("a pulled KV state arrives on the host")
        del ref, state

        rt.get([w.kernel_launches.remote(reset=True) for w in (pre, dec)],
               timeout=PD_TIMEOUT_S)
        dec0 = rt.get(dec.metrics.remote(), timeout=PD_TIMEOUT_S)
        pulled0 = rt.get(dec.kv_pulls.remote(reset=True),
                         timeout=PD_TIMEOUT_S)
        got, pulls = [], []
        for p in prompts:
            t = time.perf_counter()
            out = rt.get(handle.remote({"prompt": p,
                                        "max_tokens": SERVE_TOKENS,
                                        "return_token_ids": True}),
                         timeout=PD_TIMEOUT_S)
            latency = time.perf_counter() - t
            choice = out["choices"][0]
            got.append({"token_ids": choice["token_ids"],
                        "text": choice["text"],
                        "finish_reason": choice["finish_reason"],
                        "ttft_s": out["usage"]["ttft_s"],
                        "latency_s": latency})
            pulls.append(rt.get(dec.kv_pulls.remote(reset=True),
                                timeout=PD_TIMEOUT_S))
        check_answers("pd", got, want)
        launches = {"prefill": rt.get(pre.kernel_launches.remote(),
                                      timeout=PD_TIMEOUT_S),
                    "decode": rt.get(dec.kernel_launches.remote(),
                                     timeout=PD_TIMEOUT_S)}
        pm, dm = rt.get([pre.metrics.remote(), dec.metrics.remote()],
                        timeout=PD_TIMEOUT_S)
        fwd = {k: v["flash_attention_fwd"] for k, v in launches.items()}
        if fwd["prefill"] <= 0 or fwd["decode"] != 0:
            raise AssertionError(f"flash_fwd launches by worker {fwd}")
        if pm["decode_steps"] != 0 or dm["prefill_tokens"] != 0:
            raise AssertionError(f"the workers did not split the work: "
                                 f"prefill {pm}, decode {dm}")
        if [q["pulls"] for q in pulls] != [1] * len(prompts):
            raise AssertionError(f"KV pulls a request {pulls}")
        kv = [kv_bytes(cfg, len(p) + 1) for p in prompts]  # BOS + bytes
        if any(q["bytes"] < b for q, b in zip(pulls, kv)):
            raise AssertionError(f"pulled {[q['bytes'] for q in pulls]} "
                                 f"bytes, the KV pages hold {kv}")
        memory = rt.get([w.memory_stats.remote() for w in (pre, dec)],
                        timeout=PD_TIMEOUT_S)
        log(f"pd and batch inference: {len(got)} PD answers equal "
            f"in-process serving token for token; flash_fwd launches "
            f"{fwd}; prefill worker decode steps {pm['decode_steps']}, "
            f"decode worker prefill tokens {dm['prefill_tokens']}; "
            f"{pulled0['pulls']} pulls before the measured round")
        lat = sorted(g["latency_s"] for g in got)
        ttft = sorted(g["ttft_s"] for g in got)
        metrics.update(
            pd_latency_s=[g["latency_s"] for g in got],
            pd_latency_p50_s=percentile(lat, 0.5), pd_latency_max_s=lat[-1],
            pd_ttft_s=[g["ttft_s"] for g in got],
            pd_ttft_p50_s=percentile(ttft, 0.5), pd_ttft_max_s=ttft[-1],
            kv_page_bytes=kv, kv_pull_bytes=[q["bytes"] for q in pulls],
            kv_pull_s=[q["seconds"] for q in pulls],
            kv_pull_gb_s=[q["bytes"] / q["seconds"] / 1e9 for q in pulls],
            decode_worker_tokens_per_s=(
                (dm["decode_tokens"] - dec0["decode_tokens"])
                / (dm["decode_s"] - dec0["decode_s"])),
            prefill_worker_peak_bytes=memory[0]["max_allocated_bytes"],
            decode_worker_peak_bytes=memory[1]["max_allocated_bytes"],
            pd_flash_fwd_launches=fwd)
        pd_launches = {k: launches["prefill"][k] + launches["decode"][k]
                       for k in launches["prefill"]}
        for w in (pre, dec):
            rt.kill(w)
        serve.delete(f"llm-pd:{cfg.model_id}")

        # --- batch inference over a Dataset ------------------------------
        t0 = time.perf_counter()
        proc = build_llm_processor(
            cfg, sampling_params=sp,
            postprocess=lambda row, out: {
                "prompt": row["prompt"], "generated_text": out["text"],
                "token_ids": out["token_ids"],
                "finish_reason": out["finish_reason"]})
        eng = proc.engine_actor
        rt.get(eng.kernel_launches.remote(reset=True), timeout=PD_TIMEOUT_S)
        metrics["engine_actor_ready_s"] = time.perf_counter() - t0
        ds = rd.from_items([{"prompt": p} for p in prompts],
                           parallelism=BATCH_BLOCKS)
        t0 = time.perf_counter()
        rows = proc(ds).take_all()
        wall = time.perf_counter() - t0
        if [r["prompt"] for r in rows] != list(prompts):
            raise AssertionError(f"{len(rows)} rows, not the prompts in "
                                 f"order")
        for i, (b, w) in enumerate(zip(blocks, want_blocks)):
            block_rows = rows[i * per:i * per + len(b)]
            check_answers(f"batch inference block {i}", [
                {"token_ids": r["token_ids"], "text": r["generated_text"],
                 "finish_reason": r["finish_reason"]} for r in block_rows], w)
        bi_launches = rt.get(eng.kernel_launches.remote(),
                             timeout=PD_TIMEOUT_S)
        if bi_launches["flash_attention_fwd"] <= 0:
            raise AssertionError(f"the engine actor's launches {bi_launches}")
        em = rt.get(eng.memory_stats.remote(), timeout=PD_TIMEOUT_S)
        tokens = sum(len(r["token_ids"]) for r in rows)
        metrics.update(batch_rows=len(rows), batch_wall_s=wall,
                       batch_rows_per_s=len(rows) / wall,
                       batch_tokens_per_s=tokens / wall,
                       engine_actor_peak_bytes=em["max_allocated_bytes"],
                       batch_flash_fwd_launches=bi_launches[
                           "flash_attention_fwd"])
        log(f"pd and batch inference: {len(rows)} rows in order, each of "
            f"{len(blocks)} blocks equal to an in-process generate token "
            f"for token; engine actor flash_fwd launches "
            f"{bi_launches['flash_attention_fwd']}")
        proc.shutdown()

        # --- device batches ----------------------------------------------
        ds = rd.range(DEVICE_BATCH_ROWS, parallelism=8).map_batches(
            lambda b: {"x": b["id"].astype(np.float32) * 0.5,
                       "y": b["id"] % 7}).materialize()
        host = list(ds.iter_batches(batch_size=DEVICE_BATCH_SIZE))
        nbytes = sum(v.nbytes for b in host for v in b.values())
        stall0 = goodput.snapshot()["buckets"]["input_stall"]
        t0 = time.perf_counter()
        on_card = list(ds.iter_device_batches(batch_size=DEVICE_BATCH_SIZE,
                                              device_prefetch=2))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stall = goodput.snapshot()["buckets"]["input_stall"] - stall0
        if len(on_card) != len(host):
            raise AssertionError(f"{len(on_card)} device batches, "
                                 f"{len(host)} host batches")
        for d, h in zip(on_card, host):
            for k, v in h.items():
                if not d[k].is_cuda or not torch.equal(
                        d[k].cpu(), torch.from_numpy(v)):
                    raise AssertionError(f"device batch column {k} differs "
                                         f"from iter_batches")
        metrics.update(device_batches=len(on_card), device_batch_bytes=nbytes,
                       device_batch_s=wall,
                       device_batch_gb_s=nbytes / wall / 1e9,
                       input_stall_share=stall / wall)
        log(f"pd and batch inference: {len(on_card)} device batches "
            f"({nbytes / 1e6:.1f} MB) equal to iter_batches on the card")
        del on_card
    finally:
        try:
            serve.shutdown()
        finally:
            rt.shutdown()
    log("pd batch metrics: " + json.dumps(metrics))
    return {"pd": pd_launches, "batch_inference": bi_launches}


FT_TIMEOUT_S = 300.0  # each cluster call's
FT_CANCEL_AFTER = 4  # tokens the cancelled stream yields before the cancel
FT_CANCEL_TOKENS = 512  # the cancelled stream's budget: it would run ~10 s
FT_TREE_LAYERS = 4  # the tree of (c), (d), (e): the 1b's params at 4 of its
# 16 layers (1.28 GB): the host paths' seconds scale with its bytes
FT_SPILL_STORE = 1 << 30  # (d)'s store: below the 1.28 GB tree
FT_STORE_MAX = 8 << 30  # the other stores: at most this, or a third of
# /dev/shm's free bytes
FT_CKPT = "ft_1b"  # the object-plane checkpoint's store and vault


class FaultServer:
    """Phase 19's actor: phase 9's 1b ``LLMServer`` (seed 0) in a worker of
    the port's runtime, created with ``max_restarts=1``."""

    def __init__(self):
        import torch

        from ray_tpu_torch.llm import LLMConfig, LLMServer

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.server = LLMServer(LLMConfig(model_id="1b"), seed=0,
                                device="cuda")
        torch.cuda.synchronize()

    def ready(self) -> dict:
        """This incarnation's pid and the cards its lease is bound to."""
        return {"pid": os.getpid(),
                "cards": os.environ.get("CUDA_VISIBLE_DEVICES")}

    def complete(self, prompt: str) -> dict:
        out = asyncio.run(self.server.completions(prompt,
                                                  max_tokens=SERVE_TOKENS))
        return {k: out[k] for k in ("token_ids", "text", "finish_reason")}

    def answer(self, prompts) -> dict:
        """Phase 9's round in this worker: every prompt at once for 2 tokens
        to warm up, then for SERVE_TOKENS, the launch counters set to 0
        just before and read just after."""
        import torch

        server = self.server

        async def answer_all(max_tokens):
            return await asyncio.gather(*(
                server.completions(p, max_tokens=max_tokens)
                for p in prompts))

        asyncio.run(answer_all(2))
        torch.cuda.synchronize()
        server.kernel_launches(reset=True)
        t0 = time.perf_counter()
        out = asyncio.run(answer_all(SERVE_TOKENS))
        torch.cuda.synchronize()
        return {"answers": [{k: o[k] for k in ("token_ids", "text",
                                                "finish_reason")}
                            for o in out],
                "wall_s": time.perf_counter() - t0,
                "launches": server.kernel_launches(),
                "peak_bytes": torch.cuda.max_memory_allocated()}

    def stream(self, prompt: str, max_tokens: int):
        """One greedy request's tokens, each yielded as the engine emits it
        (called with ``num_returns="streaming"``); a stream closed early
        aborts its request."""
        import uuid

        from ray_tpu_torch.llm import SamplingParams

        engine = self.server.engine
        rid = uuid.uuid4().hex
        engine.add_request(rid, prompt, SamplingParams(max_tokens=max_tokens))
        sent, done = 0, False
        try:
            while not done and engine.has_unfinished():
                for out in engine.step():
                    if out.request_id == rid:
                        yield from out.token_ids[sent:]
                        sent, done = len(out.token_ids), out.finished
        finally:
            if not done:
                engine.abort_request(rid)

    def traced(self, tag: str) -> int:
        """Record one span in this worker and ship it to the GCS now (the
        timer would within a second); its pid."""
        from ray_tpu_torch.util import tracing

        with tracing.profile("runtime_ft.actor_span", tag=tag):
            pass
        tracing.flush()
        return os.getpid()


def card_params(seed: int) -> dict:
    """The 1b's fp32 params at FT_TREE_LAYERS of its layers from ``seed``,
    drawn on the card as phase 17 draws a version, as numpy on the host;
    with the pid, the cards and the peak device memory of the process that
    drew them."""
    import torch

    from ray_tpu_torch.llm import LLMConfig
    from ray_tpu_torch.models.convert import init_params

    cfg = dataclasses.replace(LLMConfig(model_id="1b").transformer_config(),
                              n_layers=FT_TREE_LAYERS)
    params = {k: v.cpu().numpy() for k, v in init_params(
        cfg, seed=seed, device="cuda").items()}
    return {"params": params, "pid": os.getpid(),
            "cards": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "peak_bytes": torch.cuda.max_memory_allocated()}


def check_same_bits(label: str, got: dict, want: dict) -> None:
    import numpy as np

    if sorted(got) != sorted(want):
        raise AssertionError(f"{label}: leaves {sorted(got)[:3]}... are not "
                             f"the tree's")
    for k, w in want.items():
        g = np.asarray(got[k])
        if g.dtype != w.dtype or g.shape != w.shape or not np.array_equal(
                g.view(np.uint8), w.view(np.uint8)):
            raise AssertionError(f"{label}: leaf {k} is not bit-equal")


def actor_restarted(actor, restarts: int) -> bool:
    """The GCS holds the actor alive after ``restarts`` restarts."""
    from ray_tpu_torch.util import state

    rec, = [a for a in state.list_actors()
            if a["actor_id"] == actor._actor_id.hex()]
    return rec["state"] == "ALIVE" and rec["restarts_used"] == restarts


def process_gone(pid: int) -> bool:
    """``pid`` has exited: no such process, or a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except FileNotFoundError:
        return True


def phase_runtime_faults(card: str, serving: dict) -> dict:
    """Phase 19: the runtime's fault paths on the card: an actor restart,
    streaming and cancel, a pull across two raylets, spilling, an
    object-plane checkpoint and a worker's spans."""
    import gc
    import shutil
    import tempfile

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import ckpt
    from ray_tpu_torch._private import wire
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.exceptions import TaskCancelledError
    from ray_tpu_torch.util import state, tracing
    from ray_tpu_torch.util.accelerators import detect_gpu_ids

    gc.collect()
    torch.cuda.empty_cache()
    phase_t0 = time.perf_counter()
    prompts = serving["prompts"]
    want = in_process_answers(0, prompts)
    metrics = {"card": card}
    shm = shm_bytes()
    store_mem = max(4 << 30, min(FT_STORE_MAX, shm["free"] // 3))
    metrics.update(dev_shm_free_bytes=shm["free"],
                   object_store_memory=store_mem)
    cards = detect_gpu_ids()[0]

    # --- one node, the card as GPU, tracing on in every process ---------
    os.environ["RAY_TPU_ENABLE_TRACING"] = "1"
    tracing.enable()
    t0 = time.perf_counter()
    rt.init(num_cpus=8, object_store_memory=store_mem)
    metrics["init_s"] = time.perf_counter() - t0
    try:
        # (a) a restart: killed, back on the card, serving again
        server_cls = rt.remote(num_gpus=1, max_restarts=1)(FaultServer)
        t0 = time.perf_counter()
        server = server_cls.remote()
        first = rt.get(server.ready.remote(), timeout=FT_TIMEOUT_S)
        metrics["actor_ready_s"] = time.perf_counter() - t0
        one = rt.get(server.answer.remote(prompts), timeout=FT_TIMEOUT_S)
        check_answers("restart: first incarnation", one["answers"], want)

        t_kill = time.perf_counter()
        rt.kill(server, no_restart=False)
        deadline = t_kill + FT_TIMEOUT_S
        while not actor_restarted(server, 1):
            if time.perf_counter() > deadline:
                raise AssertionError("the actor did not come back")
            time.sleep(0.05)
        again = rt.get(server.ready.remote(), timeout=FT_TIMEOUT_S)
        metrics["kill_to_ready_s"] = time.perf_counter() - t_kill
        if again["pid"] == first["pid"] or not process_gone(first["pid"]):
            raise AssertionError(f"pid {first['pid']} -> {again['pid']}: the "
                                 f"old worker has not exited")
        if first["cards"] not in cards or again["cards"] not in cards:
            raise AssertionError(f"the incarnations' cards {first['cards']}, "
                                 f"{again['cards']}, not detected {cards}")
        answered = rt.get(server.complete.remote(prompts[0]),
                          timeout=FT_TIMEOUT_S)
        metrics["kill_to_first_answer_s"] = time.perf_counter() - t_kill
        check_answers("restart: first answer", [answered], want[:1])
        two = rt.get(server.answer.remote(prompts), timeout=FT_TIMEOUT_S)
        check_answers("restart: second incarnation", two["answers"], want)
        launched = two["launches"]
        if launched["flash_attention_fwd"] <= 0:
            raise AssertionError(f"the restarted worker's launches {launched}")
        metrics.update(round_wall_s=[one["wall_s"], two["wall_s"]],
                       actor_pids=[first["pid"], again["pid"]],
                       actor_cards=[first["cards"], again["cards"]],
                       actor_peak_bytes=[one["peak_bytes"],
                                         two["peak_bytes"]],
                       flash_fwd_launches=[one["launches"][
                           "flash_attention_fwd"],
                           launched["flash_attention_fwd"]])
        log(f"runtime faults: a num_gpus=1 actor killed (no_restart=False) "
            f"was back on card {again['cards']} as pid {again['pid']} "
            f"{metrics['kill_to_ready_s']:.2f} s later (pid {first['pid']} "
            f"gone) and answered {metrics['kill_to_first_answer_s']:.2f} s "
            f"after the kill; both incarnations' {len(prompts)} answers "
            f"equal in-process serving token for token; flash_fwd launches "
            f"{metrics['flash_fwd_launches']}")

        # (b) streaming, and a cancelled stream
        t0 = time.perf_counter()
        streamed = [rt.get(r, timeout=FT_TIMEOUT_S) for r in
                    server.stream.options(num_returns="streaming").remote(
                        prompts[0], SERVE_TOKENS)]
        metrics["stream_s"] = time.perf_counter() - t0
        if streamed != serving["token_ids"][0]:
            raise AssertionError(f"streamed {streamed[:8]}..., phase 9 "
                                 f"answered {serving['token_ids'][0][:8]}...")
        gen = server.stream.options(num_returns="streaming").remote(
            prompts[0], FT_CANCEL_TOKENS)
        head = [rt.get(next(gen), timeout=FT_TIMEOUT_S)
                for _ in range(FT_CANCEL_AFTER)]
        if head != serving["token_ids"][0][:FT_CANCEL_AFTER]:
            raise AssertionError(f"the second stream began {head}")
        t0 = time.perf_counter()
        rt.cancel(gen)
        tail = []
        try:
            for ref in gen:
                tail.append(rt.get(ref, timeout=FT_TIMEOUT_S))
            cancelled = False
        except TaskCancelledError:
            cancelled = True
        metrics["cancel_s"] = time.perf_counter() - t0
        if not cancelled or FT_CANCEL_AFTER + len(tail) >= FT_CANCEL_TOKENS:
            raise AssertionError(f"the cancelled stream went on for "
                                 f"{len(tail)} more tokens and ended "
                                 f"without the cancel error")
        after = rt.get(server.complete.remote(prompts[1]),
                       timeout=FT_TIMEOUT_S)
        check_answers("after the cancel", [after], want[1:2])
        metrics["cancelled_stream_tokens"] = FT_CANCEL_AFTER + len(tail)
        log(f"runtime faults: {len(streamed)} streamed tokens equal phase "
            f"9's; a stream cancelled after {FT_CANCEL_AFTER} tokens "
            f"({len(tail)} more arrived) raised TaskCancelledError in "
            f"{metrics['cancel_s']:.3f} s and the actor answered again")

        # (f) a span recorded in the GPU actor reaches the driver
        tag = os.urandom(4).hex()
        pid = rt.get(server.traced.remote(tag), timeout=FT_TIMEOUT_S)
        spans = [sp for sp in tracing.get_spans()
                 if sp["name"] == "runtime_ft.actor_span"
                 and sp.get("tag") == tag]
        events = [e for e in state.get_timeline()["traceEvents"]
                  if e["name"] == "runtime_ft.actor_span"
                  and e["args"].get("tag") == tag]
        if [sp["pid"] for sp in spans] != [pid] or \
                [e["pid"] for e in events] != [pid]:
            raise AssertionError(f"the actor's span: {spans} in get_spans, "
                                 f"{events} in the timeline")
        log(f"runtime faults: the GPU actor's span (pid {pid}) is in the "
            f"driver's get_spans() and the GCS timeline")
        rt.kill(server)

        # (e) the 1b's params checkpointed through the object plane
        t0 = time.perf_counter()
        drawn = card_params(0)
        tree = drawn["params"]
        nbytes = sum(v.nbytes for v in tree.values())
        metrics.update(tree_bytes=nbytes,
                       tree_on_host_s=time.perf_counter() - t0)
        root = tempfile.mkdtemp(prefix="chip_smoke_ft_")
        try:
            backend = ckpt.ObjectPlaneBackend(FT_CKPT)
            store = ckpt.TieredStore(os.path.join(root, FT_CKPT),
                                     name=FT_CKPT, mirror=False,
                                     backend=backend)
            t0 = time.perf_counter()
            man = ckpt.save_checkpoint(store, tree, step=0)
            t1 = time.perf_counter()
            store.mirror_now(man.ckpt_id)
            t2 = time.perf_counter()
            store.evict_local(man.ckpt_id)
            restored = ckpt.restore_tree(store, man.ckpt_id)
            t3 = time.perf_counter()
            check_same_bits("object-plane checkpoint", restored, tree)
            fetched = store.io.counters["fetch_chunks"]
            if fetched != len(man.chunk_set()) or \
                    backend.list_chunks() != man.chunk_set():
                raise AssertionError(f"{fetched} chunks fetched from the "
                                     f"vault for {len(man.chunk_set())}")
            del restored
            listed = state.list_checkpoints().get(FT_CKPT)
            if listed is None or listed["latest"] != man.ckpt_id or \
                    listed["tier"]["residency_summary"] != {"evicted": 1}:
                raise AssertionError(f"list_checkpoints: {listed}")
            metrics.update(ckpt_save_s=t1 - t0, ckpt_mirror_s=t2 - t1,
                           ckpt_mirror_gb_s=nbytes / (t2 - t1) / 1e9,
                           ckpt_restore_s=t3 - t2,
                           ckpt_restore_gb_s=nbytes / (t3 - t2) / 1e9,
                           ckpt_chunks=fetched)
            store.close()
        finally:
            shutil.rmtree(root, ignore_errors=True)
        log(f"runtime faults: {nbytes / 1e9:.3f} GB of params in {fetched} "
            f"chunks mirrored to the object-plane vault in "
            f"{metrics['ckpt_mirror_s']:.2f} s, evicted locally and restored "
            f"from the vault bit-equal in {metrics['ckpt_restore_s']:.2f} s; "
            f"list_checkpoints shows {FT_CKPT}")
    finally:
        rt.shutdown()
        os.environ.pop("RAY_TPU_ENABLE_TRACING", None)
        tracing.disable()

    # (c) two nodes: the card on the second, the driver on the head
    cluster = Cluster(head_node_args={"resources": {"CPU": 4.0, "GPU": 0.0},
                                      "object_store_memory": store_mem})
    try:
        cluster.add_node(resources={"CPU": 2.0, "GPU": 1.0},
                         object_store_memory=store_mem)
        rt.init(address=cluster.address)
        cluster.wait_for_nodes(2)
        head = global_worker().node_hex
        task = rt.remote(num_gpus=1)(card_params)
        t0 = time.perf_counter()
        ref = task.remote(0)
        rt.wait([ref], timeout=FT_TIMEOUT_S)
        t1 = time.perf_counter()
        got = rt.get(ref, timeout=FT_TIMEOUT_S)
        t2 = time.perf_counter()
        check_same_bits("pulled across raylets", got["params"], tree)
        gpus = {n["node_id"]: n["total_resources"].get("GPU", 0.0)
                for n in rt.nodes() if n["alive"]}
        if got["cards"] not in cards or gpus.get(head) != 0.0 or \
                sorted(gpus.values()) != [0.0, 1.0]:
            raise AssertionError(f"the task ran on cards {got['cards']}; "
                                 f"GPUs by node {gpus}, head {head}")
        metrics.update(remote_task_s=t1 - t0, pull_s=t2 - t1,
                       pull_gb_s=nbytes / (t2 - t1) / 1e9,
                       remote_task_peak_bytes=got["peak_bytes"])
        del got, ref
        log(f"runtime faults: a num_gpus=1 task on the second node returned "
            f"the 1b's params in {t1 - t0:.2f} s; the head pulled "
            f"{nbytes / 1e9:.3f} GB across raylets bit-equal in "
            f"{t2 - t1:.2f} s ({metrics['pull_gb_s']:.3f} GB/s)")
    finally:
        rt.shutdown()
        cluster.shutdown()

    # (d) a store smaller than the tree: its leaves spill and restore
    rt.init(num_cpus=2, num_gpus=0, object_store_memory=FT_SPILL_STORE)
    try:
        raylet = global_worker().raylet
        t0 = time.perf_counter()
        refs = {k: rt.put(v) for k, v in tree.items()}
        t1 = time.perf_counter()
        for k, r in refs.items():
            check_same_bits("spilled and restored",
                            {k: rt.get(r, timeout=FT_TIMEOUT_S)},
                            {k: tree[k]})
        t2 = time.perf_counter()
        stats = wire.loads(global_worker()._run(
            raylet.call("StoreStats", b"")))
        if stats["num_spilled"] <= 0 or stats["num_restored"] <= 0:
            raise AssertionError(f"nothing spilled: {stats}")
        metrics.update(spill_store_bytes=FT_SPILL_STORE, spill_put_s=t1 - t0,
                       spill_gb_s=nbytes / (t1 - t0) / 1e9,
                       restore_s=t2 - t1,
                       restore_gb_s=nbytes / (t2 - t1) / 1e9,
                       num_spilled=stats["num_spilled"],
                       num_restored=stats["num_restored"])
        del refs
        log(f"runtime faults: {len(tree)} leaves ({nbytes / 1e9:.3f} GB) put "
            f"into a {FT_SPILL_STORE / 2**30:.0f} GiB store in {t1 - t0:.2f} "
            f"s ({stats['num_spilled']} spills), read back bit-equal in "
            f"{t2 - t1:.2f} s ({stats['num_restored']} restores)")
    finally:
        rt.shutdown()
    metrics["phase_s"] = time.perf_counter() - phase_t0
    log("runtime ft metrics: " + json.dumps(metrics))
    return launched


PIPE_STAGES = 2
PIPE_MICROBATCHES = 4  # of PIPE_MB_SIZE x TRAIN_SEQ: phase 4's 4 x 2048
PIPE_MB_SIZE = 1
PIPE_STEPS = 3
PIPE_DEPTH = 2  # channel slots an edge: a send overlaps the next compute
PIPE_SEED = 0  # the initial weights' (drawn on the card as phase 4 draws)
PIPE_BATCH_SEED = 0  # make_microbatches' seed
PIPE_TIMEOUT_S = 600.0  # each cluster call's
# The pipeline's step t against the one-device step on the concatenated
# batch, same initial params, same optimizer (make_stage_optimizer's
# warmup-cosine AdamW with the controller's global-norm clip of 1.0, as
# make_optimizer's chain). The pipeline's loss is the mean of the four
# microbatches' losses, each from the same modules and products at batch
# 1 x 2048 as a one-device forward of that microbatch (the hop copies the
# bf16 activation and its gradient exactly), so its distance to the
# one-device step's loss is:
# - the forward's microbatching term: delta_t = |eval(batch) - mean_j
#   eval(mb_j)|, measured on the reference's own params at step t (other
#   GEMM tilings at batch 1 and 4: fp32 sums in other orders, bf16
#   roundings that fall apart); counted twice (the pipeline's forwards may
#   round apart from the one-device microbatch forwards as much again);
# - the fp32 means: the token mean (log2 of the tokens' count roundings of
#   2^-24) and the mean of 4 means, PIPE_MEAN_ROUNDINGS units of 2^-24 |L|;
# - the updates before step t: AdamW moves an element by at most
#   lr_s ADAM_RATIO (|m_hat| <= sqrt(v_hat) for b1 = 0.9, b2 = 0.95 stays
#   below 1.2 x) plus the decay, so two runs whose gradients round apart
#   part by at most 2 ADAM_RATIO lr_s an element and a step, which moves
#   the loss by at most that times ||g_t||_1 (first order; ||g_t||_1 of
#   the reference's gradient at its step-t params, measured). The schedule
#   gives lr_0 = 0: steps 0 and 1 run the same params on both sides.
# That loss bound is loose (first order, every element at its worst), so
# the gradients and the updates are held too, against the one-device run's
# own microbatching: the reference also trains a second copy of the same
# initial params, each step on the mean of the four microbatches'
# gradients (g_m, batch 1 each) where the first copy takes the gradient of
# the concatenated batch (g_w, batch 4). The pipeline computes g_m's sum
# in its stages (the same modules at batch 1; the hop copies activations
# and their gradients exactly), so it parts from the one-device
# microbatched run by rounding at most as far as that run parts from the
# whole-batch one, and by the triangle inequality:
# - the global norm before the clip at steps 0 and 1 (the same params on
#   all sides): |norm_pipe - |g_w|| <= 2 |g_w - g_m| plus fp32 roundings of
#   both norms, PIPE_NORM_ROUNDINGS units of 2^-24 |g_w| (log2 of a leaf's
#   2^27 squares, of ~150 leaves' sum, the root and the division by 4;
#   twice);
# - each stage's parameters after PIPE_STEPS steps:
#   |p_pipe - p_w| <= 2 |p_m - p_w| plus PIPE_PARAM_ROUNDINGS units of
#   2^-24 |p_w| (the decay's and the step's rounding a step, on each side).
# Both bounds are measured in the run, and the updates' own size |p_w - p_0|
# beside them says what they can see: a stage that skipped its update, or
# took it with the sign flipped, parts from p_w by |p_w - p_0| or twice it.
PIPE_ADAM_RATIO = 1.2
PIPE_MEAN_ROUNDINGS = 13 + 4  # log2(8192) + the mean of 4 microbatches
PIPE_NORM_ROUNDINGS = 2 * (27 + 8 + 2)
PIPE_PARAM_ROUNDINGS = 2 * 2 * 3  # PIPE_STEPS steps
DAG_ITERS = 200  # timed iterations of the compiled and the eager chain


def phase_pipeline(card: str) -> dict:
    """Phase 20: the pipeline plane and compiled graphs on the port's
    runtime (the ``pipeline`` path)."""
    import gc
    import statistics

    import numpy as np
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.models import CONFIGS
    from ray_tpu_torch.parallel import TrainStepBundle, make_optimizer
    from ray_tpu_torch.train.pipeline import (PipelineConfig,
                                              PipelineTrainer,
                                              bubble_upper_bound,
                                              make_microbatches,
                                              partition_layers)
    from ray_tpu_torch.train.pipeline.partition import (make_stage_optimizer,
                                                        stage_param_keys,
                                                        top_key)

    cfg = CONFIGS[TRAIN_CONFIG]
    act_bytes = PIPE_MB_SIZE * TRAIN_SEQ * cfg.d_model * 2  # bf16
    pipe = PipelineConfig(
        num_stages=PIPE_STAGES, num_microbatches=PIPE_MICROBATCHES,
        microbatch_size=PIPE_MB_SIZE, seq_len=TRAIN_SEQ,
        clip_global_norm=1.0, channel_depth=PIPE_DEPTH,
        channel_capacity=act_bytes + (1 << 16), step_timeout_s=PIPE_TIMEOUT_S)
    metrics = {"card": card, "config": TRAIN_CONFIG,
               "stages": PIPE_STAGES, "microbatches": PIPE_MICROBATCHES,
               "microbatch": [PIPE_MB_SIZE, TRAIN_SEQ], "steps": PIPE_STEPS,
               "channel_depth": PIPE_DEPTH,
               "channel_capacity": pipe.channel_capacity}
    gc.collect()
    torch.cuda.empty_cache()

    # -- the reference: the one-device step on the concatenated batch ----
    t0 = time.perf_counter()
    opt = make_stage_optimizer()
    bundle = TrainStepBundle(cfg, device="cuda", optimizer=make_optimizer(
        learning_rate=opt.learning_rate, weight_decay=opt.weight_decay,
        warmup_steps=opt.warmup_steps, total_steps=opt.total_steps,
        b1=opt.b1, b2=opt.b2, clip=pipe.clip_global_norm))
    params, opt_state = bundle.init(seed=PIPE_SEED)
    init = {k: v.detach().to("cpu", copy=True) for k, v in params.items()}
    # the microbatched copy (PIPE_NORM_ROUNDINGS' note); the bundle computes
    # on its own tensors, ``params``, and copies a dict it is given into
    # them, so the whole-batch run's are kept aside while it does
    params_m = {k: v.detach().clone() for k, v in params.items()}
    opt_state_m = bundle.optimizer.init(params_m)

    def on_card(mb):
        return {"tokens": torch.from_numpy(mb["tokens"]).long().cuda(),
                "targets": torch.from_numpy(mb["targets"]).long().cuda(),
                "mask": torch.from_numpy(mb["mask"]).cuda()}

    def norm(xs):
        """The global norm of the tensors ``xs`` yields, one at a time."""
        return torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(x) for x in xs])).item()

    ref_losses, deltas, g1, ref_gnorm, ref_step_s = [], [], [], [], []
    grad_mb_dist = []  # |g_w - g_m| at the steps with the same params
    for step in range(PIPE_STEPS):
        mbs = make_microbatches(cfg, pipe, PIPE_BATCH_SEED, step)
        batch = on_card({k: np.concatenate([m[k] for m in mbs])
                         for k in mbs[0]})
        whole = bundle.eval_step(params, batch).item()
        parts = float(np.mean([bundle.eval_step(params, on_card(m)).item()
                               for m in mbs]))
        deltas.append(abs(whole - parts))
        _, grads = bundle.gradients(params, batch)
        g1.append(sum(g.abs().sum().item() for g in grads.values()))
        ref_gnorm.append(norm(grads.values()))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss = bundle.step(params, opt_state, batch)[2].item()
        ref_step_s.append(time.perf_counter() - t1)
        ref_losses.append(loss)
        kept = {k: v.detach().clone() for k, v in params.items()}
        grads_m = None
        for m in mbs:
            g = bundle.gradients(params_m, on_card(m))[1]
            if grads_m is None:
                grads_m = g
            else:
                torch._foreach_add_(list(grads_m.values()), list(g.values()))
            del g
        torch._foreach_div_(list(grads_m.values()), float(len(mbs)))
        if step < 2:  # lr_0 = 0: the same params on both sides
            grad_mb_dist.append(norm(grads[k] - grads_m[k]
                                     for k in grads))
        del grads
        bundle.optimizer.update(params_m, [grads_m[k] for k in params_m],
                                opt_state_m)
        del grads_m
        with torch.no_grad():
            for k, v in kept.items():
                params[k].copy_(v)
        del kept
    stage_keys = [set(stage_param_keys(cfg, s, PIPE_STAGES))
                  for s in range(PIPE_STAGES)]

    def stage_norms(tree, minus=None):
        """Each stage's |tree - minus| over its leaves, leaf by leaf on the
        card."""
        return [norm((tree[k].cuda() if minus is None
                      else tree[k].cuda() - minus[k].cuda())
                     for k in tree if top_key(k) in keys)
                for keys in stage_keys]

    final_w = {k: v.detach().to("cpu", copy=True) for k, v in params.items()}
    update_norm = stage_norms(params, init)  # |p_w - p_0|
    param_w_norm = stage_norms(params)
    param_mb_dist = stage_norms(params_m, params)
    metrics["reference_s"] = time.perf_counter() - t0
    del bundle, params, opt_state, params_m, opt_state_m, batch
    gc.collect()
    torch.cuda.empty_cache()
    grad_bounds = [2 * grad_mb_dist[t] + PIPE_NORM_ROUNDINGS * 2.0 ** -24
                   * ref_gnorm[t] for t in range(2)]
    param_bounds = [2 * param_mb_dist[s] + PIPE_PARAM_ROUNDINGS
                    * 2.0 ** -24 * param_w_norm[s]
                    for s in range(PIPE_STAGES)]
    log(f"pipeline: the microbatched reference: |g_w - g_m| at steps 0, 1 "
        f"{grad_mb_dist} (|g_w| {ref_gnorm[:2]}), bounds on the pipeline's "
        f"norm {grad_bounds}; by stage after {PIPE_STEPS} steps |p_m - p_w| "
        f"{param_mb_dist}, bounds on |p_pipe - p_w| {param_bounds}, the "
        f"updates |p_w - p_0| {update_norm}")
    lrs = [opt.schedule(s) for s in range(PIPE_STEPS)]
    bounds = [2 * deltas[t] + PIPE_MEAN_ROUNDINGS * 2.0 ** -24
              * abs(ref_losses[t])
              + 2 * PIPE_ADAM_RATIO * sum(lrs[:t]) * g1[t]
              for t in range(PIPE_STEPS)]
    log(f"pipeline: one-device reference of {TRAIN_CONFIG} at "
        f"{PIPE_MICROBATCHES * PIPE_MB_SIZE} x {TRAIN_SEQ}: losses "
        f"{ref_losses}, microbatching deltas {deltas}, lr {lrs}, ||g||_1 "
        f"{g1}; bounds 2 delta + {PIPE_MEAN_ROUNDINGS} 2^-24 |L| + 2 x "
        f"{PIPE_ADAM_RATIO} sum(lr before) ||g||_1 = {bounds}")

    shm = shm_bytes()
    store_mem = max(1 << 30, min(SERVE_STORE_MAX, shm["free"] // 2))
    metrics["object_store_memory"] = store_mem
    t0 = time.perf_counter()
    rt.init(num_cpus=8, object_store_memory=store_mem)
    metrics["init_s"] = time.perf_counter() - t0
    try:
        # -- a compiled graph of three host actors, on the fresh cluster
        @rt.remote(num_cpus=0.3)
        class Stage:
            def __init__(self, add):
                self.add = add

            def apply(self, x):
                return x + self.add

        eager_actors = [Stage.remote(a) for a in (1, 10, 100)]

        def eager(i):
            s1, s2, s3 = eager_actors
            return rt.get(s3.apply.remote(s2.apply.remote(s1.apply.remote(i))),
                          timeout=60)

        with InputNode() as inp:
            c1, c2, c3 = Stage.bind(1), Stage.bind(10), Stage.bind(100)
            dag = c3.apply.bind(c2.apply.bind(c1.apply.bind(inp)))
        t0 = time.perf_counter()
        compiled = dag.experimental_compile()
        metrics["dag_compile_s"] = time.perf_counter() - t0
        try:
            times = {"eager": [], "compiled": []}
            for i in range(-1, DAG_ITERS):  # the first of each is a warm-up
                for label, run in (("eager", eager), ("compiled", lambda j:
                                                      compiled.execute(j)
                                                      .get(timeout=60))):
                    t1 = time.perf_counter()
                    got = run(i)
                    if i >= 0:
                        times[label].append(time.perf_counter() - t1)
                    if got != i + 111:
                        raise AssertionError(f"{label} chain gave {got} for "
                                             f"{i}, want {i + 111}")
        finally:
            compiled.teardown()
            for a in eager_actors:
                rt.kill(a)

        # -- the pipeline: two half-card stage actors ------------------
        t0 = time.perf_counter()
        trainer = PipelineTrainer(
            cfg, pipe, params=init, seed=PIPE_BATCH_SEED,
            device="cuda",
            optimizer_factory=make_stage_optimizer)
        metrics["trainer_up_s"] = time.perf_counter() - t0
        del init
        try:
            actors = trainer.actors
            rt.get([a.kernel_launches.remote(reset=True) for a in actors],
                   timeout=PIPE_TIMEOUT_S)
            rt.get([a.memory_stats.remote(reset=True) for a in actors],
                   timeout=PIPE_TIMEOUT_S)
            stats = trainer.train(PIPE_STEPS)
            stage_launches = rt.get([a.kernel_launches.remote()
                                     for a in actors], timeout=PIPE_TIMEOUT_S)
            memory = rt.get([a.memory_stats.remote() for a in actors],
                            timeout=PIPE_TIMEOUT_S)
            t1 = time.perf_counter()
            final_pipe = trainer.merged_params()
            metrics["merged_params_s"] = time.perf_counter() - t1
        finally:
            trainer.shutdown()
    finally:
        rt.shutdown()

    losses = [s["loss"] for s in stats]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"pipeline losses not finite: {losses}")
    errs = [abs(a - b) for a, b in zip(losses, ref_losses)]
    if not all(e <= b for e, b in zip(errs, bounds)):
        raise AssertionError(f"pipeline losses {losses} part from the "
                             f"one-device step's {ref_losses} by {errs}, "
                             f"beyond the bounds {bounds}")
    grad_norm = [s["grad_norm"] for s in stats]
    grad_errs = [abs(grad_norm[t] - ref_gnorm[t]) for t in range(2)]
    if not all(e <= b for e, b in zip(grad_errs, grad_bounds)):
        raise AssertionError(f"pipeline gradient norms {grad_norm[:2]} part "
                             f"from the one-device step's {ref_gnorm[:2]} by "
                             f"{grad_errs}, beyond the bounds {grad_bounds}")
    if set(final_pipe) != set(final_w):
        raise AssertionError(f"the pipeline's merged params have keys "
                             f"{sorted(set(final_pipe) ^ set(final_w))} "
                             f"that the model does not, or lack them")
    param_errs = stage_norms(final_pipe, final_w)
    del final_pipe, final_w
    if not all(e <= b for e, b in zip(param_errs, param_bounds)):
        raise AssertionError(f"pipeline stages' params after {PIPE_STEPS} "
                             f"steps part from the one-device run's by "
                             f"{param_errs}, beyond the bounds "
                             f"{param_bounds} (the updates: {update_norm})")
    per_mb = []  # each stage's launches a step
    remat = 2 if cfg.remat else 1
    for s, (start, stop) in enumerate(partition_layers(cfg.n_layers,
                                                       PIPE_STAGES)):
        L = stop - start
        fwd = L * remat + (0 if s == PIPE_STAGES - 1 else L)
        per_mb.append({"flash_attention_fwd": fwd, "attention_bwd_prep": L,
                       "flash_attention_bwd": L,
                       "flash_attention_bwd_dq": 0,
                       "flash_attention_bwd_dkv": 0,
                       "flash_bwd_delta": 0})
    for s, got in enumerate(stage_launches):
        want = {k: v * PIPE_MICROBATCHES * PIPE_STEPS
                for k, v in per_mb[s].items()}
        if got != want:
            raise AssertionError(f"pipeline stage {s} launched {got}, want "
                                 f"{want}")
        if not all(got[k] > 0 for k in ("flash_attention_fwd",
                                         "attention_bwd_prep",
                                         "flash_attention_bwd")):
            raise AssertionError(f"pipeline stage {s} did not launch every "
                                 f"kernel: {got}")
    launches = {k: sum(g[k] for g in stage_launches)
                for k in stage_launches[0]}

    def median(xs):
        xs = sorted(xs)
        return xs[len(xs) // 2]

    M = PIPE_MICROBATCHES
    timings = trainer.timings
    last = stats[1:]  # the first step is the stages' warm-up
    metrics.update({
        "losses": losses, "reference_losses": ref_losses,
        "loss_errors": errs, "loss_bounds": bounds,
        "microbatching_deltas": deltas, "grad_l1": g1, "lr": lrs,
        "grad_norm": grad_norm, "reference_grad_norm": ref_gnorm,
        "grad_norm_errors": grad_errs, "grad_norm_bounds": grad_bounds,
        "grad_microbatching_dist": grad_mb_dist,
        "param_errors_by_stage": param_errs,
        "param_bounds_by_stage": param_bounds,
        "param_microbatching_dist_by_stage": param_mb_dist,
        "update_norm_by_stage": update_norm,
        "stages_ready_s": timings["ready_s"],
        "publish_s": timings["publish_s"],
        "publish_bytes": timings["publish_bytes"],
        "publish_gb_per_s": timings["publish_bytes"] / timings["publish_s"]
        / 1e9,
        "pull_s": timings["pull_s"],
        "pull_gb_per_s": timings["publish_bytes"] / timings["pull_s"] / 1e9,
        "step_s": [s["step_s"] for s in stats],
        "step_s_median": median([s["step_s"] for s in last]),
        "reference_step_s": ref_step_s,
        "tokens_per_s": M * PIPE_MB_SIZE * TRAIN_SEQ
        / median([s["step_s"] for s in last]),
        "reference_tokens_per_s": M * PIPE_MB_SIZE * TRAIN_SEQ
        / median(ref_step_s[1:]),
        "idle_share": [[1.0 - c / s["wall_s"] for c in s["compute_s"]]
                       for s in stats],
        "recv_wait_share": [[r / s["wall_s"] for r in s["recv_wait_s"]]
                            for s in stats],
        "bubble_upper_bound": bubble_upper_bound(PIPE_STAGES, M),
        "activation_bytes_per_mb": stats[-1]["activation_bytes_per_mb"],
        "send_s_per_hop": [[x / M for x in s["send_s"]] for s in last],
        "recv_wait_s_per_hop": [[x / M for x in s["recv_wait_s"]]
                                for s in last],
        "hop": stats[-1]["hop"],
        "stage_peak_bytes": [m["peak_bytes"] for m in memory],
        "launches_by_stage": stage_launches,
        "dag_eager_ms_p50": 1e3 * statistics.median(times["eager"]),
        "dag_compiled_ms_p50": 1e3 * statistics.median(times["compiled"]),
        "dag_iters": DAG_ITERS})
    if metrics["activation_bytes_per_mb"] != act_bytes:
        raise AssertionError(f"{metrics['activation_bytes_per_mb']} "
                             f"activation bytes a microbatch, want "
                             f"{act_bytes}")
    log(f"pipeline: {PIPE_STAGES} stages of num_gpus={1 / PIPE_STAGES}, "
        f"{PIPE_STEPS} steps, losses {losses} within {bounds} of the "
        f"one-device step's {ref_losses}; gradient norms at steps 0, 1 "
        f"{grad_errs} within {grad_bounds}; each stage's params "
        f"{param_errs} within {param_bounds} (updates {update_norm}); "
        f"launches by stage {stage_launches}"
        f"; compiled graph p50 {metrics['dag_compiled_ms_p50']:.3f} ms "
        f"against eager {metrics['dag_eager_ms_p50']:.3f} ms [{card}]")
    log("pipeline metrics: " + json.dumps(metrics))
    return launches


RL_ITERS = 21  # tests/test_rl.py: PPO seed 1, one iteration and 20 more
RL_RETURN = 60.0  # ... whose episode_return_mean must pass this
RL_TIMEOUT_S = 300.0  # each cluster call's
RL_INT8_LOSS = 0.02  # tests/test_quant_comms.py: int8 within 2 % of fp32
RL_GROUP_STEPS = (3, 6)  # the fp32 and the int8 groups' batches
# fp32's unit roundoff: a sum of n products in another order moves by at most
# n u of its terms' magnitude (cuBLAS on the card, MKL/OpenBLAS on the CPU)
FP32_U = 2.0 ** -24


def rl_bound(lr: float, steps: int, n: int, pmax: float) -> float:
    """How far one parameter may move apart between two devices after
    ``steps`` Adam steps from the same params and batches: a gradient is a
    sum over at most ``n`` samples, so its relative gap is at most n u; the
    step ``lr mu_hat / (sqrt(nu_hat) + eps)`` moves by at most twice its
    gradient's relative gap (mu's and sqrt(nu)'s), of at most ``lr``; the
    sum ``p + step`` rounds on each device, within half an ulp (u |p|) of
    the largest parameter ``pmax`` each; the gaps of the steps add up."""
    return steps * (lr * 2 * n * FP32_U + 2 * FP32_U * pmax)


def rl_batches(seed: int = 0) -> dict:
    """One seeded batch for each learner, at the JAX defaults' sizes:
    PPO's 1024 samples (2 runners x 4 envs x 128 steps of CartPole), an
    IMPALA batch of 64 steps x 4 envs (2 aggregated rollouts), DQN's 64
    prioritized transitions, SAC's 256 Pendulum transitions."""
    import numpy as np

    rng = np.random.default_rng(seed)
    f32 = np.float32
    n = 1024
    ppo = {"obs": rng.standard_normal((n, 4)).astype(f32),
           "actions": rng.integers(0, 2, n).astype(np.int32),
           "logp": (np.log(0.5) + 0.1 * rng.standard_normal(n)).astype(f32),
           "advantages": rng.standard_normal(n).astype(f32),
           "returns": rng.standard_normal(n).astype(f32)}
    T, B = 64, 4
    impala = {"obs": rng.standard_normal((T, B, 4)).astype(f32),
              "actions": rng.integers(0, 2, (T, B)).astype(np.int32),
              "behavior_logp": (np.log(0.5) + 0.2 * rng.standard_normal(
                  (T, B))).astype(f32),
              "rewards": np.ones((T, B), f32),
              "dones": (rng.random((T, B)) < 0.05).astype(f32),
              "last_obs": rng.standard_normal((B, 4)).astype(f32)}
    n = 64
    dqn = {"obs": rng.standard_normal((n, 4)).astype(f32),
           "next_obs": rng.standard_normal((n, 4)).astype(f32),
           "actions": rng.integers(0, 2, n).astype(np.int32),
           "rewards": np.ones(n, f32),
           "dones": (rng.random(n) < 0.1).astype(f32),
           "weights": rng.uniform(0.2, 1.0, n).astype(f32)}
    n = 256
    sac = {"obs": rng.standard_normal((n, 3)).astype(f32),
           "actions": rng.uniform(-1, 1, (n, 1)).astype(f32),
           "rewards": -rng.random(n).astype(f32) * 10,
           "dones": np.zeros(n, f32),
           "next_obs": rng.standard_normal((n, 3)).astype(f32)}
    return {"ppo": ppo, "impala": impala, "dqn": dqn, "sac": sac}


def _timed(fn, device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def rl_learner_parity(card_device: str = "cuda") -> dict:
    """Each RL learner built twice from the same params (drawn on the CPU
    from the config's seed), once on ``card_device`` and once on the CPU,
    updated on the same seeded batch: PPO's default update (8 epochs x 4
    minibatches = 32 clipped Adam steps on 1024 samples), one IMPALA
    V-trace step, one double-Q DQN step, one SAC step with the same noise.
    Raises unless every parameter agrees within ``rl_bound``; returns each
    learner's gap, bound and update ms on both devices (a second update,
    after one that warms up)."""
    from ray_tpu_torch.rl.dqn import DQNConfig, DQNLearner
    from ray_tpu_torch.rl.impala import IMPALAConfig, _ImpalaLearnerCore
    from ray_tpu_torch.rl.ppo import PPOConfig, PPOLearner
    from ray_tpu_torch.rl.sac import SACConfig, SACLearner

    batches = rl_batches()
    cases = {
        "ppo": (lambda dev: PPOLearner(PPOConfig(device=dev), 4, 2),
                32, 1e-3, 1024 // 4),
        "impala": (lambda dev: _ImpalaLearnerCore(IMPALAConfig(device=dev),
                                                  4, 2), 1, 1e-3, 64 * 4),
        "dqn": (lambda dev: DQNLearner(DQNConfig(device=dev), 4, 2),
                1, 5e-4, 64),
        "sac": (lambda dev: SACLearner(SACConfig(device=dev), 3, 1),
                1, 3e-4, 256),
    }
    out = {}
    for name, (make, steps, lr, n) in cases.items():
        runs = []
        for dev in (card_device, "cpu"):
            learner = make(dev)
            if name == "sac":
                eps = learner.noise(len(batches["sac"]["obs"]))
                run = lambda ln=learner, e=eps: ln.step(  # noqa: E731
                    batches["sac"], *e)
            else:
                run = lambda ln=learner: ln.update(  # noqa: E731
                    dict(batches[name]))
            run()
            got = learner.get_state()
            _, ms = _timed(run, learner.device)
            runs.append((got, ms))
        (card_state, card_ms), (cpu_state, cpu_ms) = runs
        parts = ([k for k in ("actor", "q1", "q2", "q1_target", "q2_target")
                  if k in cpu_state] or ["params"])
        pmax = max(float(abs(v).max()) for part in parts
                   for v in cpu_state[part].values())
        bound = rl_bound(lr, steps, n, pmax)
        gap = 0.0
        for part in parts:
            for key, want in cpu_state[part].items():
                gap = max(gap, float(abs(card_state[part][key]
                                         - want).max()))
        if "log_alpha" in cpu_state:
            gap = max(gap, float(abs(card_state["log_alpha"]
                                     - cpu_state["log_alpha"])))
        out[name] = {"max_abs_err": gap, "bound": bound, "steps": steps,
                     "n": n, "card_ms": card_ms, "cpu_ms": cpu_ms}
        log(f"rl learner {name}: card vs cpu max abs gap {gap:.3g} "
            f"(bound {bound:.3g} = {steps} steps x (lr {lr} x 2 x {n} "
            f"samples + 2 x max|p| {pmax:.3g}) x 2^-24); update "
            f"{card_ms:.2f} ms on the card, {cpu_ms:.2f} ms on the CPU")
        if not gap <= bound:
            raise AssertionError(f"rl learner {name}: the card's params part "
                                 f"from the CPU's by {gap} > {bound}")
    return out


def rl_two_learners(device: str = "cuda") -> dict:
    """Two PPO learners of ``num_gpus=0.5`` on the card in a LearnerGroup
    over gloo, on one fixed batch stream (tests/test_rl_multilearner.py's
    test_two_learners_match_single and tests/test_quant_comms.py's int8
    parity): the ranks' params bit-equal, fp32 within ``rl_bound`` of one
    learner on the card after RL_GROUP_STEPS[0] batches, int8's losses
    within 2 % of fp32's at every batch. The fp32 group, then the int8 one
    (two groups of two would need two cards). Needs a port cluster."""
    import dataclasses

    import numpy as np

    from ray_tpu_torch.rl.learner_group import LearnerGroup
    from ray_tpu_torch.rl.ppo import PPOConfig, PPOLearner

    cfg = PPOConfig(epochs=2, num_minibatches=4, seed=3, device=device)
    rng = np.random.default_rng(0)
    stream = [{k: v[:256] for k, v in rl_batches(
        int(rng.integers(1 << 30)))["ppo"].items()}
        for _ in range(RL_GROUP_STEPS[1])]

    def run_group(c, single=None):
        def factory(rank, world_size, group_name, _c=c):
            return PPOLearner(_c, 4, 2, world_size=world_size, rank=rank,
                              group_name=group_name)

        t0 = time.perf_counter()
        g = LearnerGroup(factory, 2, device=c.device)
        out = {"ready_s": time.perf_counter() - t0, "losses": [],
               "num_gpus": g.num_gpus_per_learner}
        try:
            t0 = time.perf_counter()
            for step, batch in enumerate(stream):
                out["losses"].append(g.update(dict(batch))["loss"])
                if single is not None and step + 1 == RL_GROUP_STEPS[0]:
                    out["params_at_compare"] = g.get_params()
            out["updates_s"] = time.perf_counter() - t0
            ranks = g.foreach_learner("get_params")
            for key in ranks[0]:
                if not np.array_equal(ranks[0][key], ranks[1][key]):
                    raise AssertionError(f"rl two learners "
                                         f"{c.grad_compression or 'fp32'}: "
                                         f"ranks differ at {key}")
        finally:
            g.shutdown()
        return out

    single = PPOLearner(cfg, 4, 2)
    for batch in stream[:RL_GROUP_STEPS[0]]:
        single.update(dict(batch))
    want = single.get_params()
    fp32 = run_group(cfg, single)
    int8 = run_group(dataclasses.replace(cfg, grad_compression="int8"))
    got = fp32["params_at_compare"]
    gap = max(float(abs(got[k] - want[k]).max()) for k in want)
    pmax = max(float(abs(v).max()) for v in want.values())
    bound = rl_bound(cfg.lr, RL_GROUP_STEPS[0] * 8, 256 // 4, pmax)
    if not gap <= bound:
        raise AssertionError(f"rl two learners: the fp32 group parts from "
                             f"one learner by {gap} > {bound}")
    for lf, lq in zip(fp32["losses"], int8["losses"]):
        if not abs(lq - lf) <= RL_INT8_LOSS * max(abs(lf), 1e-3):
            raise AssertionError(f"rl two learners: int8 loss {lq} vs fp32 "
                                 f"{lf}")
    log(f"rl two learners: 2 x num_gpus={fp32['num_gpus']} over gloo, "
        f"ranks bit-equal (fp32 and int8); fp32 group vs one learner max "
        f"abs gap {gap:.3g} (bound {bound:.3g}); int8 losses "
        f"{int8['losses']} vs fp32 {fp32['losses']} (within "
        f"{RL_INT8_LOSS:.0%})")
    return {"ready_s": [fp32["ready_s"], int8["ready_s"]],
            "updates_s": [fp32["updates_s"], int8["updates_s"]],
            "fp32_vs_single_gap": gap, "bound": bound,
            "losses": {"fp32": fp32["losses"], "int8": int8["losses"]}}


def phase_rl(card: str) -> dict:
    """Phase 21: the RL library (the ``rl`` path: MLPs, no kernel)."""
    import statistics

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.rl import PPOConfig

    t_phase = time.perf_counter()
    parity = rl_learner_parity()
    if rt.is_initialized():
        rt.shutdown()
    t0 = time.perf_counter()
    rt.init(num_cpus=8)  # 2 runners, then 4 learners of 2 groups
    metrics = {"init_s": time.perf_counter() - t0}
    try:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()  # earlier phases' leftovers
        t0 = time.perf_counter()
        algo = PPOConfig(seed=1).build()
        metrics["build_s"] = time.perf_counter() - t0
        try:
            results = [algo.train() for _ in range(RL_ITERS)]
            cuda_in_runners = rt.get(
                [r.cuda_initialized.remote() for r in algo.runners],
                timeout=RL_TIMEOUT_S)
        finally:
            algo.stop()
        peak = torch.cuda.max_memory_allocated() - base
        if any(cuda_in_runners):
            raise AssertionError(f"rl: an env runner initialised CUDA "
                                 f"({cuda_in_runners})")
        returns = [r["episode_return_mean"] for r in results]
        if not max(returns[1:]) > RL_RETURN:
            raise AssertionError(f"rl: PPO's returns {returns} never pass "
                                 f"{RL_RETURN}")
        steady = results[1:]
        metrics.update({
            "env_steps_per_s": statistics.median(
                r["steps_per_sec"] for r in steady),
            "sample_s": statistics.median(r["sample_s"] for r in steady),
            "update_s": statistics.median(r["update_s"] for r in steady),
            "first_sample_s": results[0]["sample_s"],
            "first_update_s": results[0]["update_s"],
            "first_return": returns[0], "best_return": max(returns),
            "learner_peak_mb": peak / 2 ** 20,
            "iterations": RL_ITERS})
        metrics["two_learners"] = rl_two_learners()
    finally:
        rt.shutdown()
    metrics["learners"] = parity
    metrics["phase_s"] = time.perf_counter() - t_phase
    two = metrics["two_learners"]
    log("rl metrics: " + json.dumps({
        "card": card, "ppo_env_steps_per_s": metrics["env_steps_per_s"],
        "ppo_sample_s": metrics["sample_s"],
        "ppo_update_s": metrics["update_s"],
        "ppo_first_sample_s": metrics["first_sample_s"],
        "ppo_first_update_s": metrics["first_update_s"],
        "ppo_first_return": metrics["first_return"],
        "ppo_best_return": metrics["best_return"],
        "ppo_learner_peak_mb": metrics["learner_peak_mb"],
        "runners_cuda_initialized": cuda_in_runners,
        "update_ms": {k: {"card": v["card_ms"], "cpu": v["cpu_ms"]}
                      for k, v in parity.items()},
        "card_vs_cpu_gap": {k: v["max_abs_err"] for k, v in parity.items()},
        "card_vs_cpu_bound": {k: v["bound"] for k, v in parity.items()},
        "two_learners_ready_s": two["ready_s"],
        "two_learners_updates_s": two["updates_s"],
        "two_learners_gap": two["fp32_vs_single_gap"],
        "init_s": metrics["init_s"], "build_s": metrics["build_s"],
        "phase_s": metrics["phase_s"]}))
    return metrics


TUNE_PHASE4_LR = 1e-4  # phase_training's learning rate
TUNE_LRS = (3e-5, TUNE_PHASE4_LR, 3e-4, 1e-3)
TUNE_MAX_T = 6  # ASHA: rungs at 2 and 4, every trial stops by step 6
TUNE_GRACE = 2
TUNE_RF = 2
TUNE_CONCURRENT = 2
TUNE_GPU_SHARE = 0.5  # two trials share the one card
TUNE_TIMEOUT_S = 600.0  # the job's, and each cluster call's
# two processes on one card from one state take the same steps: with
# flash_bwd's dQ adds in a fixed order (``ops/attention.py:dq_counters``)
# the losses are expected bit-equal to phase 4's; the bound allows what
# phase 16 allows a worker (the first equal, the rest within
# CKPT_LOSS_RTOL)
TUNE_LOSS_RTOL = CKPT_LOSS_RTOL
TUNE_BENCH_S = 1.0  # the CLI microbenchmark's seconds a benchmark
TUNE_FREE_SLACK = 1 << 30  # card memory the phase may leave held at its end

# the job's entrypoint: a Tuner sweep whose trials train the 1b on the card
# and whose ASHA logs every decision it takes, in the hub's order
TUNE_ENTRY = r'''
import json
import os
import time

import ray_tpu_torch as rt
from ray_tpu_torch import tune
from ray_tpu_torch.tune import ASHAScheduler

CFG = json.loads(os.environ["TUNE_SMOKE_CONFIG"])


class LoggedASHA(ASHAScheduler):
    """ASHA that appends each trial's launch and each decision to a file."""

    def __init__(self, log_path, **kw):
        ASHAScheduler.__init__(self, **kw)
        self.log_path = log_path

    def _log(self, rec):
        with open(self.log_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def register_trial(self, trial_id, config):
        self._log({"trial_id": trial_id, "registered_at": time.time()})

    def on_result(self, trial_id, metrics):
        decision = ASHAScheduler.on_result(self, trial_id, metrics)
        self._log({"trial_id": trial_id, "t": metrics["training_iteration"],
                   "loss": metrics["loss"], "decision": decision})
        return decision


def trainable(config):
    import importlib
    import os
    import time

    import numpy as np
    import torch

    from ray_tpu_torch import tune
    from ray_tpu_torch.models import CONFIGS
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.parallel import TrainStepBundle, make_optimizer
    from ray_tpu_torch.util.metrics import publish_metrics

    att = importlib.import_module("ray_tpu_torch.ops.attention")
    started_at = time.time()
    # the driver's settings (phase_device), so products round alike
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    torch.cuda.mem_get_info()  # makes this process's context
    cuda_init_s = time.perf_counter() - t
    _build.build_all(["flash_fwd", "flash_bwd"])
    bundle = TrainStepBundle(CONFIGS[CFG["model"]], device="cuda",
                             optimizer=make_optimizer(
                                 learning_rate=config["lr"],
                                 warmup_steps=CFG["warmup_steps"]))
    params, opt = bundle.init(seed=CFG["seed"])
    batch = bundle.make_batch(np.random.default_rng(CFG["batch_seed"]),
                              CFG["batch"], CFG["seq"])
    torch.cuda.synchronize()
    setup = {"pid": os.getpid(), "started_at": started_at,
             "ready_at": time.time(), "cuda_init_s": cuda_init_s,
             "cards": os.environ.get("CUDA_VISIBLE_DEVICES")}
    att.launch_counts(reset=True)
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for t in range(1, CFG["max_t"] + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, loss = bundle.step(params, opt, batch)
        losses.append(loss.item())
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        publish_metrics()  # the step histograms, for /metrics
        tune.report({"loss": losses[-1], "training_iteration": t,
                     "losses": list(losses), "step_s": list(step_s),
                     "launches": att.launch_counts(),
                     "peak_bytes": torch.cuda.max_memory_allocated(),
                     **setup})
    return {}


rt.init(log_to_driver=False)
fit_started_at = time.time()
grid = tune.Tuner(
    trainable, param_space={"lr": tune.grid_search(CFG["lrs"])},
    tune_config=tune.TuneConfig(
        metric="loss", mode="min",
        max_concurrent_trials=CFG["concurrent"],
        scheduler=LoggedASHA(CFG["log"], metric="loss", mode="min",
                             max_t=CFG["max_t"], grace_period=CFG["grace"],
                             reduction_factor=CFG["rf"])),
    resources_per_trial={"CPU": 1.0, "GPU": CFG["gpu_share"]}).fit()
wall_s = time.time() - fit_started_at
best = grid.get_best_result()
print("TUNE_RESULT " + json.dumps({
    "fit_started_at": fit_started_at, "wall_s": wall_s,
    "best": best.trial_id, "best_config": best.config,
    "trials": [{"trial_id": r.trial_id, "config": r.config,
                "metrics": r.metrics, "error": r.error,
                "stopped_early": r.stopped_early} for r in grid.results]}),
      flush=True)
rt.shutdown()
'''


def http_get(address: str, path: str):
    """(body, content type, seconds) of one GET to the dashboard."""
    import urllib.request

    t0 = time.perf_counter()
    with urllib.request.urlopen(f"http://{address}{path}",
                                timeout=TUNE_TIMEOUT_S) as r:
        body = r.read().decode()
        ctype = r.headers.get("Content-Type", "")
    return body, ctype, time.perf_counter() - t0


def parse_prometheus(text: str) -> list:
    """(name, labels, value) of every sample line of a Prometheus text
    exposition; raises on a line that is not one."""
    import re

    line_re = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (\S+)$')
    label_re = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"')
    out = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = line_re.match(line)
        if m is None:
            raise AssertionError(f"/metrics: not a sample line: {line!r}")
        out.append((m.group(1), dict(label_re.findall(m.group(2) or "")),
                    float(m.group(3))))
    return out


def smoke_cli(address_file: str, *args, timeout: float = 300.0):
    """One run of the port's CLI against the phase's head: its stdout and
    seconds; raises unless it exits 0."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "--address-file",
         address_file, *args], capture_output=True, text=True,
        timeout=timeout)
    if out.returncode != 0:
        raise AssertionError(f"cli {' '.join(args)}: exit {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    return out.stdout, time.perf_counter() - t0


def replay_asha(records: list) -> dict:
    """The logged report stream through a fresh ASHAScheduler of the
    sweep's settings: raises where a decision differs from the logged one;
    each trial's step of its first STOP."""
    from ray_tpu_torch.tune import ASHAScheduler

    sched = ASHAScheduler(metric="loss", mode="min", max_t=TUNE_MAX_T,
                          grace_period=TUNE_GRACE, reduction_factor=TUNE_RF)
    stops = {}
    for rec in records:
        if "decision" not in rec:
            continue
        got = sched.on_result(rec["trial_id"], {
            "loss": rec["loss"], "training_iteration": rec["t"]})
        if got != rec["decision"]:
            raise AssertionError(f"ASHA replayed {got} for {rec}")
        if got == "STOP":
            stops.setdefault(rec["trial_id"], rec["t"])
    return stops


def phase_cluster_services(card: str, training: dict) -> dict:
    """Phase 22: a head started by the port's CLI with the dashboard; a job
    submitted over its REST runs an ASHA sweep whose trials train the 1b on
    the card; the cluster is read back through the dashboard, the state API
    and the CLI; SIGINT stops the head and gives the card back. Returns the
    kernels' launches summed over the trials."""
    import gc
    import shutil
    import signal
    import tempfile
    import urllib.request

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.models import CONFIGS
    from ray_tpu_torch.util import state

    gc.collect()
    torch.cuda.empty_cache()
    phase_t0 = time.perf_counter()
    free_before, total = torch.cuda.mem_get_info()
    cfg = CONFIGS[TRAIN_CONFIG]
    per_step = {"flash_attention_fwd": (2 if cfg.remat else 1) * cfg.n_layers,
                "attention_bwd_prep": cfg.n_layers,
                "flash_attention_bwd": cfg.n_layers,
                "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
                "flash_bwd_delta": 0}
    want = training["loss"]
    metrics = {"card": card, "free_bytes_before": free_before,
               "total_bytes": total}
    root = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    address_file = os.path.join(root, "head_address")
    # (a) the head, through the CLI, with the dashboard
    t0 = time.perf_counter()
    head = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "--address-file",
         address_file, "start", "--head", "--include-dashboard",
         "--dashboard-port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    connected = False
    try:
        dashboard, lines = None, []
        while dashboard is None:
            line = head.stdout.readline()
            if not line or time.perf_counter() - t0 > TUNE_TIMEOUT_S:
                raise AssertionError("the head did not start: "
                                     + "".join(lines)[-2000:])
            lines.append(line)
            if line.startswith("dashboard at http://"):
                dashboard = line.split("http://", 1)[1].strip()
        metrics["head_ready_s"] = time.perf_counter() - t0
        body, _, _ = http_get(dashboard, "/api/nodes")
        gpus = [n["total_resources"].get("GPU") for n in json.loads(body)
                if n["alive"]]
        if gpus != [1.0]:
            raise AssertionError(f"/api/nodes: GPU {gpus}, want [1.0]")
        with open(address_file) as f:
            gcs_address = f.read().strip()
        rt.init(address=gcs_address, log_to_driver=False)
        connected = True

        # (b) the job: its working_dir holds the entrypoint
        work = os.path.join(root, "work")
        os.makedirs(work)
        with open(os.path.join(work, "tune_entry.py"), "w") as f:
            f.write(TUNE_ENTRY)
        log_path = os.path.join(root, "asha.jsonl")
        config = {"model": TRAIN_CONFIG, "seed": 0, "batch_seed": 0,
                  "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "warmup_steps": 1,
                  "lrs": list(TUNE_LRS), "max_t": TUNE_MAX_T,
                  "grace": TUNE_GRACE, "rf": TUNE_RF,
                  "concurrent": TUNE_CONCURRENT,
                  "gpu_share": TUNE_GPU_SHARE, "log": log_path}
        payload = json.dumps({
            "entrypoint": f"{sys.executable} tune_entry.py",
            "runtime_env": {"working_dir": work, "env_vars": {
                "TUNE_SMOKE_CONFIG": json.dumps(config)}}}).encode()
        t_submit = time.perf_counter()
        req = urllib.request.Request(
            f"http://{dashboard}/api/jobs", data=payload, method="POST",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=TUNE_TIMEOUT_S) as r:
            sid = json.loads(r.read())["submission_id"]
        metrics["submit_s"] = time.perf_counter() - t_submit
        node = [n for n in state.list_nodes() if n["alive"]][0]
        rss, status = {}, None
        while status not in ("SUCCEEDED", "FAILED", "STOPPED"):
            if time.perf_counter() - t_submit > TUNE_TIMEOUT_S:
                raise AssertionError(f"job {sid} still {status}")
            status = json.loads(http_get(dashboard,
                                         f"/api/jobs/{sid}")[0])["status"]
            if status != "PENDING" and "submit_to_running_s" not in metrics:
                metrics["submit_to_running_s"] = \
                    time.perf_counter() - t_submit
            # the agent's view of the trials' workers while they run
            for w in state.get_node_stats(node["address"],
                                          agent=True)["agent"]["workers"]:
                rss[w["pid"]] = max(rss.get(w["pid"], 0.0), w["rss_mb"])
            time.sleep(0.5)
        metrics["job_s"] = time.perf_counter() - t_submit
        logs, _, _ = http_get(dashboard, f"/api/jobs/{sid}/logs")
        if status != "SUCCEEDED":
            raise AssertionError(f"job {sid} {status}: {logs[-3000:]}")

        # (c) the results against phase 4 and the replayed decisions
        result = json.loads(next(
            line for line in logs.splitlines()
            if line.startswith("TUNE_RESULT "))[len("TUNE_RESULT "):])
        with open(log_path) as f:
            records = [json.loads(line) for line in f]
        stops = replay_asha(records)
        registered = {r["trial_id"]: r["registered_at"] for r in records
                      if "registered_at" in r}
        trials = result["trials"]
        if len(trials) != len(TUNE_LRS) or any(t["error"] for t in trials):
            raise AssertionError(f"trials: {[t['error'] for t in trials]}")
        launches = dict.fromkeys(per_step, 0)
        first_gaps, reported = {}, {}
        for t in trials:
            m, tid = t["metrics"], t["trial_id"]
            losses, n = m["losses"], len(m["losses"])
            first_gaps[tid] = abs(losses[0] - want[0])
            if losses[0] != want[0]:
                raise AssertionError(f"{tid}: first loss {losses[0]} is not "
                                     f"phase 4's {want[0]}")
            stream = [(r["t"], r["loss"]) for r in records
                      if r.get("trial_id") == tid and "t" in r]
            if stream != list(zip(range(1, n + 1), losses)):
                raise AssertionError(f"{tid}: the hub saw {stream}, the "
                                     f"trial reported {losses}")
            if stops.get(tid) != n or not t["stopped_early"]:
                raise AssertionError(f"{tid} ran {n} steps; the replayed "
                                     f"ASHA stops it at {stops.get(tid)}")
            if m["launches"] != {k: v * n for k, v in per_step.items()}:
                raise AssertionError(f"{tid} launched {m['launches']} in {n}"
                                     f" steps, want {per_step} a step")
            for k in launches:
                launches[k] += m["launches"][k]
            if not all(math.isfinite(x) for x in losses):
                raise AssertionError(f"{tid}: losses {losses}")
            reported[tid] = {
                "lr": t["config"]["lr"], "steps": n, "losses": losses,
                "pid": m["pid"], "cards": m["cards"],
                "worker_ready_s": m["ready_at"] - registered[tid],
                "setup_in_worker_s": m["ready_at"] - m["started_at"],
                "cuda_init_s": m["cuda_init_s"],
                "step_s": m["step_s"], "peak_bytes": m["peak_bytes"]}
        lr_trial = next(tid for tid, r in reported.items()
                        if r["lr"] == TUNE_PHASE4_LR)
        got = reported[lr_trial]["losses"]
        worst = rel_distance(got, want[:len(got)])
        if worst > TUNE_LOSS_RTOL:
            raise AssertionError(f"the lr {TUNE_PHASE4_LR} trial's "
                                 f"losses {got} part from phase 4's {want} by "
                                 f"{worst} (relative), beyond {TUNE_LOSS_RTOL}")
        best = min(reported, key=lambda tid: reported[tid]["losses"][-1])
        if result["best"] != best:
            raise AssertionError(f"the grid's best {result['best']}, the "
                                 f"argmin of the final losses {best}")
        unsampled = [r["pid"] for r in reported.values()
                     if not rss.get(r["pid"], 0.0) > 0]
        if unsampled:
            raise AssertionError(f"the agent never listed trial workers "
                                 f"{unsampled} with an RSS")
        metrics.update(trials=reported, sweep_wall_s=result["wall_s"],
                       best=best, first_loss_gaps=first_gaps,
                       lr_trial_max_rel_gap=worst, loss_rtol=TUNE_LOSS_RTOL,
                       trial_worker_rss_mb={r["pid"]: rss[r["pid"]]
                                            for r in reported.values()},
                       launches=launches)
        log(f"cluster services: job {sid} SUCCEEDED; {len(trials)} trials "
            f"stopped at {[r['steps'] for r in reported.values()]} as the "
            f"replayed ASHA decides; first losses equal phase 4's (gaps "
            f"{sorted(set(first_gaps.values()))}), the lr "
            f"{TUNE_PHASE4_LR} trial within {worst:.3g}; launches "
            f"{launches}; peaks "
            f"{[r['peak_bytes'] for r in reported.values()]} [{card}]")

        # (d) the cluster read back
        latency = {}
        body, ctype, latency["/metrics"] = http_get(dashboard, "/metrics")
        samples = parse_prometheus(body)
        steps_by_pid = {}
        for r in reported.values():
            steps_by_pid[r["pid"]] = steps_by_pid.get(r["pid"], 0) + r["steps"]
        for pid, steps in steps_by_pid.items():
            counted = sum(v for name, labels, v in samples
                          if name == "ray_tpu_train_step_seconds_count"
                          and labels.get("pid") == str(pid))
            if counted != steps:
                raise AssertionError(f"/metrics counts {counted} steps of "
                                     f"pid {pid}, whose trials ran {steps}")
        body, _, latency["/api/timeline"] = http_get(
            dashboard, "/api/timeline?limit=5000")
        runs = [e for e in json.loads(body)["traceEvents"]
                if e.get("cat") == "task" and "_run_trial" in e["name"]]
        if len(runs) < len(trials):
            raise AssertionError(f"/api/timeline holds {len(runs)} "
                                 f"_run_trial slices for {len(trials)} trials")
        for path in ("/api/health", "/api/goodput", "/api/summary",
                     f"/api/jobs/{sid}"):
            body, ctype, latency[path] = http_get(dashboard, path)
            json.loads(body)
            if "application/json" not in ctype:
                raise AssertionError(f"{path}: {ctype}")
        cli_s = {}
        out, cli_s["status"] = smoke_cli(address_file, "status")
        if json.loads(out)["num_nodes"] != 1:
            raise AssertionError(f"cli status: {out}")
        out, cli_s["job list"] = smoke_cli(address_file, "job", "list")
        if sid not in [j["submission_id"] for j in json.loads(out)]:
            raise AssertionError(f"cli job list: {out[:2000]}")
        trace = os.path.join(root, "timeline.json")
        out, cli_s["timeline"] = smoke_cli(address_file, "timeline",
                                           "--from-gcs", "--out", trace)
        out, cli_s["microbenchmark"] = smoke_cli(
            address_file, "microbenchmark", "--duration", str(TUNE_BENCH_S))
        bench = {}
        for line in out.splitlines():
            row = json.loads(line)
            bench[row["name"]] = row["rate_per_s"]
            if "GB_per_s" in row:
                bench[row["name"] + "_GB_per_s"] = row["GB_per_s"]
        metrics.update(endpoint_s=latency, cli_s=cli_s, microbenchmark=bench,
                       prometheus_samples=len(samples),
                       timeline_run_trial_slices=len(runs))
    finally:
        if connected:
            rt.shutdown()
        # (e) SIGINT, and the card given back
        t0 = time.perf_counter()
        head.send_signal(signal.SIGINT)
        code = head.wait(timeout=120)
        metrics["head_stop_s"] = time.perf_counter() - t0
        shutil.rmtree(root, ignore_errors=True)
    if code != 0:
        raise AssertionError(f"the head exited {code} on SIGINT")
    deadline = time.perf_counter() + 60
    while True:
        free = torch.cuda.mem_get_info()[0]
        alive = [r["pid"] for r in reported.values()
                 if not process_gone(r["pid"])]
        if free >= free_before - TUNE_FREE_SLACK and not alive:
            break
        if time.perf_counter() > deadline:
            raise AssertionError(f"after the head's stop {free} bytes free "
                                 f"(before the phase {free_before}); trial "
                                 f"workers alive: {alive}")
        time.sleep(0.5)
    metrics.update(free_bytes_after=free, phase_s=time.perf_counter()
                   - phase_t0)
    log("cluster services metrics: " + json.dumps(metrics))
    return launches


AUTOSCALE_TIMEOUT_S = 600.0  # each client call's, and the host's start
AUTOSCALE_IDLE_S = 5.0  # gpu_worker's idle_timeout_s
AUTOSCALE_INTERVAL_S = 0.5  # the autoscaler's poll
AUTOSCALE_MEMORY_SLACK = 1 << 30  # card memory the phase may leave held
AUTOSCALE_EVENT = "autoscaler event: "
# the phase's processes' exit after the host's: the terminated node's
# forked workers poll for its raylet for several seconds before they exit
AUTOSCALE_GONE_S = 60.0
# Phase 23's host process: a port cluster whose head has no card, the
# autoscaler over the fake multi-node provider (one node type holding the
# card, at most one node: a second would bind the same card), and the
# client proxy. It prints one AUTOSCALE_EVENT line (JSON, with the host's
# time.time()) for each provider call and each node's registration, and
# stops its autoscaler, driver and cluster on SIGTERM.
AUTOSCALE_HOST = r"""
import json
import signal
import sys
import threading
import time

import ray_tpu_torch
from ray_tpu_torch.autoscaler import (Autoscaler, ClusterConfig,
                                      FakeMultiNodeProvider, NodeTypeConfig)
from ray_tpu_torch.autoscaler.autoscaler import PROVIDER_ID_LABEL
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.util.client import start_client_server

CFG = json.loads(sys.argv[1])


def event(kind, **fields):
    print("%s%s" % (CFG["prefix"], json.dumps(
        {"event": kind, "t": time.time(), **fields})), flush=True)


class Provider(FakeMultiNodeProvider):
    def create_nodes(self, node_type, count):
        event("launch", node_type=node_type.name, count=count)
        nodes = super().create_nodes(node_type, count)
        event("launched", nodes=[n.node_id for n in nodes])
        return nodes

    def terminate_node(self, node):
        event("terminate", node=node.node_id)
        super().terminate_node(node)
        event("terminated", node=node.node_id,
              non_terminated=len(self.non_terminated_nodes()))


def watch(provider, stop):
    seen = set()
    while not stop.is_set():
        alive = {n["labels"].get(PROVIDER_ID_LABEL) for n in
                 ray_tpu_torch.nodes() if n["alive"]}
        for node in provider.non_terminated_nodes():
            if node.node_id in alive and node.node_id not in seen:
                seen.add(node.node_id)
                event("registered", node=node.node_id)
        stop.wait(0.1)


def sigterm(*_):
    raise KeyboardInterrupt


signal.signal(signal.SIGTERM, sigterm)
cluster = Cluster(head_node_args={"resources": {"CPU": 4.0, "GPU": 0.0}})
stop = threading.Event()
scaler = None
try:
    ray_tpu_torch.init(address=cluster.address)
    provider = Provider(cluster)
    config = ClusterConfig(node_types={"gpu_worker": NodeTypeConfig(
        "gpu_worker", {"CPU": 2.0, "GPU": 1.0}, min_workers=0,
        max_workers=1)}, idle_timeout_s=CFG["idle_timeout_s"])
    scaler = Autoscaler(config, provider, cluster.address)
    scaler.start(interval_s=CFG["interval_s"])
    threading.Thread(target=watch, args=(provider, stop),
                     daemon=True).start()
    start_client_server(port=0, host="127.0.0.1")
except KeyboardInterrupt:
    pass
finally:
    stop.set()
    if scaler is not None:
        scaler.stop()
    ray_tpu_torch.shutdown()
    cluster.shutdown()
    event("stopped")
"""


def encode_prompt(prompt: str) -> list:
    """Phase 23's Pool work item: a prompt's ids under the port's tokenizer
    (phase 9's engine default, ``byte``)."""
    from ray_tpu_torch.llm.tokenizer import get_tokenizer

    return get_tokenizer("byte").encode(prompt)


def card_memory_used() -> int:
    """Bytes in use on card 0, every process's, as ``nvidia-smi`` reads
    them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,"
         "nounits", "--id=0"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip()
    return int(out.splitlines()[0]) << 20


def phase_autoscaled_serving(card: str, serving: dict) -> dict:
    """Phase 23: a driver outside the cluster, through a ``ray-tpu://``
    client only, maps phase 9's prompts through a ``Pool`` and asks for a
    ``num_gpus=1`` actor that the card-less head cannot place; the
    autoscaler adds the node that holds the card, the actor serves phase
    9's requests there, and once it is killed the idle node goes. Returns
    the actor's kernel launches (the ``autoscaled_serving`` path)."""
    import gc
    import threading

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.util.multiprocessing import Pool

    gc.collect()
    torch.cuda.empty_cache()
    phase_t0 = time.perf_counter()
    used_before = card_memory_used()
    metrics = {"card": card, "card_used_bytes_before": used_before,
               "idle_timeout_s": AUTOSCALE_IDLE_S,
               "interval_s": AUTOSCALE_INTERVAL_S}
    mark = f"{os.environ.get(RUN_MARK, os.getpid())}/autoscaled_serving"
    host = subprocess.Popen(
        [sys.executable, "-c", AUTOSCALE_HOST, json.dumps({
            "prefix": AUTOSCALE_EVENT, "idle_timeout_s": AUTOSCALE_IDLE_S,
            "interval_s": AUTOSCALE_INTERVAL_S})],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, RUN_MARK: mark})
    lines, events = [], []
    listening = threading.Event()

    def read():
        for line in host.stdout:
            lines.append(line)
            if line.startswith(AUTOSCALE_EVENT):
                events.append(json.loads(line[len(AUTOSCALE_EVENT):]))
            elif "listening on" in line:
                listening.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()

    def wait_event(kind: str, timeout: float) -> dict:
        deadline = time.perf_counter() + timeout
        while True:
            found = [e for e in events if e["event"] == kind]
            if found:
                return found[0]
            if host.poll() is not None or time.perf_counter() > deadline:
                break
            time.sleep(0.05)
        raise AssertionError(f"no {kind!r} event from the host; its output: "
                             + "".join(lines)[-3000:])

    connected = False
    try:
        if not listening.wait(AUTOSCALE_TIMEOUT_S):
            raise AssertionError("the host never served clients: "
                                 + "".join(lines)[-3000:])
        metrics["host_ready_s"] = time.perf_counter() - phase_t0
        address = "ray-tpu://" + next(
            ln for ln in lines if "listening on" in ln).strip().rsplit(
                " ", 1)[1]
        t0 = time.perf_counter()
        rt.init(address=address)
        connected = True
        metrics["connect_s"] = time.perf_counter() - t0
        if rt.cluster_resources().get("GPU", 0.0) != 0.0:
            raise AssertionError(f"the head advertises "
                                 f"{rt.cluster_resources()}: want no GPU")

        # (a) a Pool over CPU tasks, through the proxy
        prompts = serving["prompts"]
        want_ids = [encode_prompt(p) for p in prompts]
        t0 = time.perf_counter()
        with Pool() as pool:
            got_ids = pool.map(encode_prompt, prompts)
        metrics["pool_map_s"] = time.perf_counter() - t0
        if got_ids != want_ids:
            raise AssertionError("the Pool's encodings part from the "
                                 "driver's own")
        log(f"autoscaler client: connected in {metrics['connect_s']:.3f} s; "
            f"a Pool mapped {len(prompts)} prompts in "
            f"{metrics['pool_map_s']:.2f} s, every id list equal")

        # (b) the actor the head cannot place: the autoscaler adds the node
        server_cls = rt.remote(num_gpus=1)(RuntimeServer)
        created_at = time.time()
        t0 = time.perf_counter()
        server = server_cls.remote()
        rt.get(server.ready.remote(), timeout=AUTOSCALE_TIMEOUT_S)
        metrics["create_to_ready_s"] = time.perf_counter() - t0
        launch = wait_event("launch", 5)
        metrics["create_to_launch_s"] = launch["t"] - created_at
        metrics["create_to_registered_s"] = \
            wait_event("registered", 5)["t"] - created_at
        launches = [e for e in events if e["event"] == "launch"]
        if [(e["node_type"], e["count"]) for e in launches] != \
                [("gpu_worker", 1)]:
            raise AssertionError(f"the autoscaler launched {launches}")
        nodes = [n for n in rt.nodes() if n["alive"]]
        added = [n for n in nodes
                 if n["labels"].get("ray.io/node-type") == "gpu_worker"]
        if len(nodes) != 2 or len(added) != 1 or \
                added[0]["total_resources"].get("GPU") != 1.0:
            raise AssertionError(f"the client sees nodes {nodes}")
        bound = rt.get(server.cards.remote(), timeout=AUTOSCALE_TIMEOUT_S)
        log(f"autoscaler client: gpu_worker launched "
            f"{metrics['create_to_launch_s']:.2f} s after the actor's "
            f"creation, registered at "
            f"{metrics['create_to_registered_s']:.2f} s, the actor ready at "
            f"{metrics['create_to_ready_s']:.2f} s on card {bound!r}")

        out = rt.get(server.serve.remote(prompts),
                     timeout=AUTOSCALE_TIMEOUT_S)
        if out["token_ids"] != serving["token_ids"]:
            differ = [i for i, (a, b) in enumerate(zip(
                out["token_ids"], serving["token_ids"])) if a != b]
            raise AssertionError(f"the autoscaled actor's greedy answers "
                                 f"{differ} part from the serving phase's")
        if out["launches"]["flash_attention_fwd"] != serving["launches"]:
            raise AssertionError(
                f"flash_fwd launched {out['launches']['flash_attention_fwd']}"
                f" times in the actor, {serving['launches']} in the serving "
                f"phase")
        metrics.update(
            serve_wall_s=out["wall_s"],
            decode_tokens_per_s=out["decode_tokens_per_s"],
            in_process_decode_tokens_per_s=serving["decode_tokens_per_s"],
            in_process_wall_s=serving["wall_s"],
            actor_max_memory_allocated_bytes=out[
                "max_memory_allocated_bytes"],
            flash_fwd_launches=out["launches"]["flash_attention_fwd"],
            cuda_visible_devices=bound)
        log(f"autoscaler client: {len(out['token_ids'])} answers equal the "
            f"serving phase's token for token; flash_fwd launches "
            f"{out['launches']['flash_attention_fwd']}")

        # (c) the idle node goes
        killed_at = time.time()
        rt.kill(server)
        gone = wait_event("terminated", AUTOSCALE_IDLE_S + 60)
        metrics["kill_to_terminated_s"] = gone["t"] - killed_at
        if gone["non_terminated"] != 0:
            raise AssertionError(f"the provider still holds "
                                 f"{gone['non_terminated']} nodes")
        alive = [n for n in rt.nodes() if n["alive"]]
        if len(alive) != 1 or not alive[0]["is_head"]:
            raise AssertionError(f"alive after the scale-down: {alive}")
    finally:
        if connected:
            rt.shutdown()
        t0 = time.perf_counter()
        host.terminate()
        try:
            code = host.wait(timeout=120)
        except subprocess.TimeoutExpired:
            host.kill()
            code = host.wait(timeout=60)
        reader.join(timeout=10)
        metrics["host_stop_s"] = time.perf_counter() - t0
        # the host's cluster is gone; the workers of the node it terminated
        # exit once they find its raylet gone
        t0 = time.perf_counter()
        left = wait_started_processes(mark, AUTOSCALE_GONE_S)
        metrics["processes_gone_s"] = time.perf_counter() - t0
    if code != 0 or not any(e["event"] == "stopped" for e in events):
        raise AssertionError(f"the host exited {code}: "
                             + "".join(lines)[-3000:])
    if left:
        raise AssertionError(f"{len(left)} of the phase's processes still "
                             f"run {AUTOSCALE_GONE_S:.0f} s after the "
                             f"host's exit: {left}")
    deadline = time.perf_counter() + 60
    while True:
        used = card_memory_used()
        if used <= used_before + AUTOSCALE_MEMORY_SLACK:
            break
        if time.perf_counter() > deadline:
            raise AssertionError(f"{used} bytes used on the card after the "
                                 f"phase, {used_before} before")
        time.sleep(0.5)
    metrics.update(card_used_bytes_after=used,
                   phase_s=time.perf_counter() - phase_t0)
    log(f"autoscaler client: the idle node terminated "
        f"{metrics['kill_to_terminated_s']:.2f} s after the kill; only the "
        f"head alive; the card's used memory back to {used >> 20} MiB "
        f"(before {used_before >> 20} MiB); every process of the phase gone "
        f"{metrics['processes_gone_s']:.2f} s after the host's exit [{card}]")
    log("autoscaler client metrics: " + json.dumps(metrics))
    return out["launches"]


def rel_distance(got, want) -> float:
    """The largest ``|got - want| / |want|`` over the steps."""
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def check_losses(label: str, got, want, first_equal: bool = True,
                 ref: str = "run A") -> None:
    """``got`` within CKPT_LOSS_RTOL of ``want`` (``ref``'s losses) step by
    step, and the first equal where ``first_equal``."""
    if len(got) != len(want) or (first_equal and got[0] != want[0]) or not all(
            abs(a - b) <= CKPT_LOSS_RTOL * abs(b) for a, b in zip(got, want)):
        raise AssertionError(f"{label}: losses {got} part from {ref}'s "
                             f"{want}")


def main() -> int:
    seconds = {}  # each phase's, in order

    def timed(label: str, phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        seconds[label] = time.perf_counter() - t0
        log(f"{label}: {seconds[label]:.2f} s")
        return out

    dev = timed("device", phase_device)
    card = dev["card"]
    timed("build", phase_build)
    fwd = timed("kernels", phase_kernels, card)
    bwd = timed("backward kernels", phase_bwd_kernels, card)
    d64 = timed("d64 kernels", phase_d64_kernels, card)
    paths = {}
    paths["training"], training = timed("training", phase_training, card)
    timed("moe layer", phase_moe_layer, card)
    paths["moe_training"], _ = timed("moe training", phase_training, card,
                                     MOE_CONFIG, "moe training")
    paths["vit_training"] = timed("vit training", phase_vit_training, card)
    serving = timed("serving", phase_serving, card)
    serve_launches = serving["launches"]
    paths.update(timed("parallel", phase_parallel, card))
    paths["tensor_parallel"], tp = timed("tensor parallel",
                                         phase_tensor_parallel, card)
    paths["seq_parallel"], sp = timed("seq parallel", phase_seq_parallel,
                                      card)
    timed("expert parallel", phase_expert_parallel, card)
    paths["traced_training"] = timed("traced training",
                                     phase_traced_training, card)
    paths["checkpointed_training"] = timed(
        "checkpointed training", phase_checkpointed_training, card)
    paths["runtime_serving"] = timed("runtime serving",
                                     phase_runtime_serving, card, serving)
    paths["runtime_training"] = timed("runtime training",
                                      phase_runtime_training, card, training)
    paths.update(timed("serve and weights", phase_serve_weights, card,
                       serving))
    paths.update(timed("pd and batch inference", phase_pd_batch, card,
                       serving))
    paths["runtime_restart"] = timed("runtime faults", phase_runtime_faults,
                                     card, serving)
    paths["pipeline"] = timed("pipeline", phase_pipeline, card)
    # MLPs only: no kernel lies on the rl path
    timed("rl", phase_rl, card)
    paths["tune"] = timed("cluster services and tune",
                          phase_cluster_services, card, training)
    paths["autoscaled_serving"] = timed("autoscaler and client",
                                        phase_autoscaled_serving, card,
                                        serving)
    log("phase seconds: " + json.dumps(seconds))
    wrapper = {"flash_fwd": "flash_attention_fwd",
               "flash_bwd": "flash_attention_bwd",
               "flash_bwd_prep": "attention_bwd_prep",
               "flash_bwd_dq": "flash_attention_bwd_dq",
               "flash_bwd_dkv": "flash_attention_bwd_dkv",
               # no wrapper: ``launch_counts`` reads its C entry's count
               "flash_bwd_delta": "flash_bwd_delta"}
    by_path = {kernel: {path: launches[fn] for path, launches in
                        paths.items()} for kernel, fn in wrapper.items()}
    by_path["flash_fwd"]["serving"] = serve_launches
    source = {"flash_fwd": "ray_tpu_torch/csrc/flash_fwd.cu",
              "flash_bwd": "ray_tpu_torch/csrc/flash_bwd.cu",
              "flash_bwd_prep": "ray_tpu_torch/csrc/flash_bwd.cu",
              "flash_bwd_delta": "ray_tpu_torch/csrc/flash_bwd.cu",
              "flash_bwd_dq": "ray_tpu_torch/csrc/flash_bwd.cu",
              "flash_bwd_dkv": "ray_tpu_torch/csrc/flash_bwd.cu"}
    # flash_bwd_prep (and the earlier flash_bwd_delta) stands for plain XLA
    # code (the JAX package computes Delta outside its kernels), not for a
    # Pallas kernel
    replaces = {"flash_fwd": "ray_tpu/ops/attention.py:45",
                "flash_bwd": ["ray_tpu/ops/attention.py:147",
                              "ray_tpu/ops/attention.py:184"],
                "flash_bwd_prep": "ray_tpu/ops/attention.py:236",
                "flash_bwd_delta": "ray_tpu/ops/attention.py:236",
                "flash_bwd_dq": "ray_tpu/ops/attention.py:147",
                "flash_bwd_dkv": "ray_tpu/ops/attention.py:184"}
    measured = {"flash_fwd": fwd, **{k: bwd[k] for k in (
        "flash_bwd", "flash_bwd_prep", "flash_bwd_delta", "flash_bwd_dq",
        "flash_bwd_dkv")}}
    kernels = []
    for name, entry in measured.items():
        kernels.append({
            "name": name, "route": "cuda", "source": source[name],
            "replaces": replaces[name],
            "launches": sum(by_path[name].values()),
            "launches_by_path": by_path[name],
            "max_abs_err": entry["max_abs_err"], "max_err": entry["max_err"],
            "ms": entry["ms"], "plain_ms": entry["plain_ms"],
            "bound_ms": entry["bound_ms"], "bound_by": entry["bound_by"],
            "library_ms": entry["library_ms"],
            **{key: entry[key] for key in (
                "mma_ms", "backward_ms", "train_shape", "min_ms", "spread_ms",
                "rounds", "back_to_back_ms", "graph_ms", "vecdot_ms",
                "vecdot_zeros_ms", "delta_alone_ms", "earlier_ms",
                "earlier_min_ms", "earlier_spread_ms",
                "earlier_back_to_back_ms", "earlier_graph_ms",
                "bits_as_earlier") if key in entry},
            **({"d64_shapes": d64[name]} if name in d64 else {}),
            **({"tensor_parallel_shapes": tp[name]} if name in tp else {}),
            **({"seq_parallel_shapes": sp[name]} if name in sp else {})})
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": dev["report"]}))
    return 0


if __name__ == "__main__":
    os.environ[RUN_MARK] = f"{os.getpid()}-{time.time_ns()}"
    try:
        code = main()
    finally:
        stop_started_processes()
    sys.exit(code)
