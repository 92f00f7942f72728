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
   their own, the fp32 pair, and ``flash_bwd_delta`` (Delta), with
   ``flash_bwd`` timed in turns with the dK/dV kernel, the earlier
   ``mma.sync`` pair (``mma_ms``), the whole bf16 backward as
   ``flash_attention_bwd`` runs it (``backward_ms``: Delta, zeros, kernel,
   cast) and the library's backward (``library_ms``);
4. training: ``TrainStepBundle`` at the 1b config's full width and depth
   (random weights from a seed) takes steps on one batch of 4 x 2048
   tokens; the loss must fall, the kernels must launch 2 x n_layers
   (forward and remat) and n_layers (``flash_bwd`` and Delta; the pair
   never) times a step, and one step's loss and gradients are held against
   the same step with plain attention; step time, tokens/s, MFU, peak
   memory, and where a step's device time goes (``torch.profiler``);
5. head_dim-64 kernels: the forward and the whole bf16 backward (Delta and
   ``flash_bwd``) against plain at the MoE and ViT training shapes, moe-1b
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
   (forward, Delta, ``flash_bwd``), one step's logits and gradients are
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
   save in flight on a ``checkpoint metrics:`` line.

Delta's rows, and the forward's at each rank's shape, also carry the
kernel's time without the wrapper's host path: 20 launches of the C entry
back to back, and the same replayed from a CUDA graph (``time_launches``).

Each path's launch counts are set to 0 just before it runs and read just
after, so the comparisons with the plain versions do not count.

The line before the last is ``{"kernels": [...]}`` (a kernel's ``launches``
is the sum over the paths it lies on, ``launches_by_path`` splits it; its
times are at the serving shape for the forward, with ``flash_fwd_mma``'s as
``mma_ms`` and the training shape's under ``train_shape``, and at the
training shape for the backward, ``flash_bwd`` with ``backward_ms`` and
``mma_ms``; ``d64_shapes`` holds the forward's, ``flash_bwd``'s and
Delta's at the MoE and ViT shapes, ``tensor_parallel_shapes`` theirs at
each rank's shape of phase 11, ``seq_parallel_shapes`` at each ring block
of phase 12); the last line is ``{"ok": true,
"device": {...}}``. With no card, or outside a checkout of the repository,
it prints no result and exits non-zero.
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


def log(msg: str) -> None:
    print(msg, flush=True)


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
    Delta."""
    rows = B * H * S
    if kernel == "flash_bwd_delta":
        return roofline(2.0 * D * rows, 2 * rows * D * itemsize + rows * 4)
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
    ``flash_attention_bwd``), the bf16 dK/dV kernel and the bf16 dQ kernel
    (``flash_bwd_dq``, the earlier design) on their own, the fp32 pair, and
    ``flash_bwd_delta`` (Delta) against its plain version. Then their times
    at the training shape. Returns the entries of the kernels line."""
    import torch

    from ray_tpu_torch.ops.attention import (attention_delta,
                                             attention_delta_plain,
                                             bwd_products, bwd_softmax_grads,
                                             flash_attention_bwd,
                                             flash_attention_bwd_dkv,
                                             flash_attention_bwd_dq,
                                             flash_attention_fwd)

    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = {"flash_bwd": {"dq": 0.0, "dk": 0.0, "dv": 0.0},
             "flash_bwd_dq": {"dq": 0.0},
             "flash_bwd_dkv": {"dk": 0.0, "dv": 0.0},
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
                    # dK and dV of two runs of the fused kernel are the same
                    # bits: they stay in one block's registers
                    dk2, dv2 = flash_attention_bwd(q, k, v, o, lse, do,
                                                   causal)[1:]
                    if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)):
                        raise AssertionError("flash_bwd's dk, dv differ "
                                             "between two runs")
                    del dk2, dv2
                outs.append(("flash_bwd_dq", "dq", flash_attention_bwd_dq(
                    q, k, v, do, lse, delta, causal)))
                dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                 causal)
                outs += [("flash_bwd_dkv", "dk", dk),
                         ("flash_bwd_dkv", "dv", dv)]
                torch.cuda.synchronize()
                where = (f"B={B} S={S} H={H} KVH={KVH} D={D} {name:8s} "
                         f"causal={int(causal)}")
                err = compare("flash_bwd_delta", "delta", delta,
                              attention_delta_plain(o, do), DELTA_TOL, where,
                              None)
                worst["flash_bwd_delta"]["delta"] = max(
                    worst["flash_bwd_delta"]["delta"], err["max_abs"])
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
    backward as ``flash_attention_bwd`` runs it (Delta, zeros, kernel,
    cast), the Delta kernel, and the library's backward, which computes its
    own Delta; then the plain backward and the plain Delta once."""
    import importlib

    import torch
    import torch.nn.functional as F

    att = importlib.import_module("ray_tpu_torch.ops.attention")
    B, S, H, D = q.shape
    KVH = k.shape[2]
    o, lse = att.flash_attention_fwd(q, k, v, True)
    delta = att.attention_delta(o, do)
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device="cuda")
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))

    # the C entries called directly: no counter, no Delta, no zeros
    def fused():
        att._launch("flash_bwd", "flash_bwd",
                    (q, k, v, do, lse, delta, dk, dv, dq_acc), True)

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
        "flash_bwd_delta": lambda: att.attention_delta(o, do),
        "library": lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                               retain_graph=True),
        # Delta's yardstick: one library call on o and dO; it rounds its
        # output to bf16, where the kernel writes fp32
        "library_delta": lambda: torch.linalg.vecdot(o, do, dim=-1),
    }
    times = {name: [] for name in runs}
    for r in range(TIME_ROUNDS):
        for name in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            times[name].append(cuda_time_ms(runs[name], 20))
    ms = {name: sorted(t)[len(t) // 2] for name, t in times.items()}
    ms["plain"] = cuda_time_ms(
        lambda: att.flash_attention_bwd_plain(q, k, v, o, lse, do, True), 5,
        warmup=1)
    ms["plain_delta"] = cuda_time_ms(
        lambda: att.attention_delta_plain(o, do), 20)
    # the earlier pair's dQ kernel alone, for its own entry
    ms["flash_bwd_dq"] = cuda_time_ms(lambda: att._launch(
        "flash_bwd", "flash_bwd_dq", (q, k, v, do, lse, delta, dq), True), 20)
    for name, t in times.items():
        log(f"time at {TRAIN_SHAPE} bf16 causal: {name} rounds {t} median "
            f"{ms[name]:.4f} ms [{card}]")
    entries = {}
    for kernel in ("flash_bwd", "flash_bwd_dkv", "flash_bwd_dq",
                   "flash_bwd_delta"):
        bound, by = bwd_bound(kernel, B, H, KVH, D, S, True, q.element_size())
        t = ms[kernel]
        plain = ms["plain_delta" if kernel == "flash_bwd_delta" else "plain"]
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
    entries["flash_bwd_delta"]["library_ms"] = ms["library_delta"]
    entries["flash_bwd_delta"].update(time_delta_launches(
        o, do, card, f"at the training shape {TRAIN_SHAPE}"))
    entries["flash_bwd"].update(backward_ms=ms["backward"],
                                mma_ms=ms["mma"])
    log(f"time bf16 backward at {TRAIN_SHAPE} causal: flash_attention_bwd "
        f"(Delta + zeros + flash_bwd + cast) {ms['backward']:.4f} ms; "
        f"library (sdpa backward) {ms['library']:.4f} ms; the earlier "
        f"mma.sync pair {ms['mma']:.4f} ms; plain {ms['plain']:.4f} ms; "
        f"Delta's library call (vecdot, bf16 out) "
        f"{ms['library_delta']:.4f} ms [{card}]")
    return entries


def kernel_counters():
    """Every kernel wrapper's launch counter, by wrapper name."""
    from ray_tpu_torch.ops.attention import (attention_delta,
                                             flash_attention_bwd,
                                             flash_attention_bwd_dkv,
                                             flash_attention_bwd_dq,
                                             flash_attention_fwd)

    return (flash_attention_fwd, attention_delta, flash_attention_bwd,
            flash_attention_bwd_dq, flash_attention_bwd_dkv)


def check_attention(q, k, v, do, causal: bool, where: str):
    """The forward kernel, Delta and the whole bf16 backward (Delta and
    ``flash_bwd``) at one shape against their plain versions on the same
    inputs (TOL, BWD_TOL, DELTA_TOL; ``compare`` raises beyond them).
    Returns the kernels' o, lse and Delta, and the errors by output."""
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
    errs["delta"] = compare("flash_bwd_delta", "delta", delta,
                            att.attention_delta_plain(o, do), DELTA_TOL,
                            where, None)
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
    ``flash_attention_bwd`` runs it (Delta, zeros, kernel, cast), the Delta
    kernel and the library's backward; the plain versions once. Returns
    each kernel's entries by shape name."""
    import importlib

    import torch

    att = importlib.import_module("ray_tpu_torch.ops.attention")
    gen = torch.Generator(device="cuda").manual_seed(2)
    out = {"flash_fwd": {}, "flash_bwd": {}, "flash_bwd_delta": {}}
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
        ms["plain_delta"] = cuda_time_ms(
            lambda: att.attention_delta_plain(o, do), 20)
        shape = {"shape": [B, S, H, KVH, D], "causal": causal}
        fb, fby = flash_bound(B, H, KVH, D, S, causal, 2)
        bb, bby = bwd_bound("flash_bwd", B, H, KVH, D, S, causal, 2)
        db, dby = bwd_bound("flash_bwd_delta", B, H, KVH, D, S, causal, 2)
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
        out["flash_bwd_delta"][name] = {
            **shape, "ms": ms["flash_bwd_delta"],
            "plain_ms": ms["plain_delta"], "library_ms": ms["library_delta"],
            "bound_ms": db, "bound_by": dby,
            "max_abs_err": errs["delta"]["max_abs"],
            **time_delta_launches(o, do, card, f"d64 {where}")}
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
            f"{ms['plain_bwd']:.4f} ms; Delta {ms['flash_bwd_delta']:.4f} "
            f"ms, bound {db:.4f} ms ({dby}), library (vecdot, bf16 out) "
            f"{ms['library_delta']:.4f} ms [{card}]")
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

    def burst():
        for _ in range(LAUNCH_BURST):
            att._launch(lib, fn, tensors, causal)

    result = {"back_to_back_ms": cuda_time_ms(burst, 5) / LAUNCH_BURST,
              "graph_ms": None}
    try:
        graph = torch.cuda.CUDAGraph()
        burst()  # warm the launch path outside the capture
        torch.cuda.synchronize()
        with torch.cuda.graph(graph):
            burst()
        result["graph_ms"] = cuda_time_ms(graph.replay, 5) / LAUNCH_BURST
    except RuntimeError as e:
        log(f"time {fn} {where}: no CUDA graph ({e})")
    log(f"time {fn} {where}: {LAUNCH_BURST} C-entry launches back to back "
        f"{result['back_to_back_ms']:.4f} ms a launch, replayed from a "
        f"graph {result['graph_ms']} ms a launch [{card}]")
    return result


def time_delta_launches(o, do, card: str, where: str) -> dict:
    """``time_launches`` of Delta (``flash_bwd_delta``) on o and dO."""
    import torch

    B, S, H, _ = o.shape
    out = torch.empty((B * H, S), dtype=torch.float32, device=o.device)
    return time_launches("flash_bwd", "flash_bwd_delta", (o, do, out), False,
                         card, where)


def time_attention(q, k, v, do, o, lse, delta, causal: bool,
                   rounds: int = TIME_ROUNDS, iters: int = 20):
    """The kernels at one shape, bf16, timed in turns over ``rounds``
    rounds (CUDA events, ``iters`` launches a time): the forward kernel and
    the library's forward, ``flash_bwd`` alone (its C entry: no Delta, no
    zeros), the backward as ``flash_attention_bwd`` runs it (Delta, zeros,
    kernel, cast), the Delta kernel, the library's backward (which computes
    its own Delta) and Delta's library call (vecdot, which rounds its
    output to bf16 where the kernel writes fp32). The library calls are
    yardsticks only, on the same inputs with K/V repeated to H heads
    outside the timed region; the port never calls them. Returns each
    run's round times and their medians."""
    import importlib

    import torch
    import torch.nn.functional as F

    att = importlib.import_module("ray_tpu_torch.ops.attention")
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device="cuda")
    dk, dv = torch.empty_like(k), torch.empty_like(v)

    def fused():  # the C entry called directly: no counter, Delta or zeros
        att._launch("flash_bwd", "flash_bwd",
                    (q, k, v, do, lse, delta, dk, dv, dq_acc), causal)

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
        "flash_bwd_delta": lambda: att.attention_delta(o, do),
        "library_bwd": lambda: torch.autograd.grad(
            lib_out, (qg, kg, vg), dot, retain_graph=True),
        "library_delta": lambda: torch.linalg.vecdot(o, do, dim=-1),
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
        "flash_attention_fwd": L, "attention_delta": L,
        "flash_attention_bwd": L, "flash_attention_bwd_dq": 0,
        "flash_attention_bwd_dkv": 0}, "vit training")
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
                   label: str = "training") -> dict:
    """An LM config (the dense 1b, or moe-1b) trained for TRAIN_STEPS steps
    on one batch through ``TrainStepBundle`` with the kernels, at full
    width and depth. Returns each kernel's launches in that run."""
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

    # bf16: one Delta and one flash_bwd a layer, never the earlier pair
    launches, run = run_steps(
        lambda: {"loss": bundle.step(params, opt_state, batch)[2]},
        TRAIN_STEPS, {
            "flash_attention_fwd": (2 if cfg.remat else 1) * cfg.n_layers,
            "attention_delta": cfg.n_layers,
            "flash_attention_bwd": cfg.n_layers,
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0},
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
    return launches


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

    counters = kernel_counters()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    values, times, enqueue = [], [], []
    for _ in range(n_steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        values.append(step())
        enqueue.append(time.perf_counter() - t)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    launches = {c.__name__: c.launches for c in counters}
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
                "flash_bwd_delta")


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
    kernels; of the rest of the attention backward (``attn_bwd_glue``: the
    device time under ``FlashAttention``'s backward other than the
    ``flash_bwd`` kernel, i.e. the Delta kernel, the zeroed dQ accumulator
    and its cast to bf16); of the matrix products by the layer their shapes
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
    return {"launches": launches}


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
    counters = kernel_counters()
    for c in counters:
        c.launches = 0
    runs = {}
    for causal in (True, False):
        for name, fn in (("ring_attention", ring_attention),
                         ("ulysses_attention", ulysses_attention)):
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            o = fn(*leaves, group, causal)
            runs[name, causal] = (o.detach(), *torch.autograd.grad(
                o, leaves, do))
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    want = {"flash_attention_fwd": 4, "attention_delta": 4,
            "flash_attention_bwd": 4, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0}
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
    into rank i's one fp32 buffer, dK and dV summed at their owner in fp32;
    the sums cast to q's dtype. Returns Delta and the gradients."""
    import torch

    from ray_tpu_torch.ops.attention import attention_delta
    from ray_tpu_torch.ops.ring_attention import block_backward

    L = q.shape[1] // n

    def part(x, i):
        return x[:, i * L:(i + 1) * L]

    deltas, dqs = [], []
    dkv = [torch.zeros(k.shape, dtype=torch.float32, device=k.device)
           for _ in range(2)]
    for i in range(n):
        delta = attention_delta(part(o, i), part(do, i))
        lse_i = part(lse, i).contiguous()  # the kernel reads it flat
        dq = torch.zeros(part(q, i).shape, dtype=torch.float32,
                         device=q.device)
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

    Times: each block kind, the merge, Delta at one rank's length, the
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
    counters = kernel_counters()
    for c in counters:
        c.launches = 0
    runs = {(n, causal): ring_emulate(q, k, v, do, n, causal)
            for causal in (True, False) for n in RING_RANKS}
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    blocks = sum(len(ring_blocks(i, n, causal)) for n in RING_RANKS
                 for causal in (True, False) for i in range(n))
    want = {"flash_attention_fwd": blocks, "attention_delta":
            2 * sum(RING_RANKS), "flash_attention_bwd": blocks,
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0}
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
        full = dict(zip(("dq", "dk", "dv"), att.flash_attention_bwd_rows(
            q, k, v, do, lse_f, delta_f, causal)))
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
    and backward, a merge, Delta at one rank's length, the whole emulated
    ring (every rank's blocks on this one card) and the busiest rank's
    share (the last one, which attends to every block). Beside each block
    kind and the unsharded kernels, the library's call on the same inputs
    (yardsticks the port never calls): one sdpa forward, the backward of
    one (with its own Delta), and for Delta ``torch.linalg.vecdot``."""
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
        "delta": lambda: att.attention_delta(o_f, do),
        "library_fwd": lib_fwd, "library_bwd": lib_bwd,
        "library_delta": lambda: torch.linalg.vecdot(o_f, do, dim=-1)}
    for n in RING_RANKS:
        L = S // n
        qs, ks, vs, dos = (x[:, :L] for x in (q, k, v, do))
        o_b, lse_b = attend_block(qs, ks, vs, False)
        o32 = o_b.float()
        delta = att.attention_delta(o_b, dos)
        dq_b = torch.zeros(qs.shape, dtype=torch.float32, device=q.device)
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
            "delta": lambda: att.attention_delta(o_b, dos),
            "whole_ring": lambda: ring_emulate(q, k, v, do, n, causal),
            "library_fwd_diagonal": diag_fwd,
            "library_fwd_off_diagonal": off_fwd,
            "library_bwd_diagonal": diag_bwd,
            "library_bwd_off_diagonal": off_bwd,
            "library_delta": lambda: torch.linalg.vecdot(o_b, dos, dim=-1)}
        times = {key: [] for key in runs}
        for r in range(TIME_ROUNDS):
            for key in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
                iters = 2 if key == "whole_ring" else 20
                times[key].append(cuda_time_ms(runs[key], iters, warmup=1))
        ms = {key: sorted(t)[len(t) // 2] for key, t in times.items()}
        # the busiest rank, the last: its diagonal, n - 1 full blocks and
        # n - 1 merges forward; Delta, the diagonal and n - 1 full blocks
        # backward
        ms["last_rank_fwd"] = (ms["fwd_diagonal"] + (n - 1)
                               * (ms["fwd_off_diagonal"] + ms["merge"]))
        ms["last_rank_bwd"] = (ms["delta"] + ms["bwd_diagonal"] + (n - 1)
                               * ms["bwd_off_diagonal"])
        # the plain versions once, at one block (the whole sequence's fp32
        # scores, 16 GB a tensor at 16384, are not timed)
        ms["plain_fwd_diagonal"] = cuda_time_ms(
            lambda: att.flash_attention_fwd_plain(qs, ks, vs, causal), 3,
            warmup=1)
        ms["plain_bwd_diagonal"] = cuda_time_ms(
            lambda: att.flash_attention_bwd_plain(qs, ks, vs, o_b, lse_b,
                                                  dos, causal), 3, warmup=1)
        ms["plain_delta"] = cuda_time_ms(
            lambda: att.attention_delta_plain(o_b, dos), 20)
        ms["delta_launches"] = time_delta_launches(
            o_b, dos, card, f"ring block 1 x {L}")
        out[n] = ms
    base = {key: cuda_time_ms(fn, 20) for key, fn in unsharded.items()}
    base["delta_launches"] = time_delta_launches(o_f, do, card,
                                                 f"ring unsharded 1 x {S}")
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
                "attention_delta": cfg.n_layers,
                "flash_attention_bwd": cfg.n_layers,
                "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0},
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
    beside ``flash_bound`` and ``bwd_bound``, the forward's and Delta's
    launches alone (``time_launches``), and the plain versions timed."""
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
                                                  causal), 3, warmup=1),
        "flash_bwd_delta": cuda_time_ms(
            lambda: att.attention_delta_plain(o, do), 20)}
    bounds = {"flash_fwd": flash_bound(B, H, KVH, D, S, causal, 2),
              "flash_bwd": bwd_bound("flash_bwd", B, H, KVH, D, S, causal,
                                     2),
              "flash_bwd_delta": bwd_bound("flash_bwd_delta", B, H, KVH, D,
                                           S, causal, 2)}
    library = {"flash_fwd": "library_fwd", "flash_bwd": "library_bwd",
               "flash_bwd_delta": "library_delta"}
    max_err = {"flash_fwd": errs["o"]["max_abs"],
               "flash_bwd": max(errs[key]["max_abs"]
                                for key in ("dq", "dk", "dv")),
               "flash_bwd_delta": errs["delta"]["max_abs"]}
    out = {kernel: {"shape": [B, S, H, KVH, D], "causal": causal,
                    "ms": ms[kernel], "bound_ms": b, "bound_by": by,
                    "plain_ms": plain[kernel],
                    "library_ms": ms[library[kernel]],
                    "max_abs_err": max_err[kernel]}
           for kernel, (b, by) in bounds.items()}
    out["flash_bwd"]["backward_ms"] = ms["backward"]
    out["flash_bwd_delta"].update(time_delta_launches(o, do, card, where))
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
    return out


def phase_tensor_parallel(card: str):
    """The tensor axis's per-rank math at full width (TP_CASES), for
    virtual ranks in one process on the card: each rank's ``Attention``
    and ``MLP`` (``tp_rank_modules``: its query and KV heads and MLP
    columns) run forward and backward through the flash kernels, the
    partial products and the norms' gradients summed in-process in rank
    order (``tp_block_on_ranks``), launches counted over those runs alone
    (T forward, Delta and ``flash_bwd`` launches at T ranks); then held
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

    counters = kernel_counters()
    launches = {c.__name__: 0 for c in counters}
    report = {"card": card, "blocks": {}, "cross_entropy": {}}
    times = {"flash_fwd": {}, "flash_bwd": {}, "flash_bwd_delta": {}}
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
            for c in counters:
                c.launches = 0
            runs[T] = tp_block_grads(block, ranks, x, pos, dout)
            torch.cuda.synchronize()
            got = {c.__name__: c.launches for c in counters}
            want = {"flash_attention_fwd": T, "attention_delta": T,
                    "flash_attention_bwd": T, "flash_attention_bwd_dq": 0,
                    "flash_attention_bwd_dkv": 0}
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
    ``flash_bwd`` launches and n Delta), held against the whole block with
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
    counters = kernel_counters()
    launches = {c.__name__: 0 for c in counters}
    report = {"card": card, "blocks": {}}
    times = {"flash_fwd": {}, "flash_bwd": {}, "flash_bwd_delta": {}}
    block = tp_block(cfg, seed=12)
    gen = torch.Generator(device="cuda").manual_seed(13)
    x, dout = (torch.randn(B, S, cfg.d_model, generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(2))
    x.requires_grad_()
    names = ["x"] + [k for k, _ in block.named_parameters()]
    runs = {}
    for n in SEQ_RANKS:
        for c in counters:
            c.launches = 0
        out = seq_block_on_ranks(block, x, n)
        grads = torch.autograd.grad(out, [x] + list(block.parameters()),
                                    dout)
        torch.cuda.synchronize()
        got = {c.__name__: c.launches for c in counters}
        pairs = n * (n + 1) // 2
        want = {"flash_attention_fwd": pairs, "attention_delta": n,
                "flash_attention_bwd": pairs, "flash_attention_bwd_dq": 0,
                "flash_attention_bwd_dkv": 0}
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
# order: they part only where flash_bwd adds dQ's key-tile shares by TMA
# reduce-add in the order the CTAs arrive (fp32, 2^-24 of a partial sum an
# addition), which moves a gradient by about 1e-6 of its size. Adam's early
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
                "attention_delta": cfg.n_layers,
                "flash_attention_bwd": cfg.n_layers,
                "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0},
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
# steps on the same batches from the same weights, which part only by
# flash_bwd's reduce-add order (TRACED_LOSS_RTOL's reasoning, over
# CKPT_STEPS steps); the first loss precedes any update: equal.
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

        counters = kernel_counters()
        for c in counters:
            c.launches = 0
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
        launches = {c.__name__: c.launches for c in counters}
        # against run B, which held the same state at the save: the first
        # resumed step is B's step 4 on the same state and batch through a
        # deterministic forward, so equal; the rest part only by flash_bwd
        # from step 4 on
        check_losses("resumed run", losses_r, losses_b[CKPT_SAVE_AT:],
                     ref="run B")
        check_losses("resumed run", losses_r, losses_a[CKPT_SAVE_AT:],
                     first_equal=False)
        n_steps = 2 * CKPT_STEPS + CKPT_STEPS - CKPT_SAVE_AT
        want = {"flash_attention_fwd": (2 if cfg.remat else 1)
                * cfg.n_layers * n_steps,
                "attention_delta": cfg.n_layers * n_steps,
                "flash_attention_bwd": cfg.n_layers * n_steps,
                "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0}
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
    dev = phase_device()
    phase_build()
    fwd = phase_kernels(dev["card"])
    bwd = phase_bwd_kernels(dev["card"])
    d64 = phase_d64_kernels(dev["card"])
    paths = {"training": phase_training(dev["card"])}
    phase_moe_layer(dev["card"])
    paths["moe_training"] = phase_training(dev["card"], MOE_CONFIG,
                                           "moe training")
    paths["vit_training"] = phase_vit_training(dev["card"])
    serve_launches = phase_serving(dev["card"])["launches"]
    paths.update(phase_parallel(dev["card"]))
    t0 = time.perf_counter()
    paths["tensor_parallel"], tp = phase_tensor_parallel(dev["card"])
    log(f"tensor parallel: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    paths["seq_parallel"], sp = phase_seq_parallel(dev["card"])
    phase_expert_parallel(dev["card"])
    log(f"seq and expert parallel: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    paths["traced_training"] = phase_traced_training(dev["card"])
    log(f"traced training: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    paths["checkpointed_training"] = phase_checkpointed_training(dev["card"])
    log(f"checkpointed training: {time.perf_counter() - t0:.2f} s")
    wrapper = {"flash_fwd": "flash_attention_fwd",
               "flash_bwd": "flash_attention_bwd",
               "flash_bwd_delta": "attention_delta",
               "flash_bwd_dq": "flash_attention_bwd_dq",
               "flash_bwd_dkv": "flash_attention_bwd_dkv"}
    by_path = {kernel: {path: launches[fn] for path, launches in
                        paths.items()} for kernel, fn in wrapper.items()}
    by_path["flash_fwd"]["serving"] = serve_launches
    source = {"flash_fwd": "ray_tpu_torch/csrc/flash_fwd.cu",
              "flash_bwd": "ray_tpu_torch/csrc/flash_bwd.cu",
              "flash_bwd_delta": "ray_tpu_torch/csrc/flash_bwd.cu",
              "flash_bwd_dq": "ray_tpu_torch/csrc/flash_bwd.cu",
              "flash_bwd_dkv": "ray_tpu_torch/csrc/flash_bwd.cu"}
    # flash_bwd_delta stands for plain XLA code (the JAX package computes
    # Delta outside its kernels), not for a Pallas kernel
    replaces = {"flash_fwd": "ray_tpu/ops/attention.py:45",
                "flash_bwd": ["ray_tpu/ops/attention.py:147",
                              "ray_tpu/ops/attention.py:184"],
                "flash_bwd_delta": "ray_tpu/ops/attention.py:236",
                "flash_bwd_dq": "ray_tpu/ops/attention.py:147",
                "flash_bwd_dkv": "ray_tpu/ops/attention.py:184"}
    measured = {"flash_fwd": fwd, **{k: bwd[k] for k in (
        "flash_bwd", "flash_bwd_delta", "flash_bwd_dq", "flash_bwd_dkv")}}
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
            **{key: entry[key] for key in ("mma_ms", "backward_ms",
                                           "train_shape") if key in entry},
            **({"d64_shapes": d64[name]} if name in d64 else {}),
            **({"tensor_parallel_shapes": tp[name]} if name in tp else {}),
            **({"seq_parallel_shapes": sp[name]} if name in sp else {})})
    log(dev["card"])
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": dev["report"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
