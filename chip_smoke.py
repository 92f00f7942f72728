#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

1. device: the card's name, count, and ``nvidia-smi``'s name and power limit;
2. build: every kernel of the training and serving paths built from
   ``ray_tpu_torch/csrc`` with nvcc for sm_90a (one nvcc per source, all
   at once), with nvcc's ``-Xptxas -v`` report;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the two paths give it, in bf16 and fp32, causal and full;
   its time, the plain version's, one PyTorch library call's, and the bound:
   the flash forward at the serving and training shapes, the two backward
   kernels at the 1b training shape and at 350m's head dims;
4. training: ``TrainStepBundle`` at the 1b config's full width and depth
   (random weights from a seed) takes steps on one batch of 4 x 2048
   tokens; the loss must fall, the kernels must launch 2 x n_layers
   (forward and remat) and n_layers (each backward kernel) times a step,
   and one step's loss and gradients are held against the same step with
   plain attention; step time, tokens/s, MFU, peak memory, and where a
   step's device time goes (``torch.profiler``);
5. serving: ``LLMServer`` over ``TorchLLMEngine`` at the 1b config's full
   width (random weights from a seed, default engine geometry) answers
   concurrent completion requests; the kernel launch counts of that run
   are held against the prefill calls, and one admitted batch's prefill
   logits against the same batch with plain attention.

Each path's launch counts are set to 0 just before it runs and read just
after, so the comparisons with the plain versions do not count.

The line before the last is ``{"kernels": [...]}`` (a kernel's ``launches``
is the sum over the paths it lies on, ``launches_by_path`` splits it; its
times are at the serving shape for the forward and the training shape for
the backward); the last line is ``{"ok": true, "device": {...}}``. With no
card, or outside a checkout of the repository, it prints no result and
exits non-zero.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
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

H100_BF16_FLOPS = 989e12   # dense tensor-core peak (data sheet, 700 W)
H100_HBM_BYTES = 3.35e12   # HBM3 bytes/s (data sheet)

TRAIN_SHAPE = (4, 16, 8, 128, 2048)  # (B, H, KVH, D, S): 1b, batch 4 x 2048
KERNEL_SHAPES = (  # the 1b prefill buckets, 350m's D, the 1b training shape
    [(8, 16, 8, 128, s) for s in (32, 77, 128, 1000, 2048)]
    + [(8, 16, 16, 64, 1024), TRAIN_SHAPE])
MAIN_SHAPE = (8, 16, 8, 128, 2048)  # 1b, 8 slots, the longest bucket
# the backward kernels: 1b training, and 350m's head dims (batch 8 x 1024)
BWD_SHAPES = (TRAIN_SHAPE, (8, 16, 16, 64, 1024))
TRAIN_CONFIG, TRAIN_BATCH, TRAIN_SEQ = "1b", 4, 2048
TRAIN_STEPS, TRAIN_WARMUP = 7, 2  # steps on one batch; the first 2 untimed
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
    """flash_bwd_dq: Q K^T, dO V^T, dS K (6 D FLOPs a pair); reads q, k, v,
    dO, lse, Delta and writes dq. flash_bwd_dkv: K Q^T, V dO^T, P^T dO,
    dS^T Q (8 D FLOPs a pair); the same reads, writes dk and dv."""
    products = 3 if kernel == "flash_bwd_dq" else 4
    flops = 2.0 * products * D * _pairs(S, causal) * B * H
    reads = B * S * (2 * H + 2 * KVH) * D * itemsize + 2 * B * H * S * 4
    writes = B * S * (H if products == 3 else 2 * KVH) * D * itemsize
    return roofline(flops, reads + writes)


# -- phases ----------------------------------------------------------------


def phase_device() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    from ray_tpu_torch.utils import device_report

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
    entry, train_shape = {}, {}
    for (B, H, KVH, D, S) in KERNEL_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn(B, S, H, D, generator=gen, device="cuda", dtype=dtype)
            k = torch.randn(B, S, KVH, D, generator=gen, device="cuda", dtype=dtype)
            v = torch.randn(B, S, KVH, D, generator=gen, device="cuda", dtype=dtype)
            for causal in (True, False):
                o, lse = flash_attention_fwd(q, k, v, causal)
                torch.cuda.synchronize()
                o_ref, lse_ref = flash_attention_fwd_plain(q, k, v, causal)
                pv = flash_attention_fwd_plain(q, k, v.abs(), causal)[0]
                name = str(dtype).split(".")[-1]
                where = (f"B={B} S={S} H={H} KVH={KVH} D={D} {name:8s} "
                         f"causal={int(causal)}")
                errs = {key: compare("flash_fwd", key, got, ref,
                                     TOL[name][key], where, pv)
                        for key, got, ref in (("o", o, o_ref),
                                              ("lse", lse, lse_ref))}
                log(f"check flash_fwd {where}: o {errs['o']}; lse "
                    f"{errs['lse']} [tol {TOL[name]}]")
                for key in worst:
                    worst[key] = max(worst[key], errs[key]["max_abs"])
                del o, lse, o_ref, lse_ref, pv
            if dtype == torch.bfloat16:
                ms = cuda_time_ms(lambda: flash_attention_fwd(q, k, v, True), 20)
                bound, by = flash_bound(B, H, KVH, D, S, True, 2)
                log(f"time flash_fwd B={B} S={S} H={H} KVH={KVH} D={D} bf16 "
                    f"causal: {ms:.4f} ms, bound {bound:.4f} ms ({by}), "
                    f"{100 * bound / ms:.1f}% of bound [{card}]")
                if (B, H, KVH, D, S) == MAIN_SHAPE:
                    entry = time_against_plain(q, k, v, ms, bound, by, card)
                if (B, H, KVH, D, S) == TRAIN_SHAPE:
                    train_shape = time_against_plain(q, k, v, ms, bound, by,
                                                     card)
            del q, k, v
    entry["max_abs_err"] = worst["o"]
    entry["max_err"] = {"o": worst["o"], "lse": worst["lse"]}
    entry["train_shape"] = train_shape
    return entry


O_BINS = (0.0, 0.125, 0.5, 2.0, float("inf"))  # |ref| ranges of the report


def compare(kernel, key, got, ref, tol, where, mag) -> dict:
    """Kernel against plain: raises beyond ``atol + rtol * |ref| + m * mag``
    (see ``TOL``, ``BWD_TOL``). Returns the max abs error, the least atol
    that passes with this rtol and mag term, and for the attention outputs
    (not lse) the max abs error in each range of |ref|."""
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
    if key != "lse":
        for lo, hi in zip(O_BINS, O_BINS[1:]):
            sel = (size >= lo) & (size < hi)
            out[f"|{key}| in [{lo}, {hi})"] = (
                diff[sel].max().item() if bool(sel.any()) else None)
    if not bool((diff <= atol + rel).all()):
        raise AssertionError(f"{kernel} {key} disagrees with plain at "
                             f"{where}: {out} (tol {tol})")
    return out


def time_against_plain(q, k, v, ms, bound, by, card) -> dict:
    """The plain version's and the library's times beside the kernel's."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops.attention import flash_attention_fwd_plain

    plain_ms = cuda_time_ms(lambda: flash_attention_fwd_plain(q, k, v, True),
                            5, warmup=1)
    # yardstick only: one library call on the same inputs (K/V repeated to
    # H heads outside the timed region); the port never calls it
    rep = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(rep, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    library_ms = cuda_time_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), 20)
    B, S, H, D = q.shape
    log(f"time flash_fwd at {(B, H, k.shape[2], D, S)} bf16 causal: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library (sdpa) "
        f"{library_ms:.4f} ms, bound {bound:.4f} ms ({by}) [{card}]")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound, "bound_by": by}


def phase_bwd_kernels(card: str) -> dict:
    """Both backward kernels against the plain backward on the same inputs
    (the forward kernel's o and lse, a random dO), then their times at the
    training shape. Returns the two kernels' entries of the kernels line."""
    import torch

    from ray_tpu_torch.ops.attention import (attention_delta,
                                             bwd_products, bwd_softmax_grads,
                                             flash_attention_bwd_dkv,
                                             flash_attention_bwd_dq,
                                             flash_attention_fwd)

    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = {"flash_bwd_dq": {"dq": 0.0},
             "flash_bwd_dkv": {"dk": 0.0, "dv": 0.0}}
    entries = {}
    for (B, H, KVH, D, S) in BWD_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do = (torch.randn(B, S, h, D, generator=gen,
                                       device="cuda", dtype=dtype)
                           for h in (H, KVH, KVH, H))
            name = str(dtype).split(".")[-1]
            for causal in (True, False):
                o, lse = flash_attention_fwd(q, k, v, causal)
                delta = attention_delta(o, do)
                dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
                dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                 causal)
                torch.cuda.synchronize()
                # the plain backward on the same o, lse and Delta, and the
                # same products on absolute values (the tolerance's M)
                p, ds = bwd_softmax_grads(q, k, v, do, lse, delta, causal)
                ref = [x.to(dtype) for x in bwd_products(p, ds, q, k, do)]
                mag = bwd_products(p, ds.abs(), q.abs(), k.abs(), do.abs())
                del p, ds
                where = (f"B={B} S={S} H={H} KVH={KVH} D={D} {name:8s} "
                         f"causal={int(causal)}")
                for kernel, key, got, r, m in (
                        ("flash_bwd_dq", "dq", dq, ref[0], mag[0]),
                        ("flash_bwd_dkv", "dk", dk, ref[1], mag[1]),
                        ("flash_bwd_dkv", "dv", dv, ref[2], mag[2])):
                    err = compare(kernel, key, got, r, BWD_TOL[name], where, m)
                    log(f"check {kernel} {key} {where}: {err} "
                        f"[tol {BWD_TOL[name]}]")
                    worst[kernel][key] = max(worst[kernel][key],
                                             err["max_abs"])
                del o, lse, delta, dq, dk, dv, ref, mag
            if (B, H, KVH, D, S) == TRAIN_SHAPE and dtype == torch.bfloat16:
                entries = time_bwd(q, k, v, do, card)
            del q, k, v, do
    for kernel, errs in worst.items():
        entries[kernel]["max_abs_err"] = max(errs.values())
        entries[kernel]["max_err"] = errs
    return entries


def time_bwd(q, k, v, do, card) -> dict:
    """The backward kernels, the plain backward and the library's backward
    at the training shape, bf16, causal."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops.attention import (attention_delta,
                                             flash_attention_bwd_dkv,
                                             flash_attention_bwd_dq,
                                             flash_attention_bwd_plain,
                                             flash_attention_fwd)

    B, S, H, D = q.shape
    KVH = k.shape[2]
    o, lse = flash_attention_fwd(q, k, v, True)
    delta = attention_delta(o, do)
    ms = {"flash_bwd_dq": cuda_time_ms(
              lambda: flash_attention_bwd_dq(q, k, v, do, lse, delta, True),
              20),
          "flash_bwd_dkv": cuda_time_ms(
              lambda: flash_attention_bwd_dkv(q, k, v, do, lse, delta, True),
              20)}
    # the plain backward computes both kernels' outputs (and Delta) at once
    plain_ms = cuda_time_ms(
        lambda: flash_attention_bwd_plain(q, k, v, o, lse, do, True), 5,
        warmup=1)
    # yardstick only: the backward of one library call on the same inputs
    # (K/V repeated to H heads outside the timed region; the forward is not
    # timed); it covers both kernels. The port never calls it.
    rep = H // KVH
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k.repeat_interleave(rep, dim=2),
                            v.repeat_interleave(rep, dim=2)))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    library_ms = cuda_time_ms(
        lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                    retain_graph=True), 20)
    entries = {}
    for kernel, t in ms.items():
        bound, by = bwd_bound(kernel, B, H, KVH, D, S, True, q.element_size())
        log(f"time {kernel} at the training shape {TRAIN_SHAPE} bf16 causal:"
            f" kernel {t:.4f} ms, bound {bound:.4f} ms ({by}), "
            f"{100 * bound / t:.1f}% of bound; plain backward (both kernels)"
            f" {plain_ms:.4f} ms; library backward (sdpa, both kernels) "
            f"{library_ms:.4f} ms [{card}]")
        entries[kernel] = {"ms": t, "plain_ms": plain_ms,
                           "library_ms": library_ms, "bound_ms": bound,
                           "bound_by": by}
    return entries


def phase_training(card: str) -> dict:
    """The 1b model trained for TRAIN_STEPS steps on one batch through
    ``TrainStepBundle`` with the kernels. Returns each kernel's launches in
    that run."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import CONFIGS
    from ray_tpu_torch.ops.attention import (flash_attention_bwd_dkv,
                                             flash_attention_bwd_dq,
                                             flash_attention_fwd)
    from ray_tpu_torch.parallel import TrainStepBundle, make_optimizer

    cfg = CONFIGS[TRAIN_CONFIG]
    t0 = time.perf_counter()
    bundle = TrainStepBundle(cfg, device="cuda", optimizer=make_optimizer(
        learning_rate=1e-4, warmup_steps=1))
    params, opt_state = bundle.init(seed=0)
    batch = bundle.make_batch(np.random.default_rng(0), TRAIN_BATCH,
                              TRAIN_SEQ)
    torch.cuda.synchronize()
    log(f"training: {TRAIN_CONFIG} bundle up in {time.perf_counter() - t0:.2f}"
        f" s ({cfg.num_params() / 1e9:.3f} B params, {cfg.n_layers} layers, "
        f"remat={cfg.remat}), batch {TRAIN_BATCH} x {TRAIN_SEQ}")
    grad_check = check_training_grads(bundle, params, batch)

    counters = (flash_attention_fwd, flash_attention_bwd_dq,
                flash_attention_bwd_dkv)
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, opt_state, loss = bundle.step(params, opt_state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(loss)
    launches = {c.__name__: c.launches for c in counters}
    peak_bytes = torch.cuda.max_memory_allocated()
    losses = [x.item() for x in losses]

    if not all(np.isfinite(losses)):
        raise AssertionError(f"training loss not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"training loss did not fall: {losses}")
    per_step = {"flash_attention_fwd": (2 if cfg.remat else 1) * cfg.n_layers,
                "flash_attention_bwd_dq": cfg.n_layers,
                "flash_attention_bwd_dkv": cfg.n_layers}
    want = {k: n * TRAIN_STEPS for k, n in per_step.items()}
    if launches != want:
        raise AssertionError(f"training launched {launches}, want {want} "
                             f"({per_step} a step x {TRAIN_STEPS} steps)")
    log(f"training: {TRAIN_STEPS} steps, losses {losses}; launches "
        f"{launches} = {per_step} a step")

    timed = sorted(times[TRAIN_WARMUP:])
    step_s = timed[len(timed) // 2]
    tokens_per_s = TRAIN_BATCH * TRAIN_SEQ / step_s
    breakdown = profile_step(bundle, params, opt_state, batch)
    metrics = {
        "card": card, "config": TRAIN_CONFIG, "batch": TRAIN_BATCH,
        "seq": TRAIN_SEQ, "steps": TRAIN_STEPS, "losses": losses,
        "step_s_median": step_s, "step_s": times,
        "tokens_per_s": tokens_per_s,
        "mfu": tokens_per_s * cfg.flops_per_token() / H100_BF16_FLOPS,
        "flops_per_token": cfg.flops_per_token(),
        "max_memory_allocated_bytes": peak_bytes,
        "launches_per_step": {k: n // TRAIN_STEPS
                              for k, n in launches.items()},
        "grad_check": grad_check, "device_ms_by_part": breakdown,
    }
    log("training metrics: " + json.dumps(metrics))
    return launches


def check_training_grads(bundle, params, batch) -> dict:
    """One step's loss and gradients through the kernels against the same
    step with plain attention (``attention_impl="xla"``), from the same
    params and batch (see TRAIN_LOSS_TOL, TRAIN_GRAD_TOL)."""
    import torch

    from ray_tpu_torch.models import Transformer, lm_loss

    plain = Transformer(dataclasses.replace(bundle.cfg, attention_impl="xla"),
                        device=bundle.device, params=params)
    result = {}
    for name, model in (("kernel", bundle.model), ("plain", plain)):
        weights = [p for _, p in model.named_parameters()]
        loss = lm_loss(model(batch["tokens"]), batch["targets"],
                       batch["mask"])
        result[name] = (loss.detach(), torch.autograd.grad(loss, weights))
    (loss_k, grads_k), (loss_p, grads_p) = result["kernel"], result["plain"]
    rel = {key: ((gk.float() - gp.float()).norm()
                 / gp.float().norm().clamp_min(1e-30)).item()
           for key, gk, gp in zip(params, grads_k, grads_p)}
    worst = max(rel, key=rel.get)
    check = {"loss_kernel": loss_k.item(), "loss_plain": loss_p.item(),
             "max_leaf_rel_err": rel[worst], "worst_leaf": worst,
             "median_leaf_rel_err": sorted(rel.values())[len(rel) // 2]}
    log(f"training: one step, kernels vs plain attention: {check}")
    if not abs(check["loss_kernel"] - check["loss_plain"]) <= TRAIN_LOSS_TOL:
        raise AssertionError(f"training loss differs beyond {TRAIN_LOSS_TOL}")
    if not rel[worst] <= TRAIN_GRAD_TOL:
        raise AssertionError(f"gradient of {worst} differs by {rel[worst]} "
                             f"(relative), beyond {TRAIN_GRAD_TOL}")
    return check


MM_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::matmul")


def profile_step(bundle, params, opt_state, batch) -> dict:
    """One more step under ``torch.profiler``: device ms of the flash
    kernels, of the matrix products by the layer their shapes name
    (attention projections, MLP, lm_head), of the optimizer's foreach ops,
    and of the rest. The full table goes to chiprun_out/."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cfg = bundle.cfg
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        bundle.step(params, opt_state, batch)
        torch.cuda.synchronize()
    parts = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0,
             "attn_projections": 0.0, "mlp": 0.0, "lm_head": 0.0,
             "other_matmul": 0.0, "optimizer": 0.0}
    total = 0.0
    averages = prof.key_averages(group_by_input_shape=True)
    for evt in averages:
        ms = evt.self_device_time_total / 1e3
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            total += ms
            for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
                if f"{kernel}_kernel" in evt.key:
                    parts[kernel] += ms
            continue
        if evt.key in MM_OPS:
            dims = {d for shape in evt.input_shapes for d in shape}
            if cfg.vocab_size in dims:
                parts["lm_head"] += ms
            elif cfg.d_ff in dims:
                parts["mlp"] += ms
            elif cfg.d_model in dims:
                parts["attn_projections"] += ms
            else:
                parts["other_matmul"] += ms
        elif evt.key.startswith("aten::_foreach"):
            parts["optimizer"] += ms
    parts["other"] = total - sum(parts.values())
    parts["total"] = total
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "train_step_profile.txt"), "w") as f:
        f.write(averages.table(sort_by="self_device_time_total",
                               row_limit=60))
    log(f"training: one profiled step, device ms by part {parts}")
    return parts


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


def main() -> int:
    dev = phase_device()
    phase_build()
    fwd = phase_kernels(dev["card"])
    bwd = phase_bwd_kernels(dev["card"])
    train_launches = phase_training(dev["card"])
    serve_launches = phase_serving(dev["card"])["launches"]
    by_path = {
        "flash_fwd": {"training": train_launches["flash_attention_fwd"],
                      "serving": serve_launches},
        "flash_bwd_dq": {"training": train_launches["flash_attention_bwd_dq"]},
        "flash_bwd_dkv": {
            "training": train_launches["flash_attention_bwd_dkv"]},
    }
    source = {"flash_fwd": "ray_tpu_torch/csrc/flash_fwd.cu",
              "flash_bwd_dq": "ray_tpu_torch/csrc/flash_bwd.cu",
              "flash_bwd_dkv": "ray_tpu_torch/csrc/flash_bwd.cu"}
    replaces = {"flash_fwd": "ray_tpu/ops/attention.py:45",
                "flash_bwd_dq": "ray_tpu/ops/attention.py:147",
                "flash_bwd_dkv": "ray_tpu/ops/attention.py:184"}
    measured = {"flash_fwd": fwd, **bwd}
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
            **({"train_shape": entry["train_shape"]}
               if "train_shape" in entry else {})})
    log(dev["card"])
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": dev["report"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
