"""Tests of the port that need the card: the CUDA kernels against their
plain PyTorch versions, and the serving and training paths through them.

They skip on a machine without a CUDA device. This file imports no jax, so
it runs where the JAX reference is missing; on the card run

    python -m pytest --noconftest -m gpu tests/test_torch_*.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from ray_tpu_torch.llm import model_runner as mr
from ray_tpu_torch.llm.config import EngineConfig, LLMConfig, SamplingParams
from ray_tpu_torch.llm.engine import TorchLLMEngine
from ray_tpu_torch.models import (CONFIGS, VIT_CONFIGS, MoEMLP,
                                  VisionTransformer, classification_loss)
from ray_tpu_torch.ops.attention import (attention, attention_delta,
                                         attention_delta_plain,
                                         bwd_products, bwd_softmax_grads,
                                         flash_attention_bwd,
                                         flash_attention_bwd_dkv,
                                         flash_attention_bwd_dq,
                                         flash_attention_fwd,
                                         flash_attention_fwd_plain)
from ray_tpu_torch.parallel import TrainStepBundle, make_optimizer

pytestmark = pytest.mark.gpu

# kernel vs plain on the same inputs, (atol, rtol, pv): an element of o
# passes within atol + rtol * |o| + pv * (P |V|), P |V| being the plain
# version's output on |v|. fp32 at the reference's flash bound (the
# kernel's bf16 hi/lo split keeps ~16 mantissa bits). bf16: kernel and plain
# round the probabilities to bf16 at different points (unnormalised and
# normalised), each within 2^-8, which moves P V by at most 2^-7 * P |V|
# when they fall on opposite sides; the term is set at 2^-8, which the
# independent roundings stay under (chip_smoke.TOL), and both round o to
# bf16 (under rtol). lse is an fp32 sum of exact products in both.
TOL = {torch.bfloat16: (1e-3, 2e-2, 2.0 ** -8),
       torch.float32: (2e-3, 2e-2, 0.0)}
# the backward kernels vs the plain backward, (atol, rtol, m): an element of
# dq, dk, dv passes within atol + rtol * |ref| + m * M, M being the same
# product on absolute values (|dS| |K|, |dS|^T |Q|, P^T |dO|). bf16: the
# kernels round P and dS to bf16 (within 2^-8 of the value) before the
# products that take them; the plain version keeps them in fp32; both round
# the result to bf16 (under rtol); the atol covers fp32 sums in other orders
# where dP - Delta cancels. fp32 as for the forward (chip_smoke.BWD_TOL).
BWD_TOL = {torch.bfloat16: (1e-4, 2e-2, 2.0 ** -8),
           torch.float32: (2e-3, 2e-2, 0.0)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


# (B, S, H, KVH, D, fused): S not a multiple of the kernels' 128-row tiles
# (77, 1000, 1), one tile (256 = 2 tiles), both head dims, GQA and MHA, and
# q, k, v as non-contiguous slices of one fused (B, S, H + 2 KVH, D) tensor
# and a tensor rank's heads: 2 query and 1 KV head (the 1b at tensor 8 at
# D=128; the block of test_block_on_two_tensor_ranks_on_the_card at D=64)
FLASH_CASES = [(2, 77, 4, 2, 64, False), (2, 256, 4, 4, 128, False),
               (1, 1000, 16, 8, 128, False), (3, 1, 4, 1, 64, False),
               (2, 1000, 4, 4, 64, False), (2, 77, 8, 2, 128, False),
               (2, 1000, 16, 8, 128, True), (1, 77, 4, 4, 64, True),
               (2, 256, 2, 1, 64, False), (1, 1000, 2, 1, 128, False)]


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_matches_plain(cuda_device, dtype, case):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    atol, rtol, pv_tol = TOL[dtype]
    B, S, H, KVH, D, fused = case
    if fused:
        qkv = torch.randn(B, S, H + 2 * KVH, D, generator=gen,
                          device=cuda_device, dtype=dtype)
        q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KVH], qkv[:, :, H + KVH:]
    else:
        q, k, v = (torch.randn(B, S, h, D, generator=gen, device=cuda_device,
                               dtype=dtype) for h in (H, KVH, KVH))
    for causal in (True, False):
        before = flash_attention_fwd.launches
        o, lse = flash_attention_fwd(q, k, v, causal)
        torch.cuda.synchronize()
        assert flash_attention_fwd.launches == before + 1
        o_ref, lse_ref = flash_attention_fwd_plain(q, k, v, causal)
        pv = flash_attention_fwd_plain(q, k, v.abs(), causal)[0].float()
        diff = (o.float() - o_ref.float()).abs()
        bound = atol + rtol * o_ref.float().abs() + pv_tol * pv
        assert bool((diff <= bound).all()), (
            f"o off by {diff.max().item():.3e} at {(B, S, H, KVH, D)} "
            f"causal={causal}; worst excess "
            f"{(diff - bound).max().item():.3e}")
        torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0)


def test_flash_kernel_rejects_what_it_cannot_run(cuda_device):
    q = torch.randn(1, 16, 2, 256, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_fwd(q, q, q, True)
    q = torch.randn(1, 16, 2, 64, device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        flash_attention_fwd(q, q, q, True)
    q = torch.randn(1, 16, 2, 128, device=cuda_device)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_fwd(q, q, q, True)
    # bf16 goes through TMA tensor maps: a base off 16 bytes, or rows 136
    # bytes apart, are refused before any launch
    before = flash_attention_fwd.launches
    buf = torch.randn(1 + 16 * 2 * 64, device=cuda_device,
                      dtype=torch.bfloat16)
    for bad in (buf[1:].view(1, 16, 2, 64),
                torch.randn(1, 16, 2, 68, device=cuda_device,
                            dtype=torch.bfloat16)[..., :64]):
        with pytest.raises(ValueError, match="aligned to 16 bytes"):
            flash_attention_fwd(bad, bad, bad, True)
    assert flash_attention_fwd.launches == before


def test_auto_attention_on_the_card_takes_only_the_kernel(cuda_device):
    """On CUDA tensors impl='auto' launches the kernel or raises: a head dim
    it does not take and segment ids are errors, not a plain fallback."""
    q = torch.randn(1, 32, 4, 64, device=cuda_device, dtype=torch.bfloat16)
    before = flash_attention_fwd.launches
    attention(q, q[:, :, :2], q[:, :, :2], True, "auto")
    assert flash_attention_fwd.launches == before + 1
    q16 = torch.randn(1, 32, 4, 16, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        attention(q16, q16, q16, True, "auto")
    seg = torch.zeros(1, 32, dtype=torch.long, device=cuda_device)
    with pytest.raises(ValueError, match="segment_ids"):
        attention(q, q, q, True, "auto", segment_ids=seg)
    assert flash_attention_fwd.launches == before + 1
    plain = attention(q16, q16, q16, True, "xla")  # asked for by name
    assert plain.shape == q16.shape


def test_engine_prefill_runs_the_kernel(cuda_device):
    """A 2-layer model at head_dim 64 in fp32 on the card: greedy tokens
    through the kernel equal those through plain attention, and the kernel
    ran once per layer per prefill call."""
    cfg = LLMConfig(model_id="tiny",
                    engine_config=EngineConfig(max_num_seqs=4,
                                               max_model_len=128,
                                               prefill_bucket_min=16),
                    model_overrides={"d_model": 128, "n_heads": 2,
                                     "n_kv_heads": 1, "dtype": "float32"})
    prompts = ["hello world", "a", "the quick brown fox jumps", "zz" * 20,
               "more requests than slots"]
    sp = SamplingParams(max_tokens=12)
    engine = TorchLLMEngine(cfg, seed=0, device=cuda_device)
    before = flash_attention_fwd.launches
    got = engine.generate(prompts, sp)
    launches = flash_attention_fwd.launches - before
    assert launches == engine.mcfg.n_layers * engine.metrics["prefill_calls"]
    plain_cfg = dataclasses.replace(
        cfg, model_overrides={**cfg.model_overrides, "attention_impl": "xla"})
    plain = TorchLLMEngine(plain_cfg, seed=0, device=cuda_device)
    want = plain.generate(prompts, sp)
    assert [o.token_ids for o in got] == [o.token_ids for o in want]
    assert mr.init_cache(engine.mcfg, 2, 16).k.is_cuda  # cuda by default


# (B, S, H, KVH, D): the 1b head dims (D=128, GQA) and 350m's (D=64, MHA),
# ragged S, one row, and a tensor rank's 2 query and 1 KV head (FLASH_CASES)
BWD_CASES = [(2, 77, 4, 2, 64), (1, 256, 4, 4, 128), (1, 1000, 16, 8, 128),
             (3, 1, 4, 1, 64), (2, 200, 16, 16, 64), (2, 256, 2, 1, 64),
             (1, 1000, 2, 1, 128)]


def _bwd_inputs(device, dtype, case, seed=1):
    gen = torch.Generator(device=device).manual_seed(seed)
    B, S, H, KVH, D = case
    return tuple(torch.randn(B, S, h, D, generator=gen, device=device,
                             dtype=dtype) for h in (H, KVH, KVH, H))


def _assert_bwd_close(name, got, ref, mag, dtype, where):
    atol, rtol, m = BWD_TOL[dtype]
    ref = ref.to(dtype).float()
    diff = (got.float() - ref).abs()
    bound = atol + rtol * ref.abs() + m * mag
    assert bool((diff <= bound).all()), (
        f"{name} off by {diff.max().item():.3e} at {where}; worst excess "
        f"{(diff - bound).max().item():.3e}")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_kernels_match_plain(cuda_device, dtype):
    """The backward kernels against the plain backward on the same o, lse
    and Delta, causal and full: the pair (dQ and dK/dV, each on its own;
    bf16 dK/dV is the TMA / wgmma kernel without dQ) and, in bf16,
    ``flash_bwd`` through ``flash_attention_bwd``, which runs Delta and the
    one fused kernel."""
    for case in BWD_CASES:
        q, k, v, do = _bwd_inputs(cuda_device, dtype, case)
        for causal in (True, False):
            where = f"{case} causal={causal}"
            o, lse = flash_attention_fwd(q, k, v, causal)
            delta = attention_delta(o, do)
            before = (flash_attention_bwd_dq.launches,
                      flash_attention_bwd_dkv.launches)
            dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
            dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
            got = {"dq": dq, "dk": dk, "dv": dv}
            if dtype == torch.bfloat16:
                fused_before = (flash_attention_bwd.launches,
                                attention_delta.launches)
                fused = flash_attention_bwd(q, k, v, o, lse, do, causal)
                assert (flash_attention_bwd.launches,
                        attention_delta.launches) == (fused_before[0] + 1,
                                                      fused_before[1] + 1)
                got.update(zip(("fused dq", "fused dk", "fused dv"), fused))
            torch.cuda.synchronize()
            assert (flash_attention_bwd_dq.launches,
                    flash_attention_bwd_dkv.launches) == (before[0] + 1,
                                                          before[1] + 1)
            assert all(x.dtype == dtype for x in got.values())
            assert dk.shape == dv.shape == k.shape
            p, ds = bwd_softmax_grads(q, k, v, do, lse, delta, causal)
            ref = dict(zip(("dq", "dk", "dv"), bwd_products(p, ds, q, k, do)))
            mag = dict(zip(("dq", "dk", "dv"), bwd_products(
                p, ds.abs(), q.abs(), k.abs(), do.abs())))
            for name, x in got.items():
                key = name.split()[-1]
                _assert_bwd_close(name, x, ref[key], mag[key], dtype, where)


def test_fused_backward_is_repeatable(cuda_device):
    """Two runs of ``flash_bwd`` on the same inputs: dK and dV are the same
    bits (each block keeps its key tile's sums in registers), dQ, added
    across blocks in an order that varies, within BWD_TOL of each other."""
    for case in ((1, 1000, 16, 8, 128), (2, 200, 16, 16, 64)):
        q, k, v, do = _bwd_inputs(cuda_device, torch.bfloat16, case, seed=3)
        o, lse = flash_attention_fwd(q, k, v, True)
        dq1, dk1, dv1 = flash_attention_bwd(q, k, v, o, lse, do, True)
        dq2, dk2, dv2 = flash_attention_bwd(q, k, v, o, lse, do, True)
        torch.cuda.synchronize()
        assert torch.equal(dk1, dk2) and torch.equal(dv1, dv2)
        atol, rtol, _ = BWD_TOL[torch.bfloat16]
        torch.testing.assert_close(dq1.float(), dq2.float(), atol=atol,
                                   rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_delta_kernel_matches_plain(cuda_device, dtype):
    """Delta = rowsum(dO * O) from ``flash_bwd_delta`` against the plain
    expression: both sum exact products in fp32, in other orders."""
    for case in BWD_CASES:
        q, _, _, do = _bwd_inputs(cuda_device, dtype, case, seed=4)
        before = attention_delta.launches
        got = attention_delta(q, do)
        assert attention_delta.launches == before + 1
        want = attention_delta_plain(q, do)
        assert got.dtype == torch.float32 and got.shape == want.shape
        torch.testing.assert_close(got, want, atol=1e-3, rtol=0)


def test_backward_kernels_reject_what_they_cannot_run(cuda_device):
    q = torch.randn(1, 16, 2, 64, device=cuda_device, dtype=torch.bfloat16)
    lse = torch.zeros(2, 16, 1, device=cuda_device)
    delta = torch.zeros(2, 16, device=cuda_device)
    big = torch.randn(1, 16, 2, 256, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_bwd_dq(big, big, big, big, lse, delta, True)
    half = q.half()
    with pytest.raises(TypeError, match="bf16 or fp32"):
        flash_attention_bwd_dkv(half, half, half, half, lse, delta, True)
    with pytest.raises(ValueError, match="do must have"):
        flash_attention_bwd_dq(q, q, q, q[:, :8], lse, delta, True)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd_dq(q, q, q, q, lse.double(), delta, True)
    with pytest.raises(ValueError, match="delta"):
        flash_attention_bwd_dkv(q, q, q, q, lse, delta.t(), True)
    # the fused bf16 backward checks before it launches anything
    before = flash_attention_bwd.launches, attention_delta.launches
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_bwd(big, big, big, big, lse, big, True)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, q, q, q, lse.double(), q, True)
    assert flash_attention_bwd.launches == before[0]
    assert attention_delta.launches == before[1] + 1  # the lse case's Delta


def test_attention_grads_on_the_card_flow_through_the_kernels(cuda_device):
    """The fault of the first slice: on CUDA tensors attention's output had
    no grad_fn, so q, k and v got no gradient. Now impl='auto' goes through
    ``FlashAttention``: its gradients are non-zero, come from the backward
    kernels, and equal the plain path's (autograd through
    ``reference_attention``), fp32."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    q, k, v = (torch.randn(2, 128, h, 64, generator=gen, device=cuda_device)
               .requires_grad_() for h in (4, 2, 2))
    do = torch.randn(2, 128, 4, 64, generator=gen, device=cuda_device)
    counters = (flash_attention_fwd, attention_delta, flash_attention_bwd_dq,
                flash_attention_bwd_dkv, flash_attention_bwd)
    before = [c.launches for c in counters]
    got = torch.autograd.grad(attention(q, k, v, True, "auto"), (q, k, v), do)
    # fp32: Delta and the pair; the fused kernel is bf16's
    assert [c.launches for c in counters] == [n + d for n, d in
                                              zip(before, (1, 1, 1, 1, 0))]
    want = torch.autograd.grad(attention(q, k, v, True, "xla"), (q, k, v), do)
    atol, rtol, _ = BWD_TOL[torch.float32]
    for g, w in zip(got, want):
        assert g.abs().max().item() > 0
        torch.testing.assert_close(g, w, atol=atol, rtol=rtol)


def test_train_step_through_kernels_matches_plain(cuda_device):
    """A 2-layer head_dim-64 fp32 model, 3 steps on one batch through the
    kernels (remat on: 2 forward launches a layer) against the same steps
    with plain attention, from the same params. The losses agree to the
    kernels' fp32 accuracy; params within Adam's update bound (2 x 1.2 x
    sum of lr, as tests/test_torch_train.py derives it)."""
    cfg = dataclasses.replace(CONFIGS["tiny"], d_model=128, n_heads=2,
                              n_kv_heads=1, dtype=torch.float32, remat=True)
    opt_kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    runs = {}
    for impl in ("auto", "xla"):
        bundle = TrainStepBundle(dataclasses.replace(cfg, attention_impl=impl),
                                 device=cuda_device,
                                 optimizer=make_optimizer(**opt_kw))
        params, opt = bundle.init(seed=0)
        batch = bundle.make_batch(np.random.default_rng(0), 4, 96)
        counters = (flash_attention_fwd, flash_attention_bwd_dq,
                    attention_delta, flash_attention_bwd)
        before = [c.launches for c in counters]
        losses = []
        for _ in range(3):
            params, opt, loss = bundle.step(params, opt, batch)
            losses.append(loss.item())
        launched = tuple(c.launches - n for c, n in zip(counters, before))
        runs[impl] = (losses, params, launched)
    # fp32 trains through the pair: Delta and dQ once a layer, no flash_bwd
    assert runs["auto"][2] == (3 * 2 * cfg.n_layers, 3 * cfg.n_layers,
                               3 * cfg.n_layers, 0)
    assert runs["xla"][2] == (0, 0, 0, 0)
    np.testing.assert_allclose(runs["auto"][0], runs["xla"][0], rtol=1e-4)
    sched = make_optimizer(**opt_kw).schedule
    atol = 2 * 1.2 * sum(sched(t) for t in range(3))
    for key, p in runs["auto"][1].items():
        diff = (p - runs["xla"][1][key]).abs().max().item()
        assert diff <= atol, f"{key} parts by {diff:.3e} > {atol:.3e}"


def test_moe_layer_on_the_card_matches_the_cpu(cuda_device, monkeypatch):
    """One ``MoEMLP`` in fp32 (moe-tiny width, 120 tokens in 8 groups of 15
    at half capacity, so slots are dropped) on the card and on the CPU from
    the same weights and input: the same routing, and outputs, aux and
    grads within fp32's rounding of sums taken in other orders. fp32
    products stay fp32 on the card (TF32 off), so no routing choice
    flips."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(MoEMLP, "GROUP_SIZE", 16)
    cfg = dataclasses.replace(CONFIGS["moe-tiny"], dtype=torch.float32,
                              capacity_factor=0.5)
    layer = MoEMLP(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in layer.parameters():
            p.normal_(0.0, 0.1, generator=gen)
    x = torch.randn(4, 30, cfg.d_model, generator=gen)
    cot = torch.randn(x.shape, generator=gen)
    runs = {}
    for name, dev in (("cpu", "cpu"), ("card", cuda_device)):
        mod = MoEMLP(cfg, device=dev)
        mod.load_state_dict(layer.state_dict())
        xd = x.to(dev).requires_grad_()
        g = mod.group_size(xd.shape[0] * xd.shape[1])
        routing = mod.route(xd.detach().reshape(-1, g, cfg.d_model))
        out, aux = mod(xd)
        grads = torch.autograd.grad((out * cot.to(dev)).sum() + aux,
                                    [xd] + list(mod.parameters()))
        runs[name] = (routing, out, aux, grads)
    (r_cpu, o_cpu, a_cpu, g_cpu), (r_gpu, o_gpu, a_gpu, g_gpu) = (
        runs["cpu"], runs["card"])
    assert not bool(r_cpu.keep.all())  # slots were dropped
    for name in ("expert", "pos", "keep"):
        assert torch.equal(getattr(r_cpu, name),
                           getattr(r_gpu, name).cpu()), name
    torch.testing.assert_close(o_gpu.cpu(), o_cpu, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(a_gpu.cpu(), a_cpu, atol=0, rtol=1e-5)
    for got, want in zip(g_gpu, g_cpu):
        torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)


def test_moe_train_step_through_kernels_matches_plain(cuda_device):
    """A 2-layer MoE model (both layers routed, head_dim 64, MHA as
    moe-1b), fp32, 3 steps on one batch through the kernels (remat on)
    against the same steps with plain attention, from the same params: the
    launches, the losses (with the aux) to the kernels' fp32 accuracy, and
    the params within Adam's update bound."""
    cfg = dataclasses.replace(CONFIGS["moe-tiny"], d_model=128, n_heads=2,
                              n_kv_heads=2, dtype=torch.float32, remat=True)
    opt_kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    counters = (flash_attention_fwd, flash_attention_bwd_dq,
                attention_delta, flash_attention_bwd)
    runs = {}
    for impl in ("auto", "xla"):
        bundle = TrainStepBundle(dataclasses.replace(cfg, attention_impl=impl),
                                 device=cuda_device,
                                 optimizer=make_optimizer(**opt_kw))
        params, opt = bundle.init(seed=0)
        batch = bundle.make_batch(np.random.default_rng(0), 4, 96)
        before = [c.launches for c in counters]
        losses = []
        for _ in range(3):
            params, opt, loss = bundle.step(params, opt, batch)
            losses.append(loss.item())
        launched = tuple(c.launches - n for c, n in zip(counters, before))
        runs[impl] = (losses, params, launched)
    assert runs["auto"][2] == (3 * 2 * cfg.n_layers, 3 * cfg.n_layers,
                               3 * cfg.n_layers, 0)
    assert runs["xla"][2] == (0, 0, 0, 0)
    np.testing.assert_allclose(runs["auto"][0], runs["xla"][0], rtol=1e-4)
    sched = make_optimizer(**opt_kw).schedule
    atol = 2 * 1.2 * sum(sched(t) for t in range(3))
    for key, p in runs["auto"][1].items():
        diff = (p - runs["xla"][1][key]).abs().max().item()
        assert diff <= atol, f"{key} parts by {diff:.3e} > {atol:.3e}"


# ViT through the non-causal kernels against plain attention, per dtype:
# (logits atol, logits rtol, per-leaf relative grad error). fp32: the
# kernels keep ~16 bits of every product (the hi/lo split), so a 2-layer
# model's logits and grads part by far less than 1e-3. bf16: kernel and
# plain round P (and in the backward dS) to bf16 at other points, a few
# 2^-8 roundings per layer and pass (2 layers x 2 passes x 4); the logits
# bound is the 1b prefill check's (chip_smoke.LOGITS_TOL).
VIT_TOL = {torch.float32: (1e-3, 1e-3, 1e-3),
           torch.bfloat16: (5e-2, 2e-2, 16 * 2.0 ** -8)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_vit_through_the_full_attention_kernels_matches_plain(cuda_device,
                                                              dtype):
    """A 2-layer ViT at 224 x 224 with 16-pixel patches (S = 197, a ragged
    tile) and head_dim 64: logits and the grads of ``classification_loss``
    through the kernels (non-causal) against the same model with plain
    attention; each layer launches the forward kernel once and the
    backward's (bf16: Delta and ``flash_bwd``; fp32: Delta and the
    pair) once."""
    cfg = dataclasses.replace(VIT_CONFIGS["vit-b16-224"], d_model=128,
                              n_heads=2, n_layers=2, d_ff=256,
                              num_classes=10, dtype=dtype)
    assert cfg.num_patches + 1 == 197 and cfg.head_dim == 64
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    images = torch.randn(4, 224, 224, 3, generator=gen, device=cuda_device)
    labels = torch.randint(0, 10, (4,), generator=gen, device=cuda_device)
    model = VisionTransformer(cfg, device=cuda_device, seed=0)
    plain = VisionTransformer(dataclasses.replace(cfg, attention_impl="xla"),
                              device=cuda_device,
                              params=dict(model.named_parameters()))
    counters = (flash_attention_fwd, attention_delta, flash_attention_bwd,
                flash_attention_bwd_dq, flash_attention_bwd_dkv)
    out = {}
    for name, m in (("kernel", model), ("plain", plain)):
        before = [c.launches for c in counters]
        logits = m(images)
        grads = torch.autograd.grad(classification_loss(logits, labels),
                                    list(m.parameters()))
        torch.cuda.synchronize()
        out[name] = (logits.detach(), grads,
                     [c.launches - n for c, n in zip(counters, before)])
    L = cfg.n_layers
    assert out["kernel"][2] == ([L, L, L, 0, 0] if dtype == torch.bfloat16
                                else [L, L, 0, L, L])
    assert out["plain"][2] == [0] * 5
    atol, rtol, grad_tol = VIT_TOL[dtype]
    torch.testing.assert_close(out["kernel"][0], out["plain"][0], atol=atol,
                               rtol=rtol)
    # a key bias's exact gradient is 0 (softmax ignores a constant added
    # to a query's scores): both sides hold rounding noise, measured
    # against the key kernel's gradient
    grads = {kind: dict(zip([n for n, _ in model.named_parameters()],
                            out[kind][1])) for kind in ("kernel", "plain")}
    for name, gk in grads["kernel"].items():
        gp = grads["plain"][name]
        ref = grads["plain"][name.replace(".key.bias", ".key.kernel")]
        rel = ((gk.float() - gp.float()).norm()
               / ref.float().norm().clamp_min(1e-30)).item()
        assert rel <= grad_tol, f"{name}: grads part by {rel:.3e}"


def test_moe_train_step_never_waits_for_the_card(cuda_device):
    """A MoE train step (bf16, remat, both layers routed) issues its work
    without one host sync: routing, slot counts, dispatch and combine stay
    on the card (``torch.cuda.set_sync_debug_mode`` raises on any op that
    waits for it)."""
    cfg = dataclasses.replace(CONFIGS["moe-tiny"], d_model=128, n_heads=2,
                              n_kv_heads=2, remat=True)
    bundle = TrainStepBundle(cfg, device=cuda_device)
    params, opt = bundle.init(seed=0)
    batch = bundle.make_batch(np.random.default_rng(0), 4, 96)
    bundle.step(params, opt, batch)  # first use: workspaces, kernel builds
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        params, opt, loss = bundle.step(params, opt, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.isfinite(loss.item())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_from_row_stats_adds_dq_into_one_buffer(cuda_device,
                                                         dtype):
    """``flash_attention_bwd_rows`` with ``dq_acc``, as the ring runs it:
    two key blocks' dQ added into one fp32 buffer equal the two computed
    apart and summed, to fp32's reassociation: each of at most 16
    additions of key tiles' shares rounds by 2^-24 of a running sum no
    larger than M = |dS| |K| of the two blocks; dK and dV are the block's
    own, bit for bit."""
    from ray_tpu_torch.ops.attention import flash_attention_bwd_rows

    gen = torch.Generator(device="cuda").manual_seed(8)
    q, k1, v1, k2, v2, do = (torch.randn(2, 256, 4, 128, generator=gen,
                                         device="cuda", dtype=dtype)
                             for _ in range(6))
    _, lse = flash_attention_fwd(q, k1, v1, False)
    delta = torch.randn(2 * 4, 256, generator=gen, device="cuda")
    acc = torch.zeros(q.shape, dtype=torch.float32, device="cuda")
    got = [flash_attention_bwd_rows(q, k, v, do, lse, delta, False, acc)
           for k, v in ((k1, v1), (k2, v2))]
    assert got[0][0] is acc and got[1][0] is acc
    apart = []
    for k, v in ((k1, v1), (k2, v2)):
        buf = torch.zeros_like(acc)
        apart.append(flash_attention_bwd_rows(q, k, v, do, lse, delta, False,
                                              buf))
    want = apart[0][0] + apart[1][0]
    mag = 0.0
    for k, v in ((k1, v1), (k2, v2)):
        p, ds = bwd_softmax_grads(q, k, v, do, lse, delta, False)
        mag = mag + bwd_products(p, ds.abs(), q.abs(), k.abs(), do.abs())[0]
    assert bool(((acc - want).abs() <= 2.0 ** -20 * mag).all())
    for g, a in zip(got, apart):
        assert torch.equal(g[1], a[1]) and torch.equal(g[2], a[2])


@pytest.mark.parametrize("name", ["int8", "fp8", "bf16"])
def test_codecs_on_the_card_equal_the_cpu(cuda_device, name):
    """The block codecs on card tensors: codes and scales equal to the same
    codec's on the CPU, bit for bit, ragged tail and non-finite values
    included (the scales divide by a tensor: CUDA's division by a Python
    number multiplies by its rounded reciprocal)."""
    from ray_tpu_torch.collective import quant

    x = torch.randn(100_003, generator=torch.Generator().manual_seed(9))
    x[[5, 700, 9000]] = torch.tensor([float("nan"), float("inf"),
                                      -float("inf")])
    codec = quant.QuantCodec(name, 64)
    card, cpu = quant.quantize(x.cuda(), codec), quant.quantize(x, codec)
    assert torch.equal(card.scales.cpu(), cpu.scales)
    if name != "bf16":  # bf16 carries NaN through, whose bits may differ
        assert torch.equal(card.codes.cpu(), cpu.codes)
    torch.testing.assert_close(quant.dequantize(card).cpu(),
                               quant.dequantize(cpu), rtol=0, atol=0,
                               equal_nan=True)


def test_mesh_step_on_the_card_matches_one_device(cuda_device):
    """A 2-layer head_dim-64 fp32 model, 3 steps on a world-1 NCCL mesh of
    every axis at 1 (the fsdp gathers and reduce-scatters, the tensor
    axis's reductions and its vocabulary-parallel cross entropy, each a
    one-rank collective) against the single-device step from the same
    params: losses at rtol 1e-5 (fp32 sums in other orders), params within
    Adam's update bound (2 x 1.2 x sum of lr, tests/test_torch_train.py)."""
    import socket

    from ray_tpu_torch import collective as col
    from ray_tpu_torch.parallel import AXES, create_mesh

    cfg = dataclasses.replace(CONFIGS["tiny"], d_model=128, n_heads=2,
                              n_kv_heads=1, dtype=torch.float32, remat=True)
    opt_kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    with socket.socket() as sock:  # a free port on this machine
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    col.init_collective_group(1, 0, group_name="gpu_mesh",
                              init_method=f"tcp://127.0.0.1:{port}")
    try:
        runs = []
        for mesh in (None, create_mesh(dict.fromkeys(AXES, 1))):
            bundle = TrainStepBundle(cfg, device=cuda_device, mesh=mesh,
                                     optimizer=make_optimizer(**opt_kw))
            params, opt = bundle.init(seed=0)
            batch = bundle.make_batch(np.random.default_rng(0), 4, 96)
            losses = []
            for _ in range(3):
                params, opt, loss = bundle.step(params, opt, batch)
                losses.append(loss.item())
            runs.append((losses, bundle.gather_params()))
    finally:
        col.destroy_collective_group("gpu_mesh")
    (single, p_single), (meshed, p_mesh) = runs
    np.testing.assert_allclose(meshed, single, rtol=1e-5)
    sched = make_optimizer(**opt_kw).schedule
    atol = 2 * 1.2 * sum(sched(t) for t in range(3))
    for key, p in p_mesh.items():
        diff = (p - p_single[key]).abs().max().item()
        assert diff <= atol, f"{key} parts by {diff:.3e} > {atol:.3e}"


def test_block_on_two_tensor_ranks_on_the_card(cuda_device):
    """A bf16 block (4 query and 2 KV heads of head_dim 64) on 2 virtual
    tensor ranks (the smoke's ``tp_block_on_ranks``: each rank's attention
    through the flash kernels at 2 query heads and 1 KV head) against the
    whole block with plain attention: one forward, Delta and ``flash_bwd``
    launch a rank; the output and every gradient within the smoke's derived
    bound, (4 T rho + 16) 2^-8 relative, with rho (the partial products'
    ||sum |P_t| || over ||sum P_t||) taken at T, its value where no partial
    cancels another. The kernels at this rank shape are held against plain
    elementwise in FLASH_CASES and BWD_CASES."""
    import chip_smoke
    from ray_tpu_torch.models.transformer import Block

    T = 2
    cfg = dataclasses.replace(CONFIGS["tiny"], d_model=256, n_heads=4,
                              n_kv_heads=2, d_ff=512)
    gen = torch.Generator(device="cuda").manual_seed(3)
    block = Block(cfg, device=cuda_device)
    with torch.no_grad():
        for name, p in block.named_parameters():
            if not name.endswith(".scale"):
                p.normal_(0.0, 0.02, generator=gen)
    x, dout = (torch.randn(2, 256, cfg.d_model, generator=gen,
                           device="cuda", dtype=torch.bfloat16)
               for _ in range(2))
    x.requires_grad_()
    pos = torch.arange(256, device="cuda")[None].expand(2, 256)
    ranks = [chip_smoke.tp_rank_modules(block, T, t) for t in range(T)]
    counters = (flash_attention_fwd, attention_delta, flash_attention_bwd)
    before = [c.launches for c in counters]
    out, got = chip_smoke.tp_block_grads(block, ranks, x, pos, dout)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [T] * 3
    plain = Block(dataclasses.replace(cfg, attention_impl="xla"),
                  device=cuda_device)
    plain.load_state_dict(block.state_dict())
    names = [k for k, _ in plain.named_parameters()]
    ref = plain(x, pos)[0]
    want = dict(zip(["x"] + names, torch.autograd.grad(
        ref, [x] + list(plain.parameters()), dout)))
    tol = (4 * T * T + chip_smoke.TP_OTHER_ROUNDINGS) * 2.0 ** -8
    got["out"], want["out"] = out, ref
    assert set(got) == set(want)
    for k, w in want.items():
        err = ((got[k].float() - w.float()).norm() / w.float().norm()).item()
        assert err <= tol, f"{k} parts by {err:.3e} > {tol:.3e}"
