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
from ray_tpu_torch.models import CONFIGS
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
FLASH_CASES = [(2, 77, 4, 2, 64, False), (2, 256, 4, 4, 128, False),
               (1, 1000, 16, 8, 128, False), (3, 1, 4, 1, 64, False),
               (2, 1000, 4, 4, 64, False), (2, 77, 8, 2, 128, False),
               (2, 1000, 16, 8, 128, True), (1, 77, 4, 4, 64, True)]


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
# ragged S, one row
BWD_CASES = [(2, 77, 4, 2, 64), (1, 256, 4, 4, 128), (1, 1000, 16, 8, 128),
             (3, 1, 4, 1, 64), (2, 200, 16, 16, 64)]


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
