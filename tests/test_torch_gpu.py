"""Tests of the port that need the card: the CUDA kernels against their
plain PyTorch versions, and the serving path through them.

They skip on a machine without a CUDA device. This file imports no jax, so
it runs where the JAX reference is missing; on the card run

    python -m pytest --noconftest -m gpu tests/test_torch_*.py -q
"""

import dataclasses

import pytest
import torch

from ray_tpu_torch.llm import model_runner as mr
from ray_tpu_torch.llm.config import EngineConfig, LLMConfig, SamplingParams
from ray_tpu_torch.llm.engine import TorchLLMEngine
from ray_tpu_torch.ops.attention import (attention, flash_attention_fwd,
                                         flash_attention_fwd_plain)

pytestmark = pytest.mark.gpu

# kernel vs plain on the same inputs, (atol, rtol, pv): an element of o
# passes within atol + rtol * |o| + pv * (P |V|), P |V| being the plain
# version's output on |v|. fp32 at the reference's flash bound (the
# kernel's bf16 hi/lo split keeps ~16 mantissa bits). bf16: kernel and plain
# round the probabilities to bf16 at different points (unnormalised and
# normalised), which moves P V by at most 2^-8 * P |V|, and both round o to
# bf16 (under rtol). lse is an fp32 sum of exact products in both.
TOL = {torch.bfloat16: (1e-3, 2e-2, 2.0 ** -8),
       torch.float32: (2e-3, 2e-2, 0.0)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_matches_plain(cuda_device, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    atol, rtol, pv_tol = TOL[dtype]
    for (B, S, H, KVH, D) in [(2, 77, 4, 2, 64), (2, 256, 4, 4, 128),
                              (1, 1000, 16, 8, 128), (3, 1, 4, 1, 64)]:
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
