"""The port's attention ops against the JAX package's, on the CPU.

The port's ``flash_attention_fwd`` takes its plain version on CPU tensors;
it is held against the JAX Pallas flash kernel run in interpret mode, and
against the JAX reference where the Pallas kernel cannot go (ragged S,
segment ids). Inputs are drawn with numpy and handed to both. The CUDA
kernel itself is compared on the card by ``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("flax")  # the JAX reference; the card's machine lacks it

import jax.numpy as jnp  # noqa: E402

from ray_tpu.ops.attention import _flash_fwd_impl
from ray_tpu.ops.attention import reference_attention as jax_reference
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.attention import (
    attention,
    flash_attention_fwd,
    flash_attention_fwd_plain,
    reference_attention,
)

# the reference's own flash-vs-reference bound (tests/test_models_ops.py)
ATOL, RTOL = 2e-3, 2e-2
# lse is a logsumexp of fp32 scores of magnitude ~1: both sides differ only
# in the order of fp32 sums
LSE_ATOL = 1e-4


def _qkv(seed, B, S, H, KVH, D, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D)).astype(dtype),
            rng.standard_normal((B, S, KVH, D)).astype(dtype),
            rng.standard_normal((B, S, KVH, D)).astype(dtype))


def _repeat(x, H):
    return jnp.repeat(jnp.asarray(x), H // x.shape[2], axis=2)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv_heads", [4, 2], ids=["mha", "gqa"])
def test_plain_flash_matches_pallas_interpret(causal, kv_heads):
    B, S, H, D = 2, 256, 4, 64
    q, k, v = _qkv(0, B, S, H, kv_heads, D)
    o_jax, lse_jax = _flash_fwd_impl(jnp.asarray(q), _repeat(k, H),
                                     _repeat(v, H), causal, interpret=True)
    o, lse = flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal)
    assert o.shape == (B, S, H, D) and lse.shape == (B * H, S, 1)
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(o_jax), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_jax),
                               atol=LSE_ATOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_ragged_seq_matches_jax_reference(causal):
    """S = 77 divides no block, which the Pallas kernel asserts on; the
    port's kernel and its plain version take any S."""
    B, S, H, KVH, D = 2, 77, 4, 2, 64
    q, k, v = _qkv(1, B, S, H, KVH, D)
    ref = jax_reference(jnp.asarray(q), _repeat(k, H), _repeat(v, H), causal)
    o, lse = flash_attention_fwd_plain(torch.from_numpy(q),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v), causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)
    # lse against numpy's logsumexp of the same scaled, masked scores
    kk = np.repeat(k, H // KVH, axis=2).astype(np.float64)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kk) / np.sqrt(D)
    if causal:
        s = np.where(np.tril(np.ones((S, S), bool)), s, -1e30)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))
    np.testing.assert_allclose(lse.numpy(), want.reshape(B * H, S, 1),
                               atol=LSE_ATOL, rtol=0)


def test_bf16_plain_matches_jax_reference():
    """bf16 inputs: both sides take fp32 scores of the bf16 values and round
    the probabilities to bf16 before P V, so they differ by bf16 roundings
    of o (|o| < 4 -> 2 ulps is under 3e-2)."""
    B, S, H, KVH, D = 1, 128, 4, 2, 64
    q, k, v = _qkv(2, B, S, H, KVH, D)
    qb, kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    ref = jax_reference(qb, jnp.repeat(kb, 2, axis=2),
                        jnp.repeat(vb, 2, axis=2), True)
    tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32)))
                  .to(torch.bfloat16) for x in (qb, kb, vb))
    o, _ = flash_attention_fwd(tq, tk, tv, True)
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=3e-2, rtol=2e-2)


def test_dispatcher_impls():
    B, S, H, KVH, D = 1, 64, 4, 2, 64
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, B, S, H, KVH, D))
    plain, _ = flash_attention_fwd_plain(q, k, v, True)
    ref = reference_attention(q, k, v, True)
    # auto on CPU tensors: the plain version, one function for both names
    torch.testing.assert_close(attention(q, k, v, True, "auto"), plain)
    torch.testing.assert_close(attention(q, k, v, True, "xla"), ref)
    torch.testing.assert_close(plain, ref, atol=0, rtol=0)
    # flash means the CUDA kernel: never on CPU tensors
    with pytest.raises(ValueError, match="CUDA"):
        attention(q, k, v, True, "flash")
    with pytest.raises(ValueError, match="unknown attention impl"):
        attention(q, k, v, True, "flash_interpret")
    # on CPU tensors, auto takes any head_dim and segment ids (plain path)
    q16, k16, v16 = (torch.from_numpy(x) for x in _qkv(4, B, S, H, KVH, 16))
    torch.testing.assert_close(attention(q16, k16, v16, True, "auto"),
                               reference_attention(q16, k16, v16, True))
    seg = torch.from_numpy(np.repeat(np.arange(2), S // 2)[None])
    want = jax_reference(jnp.asarray(q.numpy()), _repeat(k.numpy(), H),
                         _repeat(v.numpy(), H), True, jnp.asarray(seg.numpy()))
    np.testing.assert_allclose(
        attention(q, k, v, True, "auto", segment_ids=seg).numpy(),
        np.asarray(want), atol=ATOL, rtol=RTOL)
    # off the CPU, auto goes to the kernel's wrapper and never to a plain
    # path: here (no card) it raises for every tensor that is not on the CPU
    meta = [x.to("meta") for x in (q16, k16, v16)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        attention(*meta, True, "auto")
    with pytest.raises(ValueError, match="segment_ids"):
        attention(*meta, True, "auto", segment_ids=seg.to("meta"))


def test_plain_path_builds_no_kernel():
    q, k, v = (torch.from_numpy(x) for x in _qkv(5, 1, 32, 2, 2, 64))
    before = flash_attention_fwd.launches
    flash_attention_fwd(q, k, v, True)
    assert flash_attention_fwd.launches == before
    assert not _build.is_loaded("flash_fwd")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention_fwd(q.to("meta"), k.to("meta"), v.to("meta"), True)


def test_kernel_binding_declares_every_argument(monkeypatch):
    """The ctypes binding sets ``argtypes`` on first use: without them ctypes
    passes Python ints as 32-bit C ints, which cuts the device pointers and
    the stream handle. A stand-in for the library's entry point records
    what the wrapper passes (the kernel itself runs only on the card)."""
    import contextlib
    import ctypes
    import importlib
    import types

    class EntryPoint:  # a ctypes function as found: no argtypes, c_int return
        argtypes = None
        restype = ctypes.c_int

        def __call__(self, *args):
            self.args = args
            return 0

    entry = EntryPoint()
    att = importlib.import_module("ray_tpu_torch.ops.attention")
    monkeypatch.setattr(_build, "build", lambda name: types.SimpleNamespace(
        lib=types.SimpleNamespace(flash_fwd=entry)))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d:
                        types.SimpleNamespace(cuda_stream=0x7F12_3456_789A))
    q, k, v = (torch.from_numpy(x) for x in _qkv(6, 1, 8, 4, 2, 64))
    before = flash_attention_fwd.launches
    att._launch_kernel(q, k, v, True)
    pointer, i32 = ctypes.c_void_p, ctypes.c_int
    assert entry.argtypes == ([pointer] * 5 + [i32] * 6
                              + [ctypes.POINTER(ctypes.c_longlong), i32,
                                 pointer])
    assert entry.restype is ctypes.c_int
    assert len(entry.args) == len(entry.argtypes)
    assert entry.args[0] == q.data_ptr() and entry.args[-1] == 0x7F12_3456_789A
    assert list(entry.args[5:11]) == [1, 1, 8, 4, 2, 64]  # fp32, B S H KVH D
    assert flash_attention_fwd.launches == before + 1
