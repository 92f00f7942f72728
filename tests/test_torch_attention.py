"""The port's attention ops against the JAX package's, on the CPU.

The port's ``flash_attention_fwd`` and ``flash_attention_bwd`` take their
plain versions on CPU tensors; they are held against the JAX Pallas flash
kernels run in interpret mode, and against the JAX reference (and its
``jax.vjp``) where the Pallas kernels cannot go (ragged S, segment ids).
Inputs are drawn with numpy and handed to both. The CUDA kernels themselves
are compared on the card by ``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("flax")  # the JAX reference; the card's machine lacks it

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ray_tpu.ops.attention import _flash_fwd_impl
from ray_tpu.ops.attention import flash_attention_bwd as jax_flash_bwd
from ray_tpu.ops.attention import reference_attention as jax_reference
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.attention import (
    FlashAttention,
    attention,
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_plain,
    flash_attention_fwd,
    flash_attention_fwd_plain,
    reference_attention,
)

# the reference's own flash-vs-reference bound (tests/test_models_ops.py)
ATOL, RTOL = 2e-3, 2e-2
# lse is a logsumexp of fp32 scores of magnitude ~1: both sides differ only
# in the order of fp32 sums
LSE_ATOL = 1e-4
# the backward in fp32 on both sides, the same steps in other sum orders:
# P = exp(s - lse) with |s| up to ~30 carries ~1e-6 of relative error, and
# the gradients are sums of S products of magnitude ~1
BWD_TOL = dict(atol=1e-4, rtol=1e-4)


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


def _group_sum(x, kv_heads):
    """(B, S, H, D) per query head -> (B, S, KVH, D): the VJP of jnp.repeat."""
    B, S, H, D = x.shape
    return np.asarray(x).reshape(B, S, kv_heads, H // kv_heads, D).sum(3)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv_heads", [2, 1], ids=["mha", "gqa"])
@pytest.mark.parametrize("D", [64, 128])
def test_plain_bwd_matches_pallas_interpret(D, kv_heads, causal):
    """Both JAX backward kernels (interpret mode), called on (o, lse) from
    the JAX forward kernel, against the port's plain backward on the same
    o and lse. The JAX side repeats K/V to H heads and its dk, dv come out
    per query head; they are summed over each group here."""
    B, S, H = 1, 128, 2
    q, k, v = _qkv(7, B, S, H, kv_heads, D)
    do = np.random.default_rng(8).standard_normal((B, S, H, D)).astype(
        np.float32)
    kr, vr = _repeat(k, H), _repeat(v, H)
    o, lse = _flash_fwd_impl(jnp.asarray(q), kr, vr, causal, interpret=True)
    want = jax_flash_bwd(jnp.asarray(q), kr, vr, o, lse, jnp.asarray(do),
                         causal, interpret=True)
    got = flash_attention_bwd_plain(
        *(torch.from_numpy(np.array(x)) for x in (q, k, v, o, lse, do)),
        causal)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               **BWD_TOL)
    for g, w in zip(got[1:], want[1:]):
        assert g.shape == (B, S, kv_heads, D)
        np.testing.assert_allclose(g.numpy(), _group_sum(w, kv_heads),
                                   **BWD_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_ragged_bwd_matches_jax_vjp(causal):
    """S = 77 (no Pallas block divides it): the port's backward through
    ``flash_attention`` against ``jax.vjp`` of the JAX reference, GQA."""
    B, S, H, KVH, D = 2, 77, 4, 2, 64
    q, k, v = _qkv(9, B, S, H, KVH, D)
    do = np.random.default_rng(10).standard_normal((B, S, H, D)).astype(
        np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jax_reference(
        a, jnp.repeat(b, H // KVH, axis=2), jnp.repeat(c, H // KVH, axis=2),
        causal), *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = attention(tq, tk, tv, causal, "auto")
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **BWD_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_gradcheck(causal):
    """The autograd glue in float64: ``FlashAttention``'s backward (the
    plain one on the CPU) against finite differences of its forward."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 5, h, 4)))
               .requires_grad_() for h in (2, 1, 1))
    assert torch.autograd.gradcheck(
        lambda a, b, c: FlashAttention.apply(a, b, c, causal), (q, k, v))


def test_plain_backward_builds_no_kernel():
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _qkv(12, 1, 32, 4, 2, 64))
    counters = (flash_attention_fwd, flash_attention_bwd_dq,
                flash_attention_bwd_dkv)
    before = [c.launches for c in counters]
    o = attention(q, k, v, True, "auto")
    dq, dk, dv = torch.autograd.grad(o.sum(), (q, k, v))
    assert dq.shape == q.shape and dk.shape == k.shape == dv.shape
    assert [c.launches for c in counters] == before
    assert not _build.is_loaded("flash_bwd")
    meta = [x.detach().to("meta") for x in (q, k, v, o, o)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention_bwd(*meta[:4], torch.zeros(0, device="meta"),
                            meta[4], True)


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_backward_bindings_declare_every_argument(monkeypatch, kernel):
    """As for the forward: the backward entry points get their ctypes
    signatures before the first call, and the wrapper passes the pointers,
    the shape, every b, s, h stride of the 4-d tensors and the stream."""
    import contextlib
    import ctypes
    import importlib
    import types

    class EntryPoint:
        argtypes = None
        restype = ctypes.c_int

        def __call__(self, *args):
            self.args = args
            return 0

    entry = EntryPoint()
    att = importlib.import_module("ray_tpu_torch.ops.attention")
    monkeypatch.setattr(_build, "build", lambda name: types.SimpleNamespace(
        lib=types.SimpleNamespace(**{f"flash_bwd_{kernel}": entry})))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d:
                        types.SimpleNamespace(cuda_stream=0x7F12_3456_789A))
    q, k, v = (torch.from_numpy(x) for x in _qkv(13, 1, 8, 4, 2, 64))
    lse = torch.zeros(4, 8, 1)
    delta = torch.zeros(4, 8)
    launch = getattr(att, f"_launch_bwd_{kernel}")
    counter = getattr(att, f"flash_attention_bwd_{kernel}")
    before = counter.launches
    launch(q, k, v, q, lse, delta, True)
    n_ptr = 7 if kernel == "dq" else 8
    pointer, i32 = ctypes.c_void_p, ctypes.c_int
    assert entry.argtypes == ([pointer] * n_ptr + [i32] * 6
                              + [ctypes.POINTER(ctypes.c_longlong), i32,
                                 pointer])
    assert len(entry.args) == len(entry.argtypes)
    assert entry.args[0] == q.data_ptr() and entry.args[-1] == 0x7F12_3456_789A
    assert list(entry.args[n_ptr:n_ptr + 6]) == [1, 1, 8, 4, 2, 64]
    n_strides = 3 * (5 if kernel == "dq" else 6)  # q k v dO + outputs
    assert len(entry.args[n_ptr + 6]) == n_strides
    assert counter.launches == before + 1
