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

from ray_tpu.ops.attention import _flash_fwd_impl, _to_bh
from ray_tpu.ops.attention import flash_attention_bwd as jax_flash_bwd
from ray_tpu.ops.attention import reference_attention as jax_reference
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.attention import (
    FlashAttention,
    _check_kernel_inputs,
    attention,
    attention_bwd_prep,
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
    monkeypatch.setattr(att, "_ENTRIES", {})  # looked up once, from here
    monkeypatch.setattr(_build, "build", lambda name: types.SimpleNamespace(
        lib=types.SimpleNamespace(flash_fwd=entry)))
    # q's device (a CPU tensor's, -1) is the current one: no switch
    monkeypatch.setattr(att, "_current_device", lambda: -1)
    monkeypatch.setattr(att, "_current_stream", lambda index: 0x7F12_3456_789A)
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
    # the second launch reuses the entry as declared: no second lookup
    monkeypatch.setattr(_build, "build", lambda name: pytest.fail("looked up"))
    att._launch_kernel(q, k, v, True)
    assert flash_attention_fwd.launches == before + 2


@pytest.mark.parametrize("current", [True, False], ids=["current", "other"])
def test_launch_switches_device_only_off_the_current_one(monkeypatch,
                                                         current):
    """The launch path enters ``torch.cuda.device`` only when q lies on
    another card than the current one, and takes that card's stream."""
    import contextlib
    import ctypes
    import importlib
    import types

    att = importlib.import_module("ray_tpu_torch.ops.attention")
    switched, streams = [], []

    class EntryPoint:
        argtypes = None
        restype = ctypes.c_int

        def __call__(self, *args):
            return 0

    @contextlib.contextmanager
    def device(index):
        switched.append(index)
        yield

    monkeypatch.setattr(att, "_ENTRIES", {})
    monkeypatch.setattr(_build, "build", lambda name: types.SimpleNamespace(
        lib=types.SimpleNamespace(flash_fwd=EntryPoint())))
    monkeypatch.setattr(att, "_current_device",
                        lambda: -1 if current else 1)
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(att, "_current_stream",
                        lambda index: streams.append(index) or 7)
    q, k, v = (torch.from_numpy(x) for x in _qkv(6, 1, 8, 4, 2, 64))
    att._launch_kernel(q, k, v, True)
    assert switched == ([] if current else [-1])  # q's device
    assert streams == [-1]


def _bf16_view(shape, offset=0, row=None):
    """A bf16 (B, S, heads, D) view of a fresh buffer, starting ``offset``
    elements in, with each (head) row ``row`` elements apart (D if None)."""
    B, S, H, D = shape
    row = row or D
    buf = torch.zeros(offset + B * S * H * row, dtype=torch.bfloat16)
    return buf[offset:].view(B, S, H, row)[..., :D]


@pytest.mark.parametrize("case", ["base", "row_stride"])
def test_bf16_kernel_inputs_need_16_byte_alignment(case):
    """The bf16 forward reads q, k and v through TMA tensor maps, which need
    a 16-byte aligned base and b, s, h strides of multiples of 16 bytes;
    the wrapper raises on anything else, before any launch. (The check runs
    on CPU tensors here; on the card it guards the launch.)"""
    good = _bf16_view((1, 16, 2, 64))
    bad = (_bf16_view((1, 16, 2, 64), offset=1) if case == "base"
           else _bf16_view((1, 16, 2, 64), row=68))  # 136-byte rows
    assert bad.stride(-1) == 1
    for q, k, v in ((bad, good, good), (good, bad, good), (good, good, bad)):
        with pytest.raises(ValueError, match="aligned to 16 bytes"):
            _check_kernel_inputs("flash_fwd", q, k, v)
    _check_kernel_inputs("flash_fwd", good, good, good)
    # fp32 keeps the pair rule: 8-byte alignment
    f32 = torch.zeros(1 + 16 * 2 * 64)[1:].view(1, 16, 2, 64)
    with pytest.raises(ValueError, match="aligned to 8 bytes"):
        _check_kernel_inputs("flash_fwd", f32, f32, f32)


@pytest.mark.parametrize("D", [64, 128])
def test_fused_qkv_slices_pass_the_kernel_check(D):
    """q, k and v as slices of one fused (B, S, H + 2 KVH, D) projection are
    not contiguous, but their bases and strides are 16-byte multiples, so
    the kernels take them as they are (the chip smoke runs them)."""
    B, S, H, KVH = 2, 77, 4, 2
    fused = torch.zeros(B, S, H + 2 * KVH, D, dtype=torch.bfloat16)
    q, k, v = fused[:, :, :H], fused[:, :, H:H + KVH], fused[:, :, H + KVH:]
    assert not q.is_contiguous() and not k.is_contiguous()
    _check_kernel_inputs("flash_fwd", q, k, v)
    _check_kernel_inputs("flash_bwd_dq", q, k, v, q)


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
                flash_attention_bwd_dkv, flash_attention_bwd,
                attention_bwd_prep)
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


# Delta = rowsum(dO * O), the prep's plain path against the JAX package's
# expression: both sum D exact products (bf16 or fp32 operands) in fp32, in
# other orders; at D = 128 and sum |dO O| up to ~1e2 that parts them by at
# most 128 * 2^-24 * 1e2 ~ 8e-4 (the chip smoke's DELTA_TOL)
DELTA_ATOL = 1e-3


@pytest.mark.parametrize("S", [13, 70])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_prep_plain_matches_jax_delta(dtype, D, S):
    """``attention_bwd_prep`` on CPU tensors (its plain version) against
    the JAX backward's Delta expression (``ray_tpu/ops/attention.py``'s
    ``flash_attention_bwd``: fp32 rowsum of dO * O in (B * H, S, 1)), on the
    same numpy inputs cast to the same dtype on both sides, at ragged S
    (one partial 64-row tile; one full and one partial). The accumulator
    and the counters come back as zeros of flash_bwd's shapes and dtypes;
    without ``for_dq`` as None."""
    B, H = 2, 3
    rng = np.random.default_rng(15)
    o, do = (rng.standard_normal((B, S, H, D)).astype(np.float32)
             for _ in range(2))
    jo, jdo = (jnp.asarray(x, dtype=jnp.dtype(dtype)) for x in (o, do))
    want = jnp.sum(_to_bh(jdo).astype(jnp.float32)
                   * _to_bh(jo).astype(jnp.float32), axis=-1, keepdims=True)
    to = torch.from_numpy(o).to(getattr(torch, dtype))
    tdo = torch.from_numpy(do).to(getattr(torch, dtype))
    before = attention_bwd_prep.launches
    delta, acc, counts = attention_bwd_prep(to, tdo)
    assert attention_bwd_prep.launches == before  # the plain version
    assert delta.dtype == torch.float32 and delta.shape == (B * H, S)
    np.testing.assert_allclose(delta.numpy(), np.asarray(want)[..., 0],
                               atol=DELTA_ATOL, rtol=0)
    assert acc.dtype == torch.float32 and acc.shape == (B, S, H, D)
    assert counts.dtype == torch.int32
    assert counts.shape == (B * H * -(-S // 64),)
    assert not acc.any() and not counts.any()
    alone, none_acc, none_counts = attention_bwd_prep(to, tdo, for_dq=False)
    assert none_acc is None and none_counts is None
    assert torch.equal(alone, delta)


# per C entry point case: its library function, the wrapper's launcher, the
# counter it adds to, the number of pointers it takes and of b, s, h strides
# (3 for each 4-d tensor: q k v dO, then the outputs; the prep's o, dO, then
# the accumulator it clears, when it is given one)
BINDINGS = {
    "dq": ("flash_bwd_dq", "_launch_bwd_dq", "flash_attention_bwd_dq", 7, 15),
    "dkv": ("flash_bwd_dkv", "_launch_bwd_dkv", "flash_attention_bwd_dkv", 8,
            18),
    "fused": ("flash_bwd", "flash_attention_bwd", "flash_attention_bwd", 10,
              21),
    "delta": ("flash_bwd_prep", "_launch_prep", "attention_bwd_prep", 5, 6),
    "prep": ("flash_bwd_prep", "_launch_prep", "attention_bwd_prep", 5, 9),
}


@pytest.mark.parametrize("kernel", list(BINDINGS))
def test_backward_bindings_declare_every_argument(monkeypatch, kernel):
    """As for the forward: the backward entry points get their ctypes
    signatures before the first call, and the wrapper passes the pointers,
    the shape, every b, s, h stride of the 4-d tensors and the stream. The
    prep (``flash_bwd_prep``) takes o, dO, Delta and, for flash_bwd, the
    fp32 dQ accumulator of q's shape and the int32 counters of its adds'
    order, one a (batch, head, 64-row q tile), which it clears; for Delta
    alone those two are null. The fused bf16 backward (``flash_bwd``, the
    stand-ins taking the card's place) launches the prep first and then
    ``flash_bwd`` on the very Delta, accumulator and counters the prep
    was given."""
    import ctypes
    import importlib
    import types

    fn_name, launcher, counter_name, n_ptr, n_strides = BINDINGS[kernel]
    dtype = torch.bfloat16 if kernel == "fused" else torch.float32
    q, k, v = (torch.from_numpy(x).to(dtype)
               for x in _qkv(13, 1, 8, 4, 2, 64))
    n_count = 1 * 4 * 1  # B * H * ceil(S / 64)
    calls = []

    class EntryPoint:
        argtypes = None
        restype = ctypes.c_int

        def __init__(self, name):
            self.name = name

        def __call__(self, *args):
            calls.append((self.name, args))
            return 0

    entries = {name: EntryPoint(name) for name in (fn_name, "flash_bwd_prep")}
    att = importlib.import_module("ray_tpu_torch.ops.attention")
    monkeypatch.setattr(att, "_ENTRIES", {})
    monkeypatch.setattr(_build, "build", lambda name: types.SimpleNamespace(
        lib=types.SimpleNamespace(**entries)))
    monkeypatch.setattr(att, "_current_device", lambda: -1)
    monkeypatch.setattr(att, "_current_stream", lambda index: 0x7F12_3456_789A)
    lse = torch.zeros(4, 8, 1)
    delta = torch.zeros(4, 8)
    counter = getattr(att, counter_name)
    before = counter.launches, att.attention_bwd_prep.launches
    if kernel == "fused":
        monkeypatch.setattr(att, "_on_cpu", lambda *tensors: False)
        out = att.flash_attention_bwd(q, k, v, q, lse, q, True)
        (prep, prep_args), (name, args) = calls
        assert (prep, name) == ("flash_bwd_prep", "flash_bwd")
        assert att.attention_bwd_prep.launches == before[1] + 1
        # Delta, the accumulator and the counters the prep cleared
        assert None not in prep_args[2:5]
        assert (args[5], args[8], args[9]) == prep_args[2:5]
        entry = entries["flash_bwd"]
    else:
        if kernel in ("delta", "prep"):
            out = att._launch_prep(q, q, kernel == "prep")
        else:
            out = getattr(att, launcher)(q, k, v, q, lse, delta, True)
        ((name, args),) = calls
        assert name == fn_name
        entry = entries[fn_name]
    pointer, i32 = ctypes.c_void_p, ctypes.c_int
    assert entry.argtypes == ([pointer] * n_ptr + [i32] * 6
                              + [ctypes.POINTER(ctypes.c_longlong), i32,
                                 pointer])
    assert entry.restype is ctypes.c_int
    assert len(args) == len(entry.argtypes)
    assert args[0] == q.data_ptr() and args[-1] == 0x7F12_3456_789A
    kv_heads = 4 if kernel in ("delta", "prep") else 2  # the prep's dO
    dtype_code = 0 if dtype == torch.bfloat16 else 1
    assert list(args[n_ptr:n_ptr + 6]) == [dtype_code, 1, 8, 4, kv_heads, 64]
    assert len(args[n_ptr + 6]) == n_strides
    assert counter.launches == before[0] + 1
    if kernel == "delta":
        got_delta, acc, counts = out
        assert acc is None and counts is None and args[3:5] == (None, None)
        assert args[2] == got_delta.data_ptr()
        assert got_delta.shape == (4, 8) and got_delta.dtype == torch.float32
    if kernel == "prep":
        got_delta, acc, counts = out
        assert args[2:5] == tuple(x.data_ptr()
                                  for x in (got_delta, acc, counts))
        assert acc.shape == q.shape and acc.dtype == torch.float32
        assert counts.shape == (n_count,) and counts.dtype == torch.int32
        assert list(args[n_ptr + 6])[6:] == list(acc.stride()[:3])
    if kernel == "fused":
        assert att.dq_counters(q).shape == (n_count,)
        assert att.dq_counters(q).dtype == torch.int32
        dq, dk, dv = out
        assert dq.dtype == q.dtype and dq.shape == q.shape
        assert dk.shape == dv.shape == k.shape


def test_backward_dispatch_by_dtype(monkeypatch):
    """On CUDA tensors (``_on_cpu`` forced False here, the launchers replaced
    by recorders, as the binding tests replace ``_build.build``) the bf16
    backward runs the prep (Delta with the cleared accumulator and
    counters) and then ``flash_bwd`` once, and fp32 runs the prep for Delta
    alone and the pair. Nothing is built."""
    import importlib

    att = importlib.import_module("ray_tpu_torch.ops.attention")
    calls = []

    def recorder(name, result):
        def launch(*args):
            calls.append(name(*args) if callable(name) else name)
            return result(*args)
        return launch

    def prep(o, do, for_dq):
        B, S, H, D = o.shape
        return (torch.zeros(B * H, S),
                torch.zeros(o.shape) if for_dq else None,
                torch.zeros(B * H, dtype=torch.int32) if for_dq else None)

    monkeypatch.setattr(att, "_on_cpu", lambda *tensors: False)
    monkeypatch.setattr(att, "_launch_prep", recorder(
        lambda o, do, for_dq: "prep" if for_dq else "delta", prep))
    monkeypatch.setattr(att, "_launch_bwd", recorder(
        "flash_bwd", lambda q, k, v, *rest: (q, k, v)))
    monkeypatch.setattr(att, "_launch_bwd_dq", recorder(
        "flash_bwd_dq", lambda q, *rest: q))
    monkeypatch.setattr(att, "_launch_bwd_dkv", recorder(
        "flash_bwd_dkv", lambda q, k, v, *rest: (k, v)))

    def no_build(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(_build, "build", no_build)
    for dtype, want in ((torch.bfloat16, ["prep", "flash_bwd"]),
                        (torch.float32, ["delta", "flash_bwd_dq",
                                         "flash_bwd_dkv"])):
        q, k, v = (torch.from_numpy(x).to(dtype)
                   for x in _qkv(14, 1, 16, 4, 2, 64))
        lse = torch.zeros(4, 16, 1)
        calls.clear()
        dq, dk, dv = flash_attention_bwd(q, k, v, q, lse, q, True)
        assert calls == want, dtype
        assert dq.shape == q.shape and dk.shape == dv.shape == k.shape


def test_bf16_rows_backward_on_the_card_takes_a_callers_accumulator(
        monkeypatch):
    """On CUDA tensors (``_on_cpu`` forced False) the bf16
    ``flash_attention_bwd_rows`` takes the caller's zeroed ``dq_acc`` and
    launches ``flash_bwd`` on it; without one it raises before any launch
    (``flash_attention_bwd`` makes its own through the prep)."""
    import importlib

    att = importlib.import_module("ray_tpu_torch.ops.attention")
    launched = []
    monkeypatch.setattr(att, "_on_cpu", lambda *tensors: False)
    monkeypatch.setattr(att, "_launch_bwd", lambda q, k, v, do, lse, delta,
                        causal, dq_acc, counts: launched.append(
                            (dq_acc, counts)) or (dq_acc, k, v))
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _qkv(15, 1, 16, 4, 2, 64))
    lse, delta = torch.zeros(4, 16, 1), torch.zeros(4, 16)
    with pytest.raises(ValueError, match="dq_acc"):
        att.flash_attention_bwd_rows(q, k, v, q, lse, delta, True)
    assert launched == []
    acc = torch.zeros(q.shape)
    dq, dk, dv = att.flash_attention_bwd_rows(q, k, v, q, lse, delta, True,
                                              acc)
    ((got_acc, counts),) = launched
    assert dq is acc and got_acc is acc
    assert counts.dtype == torch.int32 and not counts.any()


def test_launch_counts_count_each_c_entry_where_it_launches(monkeypatch):
    """``_launch`` counts each C function's launches where it calls it, so
    ``launch_counts`` reads the earlier Delta kernel ``flash_bwd_delta``,
    which no wrapper owns, beside the wrappers and resets it with them; a
    launch whose entry returns an error counts nothing."""
    import ctypes
    import importlib
    import types

    results = []

    class EntryPoint:
        argtypes = None
        restype = ctypes.c_int

        def __call__(self, *args):
            return results.pop(0)

    att = importlib.import_module("ray_tpu_torch.ops.attention")
    monkeypatch.setattr(att, "_ENTRIES", {})
    monkeypatch.setattr(att, "entry_launches", {})
    monkeypatch.setattr(_build, "build", lambda name: types.SimpleNamespace(
        lib=types.SimpleNamespace(flash_bwd_delta=EntryPoint())))
    monkeypatch.setattr(att, "_current_device", lambda: -1)
    monkeypatch.setattr(att, "_current_stream", lambda index: 0)
    o = torch.from_numpy(_qkv(16, 1, 8, 4, 2, 64)[0])
    delta = torch.empty(4, 8)
    wrappers = {k: v for k, v in att.launch_counts().items()
                if k != "flash_bwd_delta"}
    assert att.launch_counts()["flash_bwd_delta"] == 0
    results[:] = [0, 0, 700]
    for _ in range(2):
        att._launch("flash_bwd", "flash_bwd_delta", (o, o, delta), False)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        att._launch("flash_bwd", "flash_bwd_delta", (o, o, delta), False)
    counts = att.launch_counts(reset=True)
    assert counts == {**wrappers, "flash_bwd_delta": 2}
    assert att.launch_counts() == {**dict.fromkeys(wrappers, 0),
                                   "flash_bwd_delta": 0}
