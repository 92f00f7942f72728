"""Attention ops: hand-written CUDA flash-attention kernels + plain paths.

Counterpart of ``ray_tpu/ops/attention.py``. The TPU's Pallas kernels become
CUDA kernels for ``sm_90a``, built with nvcc at first use and called through
ctypes: ``_flash_fwd_kernel`` is ``csrc/flash_fwd.cu``, and the backward pair
``_flash_bwd_dq_kernel`` / ``_flash_bwd_dkv_kernel`` is ``csrc/flash_bwd.cu``
(bf16: one kernel for both, ``flash_bwd``; fp32: the pair), after
``flash_bwd_prep`` there, which computes Delta (plain XLA in the JAX
package) and, for ``flash_bwd``, clears its dQ accumulator in one launch.
Beside each, in this module, is its plain PyTorch version: the CPU tests run
that one, and the chip smoke holds the kernel against it on the card. The
custom VJP that joins them (``jax.custom_vjp`` there) is ``FlashAttention``,
a ``torch.autograd.Function``.

Layouts follow the JAX package: q is (B, S, H, D); k and v are (B, S, KVH, D)
with H a multiple of KVH (grouped-query attention: query head h reads KV head
h // (H // KVH), as ``jnp.repeat(k, H // KVH, axis=2)`` lays it out). The
kernel reads that layout through strides, so callers neither transpose nor
repeat. The backward sums dK and dV over each KV head's group of query
heads, which is the VJP of that repeat.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from ray_tpu_torch.ops import _build

_MASKED = -1e30
KERNEL_HEAD_DIMS = (64, 128)  # the head dims the flash kernels take
_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def _repeat_kv(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, KVH, D) -> (B, S, H, D), each KV head repeated H // KVH times
    in place (``jnp.repeat(x, rep, axis=2)``)."""
    kvh = x.shape[2]
    if kvh == n_heads:
        return x
    if n_heads % kvh:
        raise ValueError(f"{n_heads} query heads do not group over {kvh} "
                         "KV heads")
    return x.repeat_interleave(n_heads // kvh, dim=2)


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """The plain versions compute in fp32, or in fp64 for fp64 inputs (the
    gradient checks)."""
    return torch.promote_types(x.dtype, torch.float32)


def _masked_scores(q, k, causal: bool, segment_ids=None) -> torch.Tensor:
    """fp32 scores (B, H, Sq, Sk) scaled by 1/sqrt(D), masked with -1e30."""
    d = q.shape[-1]
    k = _repeat_kv(k, q.shape[2])
    acc = _acc_dtype(q)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc))
    scores = scores * (1.0 / math.sqrt(d))
    S = q.shape[1]
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, _MASKED)
    if segment_ids is not None:
        seg = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        scores = scores.masked_fill(~seg, _MASKED)
    return scores


def flash_attention_fwd_plain(q, k, v, causal: bool = True,
                              segment_ids: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flash forward's function in plain PyTorch: ``(o, lse)`` with o
    (B, S, H, D) in the input dtype and lse (B*H, S, 1) the fp32 logsumexp
    of the scaled, masked scores. The softmax is fp32 and the probabilities
    are cast to the input dtype before P V, as the JAX reference does."""
    B, S, H, _ = q.shape
    scores = _masked_scores(q, k, causal, segment_ids)
    lse = torch.logsumexp(scores, dim=-1)  # (B, H, S)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", probs, _repeat_kv(v, H))
    return o, lse.reshape(B * H, S, 1)


def reference_attention(q, k, v, causal: bool = True,
                        segment_ids: Optional[torch.Tensor] = None):
    """Plain attention: (B, S, H, D) -> (B, S, H, D), the o of
    ``flash_attention_fwd_plain``."""
    return flash_attention_fwd_plain(q, k, v, causal, segment_ids)[0]


def _on_cpu(q, *others) -> bool:
    """True for CPU tensors (the plain versions), False for CUDA tensors (the
    kernels); raises for tensors split between devices or on another one."""
    if q.is_cuda:
        return False
    if q.device.type == "cpu":
        if any(x.device.type != "cpu" for x in others):
            raise ValueError("q, k and v must be on one device")
        return True
    raise ValueError(f"the flash kernels run on cuda or cpu, not "
                     f"{q.device}")


def _check_kernel_inputs(kernel: str, q, k, v, *more) -> None:
    """Raise on what the kernels cannot take. ``more`` are further tensors of
    q's shape (dO in the backward)."""
    device, dtype, size = q.get_device(), q.dtype, q.element_size()
    # bf16 is read through TMA tensor maps: 16-byte aligned base and b, s, h
    # strides; fp32 is loaded in pairs of elements
    align = 16 if dtype == torch.bfloat16 else 2 * size
    for name, x in (("q", q), ("k", k), ("v", v), *(("do", x) for x in more)):
        if x.get_device() != device:  # the wrappers' q is on a card
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != dtype:
            raise TypeError(f"{name} is {x.dtype}, q is {dtype}")
        st = x.stride()
        if len(st) != 4:
            raise ValueError(f"{name} must be (B, S, heads, D), got "
                             f"{tuple(x.shape)}")
        if st[3] != 1:
            raise ValueError(f"{name}'s last dim must be contiguous")
        if ((st[0] | st[1] | st[2]) * size | x.data_ptr()) % align:
            raise ValueError(f"{name} must be aligned to {align} bytes: "
                             f"base and b, s, h strides")
    if dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{kernel} takes bf16 or fp32, got {q.dtype}")
    shape, kshape = q.shape, k.shape
    B, S, H, D = shape
    if kshape != v.shape or kshape[0] != B or kshape[1] != S \
            or kshape[3] != D:
        raise ValueError(f"k {tuple(kshape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(shape)}")
    for x in more:
        if x.shape != shape:
            raise ValueError(f"do must have q's shape {tuple(shape)}")
    if H % kshape[2]:
        raise ValueError(f"{H} query heads do not group over {kshape[2]} "
                         "KV heads")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{kernel} supports head_dim {KERNEL_HEAD_DIMS}, "
                         f"got {D}")
    if S < 1 or B * H > 65535:
        raise ValueError(f"unsupported shape {tuple(q.shape)}")


def _check_row_stats(q, **stats) -> None:
    """lse and delta: fp32, contiguous, B * H * S values on q's device, from
    a 16-byte aligned base (the bf16 kernels read them through tensor
    maps)."""
    B, S, H, _ = q.shape
    device = q.get_device()
    for name, x in stats.items():
        if x.get_device() != device or x.dtype != torch.float32 \
                or not x.is_contiguous() or x.numel() != B * H * S \
                or x.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"fp32 (B*H, S) tensor on {q.device}, got "
                             f"{x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")


# (library, C function) -> the ctypes function with its signature declared
_ENTRIES: Dict[Tuple[str, str], object] = {}


def _entry(lib_name: str, fn_name: str, n_pointers: int):
    """The C function ``fn_name`` of ``csrc/<lib_name>.cu``, looked up once
    and given its ctypes signature: without ``argtypes`` ctypes would pass
    the 64-bit pointers and the stream as 32-bit ints."""
    fn = getattr(_build.build(lib_name).lib, fn_name)
    fn.argtypes = ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _ENTRIES[lib_name, fn_name] = fn
    return fn


# torch's own getters of the current card and of its current stream's
# handle: the public ones add a lazy-init check and a ``torch.cuda.Stream``
# object to every launch. A CPU-only torch has neither, and never launches.
def _current_device() -> int:
    return torch._C._cuda_getDevice()


def _current_stream(index: int) -> int:
    """The handle of card ``index``'s current stream."""
    return torch._C._cuda_getCurrentRawStream(index)


# launches of each C function, counted where ``_launch`` calls it: the
# count of the earlier Delta kernel ``flash_bwd_delta``, which no wrapper
# owns, that ``launch_counts`` reports
entry_launches: Dict[str, int] = {}


# ctypes array types of the strides, by length
_STRIDES = {n: ctypes.c_longlong * n for n in range(3, 31, 3)}


def _launch(lib_name: str, fn_name: str, tensors, causal: bool) -> None:
    """Call the C function ``fn_name`` of ``csrc/<lib_name>.cu`` on
    ``tensors`` (q, k, v first; None passes a null pointer; the b, s, h
    strides of each 4-d one are passed in order) on q's device and its
    current stream; raise if the launch failed. The device is switched
    only when q is not on the current one."""
    q, k = tensors[:2]
    fn = _ENTRIES.get((lib_name, fn_name)) or _entry(lib_name, fn_name,
                                                     len(tensors))
    B, S, H, D = q.shape
    strides = ()
    for x in tensors:
        if x is not None and x.dim() == 4:
            strides += x.stride()[:3]
    args = (*(None if x is None else x.data_ptr() for x in tensors),
            _KERNEL_DTYPES[q.dtype], B, S, H, k.shape[2], D,
            _STRIDES[len(strides)](*strides), int(causal))
    index = q.get_device()
    if index == _current_device():
        err = fn(*args, _current_stream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, _current_stream(index))
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err}")
    entry_launches[fn_name] = entry_launches.get(fn_name, 0) + 1


def _launch_kernel(q, k, v, causal: bool):
    B, S, H, D = q.shape
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((B * H, S, 1), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", "flash_fwd", (q, k, v, o, lse), causal)
    flash_attention_fwd.launches += 1
    return o, lse


def flash_attention_fwd(q, k, v, causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash-attention forward: ``(o, lse)`` as ``flash_attention_fwd_plain``.

    On CUDA tensors this launches ``flash_fwd`` of ``csrc/flash_fwd.cu``
    (head_dim 64 or 128, any S) or raises; there is no fallback. The C entry
    point picks the kernel by dtype: bf16 runs the TMA / ``wgmma`` kernel
    (q, k, v 16-byte aligned, with b, s, h strides of multiples of 8
    elements), fp32 the ``mma.sync`` kernel. Tensors on the CPU take the
    plain version. ``flash_attention_fwd.launches`` counts kernel
    launches."""
    if _on_cpu(q, k, v):
        return flash_attention_fwd_plain(q, k, v, causal)
    _check_kernel_inputs("flash_fwd", q, k, v)
    return _launch_kernel(q, k, v, causal)


flash_attention_fwd.launches = 0


# -- backward ---------------------------------------------------------------


def attention_delta_plain(o, do) -> torch.Tensor:
    """Delta = rowsum(dO * O) as (B * H, S), in fp32: the term the backward
    subtracts from dP (plain XLA in the JAX package too, not a kernel)."""
    B, S, H, _ = o.shape
    acc = _acc_dtype(o)
    delta = torch.einsum("bshd,bshd->bhs", do.to(acc), o.to(acc))
    return delta.reshape(B * H, S).contiguous()


def attention_bwd_prep_plain(o, do, for_dq: bool = True):
    """``attention_bwd_prep``'s function in plain PyTorch: Delta
    (``attention_delta_plain``) and, ``for_dq``, an fp32 tensor of zeros of
    o's (B, S, H, D) shape and B * H * ceil(S / 64) int32 zeros; else None
    and None."""
    delta = attention_delta_plain(o, do)
    if not for_dq:
        return delta, None, None
    B, S, H, _ = o.shape
    return (delta, torch.zeros(o.shape, dtype=torch.float32, device=o.device),
            torch.zeros(B * H * -(-S // 64), dtype=torch.int32,
                        device=o.device))


def _check_prep_inputs(o, do) -> None:
    """Raise on o and dO that ``flash_bwd_prep`` cannot take, in one pass
    over the two: equal (B, S, H, D) shapes, dtypes and devices, a
    contiguous last dim, 16-byte aligned bases and b, s, h strides (the
    kernel's loads are 16 bytes), bf16 or fp32, head_dim 64 or 128."""
    shape, dtype = o.shape, o.dtype
    if do.shape != shape or do.dtype != dtype or \
            do.get_device() != o.get_device():
        raise ValueError(f"do must match o: {do.dtype} {tuple(do.shape)} on "
                         f"{do.device}, o {dtype} {tuple(shape)} on "
                         f"{o.device}")
    if len(shape) != 4:
        raise ValueError(f"o must be (B, S, H, D) with a contiguous last "
                         f"dim, got {tuple(shape)}")
    ob, os_, oh, od = o.stride()
    db, ds, dh, dd = do.stride()
    if od != 1 or dd != 1:
        raise ValueError(f"{'o' if od != 1 else 'do'} must be (B, S, H, D) "
                         "with a contiguous last dim")
    if ((ob | os_ | oh | db | ds | dh) * o.element_size()
            | o.data_ptr() | do.data_ptr()) % 16:
        raise ValueError("o and do must be aligned to 16 bytes: base and b, "
                         "s, h strides")
    if dtype not in _KERNEL_DTYPES:
        raise TypeError(f"flash_bwd_prep takes bf16 or fp32, got {dtype}")
    if shape[3] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_bwd_prep supports head_dim "
                         f"{KERNEL_HEAD_DIMS}, got {shape[3]}")


def attention_bwd_prep(o, do, for_dq: bool = True):
    """What the backward needs before ``flash_bwd``: ``(delta, dq_acc,
    counts)`` as ``attention_bwd_prep_plain``. Delta is (B * H, S) fp32;
    ``for_dq``, dq_acc is a zeroed fp32 accumulator of o's shape (q's) and
    counts the zeroed int32 counters that order ``flash_bwd``'s dQ adds,
    one a (batch, head, 64-row q tile); without it both are None.

    On CUDA tensors this launches ``flash_bwd_prep`` of
    ``csrc/flash_bwd.cu`` once (bf16 or fp32, head_dim 64 or 128, any S)
    or raises; there is no fallback: the plain expression's fp32 copies of
    o and dO cost more than the fused backward kernel, and the zeros would
    be two more device operations. CPU tensors take the plain version.
    ``attention_bwd_prep.launches`` counts launches."""
    if _on_cpu(o, do):
        return attention_bwd_prep_plain(o, do, for_dq)
    _check_prep_inputs(o, do)
    return _launch_prep(o, do, for_dq)


attention_bwd_prep.launches = 0


def _launch_prep(o, do, for_dq: bool):
    B, S, H, _ = o.shape
    delta = o.new_empty((B * H, S), dtype=torch.float32)
    dq_acc = counts = None
    if for_dq:
        dq_acc = o.new_empty(o.shape, dtype=torch.float32)
        counts = o.new_empty(B * H * -(-S // 64), dtype=torch.int32)
    _launch("flash_bwd", "flash_bwd_prep", (o, do, delta, dq_acc, counts),
            False)
    attention_bwd_prep.launches += 1
    return delta, dq_acc, counts


def attention_delta(o, do) -> torch.Tensor:
    """Delta as ``attention_delta_plain``: ``attention_bwd_prep`` without
    the accumulator (one ``flash_bwd_prep`` launch on CUDA tensors, counted
    in ``attention_bwd_prep.launches``, or an error; the plain version on
    CPU tensors)."""
    return attention_bwd_prep(o, do, for_dq=False)[0]


def bwd_softmax_grads(q, k, v, do, lse, delta, causal: bool):
    """The backward's softmax terms in fp32, (B, H, S, S) each: P = exp(s -
    lse) of the scaled, masked scores, and dS = P * (dO V^T - Delta) *
    scale, scale = 1/sqrt(D) (dS carries one factor of it, as in the JAX
    kernels)."""
    B, S, H, D = q.shape
    acc = _acc_dtype(q)
    p = torch.exp(_masked_scores(q, k, causal) - lse.reshape(B, H, S, 1))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.to(acc),
                      _repeat_kv(v, H).to(acc))
    ds = p * (dp - delta.reshape(B, H, S, 1)) * (1.0 / math.sqrt(D))
    return p, ds


def bwd_products(p, ds, q, k, do):
    """dQ = dS K, dK = dS^T Q and dV = P^T dO in the softmax terms' dtype;
    dK and dV summed over each KV head's group of query heads, (B, S, KVH,
    D). On absolute values (|dS|, |Q|, |K|, |dO|) these are the magnitudes
    that a rounding of P or dS scales with."""
    B, S, H, D = q.shape
    kvh = k.shape[2]
    acc = p.dtype
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, _repeat_kv(k, H).to(acc))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(acc))
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.to(acc))
    group = (B, S, kvh, H // kvh, D)
    return dq, dk.reshape(group).sum(3), dv.reshape(group).sum(3)


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal: bool = True
                              ) -> Tuple[torch.Tensor, ...]:
    """The backward kernels' function in plain PyTorch, step by step as the
    JAX package's ``flash_attention_bwd`` (both kernels and Delta): masked
    fp32 scores, P = exp(s - lse), dP = dO V^T, dS = P (dP - Delta) scale,
    dQ = dS K, dK = dS^T Q, dV = P^T dO. Returns ``(dq, dk, dv)``, dq in q's
    dtype and shape, dk and dv in k's (summed over each group of query
    heads). Any S and head dim."""
    delta = attention_delta_plain(o, do)
    return _bwd_plain(q, k, v, do, lse, delta, causal)


def _bwd_plain(q, k, v, do, lse, delta, causal):
    p, ds = bwd_softmax_grads(q, k, v, do, lse, delta, causal)
    dq, dk, dv = bwd_products(p, ds, q, k, do)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal: bool = True
                           ) -> torch.Tensor:
    """dQ of flash attention, from the forward's lse and ``attention_delta``.

    On CUDA tensors this launches ``flash_bwd_dq`` of ``csrc/flash_bwd.cu``
    (the ``mma.sync`` kernel; bf16 or fp32, head_dim 64 or 128, any S) or
    raises; CPU tensors take the plain version. The bf16 backward does not
    come here: ``flash_attention_bwd`` folds dQ into ``flash_bwd``.
    ``flash_attention_bwd_dq.launches`` counts launches."""
    if _on_cpu(q, k, v, do):
        return _bwd_plain(q, k, v, do, lse, delta, causal)[0]
    _check_kernel_inputs("flash_bwd_dq", q, k, v, do)
    _check_row_stats(q, lse=lse, delta=delta)
    return _launch_bwd_dq(q, k, v, do, lse, delta, causal)


flash_attention_bwd_dq.launches = 0


def _launch_bwd_dq(q, k, v, do, lse, delta, causal: bool):
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    _launch("flash_bwd", "flash_bwd_dq", (q, k, v, do, lse, delta, dq), causal)
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal: bool = True
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK and dV of flash attention, summed over each KV head's group of
    query heads inside the kernel: (B, S, KVH, D) in k's dtype.

    On CUDA tensors this launches ``flash_bwd_dkv`` of
    ``csrc/flash_bwd.cu`` (bf16: the TMA / ``wgmma`` kernel without dQ;
    fp32: the ``mma.sync`` kernel) or raises; CPU tensors take the plain
    version. ``flash_attention_bwd_dkv.launches`` counts launches."""
    if _on_cpu(q, k, v, do):
        return _bwd_plain(q, k, v, do, lse, delta, causal)[1:]
    _check_kernel_inputs("flash_bwd_dkv", q, k, v, do)
    _check_row_stats(q, lse=lse, delta=delta)
    return _launch_bwd_dkv(q, k, v, do, lse, delta, causal)


flash_attention_bwd_dkv.launches = 0


def _launch_bwd_dkv(q, k, v, do, lse, delta, causal: bool):
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    _launch("flash_bwd", "flash_bwd_dkv", (q, k, v, do, lse, delta, dk, dv),
            causal)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True
                        ) -> Tuple[torch.Tensor, ...]:
    """Flash-attention backward: ``(dq, dk, dv)`` as
    ``flash_attention_bwd_plain``.

    On CUDA tensors, by dtype (or an error; no fallback):

    - bf16: three device operations. Once every input is checked,
      ``attention_bwd_prep`` (one ``flash_bwd_prep`` launch: Delta, the
      zeroed fp32 dQ accumulator and the zeroed counters of its adds'
      order), then one launch of ``flash_bwd`` of ``csrc/flash_bwd.cu`` on
      those very buffers, which computes dK and dV and adds each q tile's
      dQ into the accumulator in a fixed order (so every output is the
      same from run to run), then dQ's cast to bf16.
      ``flash_attention_bwd.launches`` counts the ``flash_bwd`` launches;
    - fp32: Delta (``attention_delta``), then the pair,
      ``flash_attention_bwd_dq`` and ``flash_attention_bwd_dkv`` (the
      ``mma.sync`` kernels).

    On CPU tensors: the plain version."""
    if _on_cpu(q, k, v, o, do):
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    if q.dtype != torch.bfloat16:
        return flash_attention_bwd_rows(q, k, v, do, lse,
                                        attention_delta(o, do), causal)
    _check_kernel_inputs("flash_bwd", q, k, v, do)
    _check_row_stats(q, lse=lse)
    _check_prep_inputs(o, do)  # o then has q's shape, as dO has
    delta, dq_acc, counts = _launch_prep(o, do, True)
    dq, dk, dv = _launch_bwd(q, k, v, do, lse, delta, causal, dq_acc, counts)
    return dq.to(q.dtype), dk, dv


flash_attention_bwd.launches = 0


def flash_attention_bwd_rows(q, k, v, do, lse, delta, causal: bool = True,
                             dq_acc: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, ...]:
    """The backward from row statistics the caller gives: ``lse`` (B * H,
    S, 1) and ``delta`` (B * H, S), fp32, as the forward and
    ``attention_delta`` make them. Ring attention calls it for each block
    with the lse and Delta of the merged output, which are not the block's
    own.

    Returns ``(dq, dk, dv)`` as ``flash_attention_bwd``. With ``dq_acc`` (an
    fp32 tensor of q's shape), dQ is added into it in fp32 and ``dq_acc``
    is returned in dq's place: the bf16 kernel adds each q tile's share
    into that buffer by TMA reduce-add in any case, so a caller summing dQ
    over several blocks pays neither a cast nor a rounding a block.

    On CUDA tensors bf16 takes ``dq_acc`` (zeroed, as
    ``attention_bwd_prep`` returns it) and launches ``flash_bwd`` (counted
    in ``flash_attention_bwd.launches``), and fp32 the pair
    ``flash_attention_bwd_dq`` and ``flash_attention_bwd_dkv``, or raises;
    CPU tensors take the plain version."""
    if dq_acc is not None and (dq_acc.shape != q.shape
                               or dq_acc.dtype != torch.float32
                               or dq_acc.device != q.device
                               or not dq_acc.is_contiguous()
                               or dq_acc.data_ptr() % 16):
        raise ValueError(f"dq_acc must be a contiguous, 16-byte aligned fp32 "
                         f"tensor of q's shape {tuple(q.shape)} on "
                         f"{q.device}")
    if _on_cpu(q, k, v, do):
        if dq_acc is None:
            return _bwd_plain(q, k, v, do, lse, delta, causal)
        p, ds = bwd_softmax_grads(q, k, v, do, lse, delta, causal)
        dq, dk, dv = bwd_products(p, ds, q, k, do)
        return dq_acc.add_(dq), dk.to(k.dtype), dv.to(v.dtype)
    if q.dtype == torch.bfloat16:
        if dq_acc is None:
            raise ValueError("bf16 on the card takes the caller's dq_acc "
                             "(zeroed by attention_bwd_prep); "
                             "flash_attention_bwd makes its own")
        _check_kernel_inputs("flash_bwd", q, k, v, do)
        _check_row_stats(q, lse=lse, delta=delta)
        return _launch_bwd(q, k, v, do, lse, delta, causal, dq_acc,
                           dq_counters(q))
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
    return (dq if dq_acc is None else dq_acc.add_(dq)), dk, dv


def dq_counters(q: torch.Tensor) -> torch.Tensor:
    """The zeros that ``flash_bwd`` orders its dQ adds with: one int32 a
    (batch, head, 64-row q tile) of q (B, S, H, D). A launch counts in
    them, so each launch takes fresh ones (``attention_bwd_prep`` makes
    them in its launch; this is for a caller's accumulator)."""
    B, S, H, _ = q.shape
    return torch.zeros(B * H * -(-S // 64), dtype=torch.int32,
                       device=q.device)


def _launch_bwd(q, k, v, do, lse, delta, causal: bool, dq_acc, counts):
    """``flash_bwd`` adding dQ into ``dq_acc`` in the order ``counts``
    (fresh zeros) keeps; returns ``(dq_acc, dk, dv)``."""
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    _launch("flash_bwd", "flash_bwd",
            (q, k, v, do, lse, delta, dk, dv, dq_acc, counts), causal)
    flash_attention_bwd.launches += 1
    return dq_acc, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention whose forward is ``flash_attention_fwd`` and whose backward
    is ``flash_attention_bwd``: the counterpart of the JAX package's
    ``flash_attention`` custom VJP. The TPU's head_dim <= 64 gate on the
    kernel backward is not copied: head dims 64 and 128 both take it."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        o, lse = flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """Differentiable flash attention: (B, S, H, D) with k, v (B, S, KVH, D)
    -> (B, S, H, D). The kernels on CUDA tensors, the plain versions on CPU
    tensors."""
    return FlashAttention.apply(q, k, v, causal)


def attention(q, k, v, causal: bool = True, impl: str = "auto",
              segment_ids: Optional[torch.Tensor] = None):
    """Dispatching attention op used by the model (k, v may have fewer heads
    than q). ``impl``:

    - ``auto``: ``flash_attention``, whose forward and backward are the
      kernels on CUDA tensors and their plain versions on CPU tensors. On the
      card there is no other route: a head dim the kernels do not take, or
      ``segment_ids``, raise. On the CPU, ``segment_ids`` take
      ``reference_attention``.
    - ``flash``: the kernels; raises on CPU tensors.
    - ``xla``: ``reference_attention`` (the name kept from the JAX package so
      ``model_overrides`` stay compatible), differentiated by autograd, on
      any device.
    """
    if impl == "auto":
        if q.device.type == "cpu":
            if segment_ids is not None:
                return reference_attention(q, k, v, causal, segment_ids)
            return flash_attention(q, k, v, causal)
        impl = "flash"
    if impl == "flash":
        if q.device.type == "cpu":
            raise ValueError("impl='flash' runs the CUDA kernel and needs "
                             "CUDA tensors; use impl='auto' or 'xla'")
        if segment_ids is not None:
            raise ValueError("the flash kernel takes no segment_ids; use "
                             "impl='xla' for packed sequences")
        return flash_attention(q, k, v, causal)
    if impl == "xla":
        return reference_attention(q, k, v, causal, segment_ids)
    raise ValueError(f"unknown attention impl {impl!r}: auto, flash or xla")


def launch_counts(reset: bool = False) -> Dict[str, int]:
    """This process's launch count of each kernel wrapper, by its name, and
    of the earlier Delta kernel's C entry, ``flash_bwd_delta``, which no
    wrapper launches; set to 0 after reading when ``reset``. What a serving
    process reports so a caller can see which kernels its path ran."""
    wrappers = (flash_attention_fwd, attention_bwd_prep, flash_attention_bwd,
                flash_attention_bwd_dq, flash_attention_bwd_dkv)
    counts = {fn.__name__: fn.launches for fn in wrappers}
    counts["flash_bwd_delta"] = entry_launches.get("flash_bwd_delta", 0)
    if reset:
        for fn in wrappers:
            fn.launches = 0
        entry_launches.clear()
    return counts
