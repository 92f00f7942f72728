"""Attention ops: the hand-written CUDA flash-attention forward + plain paths.

Counterpart of ``ray_tpu/ops/attention.py`` (forward half). The TPU's Pallas
kernel ``_flash_fwd_kernel`` becomes ``csrc/flash_fwd.cu``, built with nvcc
for ``sm_90a`` at first use and called through ctypes. Beside it, in this
module, is its plain PyTorch version: the CPU tests run that one, and the
chip smoke holds the kernel against it on the card.

Layouts follow the JAX package: q is (B, S, H, D); k and v are (B, S, KVH, D)
with H a multiple of KVH (grouped-query attention: query head h reads KV head
h // (H // KVH), as ``jnp.repeat(k, H // KVH, axis=2)`` lays it out). The
kernel reads that layout through strides, so callers neither transpose nor
repeat.

The backward kernels (``_flash_bwd_dq_kernel``, ``_flash_bwd_dkv_kernel``)
belong to training and are not ported yet (ROADMAP.md, queue 2).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ray_tpu_torch.ops import _build

_MASKED = -1e30
_KERNEL_HEAD_DIMS = (64, 128)
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


def _masked_scores(q, k, causal: bool, segment_ids=None) -> torch.Tensor:
    """fp32 scores (B, H, Sq, Sk) scaled by 1/sqrt(D), masked with -1e30."""
    d = q.shape[-1]
    k = _repeat_kv(k, q.shape[2])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
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


def _check_kernel_inputs(q, k, v) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != q.dtype:
            raise TypeError(f"{name} is {x.dtype}, q is {q.dtype}")
        if x.dim() != 4:
            raise ValueError(f"{name} must be (B, S, heads, D), got "
                             f"{tuple(x.shape)}")
        if x.stride(-1) != 1:
            raise ValueError(f"{name}'s last dim must be contiguous")
        # the kernel loads pairs of elements: pair-aligned rows and base
        if any(s % 2 for s in x.stride()[:3]) or \
                x.data_ptr() % (2 * x.element_size()):
            raise ValueError(f"{name} must be aligned to pairs of elements")
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"flash_fwd takes bf16 or fp32, got {q.dtype}")
    B, S, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[1] != S \
            or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"{H} query heads do not group over {k.shape[2]} "
                         "KV heads")
    if D not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_fwd supports head_dim {_KERNEL_HEAD_DIMS}, "
                         f"got {D}")
    if S < 1 or B * H > 65535:
        raise ValueError(f"unsupported shape {tuple(q.shape)}")


def _launch_kernel(q, k, v, causal: bool):
    lib = _build.build("flash_fwd").lib
    fn = lib.flash_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    B, S, H, D = q.shape
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((B * H, S, 1), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *o.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), _KERNEL_DTYPES[q.dtype], B, S, H, k.shape[2],
                 D, strides, int(causal), stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {err}")
    flash_attention_fwd.launches += 1
    return o, lse


def flash_attention_fwd(q, k, v, causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash-attention forward: ``(o, lse)`` as ``flash_attention_fwd_plain``.

    On CUDA tensors this launches ``csrc/flash_fwd.cu`` (bf16 or fp32,
    head_dim 64 or 128, any S) or raises; there is no fallback. Tensors on
    the CPU take the plain version. ``flash_attention_fwd.launches`` counts
    kernel launches."""
    if q.device.type == "cpu":
        for x in (k, v):
            if x.device.type != "cpu":
                raise ValueError("q, k and v must be on one device")
        return flash_attention_fwd_plain(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on cuda or cpu, not {q.device}")
    _check_kernel_inputs(q, k, v)
    return _launch_kernel(q, k, v, causal)


flash_attention_fwd.launches = 0


def attention(q, k, v, causal: bool = True, impl: str = "auto",
              segment_ids: Optional[torch.Tensor] = None):
    """Dispatching attention op used by the model (k, v may have fewer heads
    than q). ``impl``:

    - ``auto``: the flash forward, which is the kernel on CUDA tensors and
      its plain version on CPU tensors. On the card there is no other route:
      a head dim the kernel does not take, or ``segment_ids``, raise.
    - ``flash``: the kernel; raises on CPU tensors.
    - ``xla``: ``reference_attention`` (the name kept from the JAX package so
      ``model_overrides`` stay compatible), on any device.
    """
    if impl == "auto":
        if q.device.type == "cpu":
            return reference_attention(q, k, v, causal, segment_ids)
        impl = "flash"
    if impl == "flash":
        if q.device.type == "cpu":
            raise ValueError("impl='flash' runs the CUDA kernel and needs "
                             "CUDA tensors; use impl='auto' or 'xla'")
        if segment_ids is not None:
            raise ValueError("the flash kernel takes no segment_ids; use "
                             "impl='xla' for packed sequences")
        return flash_attention_fwd(q, k, v, causal)[0]
    if impl == "xla":
        return reference_attention(q, k, v, causal, segment_ids)
    raise ValueError(f"unknown attention impl {impl!r}: auto, flash or xla")
