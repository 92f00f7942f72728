"""Sequence-parallel attention on a collective group: the port of
``ray_tpu/ops/ring_attention.py``.

q, k and v are each rank's local ``(B, S_local, H, D)`` shard of a sequence
laid out over the group's ranks in rank order; q and k, v have the same
heads, as the JAX einsum requires. Both functions are exact causal or full
attention and differentiable (``torch.autograd.Function``s):

- ``ring_attention``: K and V go round the ring by point-to-point sends.
  At step t rank i attends to the block of rank (i - t) mod n, with the
  flash forward (``attend_block``: the kernel on CUDA tensors, its plain
  version on CPU tensors), and merges the blocks by their lse
  (``merge_blocks``). Under a causal mask a block of a later rank lies
  wholly in the future: it is skipped, where the JAX code runs it masked;
  the result is the same. The backward is written out, since sends carry
  no gradient: each block's backward (``block_backward``) runs the flash
  backward with the lse and Delta = rowsum(dO * O) of the merged output,
  not the block's own, adds its dQ share in place and its dK, dV shares
  into fp32 accumulators that travel the ring back to their owner.
- ``ulysses_attention``: all-to-alls swap the sequence and head shards,
  attention runs on whole sequences of H / n heads (``attention(impl=
  "auto")``: the flash kernels on the card; the JAX function runs plain
  XLA), and an all-to-all swaps back. The backward of an all-to-all is the
  transposed all-to-all.

``group`` is a ``TorchGroup`` or the name of one (``init_collective_group``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ray_tpu_torch.ops.attention import (attention, attention_bwd_prep,
                                         flash_attention_bwd_rows,
                                         flash_attention_fwd)


def _group(group):
    if isinstance(group, str):
        from ray_tpu_torch.collective import get_group

        return get_group(group)
    return group


def _check_shards(q, k, v) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k and v must be local (B, S_local, H, D) "
                         f"shards of one shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")


# -- the per-step math --------------------------------------------------------


def attend_block(q, k, v, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """One (local q, remote k/v) block: ``(o, lse)`` of the flash forward,
    o in q's dtype, lse (B * H, S, 1) fp32. ``causal`` masks within the
    block, which is right only for the diagonal block."""
    return flash_attention_fwd(q, k, v, causal)


def _rows(lse: torch.Tensor, shape) -> torch.Tensor:
    """(B * H, S, 1) -> (B, S, H, 1), to scale o's rows."""
    B, S, H, _ = shape
    return lse.reshape(B, H, S).transpose(1, 2)[..., None]


def merge_blocks(o, lse, o_blk, lse_blk) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge a block's ``(o_blk, lse_blk)`` into the running ``(o, lse)``:
    each is its rows' softmax-weighted mean, so the merge weighs them by
    exp(lse - lse_new), lse_new = logaddexp(lse, lse_blk). Returns o in
    fp32 and the new lse."""
    new = torch.logaddexp(lse, lse_blk)
    w = _rows(torch.exp(lse - new), o.shape)
    w_blk = _rows(torch.exp(lse_blk - new), o.shape)
    return o.float() * w + o_blk.float() * w_blk, new


def block_backward(q, k, v, do, lse, delta, causal: bool,
                   dq_acc: torch.Tensor):
    """One block's backward from the merged output's ``lse`` and ``delta``:
    dQ added into ``dq_acc`` (fp32, q's shape), ``(dk, dv)`` returned in k's
    dtype. The flash backward's bf16 kernel adds dQ into an fp32 buffer by
    TMA reduce-add whatever the caller does, so summing a rank's blocks in
    that one buffer costs nothing: no per-block zeroing, cast or bf16
    rounding of dQ."""
    _, dk, dv = flash_attention_bwd_rows(q, k, v, do, lse, delta, causal,
                                         dq_acc=dq_acc)
    return dk, dv


def _future(causal: bool, owner: int, rank: int) -> bool:
    """A block of a later rank lies wholly in the future of this rank's
    queries: under a causal mask it contributes nothing."""
    return causal and owner > rank


def _wait(requests) -> None:
    for req in requests:
        req.wait()


# -- ring ---------------------------------------------------------------------


def ring_attention_fwd(q, k, v, group, causal: bool = True):
    """``(o, lse)`` of exact attention over the ring: o in q's dtype, lse
    (B * H, S_local, 1) fp32, both of the merged output. While a block is
    computed the next K, V are already on their way."""
    group = _group(group)
    _check_shards(q, k, v)
    n, rank = group.world_size, group.rank
    o = lse = None
    kv = (k.contiguous(), v.contiguous())
    for t in range(n):
        owner = (rank - t) % n
        pending = group.ring_shift(kv) if t < n - 1 else None
        if not _future(causal, owner, rank):
            o_b, lse_b = attend_block(q, *kv, causal and owner == rank)
            o, lse = ((o_b.float(), lse_b) if o is None
                      else merge_blocks(o, lse, o_b, lse_b))
        if pending is not None:
            kv, requests = pending
            _wait(requests)
    return o.to(q.dtype), lse


def ring_attention_bwd(q, k, v, o, lse, do, group, causal: bool = True):
    """``(dq, dk, dv)`` of ``ring_attention``, from the merged ``o`` and
    ``lse`` the forward returned."""
    group = _group(group)
    n, rank = group.world_size, group.rank
    do = do.contiguous()
    # Delta of the merged output, for every block, and the zeroed fp32 dQ
    # that every block adds into, from one launch (the counters are for a
    # single flash_bwd launch: each block's takes fresh ones)
    delta, dq, _ = attention_bwd_prep(o, do)
    kv = (k.contiguous(), v.contiguous())
    # the owner's dK, dV so far: they travel with K, V and, after the last
    # step, one rank further, which is back to their owner
    dkv = [torch.zeros(k.shape, dtype=torch.float32, device=k.device)
           for _ in range(2)]
    for t in range(n):
        owner = (rank - t) % n
        pending = group.ring_shift(kv) if t < n - 1 else None
        if not _future(causal, owner, rank):
            dk, dv = block_backward(q, *kv, do, lse, delta,
                                    causal and owner == rank, dq)
            dkv[0] += dk
            dkv[1] += dv
        if n > 1:
            dkv, requests = group.ring_shift(dkv)
            _wait(requests)
        if pending is not None:
            kv, requests = pending
            _wait(requests)
    return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype)


class RingAttention(torch.autograd.Function):
    """``ring_attention_fwd`` with ``ring_attention_bwd`` as its backward."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal: bool):
        o, lse = ring_attention_fwd(q, k, v, group, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.group, ctx.causal = group, causal
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = ring_attention_bwd(q, k, v, o, lse, do, ctx.group,
                                        ctx.causal)
        return dq, dk, dv, None, None


def ring_attention(q, k, v, group, causal: bool = True) -> torch.Tensor:
    """Exact attention of local (B, S_local, H, D) shards with K and V going
    round ``group``'s ring; returns this rank's (B, S_local, H, D)."""
    return RingAttention.apply(q, k, v, _group(group), causal)


# -- Ulysses ------------------------------------------------------------------


def all_to_all(x, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    """``jax.lax.all_to_all(..., tiled=True)``: ``split_dim`` cut into n
    tiles, tile j sent to rank j, the tiles received concatenated along
    ``concat_dim`` in rank order."""
    n = group.world_size
    tiles = x.unflatten(split_dim, (n, x.shape[split_dim] // n))
    out = group.alltoall(tiles.movedim(split_dim, 0))
    return out.movedim(0, concat_dim).flatten(concat_dim, concat_dim + 1)


class AllToAll(torch.autograd.Function):
    """``all_to_all``, whose backward is the transposed all-to-all."""

    @staticmethod
    def forward(ctx, x, group, split_dim: int, concat_dim: int):
        ctx.group, ctx.dims = group, (split_dim, concat_dim)
        return all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        split_dim, concat_dim = ctx.dims
        return all_to_all(grad, ctx.group, concat_dim, split_dim), None, \
            None, None


def ulysses_attention(q, k, v, group, causal: bool = True) -> torch.Tensor:
    """DeepSpeed-Ulysses sequence parallelism: local (B, S/n, H, D) shards
    swapped to (B, S, H/n, D) by all-to-alls, full attention on that head
    shard (``attention(impl="auto")``), and swapped back. H must divide by
    the world size."""
    group = _group(group)
    _check_shards(q, k, v)
    n = group.world_size
    if q.shape[2] % n:
        raise ValueError(f"ulysses_attention needs heads divisible by the "
                         f"group's {n} ranks, got {q.shape[2]}")
    qg, kg, vg = (AllToAll.apply(x, group, 2, 1) for x in (q, k, v))
    out = attention(qg, kg, vg, causal=causal, impl="auto")
    return AllToAll.apply(out, group, 1, 2)


__all__ = ["attend_block", "block_backward", "merge_blocks",
           "ring_attention", "ring_attention_bwd", "ring_attention_fwd",
           "ulysses_attention", "all_to_all", "AllToAll", "RingAttention"]
