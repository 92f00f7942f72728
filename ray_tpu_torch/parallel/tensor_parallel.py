"""The Megatron operators of the ``tensor`` axis: the port of what the JAX
package's logical rules do to heads, the MLP and the vocabulary
(``heads``, ``kv_heads``, ``mlp`` and ``vocab`` on ``tensor``,
``ray_tpu/parallel/mesh.py:29``), written out as collectives.

Each rank of the axis holds a slice of every such dim: its query and KV
heads, its columns of the MLP's hidden layer, its rows of the vocabulary.
Activations between the blocks are whole and the same on every rank; the
attention and the MLP take them through ``copy_to_region`` (identity
forward, the gradient summed over the axis backward) and give back a
partial product through ``reduce_from_region`` (summed forward, identity
backward). The embedding looks up the rows of this rank's vocabulary and
sums over the axis; the cross entropy takes this rank's slice of the fp32
logits and all-reduces the row max, the sum of exponentials and the
target's logit, with a backward of softmax minus one-hot on the local
vocabulary that needs no collective.

The reductions go through a small interface, ``TensorAxis.all_reduce``:
``GroupAxis`` runs it on the axis's ``TorchGroup``; ``StackedRanks`` runs
every rank of the axis in one process, dim 0 of each tensor indexing the
rank, so that the operators can be held against their plain versions
(the whole table's lookup, ``lm_loss``) without a process group.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ray_tpu_torch.collective.collective_group import TorchGroup
from ray_tpu_torch.collective.types import ReduceOp
from ray_tpu_torch.models.transformer import masked_mean

Start = Union[int, torch.Tensor]


class TensorAxis:
    """The tensor axis's reductions (``all_reduce``, by "sum" or "max") and
    the Megatron operators built on them. ``size``: the axis's rank
    count."""

    size: int = 1

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        raise NotImplementedError

    def copy_to_region(self, x: torch.Tensor) -> torch.Tensor:
        """Identity forward; backward, the gradient summed over the axis (a
        whole activation feeding each rank's slice of a product)."""
        return _CopyToRegion.apply(x, self)

    def reduce_from_region(self, x: torch.Tensor) -> torch.Tensor:
        """Each rank's partial product summed over the axis; backward, the
        gradient as it is (every rank's partial adds to the same sum)."""
        return _ReduceFromRegion.apply(x, self)

    def embedding(self, weight: torch.Tensor, tokens: torch.Tensor,
                  start: Start) -> torch.Tensor:
        """The vocabulary-parallel lookup: ``weight`` holds the rows
        ``start:start + len(weight)`` of the table; each rank gives its
        rows and zeros for the others' tokens, summed over the axis."""
        return self.reduce_from_region(embedding_partial(weight, tokens,
                                                         start))


class GroupAxis(TensorAxis):
    """The axis as the ranks of a ``TorchGroup`` (a mesh's ``tensor``
    group)."""

    def __init__(self, group: TorchGroup):
        self.group = group
        self.size = group.world_size
        self.rank = group.rank

    def all_reduce(self, x, op="sum"):
        return self.group.allreduce(x, ReduceOp.MAX if op == "max"
                                    else ReduceOp.SUM)


class StackedRanks(TensorAxis):
    """``size`` ranks in one process: dim 0 of every tensor indexes the
    rank, and a reduction is over dim 0, its result on every rank."""

    def __init__(self, size: int):
        self.size = size

    def all_reduce(self, x, op="sum"):
        if x.shape[0] != self.size:
            raise ValueError(f"dim 0 of {tuple(x.shape)} is not the "
                             f"{self.size} ranks")
        out = x.amax(0) if op == "max" else x.sum(0)
        return out.expand_as(x)

    def starts(self, vocab_local: int, ndim: int) -> torch.Tensor:
        """Each rank's first vocabulary row, shaped (size, 1, ...) to
        broadcast against tokens of ``ndim`` dims."""
        return (torch.arange(self.size) * vocab_local).reshape(
            (self.size,) + (1,) * ndim)


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.axis.all_reduce(grad), None


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return axis.all_reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _local_ids(tokens: torch.Tensor, start: Start, rows: int):
    """Each token's row in this rank's slice of the vocabulary (clamped
    into it) and whether the token lies in that slice."""
    local = tokens - (start.to(tokens.device) if torch.is_tensor(start)
                      else start)
    inside = (local >= 0) & (local < rows)
    return local.clamp(0, rows - 1), inside


def embedding_partial(weight: torch.Tensor, tokens: torch.Tensor,
                      start: Start) -> torch.Tensor:
    """This rank's part of the lookup: its row of ``weight`` (the table's
    rows ``start:start + len(weight)``) for each token in its slice,
    zeros for the rest. Summed over the ranks it is ``weight_whole[tokens]``
    exactly (one nonzero term)."""
    ids, inside = _local_ids(tokens, start, weight.shape[0])
    rows = weight[ids]
    return torch.where(inside[..., None], rows, rows.new_zeros(()))


class _VocabParallelNLL(torch.autograd.Function):
    """Token NLL from each rank's slice (..., V_local) of the fp32 logits.
    Backward: (softmax - one-hot) on the local slice times the NLL's
    gradient, from the logits less the global row max and the global log
    sum of exponentials kept from the forward."""

    @staticmethod
    def forward(ctx, logits, targets, start, axis):
        logits = logits.float()
        row_max = axis.all_reduce(logits.amax(-1), "max")
        z = logits - row_max[..., None]
        lse = torch.log(axis.all_reduce(torch.exp(z).sum(-1)))
        ids, inside = _local_ids(targets, start, logits.shape[-1])
        target = z.gather(-1, ids[..., None])[..., 0]
        target = axis.all_reduce(torch.where(inside, target, 0.0))
        ctx.save_for_backward(z, lse, ids, inside)
        return lse - target

    @staticmethod
    def backward(ctx, grad):
        z, lse, ids, inside = ctx.saved_tensors
        dlogits = torch.exp(z - lse[..., None])
        dlogits.scatter_add_(-1, ids[..., None],
                             -inside[..., None].to(dlogits.dtype))
        return dlogits * grad[..., None], None, None, None


def vocab_parallel_nll(logits: torch.Tensor, targets: torch.Tensor,
                       start: Start, axis: TensorAxis) -> torch.Tensor:
    """The next-token NLL of each position from this rank's slice of the
    vocabulary's logits (columns ``start:start + V_local``); the same on
    every rank of the axis."""
    return _VocabParallelNLL.apply(logits, targets, start, axis)


def vocab_parallel_lm_loss(logits: torch.Tensor, targets: torch.Tensor,
                           start: Start, axis: TensorAxis,
                           mask: Optional[torch.Tensor] = None,
                           count: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """``models.transformer.lm_loss`` (the masked mean, divided by
    ``count`` where given) from this rank's slice of the logits."""
    return masked_mean(vocab_parallel_nll(logits, targets, start, axis),
                       mask, count)


def bind_tensor(model, axis: TensorAxis, rank: int) -> None:
    """Put ``model`` (a ``Transformer`` whose parameters are this rank's
    pieces) on the tensor axis: every module that runs on it (``Attention``,
    ``MLP``, the model's embedding and lm_head) takes ``axis``, and the
    model its first vocabulary row."""
    for module in model.modules():
        if hasattr(type(module), "tensor"):
            module.tensor = axis
    model.vocab_start = rank * (model.cfg.vocab_size // axis.size)


__all__ = ["GroupAxis", "StackedRanks", "TensorAxis", "bind_tensor",
           "embedding_partial", "vocab_parallel_lm_loss",
           "vocab_parallel_nll"]
