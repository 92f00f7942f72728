"""ZeRO-3 over the mesh's ``fsdp`` axis: the port of what the JAX package's
logical rules do to each parameter's ``embed`` dim (``embed`` on ``fsdp``,
``ray_tpu/parallel/mesh.py:29``), written out as collectives.

Each rank keeps one piece of every leaf, cut along the dim that ``fsdp``
splits, and its optimizer moments on that piece alone. Where a module uses
a weight it gathers it whole (``gather_param``): the forward all-gathers
the pieces along the leaf's ``fsdp`` dim, and the backward reduce-scatters
the whole weight's gradient back onto the pieces, summed over the ranks
(each saw its own rows of the batch). The gathers run inside each block's
``torch.utils.checkpoint`` region, so a block's whole weights are not kept
from the forward to the backward: the recompute gathers them again, as
the JAX model's remat materialises them again.

The MoE router's kernel is split over ``expert`` too (its columns,
``("embed", "expert")``), and every expert rank routes the same tokens with
the whole of it: its gather also runs over the expert axis, whose backward
keeps this rank's columns of the gradient (the expert ranks compute the
same one), where the fsdp gather's sums over ranks that saw other tokens.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
from torch import nn

from ray_tpu_torch.collective.collective_group import TorchGroup
from ray_tpu_torch.parallel.expert_parallel import gather_from_region


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, piece, dim, group, grad_dtype):
        ctx.dim, ctx.group, ctx.grad_dtype = dim, group, grad_dtype
        return group.allgather(piece.movedim(dim, 0).contiguous()) \
            .movedim(0, dim)

    @staticmethod
    def backward(ctx, grad):
        wire = grad if ctx.grad_dtype is None else grad.to(ctx.grad_dtype)
        part = ctx.group.reducescatter(wire.movedim(ctx.dim, 0)) \
            .movedim(0, ctx.dim)
        return part.to(grad.dtype).contiguous(), None, None, None


def gather_param(piece: torch.Tensor, dim: int, group: TorchGroup,
                 grad_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The whole weight from every rank's ``piece`` along ``dim``, in rank
    order; its gradient reduce-scattered back onto the pieces (over the
    wire in ``grad_dtype`` where given, e.g. bf16)."""
    return _GatherParam.apply(piece, dim, group, grad_dtype)


class FsdpGather:
    """A module's ``gather``: its parameter ``name`` whole, gathered over
    ``group`` along the dim that ``dims`` (name -> dim) gives, then over
    ``expert`` (a ``TorchGroup``) along the dim that ``expert_dims`` gives;
    a parameter in neither is not split and is returned as it is."""

    def __init__(self, dims: Mapping[str, int], group: Optional[TorchGroup],
                 grad_dtype: Optional[torch.dtype] = None,
                 expert_dims: Optional[Mapping[str, int]] = None,
                 expert: Optional[TorchGroup] = None):
        self.dims, self.group, self.grad_dtype = dict(dims), group, grad_dtype
        self.expert_dims, self.expert = dict(expert_dims or {}), expert

    def __call__(self, name: str, piece: torch.Tensor) -> torch.Tensor:
        x = piece
        if name in self.dims:
            x = gather_param(x, self.dims[name], self.group, self.grad_dtype)
        if name in self.expert_dims:
            x = gather_from_region(x, self.expert, self.expert_dims[name])
        return x


def bind_fsdp(model: nn.Module, dims: Mapping[str, int],
              group: Optional[TorchGroup],
              grad_dtype: Optional[torch.dtype] = None,
              expert_dims: Optional[Mapping[str, int]] = None,
              expert: Optional[TorchGroup] = None) -> None:
    """Set ``gather`` on every module of ``model`` that holds parameters:
    ``dims`` maps a parameter's path in ``model`` to the dim that the fsdp
    axis splits, ``expert_dims`` to the dim that the expert axis splits
    where the module uses it whole (the router)."""
    expert_dims = expert_dims or {}
    for prefix, module in model.named_modules():
        own = [name for name, _ in module.named_parameters(recurse=False)]
        if not own:
            continue
        base = f"{prefix}." if prefix else ""
        module.gather = FsdpGather(
            {name: dims[base + name] for name in own if base + name in dims},
            group, grad_dtype,
            {name: expert_dims[base + name] for name in own
             if base + name in expert_dims}, expert)


__all__ = ["FsdpGather", "bind_fsdp", "gather_param"]
