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
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
from torch import nn

from ray_tpu_torch.collective.collective_group import TorchGroup


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
    ``group`` along the dim that ``dims`` (name -> dim) gives; a parameter
    without a dim there is not split and is returned as it is."""

    def __init__(self, dims: Mapping[str, int], group: TorchGroup,
                 grad_dtype: Optional[torch.dtype] = None):
        self.dims, self.group, self.grad_dtype = dict(dims), group, grad_dtype

    def __call__(self, name: str, piece: torch.Tensor) -> torch.Tensor:
        if name not in self.dims:
            return piece
        return gather_param(piece, self.dims[name], self.group,
                            self.grad_dtype)


def bind_fsdp(model: nn.Module, dims: Mapping[str, int], group: TorchGroup,
              grad_dtype: Optional[torch.dtype] = None) -> None:
    """Set ``gather`` on every module of ``model`` that holds parameters:
    ``dims`` maps a parameter's path in ``model`` to the dim that the fsdp
    axis splits."""
    for prefix, module in model.named_modules():
        own = [name for name, _ in module.named_parameters(recurse=False)]
        if not own:
            continue
        base = f"{prefix}." if prefix else ""
        module.gather = FsdpGather(
            {name: dims[base + name] for name in own if base + name in dims},
            group, grad_dtype)


__all__ = ["FsdpGather", "bind_fsdp", "gather_param"]
