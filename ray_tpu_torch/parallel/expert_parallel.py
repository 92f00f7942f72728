"""The MoE layer's collectives on a mesh: what ``MoEMLP.forward_ranks``
(``models/transformer.py``) runs between its local steps.

The JAX package has no such file. Its ``MoEMLP``
(``ray_tpu/models/transformer.py:213-306``) is written for the global token
array, and GSPMD inserts the collectives that the shardings of its
dispatch and combine einsums imply (``:273-295``). Here they are written
out:

- ``gather_tokens``: the routing choices of every rank that holds tokens
  (``data`` and ``fsdp`` split the rows, ``seq`` each row), put together
  in the global (B, S) order, so that each slot's position in its expert's
  capacity buffer is counted in global (token, k) order;
- ``sum_tokens``: the router's statistics (the top-1 counts and the sums
  of the probabilities) summed over those ranks, so that aux is E sum_e
  f_e p_e of global means. Its backward is again the sum over the ranks:
  each of the R token ranks adds aux / R to its share of the loss, so the
  returned loss counts aux once, and each rank's router gets the global
  aux's gradient through its own tokens;
- ``to_experts``: the tokens into this rank's experts: identity forward;
  backward, the gradient summed over the ``tensor`` and ``expert`` axes,
  since each rank's experts and mlp columns take part of the tokens' use;
- ``from_experts``: the experts' outputs back: each rank's partial product
  (over its mlp columns) summed over ``tensor`` (identity backward), and
  the rows of each rank's experts gathered over ``expert`` (backward: this
  rank's rows, since every expert rank computes the same gradient of the
  same tokens).

Each rank runs its experts on the slots of its own tokens only. The rows
of the other token ranks' slots stay zero, add nothing to the output and
nothing to a weight's gradient, so the expert stacks' gradients are summed
over the token ranks as every other leaf's is. Each rank still holds its
experts' rows of the whole (E, G*C, D) buffer, of which its tokens fill
1/R; an ``all_to_all_single`` layout that sends each slot to its expert's
rank alone is for later (``ROADMAP.md`` queue 2).

The ops take and return lists with one entry per rank that this process
runs: ``GroupAxes`` is one rank on the mesh's process groups;
``VirtualRanks`` is every rank of a small mesh in one process, so that the
layer can be held against its whole version with no process group (the
tests, and the card's smoke, where every backward runs on one thread).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ray_tpu_torch.collective.collective_group import TorchGroup
from ray_tpu_torch.parallel.tensor_parallel import GroupAxis, TensorAxis


def _fold(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum in the given order."""
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x
    return acc


class _SumOver(torch.autograd.Function):
    """All-reduce over ``groups``; backward, the gradient all-reduced over
    them too."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        for group in groups:
            x = group.allreduce(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        for group in ctx.groups:
            grad = group.allreduce(grad)
        return grad, None


class _GatherFromRegion(torch.autograd.Function):
    """All-gather along ``dim`` in rank order; backward, this rank's slice
    of the gradient (the ranks hold the same gradient of the whole)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.allgather(x.movedim(dim, 0).contiguous()).movedim(0, dim)

    @staticmethod
    def backward(ctx, grad):
        group = ctx.group
        return grad.chunk(group.world_size, ctx.dim)[group.rank] \
            .contiguous(), None, None


def gather_from_region(x: torch.Tensor, group: TorchGroup,
                       dim: int) -> torch.Tensor:
    """The whole tensor from every rank's ``x`` along ``dim``, where the
    ranks go on to compute the same thing from it (the expert axis): the
    gradient of ``x`` is this rank's slice of the whole's, not a sum."""
    return _GatherFromRegion.apply(x, group, dim)


class MoEAxes:
    """The MoE layer's collectives over the ranks a process runs (lists, one
    entry a rank). ``expert_rank(i)``: the place of the i-th rank on the
    expert axis."""

    def expert_rank(self, i: int) -> int:
        raise NotImplementedError

    def gather_tokens(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each rank's (B_l, S_l, ...) put together into the global (B, S,
        ...), on every rank."""
        raise NotImplementedError

    def local(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Rank i's (B_l, S_l, ...) of a global (B, S, ...)."""
        raise NotImplementedError

    def sum_tokens(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """Summed over the token ranks; the backward likewise."""
        raise NotImplementedError

    def to_experts(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """Identity; backward, summed over the tensor and expert axes."""
        raise NotImplementedError

    def from_experts(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each rank's (E_l * G * C, D) partial summed over tensor, and the
        expert ranks' rows gathered in rank order: (E * G * C, D)."""
        raise NotImplementedError


def _op(name: str):
    """A profiler range over one of the ops' forward (``expert_parallel.
    <name>``), so that a trace books their device time by op; their
    backward shows as the autograd nodes of ``_SumOver``,
    ``_GatherFromRegion`` and the tensor axis's copy."""
    return torch.profiler.record_function(f"expert_parallel.{name}")


class GroupAxes(MoEAxes):
    """One rank on the mesh's groups: ``rows``, the groups that split the
    rows, inner first (fsdp, then data: row r of the global batch is
    rank (r // B_l) in data-major order); ``seq`` the one that splits each
    row; ``tensor`` and ``expert`` the groups of those axes. A missing axis
    is None (or absent from ``rows``); one of size 1 runs its collectives
    on one rank."""

    def __init__(self, rows: Sequence[TorchGroup], seq: Optional[TorchGroup],
                 tensor: Optional[TensorAxis], expert: Optional[TorchGroup]):
        self.rows = list(rows)
        self.seq = seq
        self.tensor = tensor
        self.expert = expert
        self._copy = None if expert is None else GroupAxis(expert)

    def expert_rank(self, i):
        return 0 if self.expert is None else self.expert.rank

    def gather_tokens(self, xs):
        (x,) = xs
        with _op("gather_tokens"):
            if self.seq is not None:
                x = self.seq.allgather(x.transpose(0, 1).contiguous()) \
                    .transpose(0, 1)
            for group in self.rows:
                x = group.allgather(x.contiguous())
        return [x]

    def local(self, i, x):
        index, count = 0, 1
        for group in self.rows:
            index += group.rank * count
            count *= group.world_size
        rows = x.shape[0] // count
        x = x[index * rows:(index + 1) * rows]
        if self.seq is None:
            return x
        cols = x.shape[1] // self.seq.world_size
        return x[:, self.seq.rank * cols:(self.seq.rank + 1) * cols]

    def sum_tokens(self, xs):
        groups = ([] if self.seq is None else [self.seq]) + self.rows
        with _op("sum_tokens"):
            return [_SumOver.apply(xs[0], groups)]

    def to_experts(self, xs):
        (x,) = xs
        with _op("to_experts"):
            if self.tensor is not None:
                x = self.tensor.copy_to_region(x)
            if self._copy is not None:
                x = self._copy.copy_to_region(x)
        return [x]

    def from_experts(self, xs):
        (x,) = xs
        with _op("from_experts"):
            if self.tensor is not None:
                x = self.tensor.reduce_from_region(x)
            if self.expert is not None:
                x = gather_from_region(x, self.expert, 0)
        return [x]


class _CopyToRanks(torch.autograd.Function):
    """Identity for each input; backward, each input's gradient the sum of
    every output's."""

    @staticmethod
    def forward(ctx, *xs):
        return tuple(x.clone() for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        total = _fold(grads)
        return tuple(total for _ in grads)


class _FromExperts(torch.autograd.Function):
    """Inputs ordered (tensor rank, expert rank): each expert rank's rows
    summed over the tensor ranks, concatenated in expert order, one copy
    for every input; backward, each input's slice of its copy's
    gradient."""

    @staticmethod
    def forward(ctx, tensor, experts, *xs):
        ctx.experts = experts
        parts = [_fold([xs[t * experts + e] for t in range(tensor)])
                 for e in range(experts)]
        whole = torch.cat(parts, 0)
        return tuple(whole.clone() for _ in xs)

    @staticmethod
    def backward(ctx, *grads):
        n = ctx.experts
        return (None, None) + tuple(
            g.chunk(n, 0)[j % n].contiguous() for j, g in enumerate(grads))


class VirtualRanks(MoEAxes):
    """Every rank of a mesh of ``rows`` x ``seq`` x ``tensor`` x ``experts``
    in one process, rank i at coordinates (row, seq, tensor, expert) in
    row-major order, as the mesh lays them out: rank i's tokens are row
    block ``row`` and sequence chunk ``seq`` of the global batch."""

    def __init__(self, rows: int = 1, seq: int = 1, tensor: int = 1,
                 experts: int = 1):
        self.shape = (rows, seq, tensor, experts)
        self.size = rows * seq * tensor * experts

    def coords(self, i: int):
        _, seq, tensor, experts = self.shape
        return (i // (seq * tensor * experts), i // (tensor * experts) % seq,
                i // experts % tensor, i % experts)

    def _ranks(self, token=None, replica=None) -> List[int]:
        """The ranks at token coordinates ``token`` (row, seq) or at
        replica coordinates ``replica`` (tensor, expert), in rank order."""
        return [i for i in range(self.size)
                if token in (None, self.coords(i)[:2])
                and replica in (None, self.coords(i)[2:])]

    def _replicas(self):
        return sorted({self.coords(i)[2:] for i in range(self.size)})

    def _tokens(self):
        return sorted({self.coords(i)[:2] for i in range(self.size)})

    def expert_rank(self, i):
        return self.coords(i)[3]

    def gather_tokens(self, xs):
        rows, seq = self.shape[:2]
        out = [None] * self.size
        for rep in self._replicas():
            ranks = self._ranks(replica=rep)
            whole = torch.cat([torch.cat([xs[ranks[r * seq + s]]
                                          for s in range(seq)], 1)
                               for r in range(rows)], 0)
            for i in ranks:
                out[i] = whole
        return out

    def local(self, i, x):
        rows, seq = self.shape[:2]
        r, s = self.coords(i)[:2]
        b, n = x.shape[0] // rows, x.shape[1] // seq
        return x[r * b:(r + 1) * b, s * n:(s + 1) * n]

    def sum_tokens(self, xs):
        out = [None] * self.size
        for rep in self._replicas():
            ranks = self._ranks(replica=rep)
            total = _fold([xs[i] for i in ranks])
            for i in ranks:
                out[i] = total
        return out

    def to_experts(self, xs):
        out = [None] * self.size
        for tok in self._tokens():
            ranks = self._ranks(token=tok)
            for i, y in zip(ranks, _CopyToRanks.apply(*[xs[i]
                                                        for i in ranks])):
                out[i] = y
        return out

    def from_experts(self, xs):
        out = [None] * self.size
        _, _, tensor, experts = self.shape
        for tok in self._tokens():
            ranks = self._ranks(token=tok)
            for i, y in zip(ranks, _FromExperts.apply(
                    tensor, experts, *[xs[i] for i in ranks])):
                out[i] = y
        return out


    def rank_layers(self, layer) -> list:
        """Each rank's copy of the ``MoEMLP`` ``layer``: its experts' rows
        of the stacks, cut along their mlp dim by its tensor rank, and the
        router whole (every rank routes the same tokens alike), bound to
        these ranks."""
        import copy

        _, _, tensor, experts = self.shape
        out = []
        for i in range(self.size):
            _, _, t, e = self.coords(i)
            rank = copy.deepcopy(layer)
            for name, mlp_dim in (("gate_proj", 2), ("up_proj", 2),
                                  ("down_proj", 1)):
                w = getattr(layer, name).detach()
                piece = w.chunk(experts, 0)[e].chunk(tensor, mlp_dim)[t]
                setattr(rank, name, torch.nn.Parameter(piece.clone(
                    memory_format=torch.contiguous_format)))
            rank.ep = self
            out.append(rank)
        return out


    def layer_grads(self, layer, x: torch.Tensor, dout: torch.Tensor,
                    aux_coef: float = 1.0) -> dict:
        """The whole ``MoEMLP`` ``layer``'s pieces (``rank_layers``) on these
        ranks, on the global tokens ``x`` (B, S, D): each rank's loss share
        its output's product with its part of ``dout`` plus ``aux_coef`` x
        aux / R (R token ranks), one backward over every rank's share.
        Returns each rank's ``out``, ``aux`` and input gradient ``dx``; each
        weight's gradient summed over the token ranks, ``dw`` keyed
        (tensor rank, expert rank, name); and the ranks' top-K choices in
        global order, ``experts`` (B, S, K)."""
        from ray_tpu_torch.models.transformer import MoEMLP

        layers = self.rank_layers(layer)
        chosen = {}
        for i, rank in enumerate(layers):
            def choose(xf, expert=None, i=i, rank=rank):
                out = MoEMLP.choose(rank, xf, expert)
                chosen[i] = out[1]
                return out
            rank.choose = choose
        xs = [self.local(i, x.detach()).clone().requires_grad_()
              for i in range(self.size)]
        res = MoEMLP.forward_ranks(layers, xs, self)
        tokens = self.shape[0] * self.shape[1]
        shares = [(out * self.local(i, dout)).sum() + aux_coef * aux / tokens
                  for i, (out, aux) in enumerate(res)]
        weights = [p for rank in layers for p in rank.parameters()]
        grads = torch.autograd.grad(_fold(shares), xs + weights)
        summed = {}
        it = iter(grads[len(xs):])
        for i, rank in enumerate(layers):
            for name, _ in rank.named_parameters():
                key = self.coords(i)[2:] + (name,)
                summed[key] = summed.get(key, 0) + next(it)
        experts = self.gather_tokens([chosen[i] for i in range(self.size)])
        return {"out": [o.detach() for o, _ in res],
                "aux": [a.detach() for _, a in res],
                "dx": list(grads[:len(xs)]), "dw": summed,
                "experts": experts[0]}


def bind_experts(model, axes: Optional[MoEAxes]) -> None:
    """Put every ``MoEMLP`` of ``model`` on ``axes`` (None: the layer on
    its own tokens alone, as on one device)."""
    for module in model.modules():
        if hasattr(type(module), "ep"):
            module.ep = axes


__all__ = ["GroupAxes", "MoEAxes", "VirtualRanks", "bind_experts",
           "gather_from_region"]
