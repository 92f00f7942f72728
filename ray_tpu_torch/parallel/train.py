"""The training step of the flagship LM in PyTorch, on one device or on a
mesh of data x fsdp x seq x tensor x expert.

Counterpart of ``ray_tpu/parallel/train.py``:

- ``make_optimizer`` is the JAX package's optax chain,
  ``clip_by_global_norm(clip)`` then ``adamw`` over
  ``warmup_cosine_decay_schedule``, written out on tensors with
  ``torch._foreach_*`` ops over all leaves at once. With ``clip_spec_fn``
  the clip is ``sharded_clip_by_global_norm``: the global norm in a pinned
  association (partial sums over the data shards, summed in rank order,
  folded in tree order), the same in the sharded and the unsharded step.
- ``TrainStepBundle`` draws the parameters, takes a step (forward, one
  backward, the optimizer) and evaluates, for a dense or a MoE config (the
  step's loss adds ``moe_aux_coef`` times the MoE layers' aux; the
  evaluation leaves it out, as the JAX bundle does). Parameters and the
  optimizer's moments are flat dicts keyed by flax paths
  (``layer_0.attn.q_proj.kernel``), so a JAX run's state converts by
  copying (``models/convert.py``).
- On a mesh (``parallel/mesh.py``) every rank passes the same global
  batch, laid out as the JAX bundle's ``P(("data", "fsdp"), "seq")``:
  ``data`` and ``fsdp`` split its rows, ``seq`` cuts each row into
  contiguous chunks, and the loss is the global masked mean, each rank
  backpropagating its share. ``fsdp``, ``tensor`` and ``expert`` split the
  parameters as the JAX bundle's shardings do: each rank holds a piece of
  every leaf and the optimizer's moments on it (ZeRO-3,
  ``parallel/fsdp.py``), runs on its heads, MLP columns and vocabulary rows
  (Megatron, ``parallel/tensor_parallel.py``), attends over its seq group's
  ring (``ops/ring_attention.py``) and runs its experts
  (``parallel/expert_parallel.py``). Gradients are reduce-scattered over
  ``fsdp``, all-reduced over ``seq``, then all-reduced over ``data``, or
  with ``shard_update=True`` reduce-scattered, each rank updating a part of
  its pieces (the moments live on that part only) before the parts are
  all-gathered. ``grad_dtype="bf16"`` rounds the gradients to bf16 before
  the reductions over ``fsdp``, ``seq`` and ``data``, which then carry bf16.

Not ported yet (``ROADMAP.md`` queue 1): the bucketed reduce of
``collective/bucketed.py``; the traced step with its ``compression`` wire;
and the goodput and tracing hooks of ``step``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch.collective.collective_group import TorchGroup
from ray_tpu_torch.collective.quant import resolve_codec
from ray_tpu_torch.models.convert import check_params, iter_init_params
from ray_tpu_torch.models.transformer import (Transformer, TransformerConfig,
                                              lm_loss, state_dict_shapes)
from ray_tpu_torch.parallel.expert_parallel import GroupAxes, bind_experts
from ray_tpu_torch.parallel.fsdp import bind_fsdp
from ray_tpu_torch.parallel.mesh import (AXES, LeafDims, cut_leaf,
                                         gather_leaf, mesh_axis_sizes,
                                         mesh_placements, param_layout,
                                         param_logical_axes, piece_shape)
from ray_tpu_torch.parallel.tensor_parallel import (GroupAxis, bind_tensor,
                                                    vocab_parallel_lm_loss)
from ray_tpu_torch.utils import DeviceLike, resolve_device

Params = Dict[str, torch.Tensor]
# a leaf's split over the data axis: (the dim, the number of equal parts)
Layout = Optional[Tuple[int, int]]


@dataclasses.dataclass
class OptState:
    """AdamW's state: the number of steps taken, and the first and second
    moments keyed by flax path. The count stays on the host, so the schedule
    and the bias corrections cost no device sync."""

    count: int
    mu: Params
    nu: Params

    def to(self, device: torch.device) -> "OptState":
        """Move the moments to ``device`` in place; returns ``self``."""
        for moments in (self.mu, self.nu):
            for key, x in moments.items():
                moments[key] = x.to(device)
        return self


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax's ``chain(clip_by_global_norm(clip), adamw(schedule, b1, b2,
    eps=1e-8, eps_root=0, weight_decay))`` with ``schedule =
    warmup_cosine_decay_schedule(0, learning_rate, warmup_steps,
    max(total_steps, warmup_steps + 1))``, as the JAX package's
    ``make_optimizer`` builds it; ``make_optimizer`` here builds this with
    the same defaults."""

    learning_rate: float
    weight_decay: float
    warmup_steps: int
    total_steps: int
    b1: float
    b2: float
    clip: float
    eps: float = 1e-8  # optax.adamw's default, which make_optimizer keeps
    # the sharded clip's layout (shape -> Layout), or None for optax's clip
    clip_spec_fn: Optional[Callable[[Tuple[int, ...]], Layout]] = None

    def schedule(self, count: int) -> float:
        """The learning rate at step ``count`` (0 at step 0): linear from 0 to
        the peak over the warmup, then a cosine down to 0 at
        ``max(total_steps, warmup_steps + 1)``."""
        warmup = self.warmup_steps
        decay = max(self.total_steps, warmup + 1) - warmup
        if count < warmup:
            return self.learning_rate * count / warmup
        t = min(count - warmup, decay)
        return self.learning_rate * 0.5 * (1.0 + math.cos(math.pi * t / decay))

    def init(self, params: Mapping[str, torch.Tensor]) -> OptState:
        return OptState(0, {k: torch.zeros_like(p) for k, p in params.items()},
                        {k: torch.zeros_like(p) for k, p in params.items()})

    @torch.no_grad()
    def update(self, params: Mapping[str, torch.Tensor],
               grads: Sequence[torch.Tensor], state: OptState,
               norm: Optional[torch.Tensor] = None) -> None:
        """One step on ``params`` in place; ``grads`` (in ``params``' order)
        are consumed as scratch. The schedule is read at the count before
        this step, the bias corrections at the count after it. ``norm``:
        the gradients' global norm where the caller took it (a mesh's rank
        holds only pieces of them), the clip then scaling by clip /
        max(norm, clip) as the sharded clip does; without it the clip takes
        the norm from ``grads``."""
        keys = list(params)
        p = [params[k] for k in keys]
        m = [state.mu[k] for k in keys]
        v = [state.nu[k] for k in keys]
        g = list(grads)
        if norm is not None:
            torch._foreach_mul_(g, self.clip / torch.clamp(norm,
                                                           min=self.clip))
        elif self.clip_spec_fn is not None:
            sharded_clip_by_global_norm(self.clip, self.clip_spec_fn, g)
        else:
            # clip_by_global_norm: scale by clip / |g| only when |g| >= clip
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(g)))
            torch._foreach_mul_(g, torch.where(norm < self.clip, 1.0,
                                               self.clip / norm))
        # scale_by_adam's moments
        torch._foreach_mul_(m, self.b1)
        torch._foreach_add_(m, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(v, self.b2)
        torch._foreach_addcmul_(v, g, g, value=1.0 - self.b2)
        lr = self.schedule(state.count)
        state.count += 1
        bc1 = 1.0 - self.b1 ** state.count
        bc2 = 1.0 - self.b2 ** state.count
        # p -= lr * (mu_hat / (sqrt(nu_hat) + eps) + weight_decay * p), with
        # the decay on every leaf; the grads' memory holds the denominator
        torch._foreach_copy_(g, v)
        torch._foreach_div_(g, bc2)
        torch._foreach_sqrt_(g)
        torch._foreach_add_(g, self.eps)
        torch._foreach_mul_(p, 1.0 - lr * self.weight_decay)
        torch._foreach_addcdiv_(p, m, g, value=-lr / bc1)


def make_optimizer(learning_rate: float = 3e-4, weight_decay: float = 0.1,
                   warmup_steps: int = 100, total_steps: int = 10000,
                   b1: float = 0.9, b2: float = 0.95, clip: float = 1.0,
                   clip_spec_fn: Optional[Callable] = None) -> AdamW:
    """AdamW with a global-norm clip, as the JAX package's
    ``make_optimizer`` (the same defaults). ``clip_spec_fn`` switches the
    clip to ``sharded_clip_by_global_norm``'s pinned association, as there;
    ``TrainStepBundle`` passes its layout function to an
    ``optimizer_factory`` when ``shard_update`` is on."""
    return AdamW(learning_rate, weight_decay, warmup_steps, total_steps, b1,
                 b2, clip, clip_spec_fn=clip_spec_fn)


def _sq_norm(x: torch.Tensor) -> torch.Tensor:
    """Sum of squares in fp32, of a contiguous copy: the same values in the
    same layout give the same bits wherever they come from."""
    return torch.sum(torch.square(x.float().contiguous()))


def _fold(values: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum in the given order, one addition at a time."""
    acc = values[0]
    for x in values[1:]:
        acc = acc + x
    return acc


def _part_sums(g: torch.Tensor, layout: Layout) -> List[torch.Tensor]:
    """The sums of squares of ``g``'s parts along ``layout`` (its own, whole,
    where None)."""
    if layout is None:
        return [_sq_norm(g)]
    return [_sq_norm(x) for x in g.chunk(layout[1], layout[0])]


def sharded_clip_by_global_norm(max_norm: float,
                                spec_fn: Callable[[Tuple[int, ...]], Layout],
                                grads: Sequence[torch.Tensor]
                                ) -> torch.Tensor:
    """The clip of the JAX function of that name: scale ``grads`` in place by
    max_norm / max(norm, max_norm) and return the norm, taken in a pinned
    association. A leaf that ``spec_fn(shape)`` splits, ``(dim, n)``,
    contributes the sums of squares of its n parts along ``dim`` (fp32, of
    contiguous copies), summed in part order; any other leaf its own sum of
    squares; the leaves' sums fold in tree order. On a mesh the train step
    takes the same sums from the ranks that hold the parts
    (``TrainStepBundle``), so the sharded and the unsharded step agree bit
    for bit in fp32."""
    sums = [_part_sums(g, spec_fn(tuple(g.shape))) for g in grads]
    norm = torch.sqrt(_fold([_fold(leaf) for leaf in sums]))
    torch._foreach_mul_(grads, max_norm / torch.clamp(norm, min=max_norm))
    return norm


class TrainStepBundle:
    """The model, its optimizer and the step, on one device or on a mesh of
    ``data`` x ``fsdp`` x ``seq`` x ``tensor`` x ``expert``, for a dense or
    a MoE config.

    ``init(seed)`` gives ``(params, opt_state)``; ``step(params, opt_state,
    batch)`` gives ``(params, opt_state, loss)``, updating both in place (the
    JAX step donates them) and returning the loss as a 0-d tensor without a
    host sync. ``params`` is the model's own parameter dict (on a mesh, this
    rank's pieces); a dict of the config's whole leaves (``from_jax_params``,
    ``init_params``, ``gather_params``) is cut and copied into the model
    first and left as it was. ``optimizer_factory`` is called with the
    clip's layout function when ``shard_update`` is on and with ``None``
    otherwise (the JAX package's signature).

    ``mesh`` (``parallel.create_mesh``): None is the single-device step. On
    a mesh every rank passes the same global batch, and the step runs on
    each axis the mesh has, even at size 1 (its collectives then run on one
    rank):

    - ``data`` and ``fsdp`` split the batch's rows jointly (their size must
      divide it), ``seq`` each row's tokens into contiguous chunks (its
      size must divide the length); tokens are the same on the ``tensor``
      and ``expert`` ranks; the loss is the global masked mean;
    - ``fsdp``, ``tensor`` and ``expert`` split the parameters as the JAX
      bundle's ``param_shardings`` do (``mesh.param_layout``): each rank
      holds its piece of every leaf and the optimizer's moments on that
      piece alone (ZeRO-3); modules gather their weights over ``fsdp``
      where they use them (``parallel/fsdp.py``; the router over
      ``expert`` too) and run on this rank's heads, MLP columns and
      vocabulary rows (``parallel/tensor_parallel.py``) and on its experts
      (``parallel/expert_parallel.py``); attention is the ring over the
      seq group, with RoPE at each token's global position;
    - a MoE layer routes the global token array: its groups, capacity and
      slot positions are the single device's, and aux comes from global
      statistics; each token rank adds aux / R (R = data x fsdp x seq) to
      its share, so the loss and every gradient count it once;
    - gradients leave the backward reduce-scattered over ``fsdp`` and are
      all-reduced over ``seq`` (every leaf is replicated there) and over
      ``data``, or with ``shard_update=True`` (``data`` > 1)
      reduce-scattered over it: each rank then updates a part of its
      piece, along the piece's first dim that divides by the data axis's
      size (JAX's ``_update_sharding``), and the optimizer state is on that
      layout (``init_sharded``, ``shard_opt_state``). The tensor and expert
      ranks compute the same gradient of a leaf they do not split, and
      each its own piece's of one they split;
    - ``grad_dtype="bf16"`` rounds the gradients through bf16 before they
      cross ``fsdp``, ``seq`` and ``data``, whose reductions carry bf16;
      moments and parameters stay fp32.

    What does not divide raises ``ValueError``: rows by data x fsdp, the
    length by seq, a split dim by its axis (``param_layout``: heads and KV
    heads by tensor, experts by expert). ``compression`` has no step here
    yet and raises."""

    def __init__(self, cfg: TransformerConfig, device: DeviceLike = None,
                 optimizer: Optional[AdamW] = None,
                 optimizer_factory: Optional[Callable] = None,
                 mesh=None, shard_update: bool = False,
                 grad_dtype: str = "fp32", compression: Optional[str] = None):
        if grad_dtype not in ("fp32", "bf16"):
            raise ValueError(f"grad_dtype must be fp32 or bf16, got "
                             f"{grad_dtype!r}")
        if resolve_codec(compression) is not None:
            raise ValueError(
                f"compression={compression!r}: the quantized wire runs on "
                "the JAX package's traced bucketed step, which is not ported "
                "yet (ROADMAP.md queue 1)")
        self.cfg = cfg
        self.mesh = mesh
        self.grad_dtype = grad_dtype
        self.sizes: Dict[str, int] = {}
        self.coords: Dict[str, int] = {}
        self.groups: Dict[str, TorchGroup] = {}
        self.tensor: Optional[GroupAxis] = None
        if mesh is None:
            self.device = resolve_device(device)
        else:
            self.device = resolve_device(mesh.device_type if device is None
                                         else device)
            if self.device.type != mesh.device_type:
                raise ValueError(f"a {mesh.device_type} mesh runs on "
                                 f"{mesh.device_type}, not {self.device}")
            self.sizes = mesh_axis_sizes(mesh)
            self.coords = dict(zip(mesh.mesh_dim_names,
                                   mesh.get_coordinate()))
            self.groups = {axis: TorchGroup.from_process_group(
                axis, mesh.get_group(axis), self.device)
                for axis in AXES if axis in self.sizes}
            if "tensor" in self.groups:
                self.tensor = GroupAxis(self.groups["tensor"])
        self.dp_size = self.sizes.get("data", 1)
        # the ranks that hold distinct tokens
        self.token_ranks = math.prod(self.sizes.get(a, 1)
                                     for a in ("data", "fsdp", "seq"))
        self.shard_update = bool(shard_update) and self.dp_size > 1
        spec_fn = self._layout if self.shard_update else None
        if optimizer is None:
            optimizer = (optimizer_factory(spec_fn) if optimizer_factory
                         is not None else make_optimizer(clip_spec_fn=spec_fn))
        if self.shard_update and optimizer.clip_spec_fn is None:
            # each rank holds its parts of the split leaves' gradients, so
            # the global norm can only be taken part by part
            optimizer = dataclasses.replace(optimizer, clip_spec_fn=spec_fn)
        self.optimizer = optimizer
        self._shapes = state_dict_shapes(cfg)
        if mesh is None:
            self._dims: Dict[str, LeafDims] = {k: {} for k in self._shapes}
            self.model = Transformer(cfg, device=self.device)
        else:
            self._dims = param_layout(cfg, self.sizes)
            self.model = Transformer(cfg, device=self.device, pieces={
                k: piece_shape(shape, self._dims[k], self.sizes)
                for k, shape in self._shapes.items()})
            self._bind_mesh()
        self._params: Params = dict(self.model.named_parameters())
        self._layouts: Dict[str, Layout] = {
            k: self._layout(tuple(p.shape)) if self.shard_update else None
            for k, p in self._params.items()}

    @property
    def param_placements(self) -> Dict[str, tuple]:
        """Flax path -> DTensor placements (one a mesh axis) of each leaf
        (``mesh_placements`` of its logical axes: the JAX bundle's
        ``param_shardings``). Empty without a mesh."""
        if self.mesh is None:
            return {}
        return {k: mesh_placements(self.mesh, names)
                for k, names in param_logical_axes(self.cfg).items()}

    def _bind_mesh(self) -> None:
        """The model's collectives: the fsdp gathers (and the router's over
        expert), the tensor axis, the seq group's ring and the MoE layers'
        axes (``_moe_axes``)."""
        groups = self.groups
        if "fsdp" in groups or "expert" in groups:
            bind_fsdp(self.model, {k: d["fsdp"] for k, d in self._dims.items()
                                   if "fsdp" in d},
                      groups.get("fsdp"), self._wire_dtype(),
                      {k: d["expert"] for k, d in self._dims.items()
                       if "expert" in d and k.endswith(".router.kernel")},
                      groups.get("expert"))
        if self.tensor is not None:
            bind_tensor(self.model, self.tensor, self.coords["tensor"])
        for module in self.model.modules():
            if hasattr(type(module), "seq"):
                module.seq = groups.get("seq")
        self._moe_axes = {split: GroupAxes(
            [groups[a] for a in ("fsdp", "data") if split and a in groups],
            groups.get("seq"), self.tensor, groups.get("expert"))
            for split in (True, False)}
        bind_experts(self.model, self._moe_axes[True])

    def _wire_dtype(self) -> Optional[torch.dtype]:
        return torch.bfloat16 if self.grad_dtype == "bf16" else None

    def _layout(self, shape: Tuple[int, ...]) -> Layout:
        """How the sharded update splits this rank's piece of a leaf:
        ``(dim, parts)`` for the piece's first dim that divides by the data
        axis's size, or None (updated whole on every rank of the axis).
        JAX's ``_update_sharding``, which puts ``data`` on the first dim
        whose size divides by its existing shard count times the data
        axis's size: the same dim."""
        for d, size in enumerate(shape):
            if size % self.dp_size == 0:
                return d, self.dp_size
        return None

    def init(self, seed: int = 0):
        """Parameters drawn from ``seed`` (``convert.init_params``: every
        layout starts from the single-device values; a mesh's rank keeps its
        pieces) and a fresh optimizer state on the pieces (see
        ``init_sharded``)."""
        with torch.no_grad():
            for key, whole in iter_init_params(self.cfg, seed, self.device):
                self._params[key].copy_(self._piece(key, whole))
        return self._params, self.optimizer.init(self._params)

    def init_sharded(self, seed: int = 0):
        """``init`` with the optimizer state on the sharded update's
        layout."""
        params, opt_state = self.init(seed)
        return params, self.shard_opt_state(opt_state)

    # -- pieces and parts -----------------------------------------------------

    def _piece(self, key: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's piece of the whole leaf ``key``."""
        dims = self._dims[key]
        return cut_leaf(whole, dims, self.sizes, self.coords) if dims \
            else whole

    def _to_piece(self, key: str, x: torch.Tensor) -> torch.Tensor:
        """``x`` as this rank's piece of leaf ``key``: cut if it is whole."""
        piece = self._params[key].shape
        if x.shape == piece:
            return x
        if tuple(x.shape) != self._shapes[key]:
            raise ValueError(f"{key}: {tuple(x.shape)} is neither the whole "
                             f"leaf {self._shapes[key]} nor this rank's "
                             f"piece {tuple(piece)}")
        return self._piece(key, x)

    def gather_params(self, params: Optional[Mapping[str, torch.Tensor]]
                      = None) -> Params:
        """Whole leaves (new tensors) from every rank's pieces of ``params``
        (the model's own by default); every rank of the mesh calls it and
        gets the same leaves."""
        params = self._params if params is None else self._bind(params)
        return self.gather_leaves(params)

    def gather_leaves(self, pieces: Mapping[str, torch.Tensor]) -> Params:
        """Whole leaves from every rank's ``pieces`` (of the parameters'
        layout: a gradient, a moment)."""
        with torch.no_grad():
            return {k: gather_leaf(p.detach(), self._dims[k], self.groups)
                    for k, p in pieces.items()}

    def _part(self, x: torch.Tensor, layout: Layout) -> torch.Tensor:
        """This rank's part of a piece along the data axis."""
        d, n = layout
        return x.chunk(n, d)[self.coords["data"]].clone(
            memory_format=torch.contiguous_format)

    def _gather(self, part: torch.Tensor, layout: Layout) -> torch.Tensor:
        """The piece from every data rank's part, in rank order."""
        d, _ = layout
        return self.groups["data"].allgather(part.movedim(d, 0)).movedim(0, d)

    def _reduce_scatter(self, g: torch.Tensor, layout: Layout
                        ) -> torch.Tensor:
        """This rank's part of the sum over the data axis of ``g``."""
        d, _ = layout
        return self.groups["data"].reducescatter(g.movedim(d, 0)) \
            .movedim(0, d).contiguous()

    def shard_opt_state(self, opt_state: OptState) -> OptState:
        """The moments of an optimizer state on whole leaves or on this
        rank's pieces (an unsharded run's, or a JAX run's through
        ``from_jax_opt_state``) cut to this rank's parts."""
        lay = self._layouts
        out = []
        for moments in (opt_state.mu, opt_state.nu):
            pieces = {k: self._to_piece(k, x) for k, x in moments.items()}
            out.append({k: x if lay[k] is None else self._part(x, lay[k])
                        for k, x in pieces.items()})
        return OptState(opt_state.count, *out)

    def unshard_opt_state(self, opt_state: OptState) -> OptState:
        """The optimizer state on this rank's pieces from every data rank's
        parts."""
        lay = self._layouts
        return OptState(opt_state.count, *(
            {k: x if lay[k] is None else self._gather(x, lay[k])
             for k, x in moments.items()}
            for moments in (opt_state.mu, opt_state.nu)))

    def opt_state_bytes_per_replica(self, opt_state: OptState) -> int:
        """Device bytes of the moments this rank holds (its pieces, or their
        parts). The step count stays on the host."""
        return sum(x.numel() * x.element_size()
                   for moments in (opt_state.mu, opt_state.nu)
                   for x in moments.values())

    def opt_state_bytes_total(self) -> int:
        """Bytes of one whole optimizer state's moments (from the shapes)."""
        return 2 * sum(math.prod(self._shapes[k]) * p.element_size()
                       for k, p in self._params.items())

    def _bind(self, params: Mapping[str, torch.Tensor]) -> Params:
        own = self._params
        if any(params.get(k) is not p for k, p in own.items()):
            check_params(params, self.cfg)
            with torch.no_grad():
                for key, p in own.items():
                    p.copy_(self._piece(key, params[key]))
        return own

    # -- the step -------------------------------------------------------------

    def _lm_loss(self, logits, batch, count=None) -> torch.Tensor:
        if self.tensor is None:
            return lm_loss(logits, batch["targets"], batch.get("mask"), count)
        return vocab_parallel_lm_loss(logits, batch["targets"],
                                      self.model.vocab_start, self.tensor,
                                      batch.get("mask"), count)

    def _loss(self, batch, count: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
        """``lm_loss`` (divided by ``count`` where given) plus
        ``moe_aux_coef`` times the sum of the MoE layers' load-balancing
        losses (none for a dense config), as the JAX bundle's
        ``loss_fn``; on a mesh, this rank's share: aux / token_ranks."""
        logits, aux = self.model(batch["tokens"], return_aux=True)
        loss = self._lm_loss(logits, batch, count)
        if aux:
            loss = loss + self.cfg.moe_aux_coef * sum(aux.values()) \
                / self.token_ranks
        return loss

    def _batch_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ranks that split the batch (seq, fsdp,
        then data)."""
        for axis in ("seq", "fsdp", "data"):
            if axis in self.groups:
                x = self.groups[axis].allreduce(x)
        return x

    def _local(self, batch: Mapping[str, torch.Tensor], split_rows: bool
               ) -> Dict[str, torch.Tensor]:
        """This rank's part of a global batch: its rows (over data x fsdp,
        where ``split_rows``) and its chunk of each row (over seq); the MoE
        layers' token axes set to match."""
        rows, length = batch["tokens"].shape
        fsdp, seq = self.sizes.get("fsdp", 1), self.sizes.get("seq", 1)
        ranks = self.dp_size * fsdp if split_rows else 1
        if rows % ranks:
            raise ValueError(f"a batch of {rows} rows does not split over "
                             f"the data and fsdp axes' {ranks} ranks")
        if length % seq:
            raise ValueError(f"rows of {length} tokens do not split over "
                             f"the seq axis's {seq} ranks")
        n, m = rows // ranks, length // seq
        i = (self.coords.get("data", 0) * fsdp + self.coords.get("fsdp", 0)
             if split_rows else 0)
        j = self.coords.get("seq", 0)
        bind_experts(self.model, self._moe_axes[split_rows])
        return {k: x[i * n:(i + 1) * n, j * m:(j + 1) * m]
                for k, x in batch.items()}

    def _count(self, local: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """The number of this rank's tokens that count (its mask's sum)."""
        mask = local.get("mask")
        return (mask.float().sum() if mask is not None else torch.tensor(
            float(local["targets"].numel()), device=self.device))

    def _global_norm(self, keys: Sequence[str],
                     grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The global norm of the gradients that the ranks hold (pieces, or
        their parts on the data axis), each distinct piece or part counted
        once, in a pinned association: every rank's sums of squares are
        gathered over tensor, expert, fsdp, then data, a leaf's summed in
        rank order over the axes that split it (taken from the axis's first
        rank over the others, which hold the same values); the leaves' sums
        fold in tree order. With a pinned clip (``clip_spec_fn``) and no
        sharded update, each piece counts as the parts the sharded update
        would cut it into, so that both steps sum the same values in the
        same order."""
        spec_fn = None if self.shard_update else self.optimizer.clip_spec_fn
        owners, sums = [], []
        for k, g in zip(keys, grads):
            parts = _part_sums(g, None if spec_fn is None
                               else spec_fn(tuple(g.shape)))
            owners += [k] * len(parts)
            sums += parts
        vec = torch.stack(sums)
        for axis in ("tensor", "expert", "fsdp", "data"):
            if axis not in self.groups or (axis == "data"
                                           and not self.shard_update):
                continue
            split = [(self._layouts[k] is not None) if axis == "data"
                     else axis in self._dims[k] for k in owners]
            group = self.groups[axis]
            rows = group.allgather(vec).reshape(group.world_size, -1)
            vec = torch.stack([_fold(list(rows[:, j])) if s else rows[0, j]
                               for j, s in enumerate(split)])
        by_leaf: Dict[str, List[torch.Tensor]] = {}
        for k, x in zip(owners, vec):
            by_leaf.setdefault(k, []).append(x)
        return torch.sqrt(_fold([_fold(xs) for xs in by_leaf.values()]))

    def step(self, params: Mapping[str, torch.Tensor], opt_state: OptState,
             batch: Mapping[str, torch.Tensor]):
        """One optimization step: the loss with the MoE aux, one backward,
        the optimizer; on a mesh, with its axes' collectives."""
        params = self._bind(params)
        opt_state.to(self.device)
        if self.mesh is None:
            loss = self._loss(batch)
            grads = torch.autograd.grad(loss, list(params.values()))
            self.optimizer.update(params, grads, opt_state)
            return params, opt_state, loss.detach()
        loss, grads = self._mesh_backward(params, batch)
        keys = list(params)
        lay = self._layouts
        parts = params
        if "data" not in self.groups:
            grads = [g.float() for g in grads]
        elif not self.shard_update:
            grads = [self.groups["data"].allreduce(g).float() for g in grads]
        else:
            parts = {k: p if lay[k] is None else self._part(p, lay[k])
                     for k, p in params.items()}
            grads = [(self.groups["data"].allreduce(g) if lay[k] is None
                      else self._reduce_scatter(g, lay[k])).float()
                     for k, g in zip(keys, grads)]
        self.optimizer.update(parts, grads, opt_state,
                              norm=self._global_norm(keys, grads))
        if self.shard_update:
            with torch.no_grad():
                for k, p in params.items():
                    if lay[k] is not None:
                        p.copy_(self._gather(parts[k], lay[k]))
        return params, opt_state, loss

    def _mesh_backward(self, params: Params, batch):
        """The global loss and this rank's gradients (pieces, in the wire
        dtype) summed over fsdp and seq, not yet over data."""
        local = self._local(batch, split_rows=True)
        # the global masked mean: each rank's masked sum over the mask's
        # count on all ranks, so that the summed gradients are the global
        # gradient (a mean of the ranks' means would weigh uneven masks
        # wrongly)
        share = self._loss(local, self._batch_sum(self._count(local)))
        keys = list(params)
        grads = list(torch.autograd.grad(share, list(params.values())))
        loss = self._batch_sum(share.detach())
        wire = self._wire_dtype()
        if wire is not None:
            grads = [g.to(wire) for g in grads]
        if "fsdp" in self.groups:
            # the gathers' backward summed the split leaves over fsdp
            grads = [g if "fsdp" in self._dims[k]
                     else self.groups["fsdp"].allreduce(g)
                     for k, g in zip(keys, grads)]
        if "seq" in self.groups:
            grads = [self.groups["seq"].allreduce(g) for g in grads]
        return loss, grads

    def gradients(self, params: Mapping[str, torch.Tensor],
                  batch: Mapping[str, torch.Tensor]):
        """``(loss, grads)``: the step's loss and the gradient of each leaf
        before the clip (on a mesh, this rank's piece of it, summed over
        every axis), keyed by flax path; the parameters are not updated."""
        params = self._bind(params)
        if self.mesh is None:
            loss = self._loss(batch)
            grads = torch.autograd.grad(loss, list(params.values()))
        else:
            loss, grads = self._mesh_backward(params, batch)
            if "data" in self.groups:
                grads = [self.groups["data"].allreduce(g) for g in grads]
        return loss.detach(), {k: g.float() for k, g in zip(params, grads)}

    @torch.no_grad()
    def eval_step(self, params: Mapping[str, torch.Tensor],
                  batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """``lm_loss`` of ``batch`` alone: the MoE aux is left out, as in the
        JAX bundle's ``eval_step``. On a mesh every rank calls it (the
        weights are gathered and the tensor axis reduces), each on its own
        batch, whose rows it keeps whole; the ranks of one seq group pass
        the same one (each takes its chunk of every row, as ``step`` does,
        and the loss is their global masked mean), and so do the ranks of
        one tensor or expert group."""
        self._bind(params)
        if self.mesh is None:
            return self._lm_loss(self.model(batch["tokens"]), batch)
        local = self._local(batch, split_rows=False)
        count = self._count(local)
        if "seq" in self.groups:
            count = self.groups["seq"].allreduce(count)
        share = self._lm_loss(self.model(local["tokens"]), local, count)
        return (share if "seq" not in self.groups
                else self.groups["seq"].allreduce(share))

    def make_batch(self, rng: np.random.Generator, batch_size: int,
                   seq_len: int) -> Dict[str, torch.Tensor]:
        """A synthetic LM batch (tokens, targets, mask) on the bundle's
        device, drawn with the same numpy call as the JAX package's, so the
        same ``rng`` gives both the same tokens."""
        tokens = rng.integers(0, self.cfg.vocab_size,
                              (batch_size, seq_len + 1), dtype=np.int32)
        batch = {"tokens": torch.from_numpy(tokens[:, :-1]).long(),
                 "targets": torch.from_numpy(tokens[:, 1:]).long(),
                 "mask": torch.ones(batch_size, seq_len, dtype=torch.float32)}
        return {k: v.to(self.device) for k, v in batch.items()}

