"""The training step of the flagship LM in PyTorch, on one device or on the
data axis of a mesh.

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
- On a mesh (``parallel/mesh.py``) the step is data parallel over the
  ``data`` axis: every rank passes the same global batch and takes its own
  rows; the loss is the global masked mean, each rank backpropagating its
  share; the gradients are all-reduced, or with ``shard_update=True``
  reduce-scattered, each rank updating its slice of every leaf (the
  optimizer's moments live on that slice only) before the parameters are
  all-gathered. ``grad_dtype="bf16"`` rounds the gradients to bf16 before
  the reduction, which then carries bf16.

Not ported yet (``ROADMAP.md`` queue 1): the ``fsdp``, ``tensor``, ``seq``
and ``expert`` axes above size 1; MoE configs on ``data`` > 1 (the
router's aux from all-reduced statistics, capacity groups that match the
global grouping); the bucketed reduce of ``collective/bucketed.py``; the
traced step with its ``compression`` wire; and the goodput and tracing
hooks of ``step``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch.collective.collective_group import TorchGroup
from ray_tpu_torch.collective.quant import resolve_codec
from ray_tpu_torch.models.convert import check_params, init_params
from ray_tpu_torch.models.transformer import (Transformer, TransformerConfig,
                                              lm_loss)
from ray_tpu_torch.parallel.mesh import mesh_axis_sizes
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
               shapes: Optional[Sequence[Tuple[int, ...]]] = None,
               group: Optional[TorchGroup] = None) -> None:
        """One step on ``params`` in place; ``grads`` (in ``params``' order)
        are consumed as scratch. The schedule is read at the count before
        this step, the bias corrections at the count after it. ``shapes``
        and ``group``: the sharded update's, where ``params``, ``grads`` and
        the moments hold this rank's part of each leaf that
        ``clip_spec_fn`` splits (``shapes`` are the whole leaves')."""
        keys = list(params)
        p = [params[k] for k in keys]
        m = [state.mu[k] for k in keys]
        v = [state.nu[k] for k in keys]
        g = list(grads)
        if self.clip_spec_fn is not None:
            sharded_clip_by_global_norm(self.clip, self.clip_spec_fn, g,
                                        shapes, group)
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


def sharded_clip_by_global_norm(max_norm: float,
                                spec_fn: Callable[[Tuple[int, ...]], Layout],
                                grads: Sequence[torch.Tensor],
                                shapes: Optional[Sequence[Tuple[int, ...]]]
                                = None,
                                group: Optional[TorchGroup] = None
                                ) -> torch.Tensor:
    """The clip of the JAX function of that name: scale ``grads`` in place by
    max_norm / max(norm, max_norm) and return the norm, taken in a pinned
    association. A leaf that ``spec_fn(shape)`` splits, ``(dim, n)``,
    contributes the sums of squares of its n parts along ``dim`` (fp32, of
    contiguous copies), summed in part (rank) order; any other leaf its own
    sum of squares; the leaves' sums fold in tree order. With ``shapes``
    (the whole leaves') the split leaves of ``grads`` hold only the part of
    ``group``'s rank, and the other parts' sums come from the group: the
    same values in the same order, so the sharded and the unsharded step
    agree bit for bit in fp32."""
    sums: List = []
    mine: List[int] = []
    for i, g in enumerate(grads):
        layout = spec_fn(tuple(g.shape if shapes is None else shapes[i]))
        if layout is None:
            sums.append([_sq_norm(g)])
        elif shapes is None:
            sums.append([_sq_norm(x) for x in g.chunk(layout[1], layout[0])])
        else:
            sums.append(None)
            mine.append(i)
    if mine:
        local = torch.stack([_sq_norm(grads[i]) for i in mine])
        parts = group.allgather(local).reshape(group.world_size, -1)
        for j, i in enumerate(mine):
            sums[i] = list(parts[:, j])
    norm = torch.sqrt(_fold([_fold(leaf) for leaf in sums]))
    torch._foreach_mul_(grads, max_norm / torch.clamp(norm, min=max_norm))
    return norm


class TrainStepBundle:
    """The model, its optimizer and the step, on one device or on the data
    axis of a mesh.

    ``init(seed)`` gives ``(params, opt_state)``; ``step(params, opt_state,
    batch)`` gives ``(params, opt_state, loss)``, updating both in place (the
    JAX step donates them) and returning the loss as a 0-d tensor without a
    host sync. ``params`` is the model's own parameter dict; any other dict
    of the config's leaves (``from_jax_params``, ``init_params``) is copied
    into the model first and left as it was. ``optimizer_factory`` is called
    with the clip's layout function when ``shard_update`` is on and with
    ``None`` otherwise (the JAX package's signature).

    ``mesh`` (``parallel.create_mesh``): None is the single-device step.
    On a mesh every rank passes the same global batch and the step
    runs on the ``data`` axis, whose size must divide the batch; the other
    axes must be 1. ``shard_update=True`` (with ``data`` > 1) splits each
    leaf's update across the data axis along its first dim that divides
    by the axis's size (leaves without one are updated whole on every
    rank); the optimizer state is then on that layout (``init_sharded``,
    ``shard_opt_state``). ``grad_dtype="bf16"`` rounds the gradients
    through bf16 before the reduction, which carries bf16; moments and
    parameters stay fp32. ``compression`` has no step here yet and
    raises."""

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
        self.group: Optional[TorchGroup] = None
        self.dp_size = 1
        if mesh is None:
            self.device = resolve_device(device)
        else:
            self.device = resolve_device(mesh.device_type if device is None
                                         else device)
            if self.device.type != mesh.device_type:
                raise ValueError(f"a {mesh.device_type} mesh runs on "
                                 f"{mesh.device_type}, not {self.device}")
            sizes = mesh_axis_sizes(mesh)
            wider = {a: n for a, n in sizes.items() if a != "data" and n > 1}
            if wider:
                raise NotImplementedError(
                    f"mesh axes {wider}: the port's step runs on the data "
                    "axis only; fsdp, tensor, seq and expert come with a "
                    "later slice (ROADMAP.md queue 1)")
            self.dp_size = sizes.get("data", 1)
            if cfg.n_experts and self.dp_size > 1:
                raise NotImplementedError(
                    "a MoE config on data > 1 needs the router's aux from "
                    "all-reduced statistics and capacity groups that match "
                    "the global grouping: the expert-parallel slice "
                    "(ROADMAP.md queue 1)")
            if "data" in sizes:
                self.group = TorchGroup.from_process_group(
                    "data", mesh.get_group("data"), self.device)
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
        self.model = Transformer(cfg, device=self.device)
        self._params: Params = dict(self.model.named_parameters())
        self._layouts: Dict[str, Layout] = {
            k: self._layout(tuple(p.shape)) if self.shard_update else None
            for k, p in self._params.items()}

    def _layout(self, shape: Tuple[int, ...]) -> Layout:
        """How the sharded update splits a leaf: ``(dim, parts)`` for its
        first dim that divides by the data axis's size, or None (updated
        whole on every rank). JAX's ``_update_sharding`` and ``_norm_spec``
        with every other mesh axis of size 1, where both pick this dim."""
        for d, size in enumerate(shape):
            if size % self.dp_size == 0:
                return d, self.dp_size
        return None

    def init(self, seed: int = 0):
        """Parameters drawn from ``seed`` (``convert.init_params``) and a
        fresh optimizer state (whole leaves; see ``init_sharded``)."""
        self._bind(init_params(self.cfg, seed=seed, device=self.device))
        return self._params, self.optimizer.init(self._params)

    def init_sharded(self, seed: int = 0):
        """``init`` with the optimizer state on the sharded update's
        layout."""
        params, opt_state = self.init(seed)
        return params, self.shard_opt_state(opt_state)

    # -- the sharded layout ---------------------------------------------------

    def _part(self, x: torch.Tensor, layout: Layout) -> torch.Tensor:
        """This rank's part of a whole leaf, as a tensor of its own."""
        d, n = layout
        return x.chunk(n, d)[self.group.rank].clone(
            memory_format=torch.contiguous_format)

    def _gather(self, part: torch.Tensor, layout: Layout) -> torch.Tensor:
        """The whole leaf from every rank's part, in rank order."""
        d, _ = layout
        return self.group.allgather(part.movedim(d, 0)).movedim(0, d)

    def _reduce_scatter(self, g: torch.Tensor, layout: Layout
                        ) -> torch.Tensor:
        """This rank's part of the sum of every rank's ``g``."""
        d, _ = layout
        return self.group.reducescatter(g.movedim(d, 0)).movedim(0, d) \
            .contiguous()

    def shard_opt_state(self, opt_state: OptState) -> OptState:
        """The moments of a whole-leaf optimizer state cut to this rank's
        parts (the state of an unsharded run taken over)."""
        lay = self._layouts
        return OptState(opt_state.count, *(
            {k: x if lay[k] is None else self._part(x, lay[k])
             for k, x in moments.items()}
            for moments in (opt_state.mu, opt_state.nu)))

    def unshard_opt_state(self, opt_state: OptState) -> OptState:
        """The whole-leaf optimizer state from every rank's parts."""
        lay = self._layouts
        return OptState(opt_state.count, *(
            {k: x if lay[k] is None else self._gather(x, lay[k])
             for k, x in moments.items()}
            for moments in (opt_state.mu, opt_state.nu)))

    def opt_state_bytes_per_replica(self, opt_state: OptState) -> int:
        """Device bytes of the moments this rank holds (a split leaf counts
        its part, a whole one in full). The step count stays on the host."""
        return sum(x.numel() * x.element_size()
                   for moments in (opt_state.mu, opt_state.nu)
                   for x in moments.values())

    def opt_state_bytes_total(self) -> int:
        """Bytes of one whole optimizer state's moments (from the shapes)."""
        return 2 * sum(p.numel() * p.element_size()
                       for p in self._params.values())

    def _bind(self, params: Mapping[str, torch.Tensor]) -> Params:
        own = self._params
        if any(params.get(k) is not p for k, p in own.items()):
            check_params(params, self.cfg)
            with torch.no_grad():
                for key, p in own.items():
                    p.copy_(params[key])
        return own

    def _loss(self, batch, count: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
        """``lm_loss`` (divided by ``count`` where given) plus
        ``moe_aux_coef`` times the sum of the MoE layers' load-balancing
        losses (none for a dense config), as the JAX bundle's
        ``loss_fn``."""
        logits, aux = self.model(batch["tokens"], return_aux=True)
        loss = lm_loss(logits, batch["targets"], batch.get("mask"), count)
        if aux:
            loss = loss + self.cfg.moe_aux_coef * sum(aux.values())
        return loss

    def step(self, params: Mapping[str, torch.Tensor], opt_state: OptState,
             batch: Mapping[str, torch.Tensor]):
        """One optimization step: the loss with the MoE aux, one backward,
        the optimizer; on a mesh, with the data axis's reductions."""
        params = self._bind(params)
        opt_state.to(self.device)
        if self.group is None:
            loss = self._loss(batch)
            grads = torch.autograd.grad(loss, list(params.values()))
            self.optimizer.update(params, grads, opt_state)
            return params, opt_state, loss.detach()
        group = self.group
        rows = batch["tokens"].shape[0]
        if rows % self.dp_size:
            raise ValueError(f"a batch of {rows} rows does not split over "
                             f"the data axis's {self.dp_size} ranks")
        n = rows // self.dp_size
        local = {k: x[group.rank * n:(group.rank + 1) * n]
                 for k, x in batch.items()}
        # the global masked mean: each rank's masked sum over the mask's
        # count on all ranks, so that the summed gradients are the global
        # gradient (a mean of the ranks' means would weigh uneven masks
        # wrongly)
        mask = local.get("mask")
        count = (mask.float().sum() if mask is not None else torch.tensor(
            float(local["targets"].numel()), device=self.device))
        share = self._loss(local, group.allreduce(count))
        grads = torch.autograd.grad(share, list(params.values()))
        loss = group.allreduce(share.detach())
        if self.grad_dtype == "bf16":
            grads = [g.to(torch.bfloat16) for g in grads]
        if not self.shard_update:
            self.optimizer.update(params, [group.allreduce(g).float()
                                           for g in grads], opt_state)
            return params, opt_state, loss
        lay = self._layouts
        parts = {k: p if lay[k] is None else self._part(p, lay[k])
                 for k, p in params.items()}
        grads = [(group.allreduce(g) if lay[k] is None
                  else self._reduce_scatter(g, lay[k])).float()
                 for k, g in zip(params, grads)]
        self.optimizer.update(parts, grads, opt_state,
                              shapes=[tuple(p.shape) for p in params.values()],
                              group=group)
        with torch.no_grad():
            for k, p in params.items():
                if lay[k] is not None:
                    p.copy_(self._gather(parts[k], lay[k]))
        return params, opt_state, loss

    @torch.no_grad()
    def eval_step(self, params: Mapping[str, torch.Tensor],
                  batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """``lm_loss`` alone: the MoE aux is left out, as in the JAX
        bundle's ``eval_step``."""
        self._bind(params)
        return lm_loss(self.model(batch["tokens"]), batch["targets"],
                       batch.get("mask"))

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
