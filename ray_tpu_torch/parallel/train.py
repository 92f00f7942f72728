"""The training step of the flagship LM on one device, in PyTorch.

Counterpart of ``ray_tpu/parallel/train.py`` (its single-device subset):

- ``make_optimizer`` is the JAX package's optax chain,
  ``clip_by_global_norm(clip)`` then ``adamw`` over
  ``warmup_cosine_decay_schedule``, written out on tensors with
  ``torch._foreach_*`` ops over all leaves at once.
- ``TrainStepBundle`` draws the parameters, takes a step (forward, one
  backward, the optimizer) and evaluates, for a dense or a MoE config (the
  step's loss adds ``moe_aux_coef`` times the MoE layers' aux; the
  evaluation leaves it out, as the JAX bundle does). Parameters and the
  optimizer's moments are flat dicts keyed by flax paths
  (``layer_0.attn.q_proj.kernel``), so a JAX run's state converts by
  copying (``models/convert.py``).

Not ported yet (ROADMAP.md queue 1): the mesh and its shardings,
``shard_update`` with its bucketed reduce-scatter, ``grad_dtype``,
``compression``, and the goodput and tracing hooks of ``step``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from ray_tpu_torch.models.convert import check_params, init_params
from ray_tpu_torch.models.transformer import (Transformer, TransformerConfig,
                                              lm_loss)
from ray_tpu_torch.utils import DeviceLike, resolve_device

Params = Dict[str, torch.Tensor]


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
               grads: Sequence[torch.Tensor], state: OptState) -> None:
        """One step on ``params`` in place; ``grads`` (in ``params``' order)
        are consumed as scratch. The schedule is read at the count before
        this step, the bias corrections at the count after it."""
        keys = list(params)
        p = [params[k] for k in keys]
        m = [state.mu[k] for k in keys]
        v = [state.nu[k] for k in keys]
        g = list(grads)
        # clip_by_global_norm: scale by clip / |g| only when |g| >= clip
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
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
                   b1: float = 0.9, b2: float = 0.95, clip: float = 1.0
                   ) -> AdamW:
    """AdamW with a global-norm clip, as the JAX package's
    ``make_optimizer`` (the same defaults)."""
    return AdamW(learning_rate, weight_decay, warmup_steps, total_steps, b1,
                 b2, clip)


class TrainStepBundle:
    """The model, its optimizer and the step on one device.

    ``init(seed)`` gives ``(params, opt_state)``; ``step(params, opt_state,
    batch)`` gives ``(params, opt_state, loss)``, updating both in place (the
    JAX step donates them) and returning the loss as a 0-d tensor without a
    host sync. ``params`` is the model's own parameter dict; any other dict
    of the config's leaves (``from_jax_params``, ``init_params``) is copied
    into the model first and left as it was. ``optimizer_factory`` is called
    with the clip's sharding function, which is ``None`` on one device (the
    JAX package's signature)."""

    def __init__(self, cfg: TransformerConfig, device: DeviceLike = None,
                 optimizer: Optional[AdamW] = None,
                 optimizer_factory: Optional[Callable] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if optimizer is None:
            optimizer = (optimizer_factory(None) if optimizer_factory
                         is not None else make_optimizer())
        self.optimizer = optimizer
        self.model = Transformer(cfg, device=self.device)
        self._params: Params = dict(self.model.named_parameters())

    def init(self, seed: int = 0):
        """Parameters drawn from ``seed`` (``convert.init_params``) and a
        fresh optimizer state."""
        self._bind(init_params(self.cfg, seed=seed, device=self.device))
        return self._params, self.optimizer.init(self._params)

    def _bind(self, params: Mapping[str, torch.Tensor]) -> Params:
        own = self._params
        if any(params.get(k) is not p for k, p in own.items()):
            check_params(params, self.cfg)
            with torch.no_grad():
                for key, p in own.items():
                    p.copy_(params[key])
        return own

    def _loss(self, batch) -> torch.Tensor:
        """``lm_loss`` plus ``moe_aux_coef`` times the sum of the MoE layers'
        load-balancing losses (none for a dense config), as the JAX
        bundle's ``loss_fn``."""
        logits, aux = self.model(batch["tokens"], return_aux=True)
        loss = lm_loss(logits, batch["targets"], batch.get("mask"))
        if aux:
            loss = loss + self.cfg.moe_aux_coef * sum(aux.values())
        return loss

    def step(self, params: Mapping[str, torch.Tensor], opt_state: OptState,
             batch: Mapping[str, torch.Tensor]):
        """One optimization step: the loss with the MoE aux, one backward,
        the optimizer."""
        params = self._bind(params)
        loss = self._loss(batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        self.optimizer.update(params, grads, opt_state.to(self.device))
        return params, opt_state, loss.detach()

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
