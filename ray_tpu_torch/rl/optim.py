"""The RL learners' optimizer: optax's ``adam(lr)`` with a constant learning
rate, optionally behind ``clip_by_global_norm(max_norm)``, as the JAX
learners chain them (``optax.chain(clip_by_global_norm(0.5), adam(lr))``
for PPO, IMPALA/APPO and multi-agent PPO; plain ``adam`` for DQN, SAC and
the offline learners).

optax's algebra, step by step: the clip scales every leaf by
``max_norm / |g|`` where the global norm ``|g|`` (the root of the sum of
every leaf's sum of squares) is at least ``max_norm``; then
``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``, the count goes
up by one, and ``p += -lr * mu_hat / (sqrt(nu_hat) + eps)`` with
``mu_hat = mu / (1 - b1^count)``, ``nu_hat = nu / (1 - b2^count)`` and eps
1e-8 outside the root. The state is ``parallel.train.OptState`` (count,
mu, nu keyed like the parameters), which ``models.convert.
from_jax_opt_state`` builds from an optax state.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from ray_tpu_torch.parallel.train import OptState

Params = Mapping[str, torch.Tensor]


def global_norm(grads: Params) -> torch.Tensor:
    """optax's ``global_norm``: sqrt of the sum of every leaf's squares."""
    return torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))


def clip_by_global_norm(grads: Params, max_norm: float) -> dict:
    """optax's ``clip_by_global_norm``: the leaves unchanged where the
    global norm is below ``max_norm``, else each ``(g / norm) * max_norm``."""
    norm = global_norm(grads)
    keep = norm < max_norm
    return {k: torch.where(keep, g, (g / norm) * max_norm)
            for k, g in grads.items()}


class Adam:
    """``optax.chain(clip_by_global_norm(clip), adam(lr, b1, b2, eps))``,
    or plain ``adam`` where ``clip`` is None, over a flat dict of
    parameters updated in place."""

    def __init__(self, lr: float, clip: Optional[float] = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.clip = lr, clip
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Params) -> OptState:
        return OptState(0, {k: torch.zeros_like(p) for k, p in params.items()},
                        {k: torch.zeros_like(p) for k, p in params.items()})

    @torch.no_grad()
    def step(self, params: Params, grads: Params, state: OptState) -> None:
        """One update of ``params`` (and ``state``) in place."""
        if self.clip is not None:
            grads = clip_by_global_norm(grads, self.clip)
        keys = list(params)
        p = [params[k] for k in keys]
        g = [grads[k] for k in keys]
        state.count += 1
        # optax takes the corrections in fp32: 1 - decay ** count
        count = torch.tensor(state.count, dtype=torch.float32)
        bc1 = float(1 - torch.tensor(self.b1) ** count)
        bc2 = float(1 - torch.tensor(self.b2) ** count)
        mu = torch._foreach_mul(g, 1 - self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(
            [state.mu[k] for k in keys], self.b1))
        nu = torch._foreach_mul(g, g)
        torch._foreach_mul_(nu, 1 - self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(
            [state.nu[k] for k in keys], self.b2))
        state.mu.update(zip(keys, mu))
        state.nu.update(zip(keys, nu))
        # p += -lr * (mu / bc1) / (sqrt(nu / bc2) + eps)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, -self.lr)
        torch._foreach_add_(p, upd)
