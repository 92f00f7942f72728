"""MLP networks for RL: the port of ``ray_tpu/models/actor_critic.py``
(reference capability: rllib RLModule default MLP nets).

The parameters keep flax's key paths and layouts, as the transformer's do:
a layer's ``kernel`` is ``(in, out)`` and it computes ``x @ kernel + bias``;
the named layers keep their names (``torso_<i>``, ``pi``, ``vf``, ``q``) and
the unnamed ones of the SAC nets are ``Dense_0``, ``Dense_1``, ... in
flax's order, so ``models.convert.from_jax_params`` carries a JAX tree
across as a plain copy. The init is the port's own, from an explicit
``torch.Generator``, with flax's laws: lecun_normal (a normal truncated at
two deviations) for the kernels, zeros for the biases, orthogonal(0.01)
for ``pi`` and ``q``, orthogonal(1.0) for ``vf``.

Learners hold their parameters as a flat dict of tensors and run a net on
it with its ``run(params, *inputs)`` (flax's ``apply``); env runners load
a dict into the module itself.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

Params = Dict[str, torch.Tensor]

# flax's truncated_normal: the std of a standard normal cut at +-2
_TRUNCATED_STD = 0.87962566103423978


class Dense(nn.Module):
    """flax's ``nn.Dense`` parameters: an ``(in, out)`` kernel and a bias,
    computed as ``x @ kernel + bias`` (``_dense``). ``scale`` None draws
    the kernel lecun_normal, else orthogonal(scale)."""

    def __init__(self, in_features: int, out_features: int,
                 scale: Optional[float] = None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.scale = scale

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.scale is None:
            std = math.sqrt(1.0 / self.kernel.shape[0]) / _TRUNCATED_STD
            nn.init.trunc_normal_(self.kernel, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
        else:
            nn.init.orthogonal_(self.kernel, self.scale, generator=generator)
        self.bias.zero_()


class _Net(nn.Module):
    """A net of ``Dense`` layers with the port's seeded init. ``run(params,
    *inputs)`` computes the net on a flat dict of parameters (``forward``
    runs it on the module's own)."""

    def init_params(self, seed: int = 0) -> Params:
        """Fresh parameters from ``torch.Generator().manual_seed(seed)``,
        drawn on the CPU (so the card and the CPU start from the same
        bits), layer by layer in the order the net makes them; the module's
        own parameters take them too."""
        gen = torch.Generator().manual_seed(seed)
        device = next(self.parameters()).device
        self.cpu()
        for module in self.modules():
            if isinstance(module, Dense):
                module.reset_parameters(gen)
        params = {k: v.detach().clone() for k, v in self.state_dict().items()}
        self.to(device)
        return params

    def load_params(self, params: Mapping[str, object]) -> None:
        """Copy a flat dict of tensors or numpy arrays into the module."""
        with torch.no_grad():
            for key, p in self.state_dict(keep_vars=True).items():
                p.copy_(_tensor(params[key]))

    def forward(self, *inputs):
        return self.run(dict(self.named_parameters()), *inputs)

    def run(self, params: Mapping[str, torch.Tensor], *inputs):
        raise NotImplementedError


def _dense(params: Mapping[str, torch.Tensor], name: str,
           x: torch.Tensor) -> torch.Tensor:
    return x @ params[name + ".kernel"] + params[name + ".bias"]


class QNetwork(_Net):
    """State-action value MLP for DQN-family algorithms."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = (64, 64)):
        super().__init__()
        dims = (obs_dim,) + tuple(hidden)
        self.torso = [f"torso_{i}" for i in range(len(hidden))]
        for name, i, o in zip(self.torso, dims[:-1], dims[1:]):
            self.add_module(name, Dense(i, o))
        self.q = Dense(dims[-1], action_dim, scale=0.01)

    def run(self, params, obs: torch.Tensor) -> torch.Tensor:
        x = obs
        for name in self.torso:
            x = torch.relu(_dense(params, name, x))
        return _dense(params, "q", x)


class ActorCritic(_Net):
    """Discrete-action policy logits and a value head on a tanh torso."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = (64, 64)):
        super().__init__()
        dims = (obs_dim,) + tuple(hidden)
        self.torso = [f"torso_{i}" for i in range(len(hidden))]
        for name, i, o in zip(self.torso, dims[:-1], dims[1:]):
            self.add_module(name, Dense(i, o))
        self.pi = Dense(dims[-1], action_dim, scale=0.01)
        self.vf = Dense(dims[-1], 1, scale=1.0)

    def run(self, params, obs: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = obs
        for name in self.torso:
            x = torch.tanh(_dense(params, name, x))
        return _dense(params, "pi", x), _dense(params, "vf", x)[..., 0]


class SquashedGaussianActor(_Net):
    """Tanh-squashed diagonal Gaussian policy for continuous control
    (reference: rllib SAC's action distribution). ``sample`` returns
    (action in [-1,1]^d, log_prob with the tanh change-of-variables
    correction) for standard-normal noise ``eps`` given by the caller."""

    def __init__(self, obs_dim: int, act_dim: int,
                 hidden: Sequence[int] = (128, 128),
                 log_std_min: float = -10.0, log_std_max: float = 2.0):
        super().__init__()
        dims = (obs_dim,) + tuple(hidden)
        self.hidden = [f"Dense_{i}" for i in range(len(hidden))]
        for name, i, o in zip(self.hidden, dims[:-1], dims[1:]):
            self.add_module(name, Dense(i, o))
        self.mu_name = f"Dense_{len(hidden)}"
        self.log_std_name = f"Dense_{len(hidden) + 1}"
        self.add_module(self.mu_name, Dense(dims[-1], act_dim))
        self.add_module(self.log_std_name, Dense(dims[-1], act_dim))
        self.act_dim = act_dim
        self.log_std_min, self.log_std_max = log_std_min, log_std_max

    def run(self, params, obs: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = obs
        for name in self.hidden:
            x = torch.relu(_dense(params, name, x))
        mu = _dense(params, self.mu_name, x)
        log_std = _dense(params, self.log_std_name, x)
        return mu, torch.clamp(log_std, self.log_std_min, self.log_std_max)

    def sample(self, obs: torch.Tensor, eps: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        return squashed_sample(*self(obs), eps)


def squashed_sample(mu: torch.Tensor, log_std: torch.Tensor,
                    eps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``SquashedGaussianActor.sample`` from the actor's outputs: the
    action ``tanh(mu + exp(log_std) eps)`` and its log-probability."""
    std = torch.exp(log_std)
    pre_tanh = mu + std * eps
    action = torch.tanh(pre_tanh)
    # log N(pre_tanh; mu, std) - sum log(1 - tanh^2)
    logp = (-0.5 * (((pre_tanh - mu) / std) ** 2
                    + 2 * log_std + math.log(2 * math.pi))).sum(-1)
    logp = logp - (2 * (math.log(2.0) - pre_tanh - nn.functional.softplus(
        -2 * pre_tanh))).sum(-1)
    return action, logp


class ContinuousQ(_Net):
    """Q(s, a) head for continuous actions (reference: SAC twin critics)."""

    def __init__(self, obs_dim: int, act_dim: int,
                 hidden: Sequence[int] = (128, 128)):
        super().__init__()
        dims = (obs_dim + act_dim,) + tuple(hidden) + (1,)
        self.layers = [f"Dense_{i}" for i in range(len(dims) - 1)]
        for name, i, o in zip(self.layers, dims[:-1], dims[1:]):
            self.add_module(name, Dense(i, o))

    def run(self, params, obs: torch.Tensor, action: torch.Tensor
            ) -> torch.Tensor:
        x = torch.cat([obs, action], dim=-1)
        for name in self.layers[:-1]:
            x = torch.relu(_dense(params, name, x))
        return _dense(params, self.layers[-1], x)[..., 0]


def to_device(params: Mapping[str, object], device) -> Params:
    """A flat dict of numpy arrays or tensors as fp32 tensors on
    ``device`` (fresh copies)."""
    return {k: _tensor(v).to(device=device, dtype=torch.float32, copy=True)
            for k, v in params.items()}


def _tensor(v) -> torch.Tensor:
    """A tensor, or a numpy array (read-only ones too) as a CPU tensor."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.from_numpy(np.array(v, copy=True))


def to_numpy(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A flat dict of tensors as numpy arrays on the host (copies, which
    later in-place updates of the tensors leave alone)."""
    return {k: v.detach().cpu().numpy().copy() for k, v in params.items()}
