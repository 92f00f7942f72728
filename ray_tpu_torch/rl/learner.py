"""What the RL learners share: parameters as a flat dict of fp32 tensors on
the learner's device, drawn on the CPU from the config's seed (so the card
and the CPU start from the same bits); batches moved there once; the
gradient of a loss as a dict; and the state in and out as numpy.

``device`` is the card unless the config (or the caller) names the CPU;
asking for the card where there is none raises.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ray_tpu_torch.models.actor_critic import Params, to_device, to_numpy
from ray_tpu_torch.parallel.train import OptState
from ray_tpu_torch.utils import resolve_device


def trainable(params: Params) -> Params:
    """The dict's tensors as leaves that take gradients."""
    return {k: v.detach().requires_grad_(True) for k, v in params.items()}


def grad_dict(loss: torch.Tensor, params: Params) -> Params:
    """d loss / d params, zeros for a leaf the loss does not use (BC's
    value head), as JAX gives them."""
    keys = list(params)
    grads = torch.autograd.grad(loss, [params[k] for k in keys],
                                allow_unused=True)
    return {k: torch.zeros_like(params[k]) if g is None else g
            for k, g in zip(keys, grads)}


def batch_to(batch: Mapping[str, Any], device: torch.device,
             skip=("episode_returns",)) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays as tensors on ``device``, one copy each."""
    return {k: torch.from_numpy(np.array(v, copy=True)).to(device)
            for k, v in batch.items() if k not in skip}


def opt_state_to(state: OptState, device) -> OptState:
    """An Adam state (numpy or tensor moments) as tensors on ``device``."""
    return OptState(int(state.count), to_device(state.mu, device),
                    to_device(state.nu, device))


def opt_state_numpy(state: OptState) -> OptState:
    return OptState(int(state.count), to_numpy(state.mu), to_numpy(state.nu))


class Learner:
    """Params + Adam on one device for one net (``model``)."""

    def _setup(self, cfg, model: torch.nn.Module, seed: int, opt,
               device=None) -> None:
        self.cfg = cfg
        self.device = resolve_device(cfg.device if device is None else device)
        self.model = model.to(self.device)
        self.params = trainable(to_device(model.init_params(seed),
                                          self.device))
        self.opt = opt
        self.opt_state = opt.init(self.params)

    def get_params(self) -> Dict[str, np.ndarray]:
        return to_numpy(self.params)

    def set_params(self, params: Mapping[str, Any]) -> None:
        self.params = trainable(to_device(params, self.device))

    def get_state(self) -> Dict[str, Any]:
        return {"params": to_numpy(self.params),
                "opt_state": opt_state_numpy(self.opt_state)}

    def set_state(self, state: Mapping[str, Any]) -> None:
        self.set_params(state["params"])
        self.opt_state = opt_state_to(state["opt_state"], self.device)
