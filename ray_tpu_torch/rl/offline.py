"""Offline RL: behavior cloning (BC) and MARWIL: the port of
``ray_tpu/rl/offline.py``.

Reference: rllib/algorithms/bc + rllib/algorithms/marwil: learn a policy
from a fixed dataset of (obs, action[, reward]) transitions with no
environment interaction during training; MARWIL weights the imitation
loss by exponentiated advantages against a learned value baseline
(marwil.py's beta). Datasets may be the port's ``data.Dataset``
(reference: offline data on ray.data)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rl.learner import Learner, batch_to, grad_dict
from ray_tpu_torch.rl.optim import Adam
from ray_tpu_torch.rl.ppo import probe_env


@dataclass
class BCConfig(AlgorithmConfig):
    env: str = "CartPole-v1"
    # dataset for cfg.build(): dict of arrays or a ray_tpu_torch Dataset
    offline_data: Any = None
    lr: float = 1e-3
    batch_size: int = 256
    updates_per_iteration: int = 32
    hidden: tuple = (64, 64)
    # MARWIL advantage weighting; 0.0 == plain BC (reference: marwil.py beta)
    beta: float = 0.0
    vf_coef: float = 1.0
    gamma: float = 0.99
    eval_episodes: int = 8

    @property
    def algo_cls(self):
        return BC


@dataclass
class MARWILConfig(BCConfig):
    beta: float = 1.0

    @property
    def algo_cls(self):
        return MARWIL


def offline_loss(model, params, b, beta: float, vf_coef: float):
    """(total, [total, pi_loss, vf_loss]) of the weighted imitation loss."""
    logits, values = model.run(params, b["obs"])
    logp_all = torch.log_softmax(logits, -1)
    logp = logp_all.gather(-1, b["actions"].long()[:, None])[:, 0]
    if beta > 0.0:
        adv = b["returns"] - values
        # center + scale: below-average transitions (e.g. random filler in
        # a mixed dataset) get exponentially small weight even before the
        # value baseline converges
        norm = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        weights = torch.clamp(torch.exp(beta * norm.detach()), 0.0, 20.0)
        pi_loss = -(weights * logp).mean()
        vf_loss = (adv ** 2).mean()
        total = pi_loss + vf_coef * vf_loss
    else:
        pi_loss = -logp.mean()
        vf_loss = torch.zeros((), device=logp.device)
        total = pi_loss
    return total, torch.stack([total, pi_loss, vf_loss])


class _OfflineLearner(Learner):
    """The weighted-imitation update over an offline batch, plain Adam."""

    def __init__(self, cfg: BCConfig, obs_dim: int, n_actions: int,
                 device=None):
        from ray_tpu_torch.models.actor_critic import ActorCritic

        self._setup(cfg, ActorCritic(obs_dim, n_actions, cfg.hidden),
                    cfg.seed, Adam(cfg.lr), device)

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        b = batch_to(batch, self.device)
        total, mvec = offline_loss(self.model, self.params, b, self.cfg.beta,
                                   self.cfg.vf_coef)
        self.opt.step(self.params, grad_dict(total, self.params),
                      self.opt_state)
        return dict(zip(("loss", "pi_loss", "vf_loss"),
                        mvec.detach().cpu().tolist()))


class BC(Algorithm):
    """Behavior cloning from an offline dataset.

    The dataset may be a ``ray_tpu_torch.data.Dataset`` of rows with
    ``obs``/``actions`` (MARWIL additionally needs per-episode ``rewards``
    + ``dones`` or precomputed ``returns``), or a plain dict of arrays via
    ``config.offline_data``."""

    def __init__(self, cfg: BCConfig, offline_data=None):
        super().__init__(cfg)
        self.cfg = cfg
        if offline_data is None:
            offline_data = cfg.offline_data
        obs_dim, space = probe_env(cfg.env)
        self.learner = _OfflineLearner(cfg, obs_dim, int(space.n))
        self._data = self._load_data(offline_data)
        self._rng = np.random.default_rng(cfg.seed)

    def _load_data(self, offline_data) -> Dict[str, np.ndarray]:
        if offline_data is None:
            raise ValueError("BC/MARWIL require offline_data")
        if isinstance(offline_data, dict):
            data = {k: np.asarray(v) for k, v in offline_data.items()}
        else:  # a Dataset of row dicts
            rows = offline_data.take_all()
            keys = rows[0].keys()
            data = {k: np.asarray([r[k] for r in rows]) for k in keys}
        data["obs"] = data["obs"].astype(np.float32)
        data["actions"] = data["actions"].astype(np.int32)
        if self.cfg.beta > 0.0 and "returns" not in data:
            data["returns"] = self._discounted_returns(data)
        if "returns" in data:
            r = data["returns"].astype(np.float32)
            # standardize: the value head shares a torso with the policy, so
            # unscaled-return regression gradients would swamp the
            # imitation signal (advantages only need relative scale)
            data["returns"] = (r - r.mean()) / (r.std() + 1e-8)
        return data

    def _discounted_returns(self, data) -> np.ndarray:
        rewards = data["rewards"].astype(np.float32)
        dones = data["dones"].astype(bool)
        returns = np.zeros_like(rewards)
        acc = 0.0
        for i in reversed(range(len(rewards))):
            acc = rewards[i] + self.cfg.gamma * (0.0 if dones[i] else acc)
            returns[i] = acc
        return returns

    def training_step(self) -> Dict[str, Any]:
        n = len(self._data["obs"])
        metrics = {}
        for _ in range(self.cfg.updates_per_iteration):
            idx = self._rng.integers(0, n, self.cfg.batch_size)
            batch = {k: v[idx] for k, v in self._data.items()
                     if k in ("obs", "actions", "returns")}
            metrics = self.learner.update(batch)
        return metrics

    @torch.no_grad()
    def evaluate(self) -> Dict[str, float]:
        """Greedy rollouts in the env (reference: evaluation duration on
        the Algorithm), the policy on the learner's device."""
        from ray_tpu_torch.rl import envs

        env = envs.make(self.cfg.env)
        ln = self.learner
        total = []
        for ep in range(self.cfg.eval_episodes):
            obs, _ = env.reset(seed=self.cfg.seed + ep)
            done, ret = False, 0.0
            while not done:
                logits, _ = ln.model.run(ln.params, torch.as_tensor(
                    obs, dtype=torch.float32, device=ln.device)[None])
                action = int(torch.argmax(logits[0]))
                obs, rew, term, trunc, _ = env.step(action)
                ret += float(rew)
                done = term or trunc
            total.append(ret)
        env.close()
        return {"episode_return_mean": float(np.mean(total))}

    def get_state(self):
        return {"params": self.learner.get_params()}

    def set_state(self, state):
        self.learner.set_params(state["params"])

    def stop(self):
        pass


class MARWIL(BC):
    """Advantage-weighted imitation (beta > 0)."""
