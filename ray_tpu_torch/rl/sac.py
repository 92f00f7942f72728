"""SAC: off-policy continuous control with entropy regularization: the port
of ``ray_tpu/rl/sac.py``.

Reference: rllib/algorithms/sac: twin Q critics with target networks,
tanh-squashed Gaussian actor, automatic entropy-temperature tuning
(sac_torch_learner's alpha loss), env-runner actors feeding a replay
buffer. The update (twin critics + actor + alpha + polyak) runs on the
learner's device. Its Gaussian noise is an argument of ``step``: by
default drawn on the CPU from a ``torch.Generator`` seeded ``seed + 17``
(so the card and the CPU draw the same), or given by the caller.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.models.actor_critic import (squashed_sample, to_device,
                                               to_numpy)
from ray_tpu_torch.rl.algorithm import (Algorithm, AlgorithmConfig,
                                        config_blob, ensure_runtime, kill_all,
                                        load_config)
from ray_tpu_torch.rl.learner import (batch_to, grad_dict, opt_state_numpy,
                                      opt_state_to, trainable)
from ray_tpu_torch.rl.optim import Adam
from ray_tpu_torch.rl.ppo import probe_env
from ray_tpu_torch.rl.replay_buffer import ReplayBuffer
from ray_tpu_torch.utils import resolve_device


@dataclass
class SACConfig(AlgorithmConfig):
    env: str = "Pendulum-v1"
    num_env_runners: int = 1
    num_envs_per_runner: int = 4
    rollout_length: int = 64
    gamma: float = 0.99
    tau: float = 0.01
    lr: float = 3e-4
    alpha_lr: float = 3e-4
    buffer_capacity: int = 100_000
    batch_size: int = 256
    updates_per_iteration: int = 32
    warmup_steps: int = 1000
    hidden: tuple = (128, 128)

    @property
    def algo_cls(self):
        return SAC


@ray_tpu_torch.remote(num_cpus=1)
class _SACRunner:
    """Continuous-action sampler (squashed-Gaussian exploration)."""

    def __init__(self, config_blob_: bytes, worker_index: int):
        from ray_tpu_torch.rl.env_runner import EpisodeTracker, make_vec_env

        torch.set_num_threads(1)
        self.cfg: SACConfig = load_config(config_blob_)
        self.envs, self.obs = make_vec_env(
            self.cfg.env, self.cfg.num_envs_per_runner,
            self.cfg.seed + worker_index * 1000)
        self.net = None
        self._rng_seed = self.cfg.seed * 9973 + worker_index
        self.episodes = EpisodeTracker(self.cfg.num_envs_per_runner)
        space = self.envs.single_action_space
        self.act_low = np.asarray(space.low, np.float32)
        self.act_high = np.asarray(space.high, np.float32)

    def _policy(self, params):
        if self.net is None:
            from ray_tpu_torch.models.actor_critic import SquashedGaussianActor

            obs_dim = int(np.prod(self.envs.single_observation_space.shape))
            act_dim = int(np.prod(self.envs.single_action_space.shape))
            self.net = SquashedGaussianActor(obs_dim, act_dim,
                                             self.cfg.hidden)
        self.net.load_params(params)
        return self.net

    @torch.no_grad()
    def sample(self, params, random_actions: bool = False
               ) -> Dict[str, np.ndarray]:
        from ray_tpu_torch.rl.env_runner import true_next_obs

        T, N = self.cfg.rollout_length, self.cfg.num_envs_per_runner
        act_shape = self.envs.single_action_space.shape
        obs_buf = np.zeros((T, N) + self.obs.shape[1:], np.float32)
        act_buf = np.zeros((T, N) + act_shape, np.float32)
        rew_buf = np.zeros((T, N), np.float32)
        done_buf = np.zeros((T, N), np.float32)
        next_buf = np.zeros_like(obs_buf)
        net = None if random_actions else self._policy(params)
        gen = torch.Generator().manual_seed(self._rng_seed)
        self._rng_seed += 1
        scale = (self.act_high - self.act_low) / 2.0
        mid = (self.act_high + self.act_low) / 2.0
        for t in range(T):
            if random_actions:
                action = np.random.default_rng(self._rng_seed * 131 + t).uniform(
                    -1.0, 1.0, (N,) + act_shape).astype(np.float32)
            else:
                obs = torch.as_tensor(self.obs, dtype=torch.float32)
                eps = torch.randn((N,) + act_shape, generator=gen)
                action, _ = net.sample(obs, eps)
                action = action.numpy()
            env_action = action * scale + mid
            obs_buf[t] = self.obs
            act_buf[t] = action
            self.obs, rew, term, trunc, info = self.envs.step(env_action)
            done = np.logical_or(term, trunc)
            next_buf[t] = true_next_obs(self.obs, done, info)
            rew_buf[t] = rew
            # bootstrap through time-limit truncations (Pendulum always
            # truncates): only true terminations cut the value target
            done_buf[t] = term.astype(np.float32)
            self.episodes.step(rew, done)
        flat = lambda a: a.reshape((-1,) + a.shape[2:])  # noqa: E731
        return {
            "obs": flat(obs_buf), "actions": flat(act_buf),
            "rewards": flat(rew_buf), "dones": flat(done_buf),
            "next_obs": flat(next_buf),
            "episode_returns": self.episodes.pop(),
        }


class SACLearner:
    """One step: twin-critic Bellman + actor + temperature + polyak.

    The state is ``actor``, ``q1``, ``q2``, ``q1_target``, ``q2_target``
    (flat dicts of tensors), ``log_alpha`` (a 0-d tensor) and the four
    Adam states, on ``device``."""

    def __init__(self, cfg: SACConfig, obs_dim: int, act_dim: int,
                 device=None):
        from ray_tpu_torch.models.actor_critic import (ContinuousQ,
                                                       SquashedGaussianActor)

        self.cfg = cfg
        self.device = resolve_device(cfg.device if device is None else device)
        self.actor = SquashedGaussianActor(obs_dim, act_dim, cfg.hidden).to(
            self.device)
        self.q = ContinuousQ(obs_dim, act_dim, cfg.hidden).to(self.device)
        self.act_dim = act_dim
        # three nets from seeds seed, seed + 1 and seed + 2 (the JAX
        # learner splits one key three ways)
        self.actor_params = trainable(to_device(
            self.actor.init_params(cfg.seed), self.device))
        self.q1_params = trainable(to_device(
            self.q.init_params(cfg.seed + 1), self.device))
        self.q2_params = trainable(to_device(
            self.q.init_params(cfg.seed + 2), self.device))
        self.q1_target = _copy(self.q1_params)
        self.q2_target = _copy(self.q2_params)
        self.log_alpha = torch.zeros((), device=self.device,
                                     requires_grad=True)
        self.target_entropy = -float(act_dim)
        self.actor_opt = Adam(cfg.lr)
        self.q_opt = Adam(cfg.lr)
        self.alpha_opt = Adam(cfg.alpha_lr)
        self.actor_opt_state = self.actor_opt.init(self.actor_params)
        self.q1_opt_state = self.q_opt.init(self.q1_params)
        self.q2_opt_state = self.q_opt.init(self.q2_params)
        self.alpha_opt_state = self.alpha_opt.init(
            {"log_alpha": self.log_alpha})
        self._gen = torch.Generator().manual_seed(cfg.seed + 17)

    def noise(self, batch_size: int):
        """(eps for the next-state action, eps for the policy's action)."""
        shape = (batch_size, self.act_dim)
        return (torch.randn(shape, generator=self._gen),
                torch.randn(shape, generator=self._gen))

    def step(self, batch: Dict[str, np.ndarray], eps_next=None, eps_pi=None
             ) -> Dict[str, torch.Tensor]:
        """One update on ``batch``; the noise is drawn where not given."""
        cfg = self.cfg
        b = batch_to(batch, self.device)
        if eps_next is None:
            eps_next, eps_pi = self.noise(len(batch["obs"]))
        eps_next, eps_pi = (torch.from_numpy(np.array(e, np.float32)).to(
            self.device) for e in (eps_next, eps_pi))
        alpha = torch.exp(self.log_alpha).detach()

        # critic targets
        with torch.no_grad():
            next_act, next_logp = squashed_sample(
                *self.actor.run(self.actor_params, b["next_obs"]),
                eps_next)
            tq1 = self.q.run(self.q1_target, b["next_obs"], next_act)
            tq2 = self.q.run(self.q2_target, b["next_obs"], next_act)
            target_v = torch.minimum(tq1, tq2) - alpha * next_logp
            target = b["rewards"] + cfg.gamma * (1.0 - b["dones"]) * target_v

        q_losses = []
        for params, state in ((self.q1_params, self.q1_opt_state),
                              (self.q2_params, self.q2_opt_state)):
            pred = self.q.run(params, b["obs"], b["actions"])
            q_loss = ((pred - target) ** 2).mean()
            self.q_opt.step(params, grad_dict(q_loss, params), state)
            q_losses.append(q_loss.detach())

        # actor, against the updated critics
        act, logp = squashed_sample(
            *self.actor.run(self.actor_params, b["obs"]), eps_pi)
        qv = torch.minimum(self.q.run(self.q1_params, b["obs"], act),
                           self.q.run(self.q2_params, b["obs"], act))
        pi_loss = (alpha * logp - qv).mean()
        self.actor_opt.step(self.actor_params,
                            grad_dict(pi_loss, self.actor_params),
                            self.actor_opt_state)

        # temperature
        la = {"log_alpha": self.log_alpha}
        alpha_loss = (-torch.exp(self.log_alpha)
                      * (logp.detach() + self.target_entropy)).mean()
        self.alpha_opt.step(la, grad_dict(alpha_loss, la),
                            self.alpha_opt_state)

        # polyak
        with torch.no_grad():
            for tgt, src in ((self.q1_target, self.q1_params),
                             (self.q2_target, self.q2_params)):
                for k in tgt:
                    tgt[k] = tgt[k] * (1 - cfg.tau) + src[k] * cfg.tau
        return {"q_loss": (q_losses[0] + q_losses[1]) / 2,
                "pi_loss": pi_loss.detach(),
                "alpha": torch.exp(self.log_alpha).detach(),
                "entropy": -logp.detach().mean()}

    def update(self, batches: List[Dict[str, np.ndarray]]
               ) -> Dict[str, float]:
        metrics = {}
        for batch in batches:
            metrics = self.step(batch)
        return {k: float(v) for k, v in metrics.items()}

    def get_state(self) -> Dict[str, Any]:
        return {"actor": to_numpy(self.actor_params),
                "q1": to_numpy(self.q1_params),
                "q2": to_numpy(self.q2_params),
                "q1_target": to_numpy(self.q1_target),
                "q2_target": to_numpy(self.q2_target),
                "log_alpha": self.log_alpha.detach().cpu().numpy().copy(),
                **{k: opt_state_numpy(getattr(self, k + "_state"))
                   for k in ("actor_opt", "q1_opt", "q2_opt", "alpha_opt")}}

    def set_state(self, state: Dict[str, Any]) -> None:
        dev = self.device
        self.actor_params = trainable(to_device(state["actor"], dev))
        self.q1_params = trainable(to_device(state["q1"], dev))
        self.q2_params = trainable(to_device(state["q2"], dev))
        self.q1_target = to_device(state["q1_target"], dev)
        self.q2_target = to_device(state["q2_target"], dev)
        self.log_alpha = torch.tensor(np.asarray(state["log_alpha"]),
                                      dtype=torch.float32).to(dev)
        self.log_alpha.requires_grad_(True)
        for k in ("actor_opt", "q1_opt", "q2_opt", "alpha_opt"):
            setattr(self, k + "_state", opt_state_to(state[k], dev))


def _copy(params):
    return {k: v.detach().clone() for k, v in params.items()}


class SAC(Algorithm):
    def __init__(self, cfg: SACConfig):
        super().__init__(cfg)
        self.cfg = cfg
        ensure_runtime(resolve_device(cfg.device))
        obs_dim, space = probe_env(cfg.env)
        act_dim = int(np.prod(space.shape))
        self.learner = SACLearner(cfg, obs_dim, act_dim)
        blob = config_blob(cfg)
        self.runners = [_SACRunner.remote(blob, i)
                        for i in range(cfg.num_env_runners)]
        self.buffer = ReplayBuffer(cfg.buffer_capacity, cfg.seed)
        self._steps_sampled = 0
        self._return_window: List[float] = []

    def training_step(self) -> Dict[str, Any]:
        t0 = time.time()
        params_np = to_numpy(self.learner.actor_params)
        warmup = self._steps_sampled < self.cfg.warmup_steps
        rollouts = ray_tpu_torch.get(
            [r.sample.remote(params_np, warmup) for r in self.runners],
            timeout=600)
        for roll in rollouts:
            self._return_window.extend(roll.pop("episode_returns").tolist())
            self.buffer.add_batch(roll)
            self._steps_sampled += len(roll["obs"])
        self._return_window = self._return_window[-50:]
        metrics = {}
        if not warmup and len(self.buffer) >= self.cfg.batch_size:
            batches = [self.buffer.sample(self.cfg.batch_size)
                       for _ in range(self.cfg.updates_per_iteration)]
            metrics = self.learner.update(batches)
        return {
            "episode_return_mean": (float(np.mean(self._return_window))
                                    if self._return_window else 0.0),
            "num_env_steps_sampled": self._steps_sampled,
            "steps_per_sec": (self.cfg.rollout_length
                              * self.cfg.num_envs_per_runner
                              * len(self.runners)) / max(time.time() - t0, 1e-6),
            **metrics,
        }

    def get_state(self):
        return {"state": self.learner.get_state()}

    def set_state(self, state):
        self.learner.set_state(state["state"])

    def stop(self):
        kill_all(self.runners)
