"""DQN: epsilon-greedy env runners + replay buffer + a double-DQN learner:
the port of ``ray_tpu/rl/dqn.py``.

Reference: rllib/algorithms/dqn (training_step samples from env runners into
a replay buffer, updates with target-network TD, syncs target every
``target_network_update_freq`` steps). The Q-update (double-DQN target,
huber loss, PER weighting) runs on the learner's device; replay stays in
host numpy (see replay_buffer.py). The runner is deterministic given the
params and the seed: argmax of Q plus numpy's epsilon draws.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.models.actor_critic import to_device, to_numpy
from ray_tpu_torch.rl.algorithm import (Algorithm, AlgorithmConfig,
                                        config_blob, ensure_runtime, kill_all,
                                        load_config)
from ray_tpu_torch.rl.learner import (Learner, batch_to, grad_dict,
                                      opt_state_numpy, opt_state_to)
from ray_tpu_torch.rl.optim import Adam
from ray_tpu_torch.rl.ppo import probe_env
from ray_tpu_torch.rl.replay_buffer import PrioritizedReplayBuffer, ReplayBuffer


@dataclass
class DQNConfig(AlgorithmConfig):
    num_env_runners: int = 2
    num_envs_per_runner: int = 2
    rollout_length: int = 64
    buffer_capacity: int = 50_000
    prioritized_replay: bool = True
    learning_starts: int = 500
    train_batch_size: int = 64
    updates_per_iteration: int = 32
    gamma: float = 0.99
    lr: float = 5e-4
    epsilon_initial: float = 1.0
    epsilon_final: float = 0.05
    epsilon_decay_steps: int = 5_000
    target_update_freq: int = 500  # env steps between target syncs
    hidden: tuple = (64, 64)
    double_q: bool = True

    @property
    def algo_cls(self):
        return DQN


@ray_tpu_torch.remote(num_cpus=1)
class _DQNRunner:
    """Vector env sampler emitting (s, a, r, s', done) transitions."""

    def __init__(self, config_blob_: bytes, worker_index: int):
        from ray_tpu_torch.rl.env_runner import EpisodeTracker, make_vec_env

        torch.set_num_threads(1)
        self.cfg: DQNConfig = load_config(config_blob_)
        self.envs, self.obs = make_vec_env(
            self.cfg.env, self.cfg.num_envs_per_runner,
            self.cfg.seed + worker_index * 1000)
        self._rng = np.random.default_rng(self.cfg.seed * 131 + worker_index)
        self.net = None
        self.episodes = EpisodeTracker(self.cfg.num_envs_per_runner)

    def _q(self, params):
        if self.net is None:
            from ray_tpu_torch.models.actor_critic import QNetwork

            obs_dim = int(np.prod(self.envs.single_observation_space.shape))
            self.net = QNetwork(obs_dim, int(self.envs.single_action_space.n),
                                self.cfg.hidden)
        self.net.load_params(params)
        return self.net

    @torch.no_grad()
    def sample(self, params, epsilon: float) -> Dict[str, np.ndarray]:
        from ray_tpu_torch.rl.env_runner import true_next_obs

        net = self._q(params)
        T, N = self.cfg.rollout_length, self.cfg.num_envs_per_runner
        shp = self.obs.shape[1:]
        out = {k: np.zeros((T, N) + (shp if k in ("obs", "next_obs") else ()),
                           np.float32)
               for k in ("obs", "next_obs", "rewards", "dones")}
        out["actions"] = np.zeros((T, N), np.int32)
        for t in range(T):
            q = net(torch.as_tensor(self.obs, dtype=torch.float32)).numpy()
            action = q.argmax(-1)
            explore = self._rng.random(N) < epsilon
            action = np.where(
                explore, self._rng.integers(0, q.shape[-1], N), action)
            nxt, rew, term, trunc, info = self.envs.step(action)
            done = np.logical_or(term, trunc)
            out["obs"][t] = self.obs
            # TD target state: the terminal obs, not the autoreset obs
            out["next_obs"][t] = true_next_obs(nxt, done, info)
            out["actions"][t] = action
            out["rewards"][t] = rew
            # bootstrap through truncation: only true termination zeroes the
            # next-state value; truncation bootstraps V(final_obs)
            out["dones"][t] = term.astype(np.float32)
            self.obs = nxt
            self.episodes.step(rew, done)
        flat = lambda a: a.reshape((-1,) + a.shape[2:])  # noqa: E731
        res = {k: flat(v) for k, v in out.items()}
        res["episode_returns"] = self.episodes.pop()
        return res

    def cuda_initialized(self) -> bool:
        return torch.cuda.is_initialized()


def dqn_loss(model, params, target_params, b, gamma: float, double_q: bool):
    """(PER-weighted huber TD loss, td errors) of one batch."""
    q = model.run(params, b["obs"])
    q_sel = q.gather(-1, b["actions"].long()[:, None])[:, 0]
    q_next_t = model.run(target_params, b["next_obs"])
    if double_q:
        best = torch.argmax(model.run(params, b["next_obs"]), dim=-1)
    else:
        best = torch.argmax(q_next_t, dim=-1)
    q_next = q_next_t.gather(-1, best[:, None])[:, 0]
    target = b["rewards"] + gamma * (1.0 - b["dones"]) * q_next.detach()
    td = q_sel - target
    huber = torch.where(td.abs() < 1.0, 0.5 * td * td, td.abs() - 0.5)
    w = b.get("weights")
    if w is None:
        w = torch.ones_like(td)
    return (w * huber).mean(), td


class DQNLearner(Learner):
    """The Q-network, its target copy and plain Adam on one device."""

    def __init__(self, cfg: DQNConfig, obs_dim: int, n_actions: int,
                 device=None):
        from ray_tpu_torch.models.actor_critic import QNetwork

        self._setup(cfg, QNetwork(obs_dim, n_actions, cfg.hidden), cfg.seed,
                    Adam(cfg.lr), device)
        self.sync_target()

    def sync_target(self) -> None:
        self.target_params = {k: v.detach().clone()
                              for k, v in self.params.items()}

    def update(self, batch: Dict[str, np.ndarray]):
        """One step on a sampled batch; returns (loss, td errors) as a
        device scalar and a device vector."""
        b = batch_to(batch, self.device)
        loss, td = dqn_loss(self.model, self.params, self.target_params, b,
                            self.cfg.gamma, self.cfg.double_q)
        self.opt.step(self.params, grad_dict(loss, self.params),
                      self.opt_state)
        return loss.detach(), td.detach()


class DQN(Algorithm):
    def __init__(self, cfg: DQNConfig):
        from ray_tpu_torch.utils import resolve_device

        super().__init__(cfg)
        ensure_runtime(resolve_device(cfg.device))
        obs_dim, space = probe_env(cfg.env)
        self.learner = DQNLearner(cfg, obs_dim, int(space.n))
        buf_cls = PrioritizedReplayBuffer if cfg.prioritized_replay \
            else ReplayBuffer
        self.buffer = buf_cls(cfg.buffer_capacity, seed=cfg.seed)
        blob = config_blob(cfg)
        self.runners = [_DQNRunner.remote(blob, i)
                        for i in range(cfg.num_env_runners)]
        self.env_steps = 0
        self._steps_since_target_sync = 0
        self._return_window: List[float] = []

    @property
    def params(self):
        return self.learner.params

    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self.env_steps / max(cfg.epsilon_decay_steps, 1))
        return cfg.epsilon_initial + frac * (cfg.epsilon_final
                                             - cfg.epsilon_initial)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.time()
        params_np = self.learner.get_params()
        eps = self._epsilon()
        rollouts = ray_tpu_torch.get(
            [r.sample.remote(params_np, eps) for r in self.runners],
            timeout=600)
        for r in rollouts:
            self._return_window.extend(r.pop("episode_returns").tolist())
            n = len(r["obs"])
            self.buffer.add_batch(r)
            self.env_steps += n
            self._steps_since_target_sync += n
        self._return_window = self._return_window[-100:]

        loss_val = 0.0
        if len(self.buffer) >= cfg.learning_starts:
            for _ in range(cfg.updates_per_iteration):
                batch = self.buffer.sample(cfg.train_batch_size)
                idx = batch.pop("idx", None)
                loss, td = self.learner.update(batch)
                if idx is not None:
                    self.buffer.update_priorities(idx, td.cpu().numpy())
                loss_val = float(loss)
            if self._steps_since_target_sync >= cfg.target_update_freq:
                self.learner.sync_target()
                self._steps_since_target_sync = 0
        return {
            "episode_return_mean": (float(np.mean(self._return_window))
                                    if self._return_window else 0.0),
            "num_env_steps_sampled": self.env_steps,
            "epsilon": eps,
            "loss": loss_val,
            "buffer_size": len(self.buffer),
            "steps_per_sec": (sum(len(r["obs"]) for r in rollouts)
                              / max(time.time() - t0, 1e-6)),
        }

    def get_state(self):
        ln = self.learner
        return {"params": to_numpy(ln.params),
                "target": to_numpy(ln.target_params),
                "opt_state": opt_state_numpy(ln.opt_state),
                "buffer": self.buffer.state(),
                "env_steps": self.env_steps,
                "steps_since_target_sync": self._steps_since_target_sync}

    def set_state(self, state):
        ln = self.learner
        ln.set_params(state["params"])
        ln.target_params = to_device(state["target"], ln.device)
        ln.opt_state = opt_state_to(state["opt_state"], ln.device)
        self.buffer.set_state(state["buffer"])
        self.env_steps = int(state["env_steps"])
        self._steps_since_target_sync = int(state["steps_since_target_sync"])

    def stop(self):
        kill_all(self.runners)
