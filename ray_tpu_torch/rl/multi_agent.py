"""Multi-agent RL: env abstraction, env-runner actors, and a multi-policy
PPO trainer: the port of ``ray_tpu/rl/multi_agent.py``.

Reference: rllib/env/multi_agent_env.py (dict-keyed obs/reward/termination
per agent), rllib/env/multi_agent_env_runner.py (one runner steps one
multi-agent env, routing each agent's obs through its policy via a
policy_mapping_fn and collecting per-POLICY batches), and the
multi-module learner (core/rl_module/multi_rl_module.py), realized here
as one ActorCritic + PPO update per policy id on the learner's device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.models.actor_critic import to_device, to_numpy
from ray_tpu_torch.rl.algorithm import (Algorithm, AlgorithmConfig,
                                        config_blob, ensure_runtime, kill_all,
                                        load_config)
from ray_tpu_torch.rl.learner import (batch_to, grad_dict, opt_state_numpy,
                                      opt_state_to, trainable)
from ray_tpu_torch.rl.optim import Adam
from ray_tpu_torch.rl.ppo import categorical


class MultiAgentEnv:
    """Dict-keyed multi-agent episode protocol (reference:
    rllib/env/multi_agent_env.py). Subclasses define ``agents`` plus
    per-agent observation/action dims and implement reset/step over
    ``{agent_id: value}`` dicts; "__all__" in terminateds ends the episode.
    """

    agents: List[str] = []

    def reset(self, seed: Optional[int] = None) -> Tuple[Dict, Dict]:
        raise NotImplementedError

    def step(self, actions: Dict[str, int]
             ) -> Tuple[Dict, Dict, Dict, Dict, Dict]:
        """-> (obs, rewards, terminateds, truncateds, infos), dict-keyed;
        terminateds/truncateds carry the "__all__" aggregate key."""
        raise NotImplementedError

    def observation_dim(self, agent: str) -> int:
        raise NotImplementedError

    def action_count(self, agent: str) -> int:
        raise NotImplementedError


class RendezvousEnv(MultiAgentEnv):
    """Tiny cooperative test env: two agents on a line of L cells move
    left/stay/right; both receive reward 1.0 each step they share a cell.
    Optimal behavior is to meet and stay: mean per-episode return near
    the horizon; random play scores far below."""

    agents = ["a0", "a1"]

    def __init__(self, length: int = 5, horizon: int = 16,
                 seed: int = 0):
        self.length = length
        self.horizon = horizon
        self._rng = np.random.RandomState(seed)
        self._pos: Dict[str, int] = {}
        self._t = 0

    def _obs(self) -> Dict[str, np.ndarray]:
        # each agent sees [own_pos, other_pos] scaled to [0, 1]
        p0, p1 = self._pos["a0"], self._pos["a1"]
        s = float(self.length - 1)
        return {"a0": np.array([p0 / s, p1 / s], np.float32),
                "a1": np.array([p1 / s, p0 / s], np.float32)}

    def reset(self, seed=None):
        if seed is not None:
            self._rng = np.random.RandomState(seed)
        self._pos = {"a0": int(self._rng.randint(self.length)),
                     "a1": int(self._rng.randint(self.length))}
        self._t = 0
        return self._obs(), {}

    def step(self, actions):
        for aid, act in actions.items():
            delta = int(act) - 1  # 0/1/2 -> left/stay/right
            self._pos[aid] = int(np.clip(self._pos[aid] + delta, 0,
                                         self.length - 1))
        self._t += 1
        together = float(self._pos["a0"] == self._pos["a1"])
        rewards = {"a0": together, "a1": together}
        done = self._t >= self.horizon
        terms = {"a0": done, "a1": done, "__all__": done}
        truncs = {"a0": False, "a1": False, "__all__": False}
        return self._obs(), rewards, terms, truncs, {}

    def observation_dim(self, agent):
        return 2

    def action_count(self, agent):
        return 3


_ENV_REGISTRY: Dict[str, Callable[..., MultiAgentEnv]] = {
    "rendezvous": RendezvousEnv,
}


def register_multi_agent_env(name: str, ctor: Callable[..., MultiAgentEnv]):
    _ENV_REGISTRY[name] = ctor


@dataclass
class MultiAgentPPOConfig(AlgorithmConfig):
    env: str = "rendezvous"
    env_config: Dict[str, Any] = field(default_factory=dict)
    # agent_id -> policy_id; None = one shared policy for all agents
    policy_mapping: Optional[Dict[str, str]] = None
    num_env_runners: int = 2
    rollout_length: int = 128
    gamma: float = 0.95
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    lr: float = 3e-3
    entropy_coef: float = 0.01
    vf_coef: float = 0.5
    epochs: int = 4
    hidden: tuple = (32, 32)

    @property
    def algo_cls(self):
        return MultiAgentPPO

    def policy_of(self, agent: str) -> str:
        if self.policy_mapping is None:
            return "shared"
        return self.policy_mapping.get(agent, "shared")


@ray_tpu_torch.remote(num_cpus=0.5)
class _MultiAgentRunner:
    """Steps one multi-agent env, routing each agent through its policy
    and emitting per-POLICY flat batches with GAE-ready fields
    (reference: multi_agent_env_runner.py)."""

    def __init__(self, config_blob_: bytes, worker_index: int):
        torch.set_num_threads(1)
        self.cfg: MultiAgentPPOConfig = load_config(config_blob_)
        ctor = _ENV_REGISTRY[self.cfg.env]
        self.env = ctor(seed=self.cfg.seed + worker_index * 1000,
                        **self.cfg.env_config)
        self.obs, _ = self.env.reset(seed=self.cfg.seed + worker_index)
        self._nets: Dict[str, Any] = {}
        self._rng_seed = self.cfg.seed * 104729 + worker_index
        self._ep_return = 0.0
        self._done_returns: List[float] = []

    def _policy_net(self, policy: str, agent: str):
        if policy not in self._nets:
            from ray_tpu_torch.models.actor_critic import ActorCritic

            self._nets[policy] = ActorCritic(
                self.env.observation_dim(agent),
                self.env.action_count(agent), self.cfg.hidden)
        return self._nets[policy]

    @torch.no_grad()
    def sample(self, params_by_policy) -> Dict[str, Dict[str, np.ndarray]]:
        cfg = self.cfg
        gen = torch.Generator().manual_seed(self._rng_seed)
        self._rng_seed += 1
        for aid in self.env.agents:
            pol = cfg.policy_of(aid)
            self._policy_net(pol, aid).load_params(params_by_policy[pol])
        # per-AGENT trajectory streams: GAE is a time recursion over one
        # agent's experience; interleaving agents would chain one agent's
        # delta into another's advantage
        cols: Dict[str, Dict[str, list]] = {
            a: {k: [] for k in ("obs", "actions", "logp", "rewards",
                                "dones", "values")}
            for a in self.env.agents}
        for _ in range(cfg.rollout_length):
            actions: Dict[str, int] = {}
            for aid in self.env.agents:
                net = self._nets[cfg.policy_of(aid)]
                logits, value = net(torch.as_tensor(
                    self.obs[aid], dtype=torch.float32)[None])
                act = int(categorical(logits, gen)[0])
                logp = float(torch.log_softmax(logits[0], -1)[act])
                actions[aid] = act
                c = cols[aid]
                c["obs"].append(np.asarray(self.obs[aid], np.float32))
                c["actions"].append(act)
                c["logp"].append(logp)
                c["values"].append(float(value[0]))
            next_obs, rewards, terms, truncs, _ = self.env.step(actions)
            done = bool(terms.get("__all__")) or bool(truncs.get("__all__"))
            self._ep_return += float(np.mean(list(rewards.values())))
            for aid in self.env.agents:
                cols[aid]["rewards"].append(float(rewards.get(aid, 0.0)))
                cols[aid]["dones"].append(float(done))
            if done:
                self._done_returns.append(self._ep_return)
                self._ep_return = 0.0
                next_obs, _ = self.env.reset()
            self.obs = next_obs
        # per-agent GAE (tail bootstraps with V(next_obs): a rollout cut
        # is truncation, not termination), then concatenate each policy's
        # agent streams into one flat batch
        by_policy: Dict[str, list] = {}
        for aid in self.env.agents:
            pol = cfg.policy_of(aid)
            c = cols[aid]
            batch = {k: np.asarray(v, np.float32) for k, v in c.items()}
            batch["actions"] = batch["actions"].astype(np.int32)
            _, tail_v = self._nets[pol](torch.as_tensor(
                self.obs[aid], dtype=torch.float32)[None])
            batch["adv"], batch["returns"] = self._gae(
                batch["values"], batch["rewards"], batch["dones"],
                tail_value=float(tail_v[0]))
            by_policy.setdefault(pol, []).append(batch)
        out: Dict[str, Any] = {}
        for pol, batches in by_policy.items():
            out[pol] = {k: np.concatenate([b[k] for b in batches])
                        for k in batches[0]}
        out["__episode_returns__"] = np.asarray(self._done_returns,
                                                np.float32)
        self._done_returns = []
        return out

    def _gae(self, values, rewards, dones, tail_value: float = 0.0):
        cfg = self.cfg
        T = len(rewards)
        adv = np.zeros(T, np.float32)
        lastgae = 0.0
        next_value = tail_value  # rollout cut = truncation: bootstrap
        for t in reversed(range(T)):
            nonterm = 1.0 - dones[t]
            delta = rewards[t] + cfg.gamma * next_value * nonterm - values[t]
            lastgae = delta + cfg.gamma * cfg.gae_lambda * nonterm * lastgae
            adv[t] = lastgae
            next_value = values[t]
        return adv, adv + values


def multi_agent_loss(model, params, b, cfg):
    """(total, [pg_loss, vf_loss, entropy]) of one policy's full batch."""
    logits, values = model.run(params, b["obs"])
    logp_all = torch.log_softmax(logits, -1)
    logp = logp_all.gather(-1, b["actions"].long()[:, None])[:, 0]
    adv = (b["adv"] - b["adv"].mean()) / (b["adv"].std(correction=0) + 1e-8)
    ratio = torch.exp(logp - b["logp"])
    pg1 = ratio * adv
    pg2 = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
    pg_loss = -torch.minimum(pg1, pg2).mean()
    vf_loss = ((values - b["returns"]) ** 2).mean()
    entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
    total = pg_loss + cfg.vf_coef * vf_loss - cfg.entropy_coef * entropy
    return total, torch.stack([pg_loss, vf_loss, entropy])


class MultiAgentPPO(Algorithm):
    """One ActorCritic + optimizer per policy id; each training step
    gathers per-policy batches from every runner and applies the PPO
    clipped update policy by policy, ``epochs`` full-batch steps each."""

    def __init__(self, cfg: MultiAgentPPOConfig):
        from ray_tpu_torch.models.actor_critic import ActorCritic
        from ray_tpu_torch.utils import resolve_device

        super().__init__(cfg)
        self.device = resolve_device(cfg.device)
        ensure_runtime(self.device)
        probe = _ENV_REGISTRY[cfg.env](seed=cfg.seed, **cfg.env_config)
        self.policies = sorted(set(cfg.policy_of(a) for a in probe.agents))
        pol_agents = {p: [a for a in probe.agents if cfg.policy_of(a) == p]
                      for p in self.policies}
        self.params: Dict[str, Any] = {}
        self.opt_states: Dict[str, Any] = {}
        self._models: Dict[str, Any] = {}
        self.opt = Adam(cfg.lr, clip=0.5)
        for i, pol in enumerate(self.policies):
            a0 = pol_agents[pol][0]
            model = ActorCritic(probe.observation_dim(a0),
                                probe.action_count(a0), cfg.hidden)
            self._models[pol] = model.to(self.device)
            self.params[pol] = trainable(to_device(
                model.init_params(cfg.seed + i), self.device))
            self.opt_states[pol] = self.opt.init(self.params[pol])
        blob = config_blob(cfg)
        self.runners = [_MultiAgentRunner.remote(blob, i)
                        for i in range(cfg.num_env_runners)]
        self.env_steps = 0
        self._return_window: List[float] = []

    def update_policy(self, pol: str, batch: Dict[str, np.ndarray]) -> float:
        """``epochs`` full-batch steps of one policy (the JAX package's
        ``lax.scan``); returns the last step's loss."""
        b = batch_to(batch, self.device)
        params, state = self.params[pol], self.opt_states[pol]
        total = None
        for _ in range(self.config.epochs):
            total, _ = multi_agent_loss(self._models[pol], params, b,
                                        self.config)
            self.opt.step(params, grad_dict(total, params), state)
        return float(total.detach())

    def training_step(self) -> Dict[str, Any]:
        params_np = {p: to_numpy(v) for p, v in self.params.items()}
        rollouts = ray_tpu_torch.get(
            [r.sample.remote(params_np) for r in self.runners], timeout=600)
        losses = {}
        for pol in self.policies:
            batch = {k: np.concatenate([r[pol][k] for r in rollouts])
                     for k in rollouts[0][pol]}
            self.env_steps += len(batch["actions"])
            losses[f"loss_{pol}"] = self.update_policy(pol, batch)
        for r in rollouts:
            self._return_window.extend(r["__episode_returns__"].tolist())
        self._return_window = self._return_window[-100:]
        return {
            "episode_return_mean": (float(np.mean(self._return_window))
                                    if self._return_window else 0.0),
            "num_env_steps_sampled": self.env_steps,
            **losses,
        }

    def get_state(self):
        return {"params": {p: to_numpy(v) for p, v in self.params.items()},
                "opt_states": {p: opt_state_numpy(v)
                               for p, v in self.opt_states.items()},
                "env_steps": self.env_steps}

    def set_state(self, state):
        self.params = {p: trainable(to_device(v, self.device))
                       for p, v in state["params"].items()}
        if "opt_states" in state:
            self.opt_states = {p: opt_state_to(v, self.device)
                               for p, v in state["opt_states"].items()}
        self.env_steps = int(state["env_steps"])

    def stop(self):
        kill_all(self.runners)
