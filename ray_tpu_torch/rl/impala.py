"""IMPALA: async env-runners + aggregator actors + a V-trace learner: the
port of ``ray_tpu/rl/impala.py``.

Reference: rllib/algorithms/impala/impala.py:605 (async sampling loop) and
:133-148 (aggregator actors). Runners sample continuously with whatever
params they last received; the learner corrects the resulting policy lag
with V-trace importance weighting (Espeholt et al. 2018), a reverse loop
over the time axis on the learner's device (the JAX package's
``lax.scan``). Aggregator actors stack several rollouts into one learner
batch off the algorithm's process, which only moves object refs. Runners
and aggregators compute on the CPU.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rl.algorithm import (Algorithm, AlgorithmConfig,
                                        config_blob, ensure_runtime, kill_all)
from ray_tpu_torch.rl.learner import Learner, batch_to, grad_dict
from ray_tpu_torch.rl.optim import Adam
from ray_tpu_torch.rl.ppo import PolicyRunner, categorical, probe_env


def vtrace_returns(values, last_value, rewards, dones, rhos, *, gamma,
                   rho_clip, c_clip):
    """V-trace targets + pg advantages over [T, B] inputs (Espeholt et al.
    2018), accumulated backwards in time. Shared by the IMPALA and APPO
    learners; both results are detached."""
    values, last_value, rhos = (values.detach(), last_value.detach(),
                                rhos.detach())
    rho_cl = torch.clamp(rhos, max=rho_clip)
    c_cl = torch.clamp(rhos, max=c_clip)
    nonterm = 1.0 - dones
    values_tp1 = torch.cat([values[1:], last_value[None]], dim=0)
    deltas = rho_cl * (rewards + gamma * values_tp1 * nonterm - values)
    acc = torch.empty_like(deltas)
    carry = torch.zeros_like(last_value)
    for t in reversed(range(deltas.shape[0])):
        carry = deltas[t] + gamma * nonterm[t] * c_cl[t] * carry
        acc[t] = carry
    vs = values + acc
    vs_tp1 = torch.cat([vs[1:], last_value[None]], dim=0)
    pg_adv = rho_cl * (rewards + gamma * vs_tp1 * nonterm - values)
    return vs, pg_adv


@dataclass
class IMPALAConfig(AlgorithmConfig):
    num_env_runners: int = 2
    num_envs_per_runner: int = 2
    rollout_length: int = 64
    num_rollouts_per_update: int = 2  # aggregated per learner batch
    gamma: float = 0.99
    lr: float = 1e-3
    entropy_coef: float = 0.01
    vf_coef: float = 0.25
    vtrace_rho_clip: float = 1.0
    vtrace_c_clip: float = 1.0
    hidden: tuple = (64, 64)
    num_aggregators: int = 1
    # multi-learner gradient sync (reference: learner_group.py:101); each
    # learner consumes its own aggregated batch, grads allreduce-averaged
    num_learners: int = 1
    learner_backend: str = "cpu"

    @property
    def algo_cls(self):
        return IMPALA


@ray_tpu_torch.remote(num_cpus=1)
class _ImpalaRunner(PolicyRunner):
    """Time-major rollout sampler carrying behavior logp for V-trace."""

    def __init__(self, config_blob_: bytes, worker_index: int):
        self._setup_runner(config_blob_, worker_index)

    @torch.no_grad()
    def sample(self, params) -> Dict[str, np.ndarray]:
        net = self._policy(params)
        gen = self._next_generator()
        T, N = self.cfg.rollout_length, self.cfg.num_envs_per_runner
        obs_buf = np.zeros((T, N) + self.obs.shape[1:], np.float32)
        act_buf = np.zeros((T, N), np.int32)
        logp_buf = np.zeros((T, N), np.float32)
        rew_buf = np.zeros((T, N), np.float32)
        done_buf = np.zeros((T, N), np.float32)
        for t in range(T):
            logits, _ = net(torch.as_tensor(self.obs, dtype=torch.float32))
            action = categorical(logits, gen)
            logp = torch.log_softmax(logits, -1).gather(
                -1, action[:, None])[:, 0]
            action = action.numpy()
            obs_buf[t] = self.obs
            act_buf[t] = action
            logp_buf[t] = logp.numpy()
            self.obs, rew, term, trunc, _ = self.envs.step(action)
            done = np.logical_or(term, trunc)
            rew_buf[t] = rew
            # cut the V-trace recursion at BOTH termination and truncation:
            # values may not leak across an episode boundary (obs[t+1] is the
            # next episode's reset obs under same-step autoreset)
            done_buf[t] = done.astype(np.float32)
            self.episodes.step(rew, done)
        return {
            "obs": obs_buf, "actions": act_buf, "behavior_logp": logp_buf,
            "rewards": rew_buf, "dones": done_buf,
            "last_obs": np.asarray(self.obs, np.float32),
            "episode_returns": self.episodes.pop(),
        }


@ray_tpu_torch.remote(num_cpus=0.5)
class _Aggregator:
    """Stacks rollouts into one [T, B] learner batch off the algorithm's
    process (reference: impala.py:133-148 aggregator actors)."""

    def stack(self, *rollouts) -> Dict[str, np.ndarray]:
        ep = np.concatenate([r["episode_returns"] for r in rollouts])
        out = {k: np.concatenate([r[k] for r in rollouts], axis=1)
               for k in ("obs", "actions", "behavior_logp", "rewards", "dones")}
        out["last_obs"] = np.concatenate(
            [r["last_obs"] for r in rollouts], axis=0)
        out["episode_returns"] = ep
        return out


def _time_major(model, params, batch):
    """The net on the [T, B] observations and the last ones in one pass:
    (logits [T, B, A], values [T, B], last values [B])."""
    T, B = batch["actions"].shape
    obs_all = torch.cat([batch["obs"].reshape((T * B,)
                                              + batch["obs"].shape[2:]),
                         batch["last_obs"]], dim=0)
    logits_all, values_all = model.run(params, obs_all)
    logits = logits_all[: T * B].reshape(T, B, -1)
    values = values_all[: T * B].reshape(T, B)
    last_value = values_all[T * B:]
    return logits, values, last_value


class _ImpalaLearnerCore(Learner):
    """Params + optimizer + the V-trace update, usable in-process
    (num_learners=1) or as rank ``rank`` of a LearnerGroup: in the multi
    case each learner consumes its OWN aggregated batch and gradients are
    allreduce-averaged before apply (reference:
    rllib/core/learner/torch/torch_learner.py:524-547), so parameters stay
    identical across ranks (same seed -> same init)."""

    metric_keys = ("loss", "pg_loss", "vf_loss", "entropy", "mean_rho")

    def __init__(self, cfg, obs_dim: int, n_actions: int,
                 world_size: int = 1, rank: int = 0, group_name=None,
                 device=None):
        from ray_tpu_torch.models.actor_critic import ActorCritic

        self._setup(cfg, ActorCritic(obs_dim, n_actions, cfg.hidden),
                    cfg.seed, Adam(cfg.lr, clip=0.5), device)
        self.world_size, self.rank, self.group_name = (world_size, rank,
                                                       group_name)

    # -- algorithm-specific pieces (APPO overrides) ---------------------

    def loss(self, params, batch):
        """(total, the metric_keys' values stacked)."""
        cfg = self.cfg
        logits, values, last_value = _time_major(self.model, params, batch)
        logp_all = torch.log_softmax(logits, -1)
        logp = logp_all.gather(-1, batch["actions"].long()[..., None])[..., 0]
        rhos = torch.exp(logp - batch["behavior_logp"])
        vs, pg_adv = vtrace_returns(
            values, last_value, batch["rewards"], batch["dones"], rhos,
            gamma=cfg.gamma, rho_clip=cfg.vtrace_rho_clip,
            c_clip=cfg.vtrace_c_clip)
        pg_loss = -(logp * pg_adv).mean()
        vf_loss = ((values - vs) ** 2).mean()
        entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
        total = pg_loss + cfg.vf_coef * vf_loss - cfg.entropy_coef * entropy
        return total, torch.stack([total, pg_loss, vf_loss, entropy,
                                   rhos.mean()])

    def _post_update(self):
        pass

    # -- update ---------------------------------------------------------

    def update(self, batch) -> dict:
        b = batch_to(batch, self.device)
        total, mvec = self.loss(self.params, b)
        grads = grad_dict(total, self.params)
        if self.world_size == 1:
            self.opt.step(self.params, grads, self.opt_state)
            self._post_update()
            return dict(zip(self.metric_keys, mvec.detach().cpu().tolist()))
        from ray_tpu_torch.rl.learner_group import sync_gradients

        scale = 1.0 / self.world_size
        grads, mvec = sync_gradients(
            {k: g * scale for k, g in grads.items()},
            mvec.detach() * scale, self.group_name)
        self.opt.step(self.params, grads, self.opt_state)
        self._post_update()
        return dict(zip(self.metric_keys, map(float, mvec)))


class IMPALA(Algorithm):
    learner_core_cls = _ImpalaLearnerCore

    def __init__(self, cfg: IMPALAConfig):
        from ray_tpu_torch.utils import resolve_device

        super().__init__(cfg)
        ensure_runtime(resolve_device(cfg.device))
        obs_dim, space = probe_env(cfg.env)
        n_actions = int(space.n)
        self.learner_group = None
        if cfg.num_learners > 1:
            if cfg.num_learners > cfg.num_env_runners:
                raise ValueError(
                    f"num_learners={cfg.num_learners} needs at least as "
                    f"many env runners (got {cfg.num_env_runners}): each "
                    f"learner consumes >=1 rollout per update")
            from ray_tpu_torch.rl.learner_group import LearnerGroup

            core_cls = self.learner_core_cls

            def factory(rank, world_size, group_name, _cfg=cfg, _o=obs_dim,
                        _n=n_actions, _cls=core_cls):
                return _cls(_cfg, _o, _n, world_size=world_size, rank=rank,
                            group_name=group_name)

            self.learner_group = LearnerGroup(
                factory, cfg.num_learners, backend=cfg.learner_backend,
                device=cfg.device)
            self.core = None
        else:
            self.core = self.learner_core_cls(cfg, obs_dim, n_actions)

        blob = config_blob(cfg)
        self.runners = [_ImpalaRunner.remote(blob, i)
                        for i in range(cfg.num_env_runners)]
        self.aggregators = [_Aggregator.remote()
                            for _ in range(cfg.num_aggregators)]
        self._agg_rr = 0
        # prime the async pipeline: every runner starts sampling immediately
        params_np = self._current_params_np()
        self._inflight = {r.sample.remote(params_np): r for r in self.runners}
        self.env_steps = 0
        self._return_window: List[float] = []

    def _current_params_np(self):
        if self.learner_group is not None:
            return self.learner_group.get_params()
        return self.core.get_params()

    def _next_aggregator(self):
        agg = self.aggregators[self._agg_rr % len(self.aggregators)]
        self._agg_rr += 1
        return agg

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.time()
        n_learners = max(1, cfg.num_learners)
        want = min(max(cfg.num_rollouts_per_update, n_learners),
                   len(self.runners))
        ready, _ = ray_tpu_torch.wait(list(self._inflight),
                                      num_returns=want, timeout=600)
        rollout_refs = []
        params_np = self._current_params_np()
        for ref in ready:
            runner = self._inflight.pop(ref)
            rollout_refs.append(ref)
            # relaunch with current weights: the runner never idles
            self._inflight[runner.sample.remote(params_np)] = runner
        if self.learner_group is None:
            batch = ray_tpu_torch.get(
                self._next_aggregator().stack.remote(*rollout_refs),
                timeout=600)
            self._return_window.extend(batch.pop("episode_returns").tolist())
            metrics = self.core.update(batch)
            steps = int(np.prod(batch["actions"].shape))
        else:
            # one aggregated batch per learner (round-robin over the ready
            # rollouts); gradients sync inside the group
            groups = [rollout_refs[i::n_learners] for i in range(n_learners)]
            batches = ray_tpu_torch.get(
                [self._next_aggregator().stack.remote(*g) for g in groups],
                timeout=600)
            steps = 0
            for b in batches:
                self._return_window.extend(b.pop("episode_returns").tolist())
                steps += int(np.prod(b["actions"].shape))
            metrics = self.learner_group.update_shards(batches)
        self._return_window = self._return_window[-100:]
        self.env_steps += steps
        return {
            "episode_return_mean": (float(np.mean(self._return_window))
                                    if self._return_window else 0.0),
            "num_env_steps_sampled": self.env_steps,
            "num_rollouts_aggregated": len(rollout_refs),
            "steps_per_sec": steps / max(time.time() - t0, 1e-6),
            **{k: float(v) for k, v in metrics.items()},
        }

    def get_state(self):
        if self.learner_group is not None:
            state = self.learner_group.get_state()
        else:
            state = self.core.get_state()
        state["env_steps"] = self.env_steps
        return state

    def set_state(self, state):
        self.env_steps = int(state.get("env_steps", 0))
        if self.learner_group is not None:
            self.learner_group.set_state(state)
        else:
            self.core.set_state(state)

    def stop(self):
        if self.learner_group is not None:
            self.learner_group.shutdown()
        kill_all(list(self.runners) + list(self.aggregators))
