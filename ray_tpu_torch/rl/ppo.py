"""PPO: env-runner actors sampling + a torch learner (GAE, clipped
objective): the port of ``ray_tpu/rl/ppo.py``.

Reference: rllib: EnvRunnerGroup (env/env_runner_group.py:70) of actors
stepping vector envs, Learner/LearnerGroup (core/learner/learner.py:112)
doing the update, Algorithm.train() orchestrating one iteration
(algorithms/ppo/ppo.py:390 training_step). The learner runs on the card
(or the CPU where the config says so); the env runners step the port's
numpy environments and sample their policy on the CPU, and never touch
CUDA. Multi-learner gradient sync goes through ``learner_group.py``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rl.algorithm import (Algorithm, AlgorithmConfig,
                                        config_blob, ensure_runtime, kill_all,
                                        load_config)
from ray_tpu_torch.rl.learner import Learner, batch_to, grad_dict
from ray_tpu_torch.rl.optim import Adam


@dataclass
class PPOConfig(AlgorithmConfig):
    num_env_runners: int = 2
    num_envs_per_runner: int = 4
    rollout_length: int = 128
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    lr: float = 1e-3
    entropy_coef: float = 0.005
    vf_coef: float = 0.5
    epochs: int = 8
    num_minibatches: int = 4
    hidden: tuple = (64, 64)
    # multi-learner gradient sync (reference: learner_group.py:101
    # num_learners); backend "cpu" = gloo, "xla" = NCCL (a card a rank)
    num_learners: int = 1
    learner_backend: str = "cpu"
    # wire compression of the gradient allreduce (collective/quant.py):
    # None = fp32, "int8"/"fp8" block-quantized with error feedback,
    # "bf16" plain narrowing. Advantage-normalization stats stay fp32.
    grad_compression: Optional[str] = None

    @property
    def algo_cls(self):
        return PPO


def categorical(logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """One draw a row of the softmax of ``logits`` by the Gumbel-max trick
    (``jax.random.categorical``'s), from ``gen``."""
    u = torch.rand(logits.shape, generator=gen, dtype=logits.dtype)
    u = u.clamp_(min=torch.finfo(logits.dtype).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


class PolicyRunner:
    """What the env runners share: a vector env on the port's numpy envs
    (seeded ``seed + 1000 * worker_index``), a CPU copy of the policy net,
    one torch thread, and the episode returns. Sampling draws from a
    ``torch.Generator`` seeded ``seed_base`` (plus one a rollout)."""

    def _setup_runner(self, config_blob_: bytes, worker_index: int,
                      seed_mult: int = 7919) -> None:
        from ray_tpu_torch.rl.env_runner import EpisodeTracker, make_vec_env

        torch.set_num_threads(1)
        self.cfg = load_config(config_blob_)
        # same-step autoreset (via make_vec_env): the obs after a done is the
        # next episode's reset obs, so every stored transition is a real one
        self.envs, self.obs = make_vec_env(
            self.cfg.env, self.cfg.num_envs_per_runner,
            self.cfg.seed + worker_index * 1000)
        self.net = None
        self._rng_seed = self.cfg.seed * seed_mult + worker_index
        self.episodes = EpisodeTracker(self.cfg.num_envs_per_runner)

    def _next_generator(self) -> torch.Generator:
        gen = torch.Generator().manual_seed(self._rng_seed)
        self._rng_seed += 1
        return gen

    def _policy(self, params) -> torch.nn.Module:
        if self.net is None:
            from ray_tpu_torch.models.actor_critic import ActorCritic

            obs_dim = int(np.prod(self.envs.single_observation_space.shape))
            self.net = ActorCritic(obs_dim,
                                   int(self.envs.single_action_space.n),
                                   self.cfg.hidden)
        self.net.load_params(params)
        return self.net

    def cuda_initialized(self) -> bool:
        """Whether this process ever initialised CUDA (it must not)."""
        return torch.cuda.is_initialized()


@ray_tpu_torch.remote(num_cpus=1)
class EnvRunner(PolicyRunner):
    """Vectorized env sampler (reference: env/single_agent_env_runner.py:68)."""

    def __init__(self, config_blob_: bytes, worker_index: int):
        self._setup_runner(config_blob_, worker_index)

    @torch.no_grad()
    def sample(self, params) -> Dict[str, np.ndarray]:
        """Collect rollout_length steps from each vector env."""
        net = self._policy(params)
        gen = self._next_generator()
        T, N = self.cfg.rollout_length, self.cfg.num_envs_per_runner
        obs_buf = np.zeros((T, N) + self.obs.shape[1:], np.float32)
        act_buf = np.zeros((T, N), np.int32)
        logp_buf = np.zeros((T, N), np.float32)
        val_buf = np.zeros((T + 1, N), np.float32)
        rew_buf = np.zeros((T, N), np.float32)
        done_buf = np.zeros((T, N), np.float32)
        for t in range(T):
            logits, value = net(torch.as_tensor(self.obs, dtype=torch.float32))
            action = categorical(logits, gen)
            logp = torch.log_softmax(logits, -1).gather(
                -1, action[:, None])[:, 0]
            action = action.numpy()
            obs_buf[t] = self.obs
            act_buf[t] = action
            logp_buf[t] = logp.numpy()
            val_buf[t] = value.numpy()
            self.obs, rew, term, trunc, _ = self.envs.step(action)
            done = np.logical_or(term, trunc)
            rew_buf[t] = rew
            done_buf[t] = done
            self.episodes.step(rew, done)
        _, last_value = net(torch.as_tensor(self.obs, dtype=torch.float32))
        val_buf[T] = last_value.numpy()
        adv = gae(rew_buf, val_buf, done_buf, self.cfg.gamma,
                  self.cfg.gae_lambda)
        returns = adv + val_buf[:T]
        flat = lambda a: a.reshape((-1,) + a.shape[2:])  # noqa: E731
        return {
            "obs": flat(obs_buf),
            "actions": flat(act_buf),
            "logp": flat(logp_buf),
            "advantages": flat(adv),
            "returns": flat(returns),
            "episode_returns": self.episodes.pop(),
        }


def gae(rew: np.ndarray, val: np.ndarray, done: np.ndarray, gamma: float,
        lam: float) -> np.ndarray:
    """GAE over [T, N] rewards and dones with [T + 1, N] values
    (reference: rllib postprocessing/advantages), as the JAX runner
    computes it in numpy."""
    T, N = rew.shape
    adv = np.zeros((T, N), np.float32)
    lastgae = np.zeros(N, np.float32)
    for t in reversed(range(T)):
        nonterminal = 1.0 - done[t]
        delta = rew[t] + gamma * val[t + 1] * nonterminal - val[t]
        lastgae = delta + gamma * lam * nonterminal * lastgae
        adv[t] = lastgae
    return adv


def _pg_terms(model, params, b):
    """(per-sample probability ratios, values, per-sample entropy)."""
    logits, values = model.run(params, b["obs"])
    logp_all = torch.log_softmax(logits, -1)
    logp = logp_all.gather(-1, b["actions"].long()[:, None])[:, 0]
    ratio = torch.exp(logp - b["logp"])
    entropy = -(torch.exp(logp_all) * logp_all).sum(-1)
    return ratio, values, entropy


class PPOLearner(Learner):
    """The PPO update on one device.

    Single-process by default; with ``world_size > 1`` it is rank ``rank``
    of a LearnerGroup (learner_group.py): every rank sees the full batch,
    derives the SAME seeded minibatch permutation, computes gradients on
    its 1/world slice of each minibatch as global-denominator
    contributions, and allreduce-SUMs them, so the reduced gradient (and
    the advantage-normalization statistics, synced the same way) equal
    the single-learner computation and parameters never diverge.
    Reference: rllib/core/learner/torch/torch_learner.py:524-547."""

    def __init__(self, cfg: PPOConfig, obs_dim: int, n_actions: int,
                 world_size: int = 1, rank: int = 0,
                 group_name: Optional[str] = None, device=None):
        from ray_tpu_torch.models.actor_critic import ActorCritic

        self._setup(cfg, ActorCritic(obs_dim, n_actions, cfg.hidden),
                    cfg.seed, Adam(cfg.lr, clip=0.5), device)
        self.world_size = world_size
        self.rank = rank
        self.group_name = group_name
        # quantized grad sync: per-learner error-feedback residual so the
        # int8/fp8 wire stays unbiased across updates (quant.py)
        self._grad_compression = None
        self._grad_ef = None
        if world_size > 1:
            from ray_tpu_torch.collective import quant

            codec = quant.resolve_codec(getattr(cfg, "grad_compression",
                                                None))
            if codec is not None:
                backend = getattr(cfg, "learner_backend", "cpu")
                if backend != "cpu":
                    raise ValueError(
                        f"grad_compression requires "
                        f"learner_backend='cpu' (got {backend!r})")
                self._grad_compression = codec
                self._grad_ef = quant.ErrorFeedback(codec)

    def loss(self, params, b):
        cfg = self.cfg
        ratio, values, entropy = _pg_terms(self.model, params, b)
        adv = b["advantages"]
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        pg1 = ratio * adv
        pg2 = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
        pg_loss = -torch.minimum(pg1, pg2).mean()
        vf_loss = ((values - b["returns"]) ** 2).mean()
        ent = entropy.mean()
        total = pg_loss + cfg.vf_coef * vf_loss - cfg.entropy_coef * ent
        return total, torch.stack([total, pg_loss, vf_loss, ent])

    def _minibatches(self, n: int) -> List[np.ndarray]:
        """The minibatches' sample indices, in the JAX learner's order:
        ``default_rng(seed)`` shuffles one index array in place each
        epoch, cut into ``n // num_minibatches`` slices."""
        cfg = self.cfg
        idx = np.arange(n)
        rng = np.random.default_rng(cfg.seed)
        mb = max(1, n // cfg.num_minibatches)
        out = []
        for _ in range(cfg.epochs):
            rng.shuffle(idx)
            out += [idx[start:start + mb].copy() for start in range(0, n, mb)]
        return out

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        if self.world_size > 1:
            return self._update_distributed(batch)
        b = batch_to(batch, self.device)
        sels = self._minibatches(len(batch["obs"]))
        # every minibatch's indices cross to the device at once
        flat = torch.as_tensor(np.concatenate(sels)).to(self.device)
        pos, mvec = 0, None
        for sel in sels:
            idx = flat[pos:pos + len(sel)]
            pos += len(sel)
            total, mvec = self.loss(self.params, {k: v[idx]
                                                  for k, v in b.items()})
            self.opt.step(self.params, grad_dict(total, self.params),
                          self.opt_state)
        m = mvec.detach().cpu().tolist()
        return dict(zip(("loss", "pg_loss", "vf_loss", "entropy"), m))

    def loss_shard(self, params, b, w, adv_mean, adv_std, denom):
        """The same loss with explicit per-sample weights and externally
        supplied (globally synced) advantage statistics."""
        cfg = self.cfg
        ratio, values, entropy = _pg_terms(self.model, params, b)
        adv = (b["advantages"] - adv_mean) / (adv_std + 1e-8)
        pg1 = ratio * adv
        pg2 = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
        pg_loss = -(w * torch.minimum(pg1, pg2)).sum() / denom
        vf_loss = (w * (values - b["returns"]) ** 2).sum() / denom
        ent = (w * entropy).sum() / denom
        total = pg_loss + cfg.vf_coef * vf_loss - cfg.entropy_coef * ent
        return total, torch.stack([total, pg_loss, vf_loss, ent])

    def _update_distributed(self, batch: Dict[str, np.ndarray]
                            ) -> Dict[str, float]:
        """Rank's share of one LearnerGroup update (see class docstring).

        Two collectives per minibatch: a 3-float advantage-stats allreduce
        (global weighted mean/var: normalization must NOT use shard-local
        statistics or ranks compute different losses), then the flat
        gradient+metrics allreduce. Minibatches are padded to a multiple of
        world_size with zero-weight repeats, as the JAX learner pads them
        for jit's static shapes."""
        from ray_tpu_torch import collective as col
        from ray_tpu_torch.rl.learner_group import group_device, sync_gradients

        W = self.world_size
        b = batch_to(batch, self.device)
        gdev = group_device(self.group_name)
        mvec = np.zeros(4, np.float32)
        for sel in self._minibatches(len(batch["obs"])):
            shard = -(-len(sel) // W)
            pad = shard * W - len(sel)
            w = np.ones(len(sel), np.float32)
            if pad:
                sel = np.concatenate([sel, np.repeat(sel[-1], pad)])
                w = np.concatenate([w, np.zeros(pad, np.float32)])
            lo = self.rank * shard
            msel = torch.as_tensor(sel[lo:lo + shard]).to(self.device)
            mw = torch.as_tensor(w[lo:lo + shard]).to(self.device)
            mb = {k: v[msel] for k, v in b.items()}
            adv = mb["advantages"]
            stats = torch.stack([mw.sum(), (mw * adv).sum(),
                                 (mw * adv * adv).sum()]).detach()
            stats = col.allreduce(stats.to(gdev), group_name=self.group_name)
            stats = stats.cpu().tolist()
            wsum = float(stats[0])
            mean = float(stats[1]) / wsum
            std = max(float(stats[2]) / wsum - mean * mean, 0.0) ** 0.5
            total, scalars = self.loss_shard(self.params, mb, mw, mean, std,
                                             wsum)
            grads, mvec = sync_gradients(
                grad_dict(total, self.params), scalars.detach(),
                self.group_name, compression=self._grad_compression,
                error_feedback=self._grad_ef)
            self.opt.step(self.params, grads, self.opt_state)
        return {"loss": float(mvec[0]), "pg_loss": float(mvec[1]),
                "vf_loss": float(mvec[2]), "entropy": float(mvec[3])}


def probe_env(name: str):
    """(obs_dim, the action space) of the named env."""
    from ray_tpu_torch.rl import envs

    probe = envs.make(name)
    obs_dim = int(np.prod(probe.observation_space.shape))
    space = probe.action_space
    probe.close()
    return obs_dim, space


class PPO(Algorithm):
    """The PPO algorithm (reference: Algorithm.step at algorithm.py:1189)."""

    def __init__(self, cfg: PPOConfig):
        from ray_tpu_torch.utils import resolve_device

        super().__init__(cfg)
        self.cfg = cfg
        ensure_runtime(resolve_device(cfg.device))
        obs_dim, space = probe_env(cfg.env)
        n_actions = int(space.n)
        self.learner_group = None
        if cfg.num_learners > 1:
            from ray_tpu_torch.rl.learner_group import LearnerGroup

            def factory(rank, world_size, group_name,
                        _cfg=cfg, _obs=obs_dim, _na=n_actions):
                return PPOLearner(_cfg, _obs, _na, world_size=world_size,
                                  rank=rank, group_name=group_name)

            self.learner_group = LearnerGroup(
                factory, cfg.num_learners, backend=cfg.learner_backend,
                device=cfg.device)
            self.learner = None
        else:
            self.learner = PPOLearner(cfg, obs_dim, n_actions)
        blob = config_blob(cfg)
        self.runners = [EnvRunner.remote(blob, i)
                        for i in range(cfg.num_env_runners)]
        self._return_window: List[float] = []

    def get_params(self) -> Dict[str, np.ndarray]:
        if self.learner_group is not None:
            return self.learner_group.get_params()
        return self.learner.get_params()

    def training_step(self) -> Dict[str, Any]:
        """One iteration: parallel sampling -> PPO update -> weight sync."""
        t0 = time.time()
        params_np = self.get_params()
        sample_refs = [r.sample.remote(params_np) for r in self.runners]
        rollouts = ray_tpu_torch.get(sample_refs, timeout=600)
        batch = {
            k: np.concatenate([r[k] for r in rollouts])
            for k in rollouts[0]
        }
        t1 = time.time()
        if self.learner_group is not None:
            metrics = self.learner_group.update(batch)
        else:
            metrics = self.learner.update(batch)
        self._return_window.extend(batch["episode_returns"].tolist())
        self._return_window = self._return_window[-100:]
        steps = len(batch["obs"])
        t2 = time.time()
        return {
            "episode_return_mean": (float(np.mean(self._return_window))
                                    if self._return_window else 0.0),
            "num_env_steps_sampled": steps,
            "steps_per_sec": steps / max(t2 - t0, 1e-6),
            "sample_s": t1 - t0,
            "update_s": t2 - t1,
            **metrics,
        }

    def get_state(self):
        if self.learner_group is not None:
            return self.learner_group.get_state()
        return self.learner.get_state()

    def set_state(self, state):
        if self.learner_group is not None:
            self.learner_group.set_state(state)
            return
        self.learner.set_state(state)

    def stop(self):
        if self.learner_group is not None:
            self.learner_group.shutdown()
        kill_all(self.runners)
