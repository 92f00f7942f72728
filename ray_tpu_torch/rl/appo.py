"""APPO: asynchronous PPO: IMPALA's async runner/aggregator architecture
with a PPO clipped-surrogate learner over V-trace-corrected advantages and
a target network. The port of ``ray_tpu/rl/appo.py``.

Reference: rllib/algorithms/appo/appo.py:347 (training_step: IMPALA
sampling + surrogate loss + periodic target-network sync + optional KL
term). V-trace runs on the ONLINE value function and online/behavior
ratios (as in the rllib learner); the TARGET network's role is the
optional KL anchor and a stable policy snapshot. Multi-learner: the core
plugs into LearnerGroup like IMPALA's (each rank's target syncs in
lockstep because update counts advance identically on every rank).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

from ray_tpu_torch.models.actor_critic import to_device, to_numpy
from ray_tpu_torch.rl.impala import (IMPALA, IMPALAConfig, _ImpalaLearnerCore,
                                     _time_major, vtrace_returns)


@dataclass
class APPOConfig(IMPALAConfig):
    clip_param: float = 0.2
    # updates between target-network syncs (reference:
    # appo.py target_network_update_freq, counted here in learner updates)
    target_update_freq: int = 4
    use_kl_loss: bool = False
    kl_coeff: float = 0.2

    @property
    def algo_cls(self):
        return APPO


def appo_loss(model, params, target_params, batch, cfg):
    """APPO's loss on a [T, B] batch: (total, [total, pg_loss, vf_loss,
    entropy, mean_ratio])."""
    logits, values, last_value = _time_major(model, params, batch)
    T, B = batch["actions"].shape
    t_logits_all, _ = model.run(target_params, torch.cat(
        [batch["obs"].reshape((T * B,) + batch["obs"].shape[2:]),
         batch["last_obs"]], dim=0))
    acts = batch["actions"].long()[..., None]
    logp_all = torch.log_softmax(logits, -1)
    logp = logp_all.gather(-1, acts)[..., 0]
    t_logp_all = torch.log_softmax(t_logits_all[: T * B].reshape(T, B, -1),
                                   -1)
    ratio = torch.exp(logp - batch["behavior_logp"])
    vs, pg_adv = vtrace_returns(
        values, last_value, batch["rewards"], batch["dones"], ratio,
        gamma=cfg.gamma, rho_clip=cfg.vtrace_rho_clip,
        c_clip=cfg.vtrace_c_clip)
    adv = (pg_adv - pg_adv.mean()) / (pg_adv.std(correction=0) + 1e-8)
    surr1 = ratio * adv
    surr2 = torch.clamp(ratio, 1 - cfg.clip_param, 1 + cfg.clip_param) * adv
    pg_loss = -torch.minimum(surr1, surr2).mean()
    vf_loss = ((values - vs) ** 2).mean()
    entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
    total = pg_loss + cfg.vf_coef * vf_loss - cfg.entropy_coef * entropy
    if cfg.use_kl_loss:
        kl = (torch.exp(t_logp_all) * (t_logp_all - logp_all)).sum(-1).mean()
        total = total + cfg.kl_coeff * kl
    return total, torch.stack([total, pg_loss, vf_loss, entropy,
                               ratio.mean()])


class _AppoLearnerCore(_ImpalaLearnerCore):
    """APPO loss + target network on the IMPALA learner chassis."""

    metric_keys = ("loss", "pg_loss", "vf_loss", "entropy", "mean_ratio")

    def __init__(self, cfg, obs_dim, n_actions, world_size=1, rank=0,
                 group_name=None, device=None):
        super().__init__(cfg, obs_dim, n_actions, world_size=world_size,
                         rank=rank, group_name=group_name, device=device)
        self.target_params = self._snapshot()
        self.updates_done = 0

    def _snapshot(self):
        return {k: v.detach().clone() for k, v in self.params.items()}

    def loss(self, params, batch):
        return appo_loss(self.model, params, self.target_params, batch,
                         self.cfg)

    def _post_update(self):
        self.updates_done += 1
        if self.updates_done % self.cfg.target_update_freq == 0:
            self.target_params = self._snapshot()

    def get_state(self) -> Dict[str, Any]:
        state = super().get_state()
        state["target_params"] = to_numpy(self.target_params)
        state["updates_done"] = self.updates_done
        return state

    def set_state(self, state: Dict[str, Any]) -> None:
        super().set_state(state)
        target = state.get("target_params")
        self.target_params = (self._snapshot() if target is None
                              else to_device(target, self.device))
        self.updates_done = int(state.get("updates_done", 0))


class APPO(IMPALA):
    """Inherits the async pipeline (runners, aggregators, relaunch loop)
    and the multi-learner path; only the learner core differs."""

    learner_core_cls = _AppoLearnerCore
