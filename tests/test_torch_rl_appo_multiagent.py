"""Mirror of ``tests/test_rl_appo_multiagent.py`` on the port
(``ray_tpu_torch.rl``), on the CPU: APPO and the multi-agent env runner
learn (reference: rllib/algorithms/appo/appo.py:347,
rllib/env/multi_agent_env_runner.py; rllib treats tuned_examples
run-to-reward as CI assertions). Same configs, seeds and thresholds as the
JAX tests; learners on the CPU (``device="cpu"``)."""

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.rl import APPOConfig, MultiAgentPPOConfig


@pytest.fixture(scope="module")
def cluster():
    # the learners' nets are tiny: one torch thread runs them fastest, and
    # keeps parallel test workers from contending for the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=6, device="cpu")
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()
    torch.set_num_threads(threads)


def test_appo_learns_cartpole(cluster):
    algo = APPOConfig(
        env="CartPole-v1", num_env_runners=2, num_envs_per_runner=4,
        rollout_length=64, num_rollouts_per_update=2, lr=3e-3,
        entropy_coef=0.01, target_update_freq=4, seed=0,
        device="cpu").build()
    best = 0.0
    try:
        # same bar as the sibling IMPALA learning test (>60 within 90
        # iterations): the surrogate must demonstrably improve the policy
        for _ in range(130):
            result = algo.train()
            best = max(best, result["episode_return_mean"])
            if best > 60.0:
                break
        assert best > 60.0, f"APPO failed to learn: best={best}"
        state = algo.get_state()
        assert "target_params" in state and "params" in state
    finally:
        algo.stop()


def test_multi_agent_shared_policy_learns_rendezvous(cluster):
    algo = MultiAgentPPOConfig(
        env="rendezvous", num_env_runners=2, rollout_length=128,
        lr=5e-3, epochs=4, seed=0, device="cpu").build()
    best = 0.0
    try:
        for _ in range(40):
            result = algo.train()
            best = max(best, result["episode_return_mean"])
            if best >= 10.0:  # horizon 16; random play scores ~3
                break
        assert best >= 10.0, f"multi-agent PPO failed to learn: best={best}"
    finally:
        algo.stop()


def test_multi_agent_per_agent_policies(cluster):
    """Distinct policies per agent train independently and still learn."""
    algo = MultiAgentPPOConfig(
        env="rendezvous", num_env_runners=2, rollout_length=128,
        policy_mapping={"a0": "p0", "a1": "p1"},
        lr=5e-3, epochs=4, seed=1, device="cpu").build()
    try:
        assert sorted(algo.policies) == ["p0", "p1"]
        best = 0.0
        for _ in range(40):
            result = algo.train()
            assert "loss_p0" in result and "loss_p1" in result
            best = max(best, result["episode_return_mean"])
            if best >= 10.0:
                break
        assert best >= 10.0, f"per-agent policies failed: best={best}"
    finally:
        algo.stop()
