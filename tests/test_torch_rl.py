"""Mirror of ``tests/test_rl.py`` on the port (``ray_tpu_torch.rl``), on the
CPU: PPO on the port's CartPole improves (reference tier: rllib
tuned_examples run-to-reward, shrunk for CI). Same config, seed and
threshold as the JAX test; the learner runs on the CPU (``device="cpu"``),
the env runners are actors of a port cluster."""

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.rl import PPO, PPOConfig


@pytest.fixture(scope="module")
def cluster():
    # the learners' nets are tiny: one torch thread runs them fastest, and
    # keeps parallel test workers from contending for the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, device="cpu")
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()
    torch.set_num_threads(threads)


def test_ppo_cartpole_improves(cluster):
    algo = PPOConfig(
        env="CartPole-v1",
        num_env_runners=2,
        num_envs_per_runner=4,
        rollout_length=128,
        epochs=8,
        seed=1,
        device="cpu",
    ).build()
    first = algo.train()
    assert first["num_env_steps_sampled"] == 2 * 4 * 128
    returns = []
    for _ in range(20):
        m = algo.train()
        returns.append(m["episode_return_mean"])
    algo.stop()
    # CartPole random play ~ 20; PPO must clearly improve within ~20k steps
    assert max(returns) > 60, returns
