"""Mirror of ``tests/test_rl_algorithms.py`` on the port
(``ray_tpu_torch.rl``), on the CPU: the replay buffers, DQN and IMPALA
(reference tier: rllib tuned_examples run-to-reward, shrunk for CI). Same
configs, seeds and thresholds as the JAX tests; learners on the CPU
(``device="cpu"``), env runners and aggregators actors of a port cluster."""

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.rl import (DQN, IMPALA, DQNConfig, IMPALAConfig,
                        PrioritizedReplayBuffer, ReplayBuffer)


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


def test_replay_buffer_ring():
    buf = ReplayBuffer(capacity=100, seed=0)
    for i in range(12):
        buf.add_batch({"x": np.full(10, i, np.float32)})
    assert len(buf) == 100
    s = buf.sample(64)
    assert s["x"].shape == (64,)
    # oldest chunk (i=0,1) was overwritten by i=10,11
    assert s["x"].min() >= 2.0


def test_prioritized_buffer_biases_sampling():
    buf = PrioritizedReplayBuffer(capacity=128, alpha=1.0, seed=0)
    buf.add_batch({"x": np.arange(128, dtype=np.float32)})
    idx = np.arange(128)
    # give item 7 overwhelming priority
    td = np.full(128, 1e-4)
    td[7] = 100.0
    buf.update_priorities(idx, td)
    s = buf.sample(256)
    frac = float((s["x"] == 7.0).mean())
    assert frac > 0.5, frac
    assert "weights" in s and s["weights"].shape == (256,)
    # weights for the over-sampled item are the smallest
    assert s["weights"].min() == pytest.approx(
        s["weights"][s["x"] == 7.0].min())


def test_dqn_cartpole_improves(cluster):
    algo = DQNConfig(
        env="CartPole-v1", num_env_runners=2, num_envs_per_runner=2,
        rollout_length=64, learning_starts=400, updates_per_iteration=48,
        epsilon_decay_steps=4000, target_update_freq=300, seed=3,
        device="cpu",
    ).build()
    returns = []
    for _ in range(55):
        m = algo.train()
        returns.append(m["episode_return_mean"])
    algo.stop()
    assert max(returns) > 60, returns


def test_dqn_checkpoint_roundtrip(cluster, tmp_path):
    cfg = DQNConfig(num_env_runners=1, num_envs_per_runner=1,
                    rollout_length=8, learning_starts=8,
                    updates_per_iteration=2, seed=0, device="cpu")
    algo = cfg.build()
    algo.train()
    ckpt = algo.save_checkpoint(str(tmp_path / "ck"))
    algo2 = cfg.build()
    algo2.restore_from_checkpoint(ckpt)
    a = algo.get_state()["params"]
    b = algo2.get_state()["params"]
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k])
    assert algo2.iteration == 1
    algo.stop()
    algo2.stop()


def test_impala_cartpole_improves(cluster):
    algo = IMPALAConfig(
        env="CartPole-v1", num_env_runners=2, num_envs_per_runner=4,
        rollout_length=64, num_rollouts_per_update=2, lr=1e-3,
        entropy_coef=0.01, seed=1, device="cpu",
    ).build()
    returns = []
    for _ in range(90):
        m = algo.train()
        returns.append(m["episode_return_mean"])
    algo.stop()
    # async off-policy lag is corrected by v-trace; must still learn
    assert max(returns) > 60, returns


def test_impala_rho_sane(cluster):
    algo = IMPALAConfig(num_env_runners=1, num_envs_per_runner=2,
                        rollout_length=16, num_rollouts_per_update=1,
                        seed=0, device="cpu").build()
    m = algo.train()
    # first update: behavior == target policy, so rho ~= 1
    assert m["mean_rho"] == pytest.approx(1.0, abs=0.05)
    algo.stop()
