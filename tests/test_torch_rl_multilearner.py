"""Mirror of ``tests/test_rl_multilearner.py`` and of
``tests/test_quant_comms.py::test_ppo_int8_grad_sync_loss_parity`` on the
port (``ray_tpu_torch.rl``), on the CPU: N=2 learners syncing gradients
over a gloo collective group (the JAX package's ``backend="cpu"`` tier)
must produce the same parameters as N=1 on the same batch stream, stay
bit-equal to each other (fp32 and int8 wires), and still learn end to end.
Same configs, seeds and thresholds as the JAX tests; learners on the CPU
(``device="cpu"``), actors of a port cluster."""

import dataclasses

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.rl import PPOConfig
from ray_tpu_torch.rl.ppo import PPOLearner


@pytest.fixture(scope="module")
def cluster():
    # the learners' nets are tiny: one torch thread runs them fastest, and
    # keeps parallel test workers from contending for the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=8, device="cpu")
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()
    torch.set_num_threads(threads)


def _synthetic_batch(rng, n, obs_dim, n_actions):
    return {
        "obs": rng.standard_normal((n, obs_dim)).astype(np.float32),
        "actions": rng.integers(0, n_actions, n).astype(np.int32),
        "logp": (-np.log(n_actions)
                 + 0.1 * rng.standard_normal(n)).astype(np.float32),
        "advantages": rng.standard_normal(n).astype(np.float32),
        "returns": rng.standard_normal(n).astype(np.float32),
    }


def _leaves(params):
    return [np.asarray(params[k]) for k in sorted(params)]


def _make_group(cfg, obs_dim=4, n_actions=2):
    from ray_tpu_torch.rl.learner_group import LearnerGroup

    def factory(rank, world_size, group_name, _cfg=cfg):
        return PPOLearner(_cfg, obs_dim, n_actions, world_size=world_size,
                          rank=rank, group_name=group_name)

    return LearnerGroup(factory, num_learners=2, device=cfg.device)


def test_two_learners_match_single(cluster):
    """The north-star contract: sharded gradients allreduced across 2
    learners == the single-learner gradient, so params stay identical (to
    float tolerance) across a stream of updates."""
    obs_dim, n_actions = 4, 2
    cfg = PPOConfig(env="CartPole-v1", epochs=2, num_minibatches=4, seed=3,
                    device="cpu")
    single = PPOLearner(cfg, obs_dim, n_actions)
    group = _make_group(cfg, obs_dim, n_actions)
    try:
        rng = np.random.default_rng(0)
        for step in range(3):
            batch = _synthetic_batch(rng, 256 + 32 * step, obs_dim, n_actions)
            m1 = single.update(dict(batch))
            m2 = group.update(batch)
            assert np.isfinite(m1["loss"]) and np.isfinite(m2["loss"])
        flat1 = _leaves(single.get_params())
        flat2 = _leaves(group.get_params())
        assert len(flat1) == len(flat2)
        for a, b in zip(flat1, flat2):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)
        # and the two group ranks agree bitwise-identically with each other
        params_all = group.foreach_learner("get_params")
        for a, b in zip(_leaves(params_all[0]), _leaves(params_all[1])):
            np.testing.assert_array_equal(a, b)
    finally:
        group.shutdown()


def test_ppo_two_learners_improves(cluster):
    algo = PPOConfig(
        env="CartPole-v1",
        num_env_runners=2,
        num_envs_per_runner=4,
        rollout_length=128,
        epochs=8,
        num_learners=2,
        seed=1,
        device="cpu",
    ).build()
    returns = []
    for _ in range(20):
        m = algo.train()
        returns.append(m["episode_return_mean"])
    algo.stop()
    assert max(returns) > 60, returns


def test_impala_two_learners_improves(cluster):
    from ray_tpu_torch.rl import IMPALAConfig

    # same data scale as test_impala_cartpole_improves, split over 2 learners
    algo = IMPALAConfig(
        env="CartPole-v1",
        num_env_runners=2,
        num_envs_per_runner=4,
        rollout_length=64,
        num_rollouts_per_update=2,
        num_learners=2,
        seed=1,
        device="cpu",
    ).build()
    returns = []
    for _ in range(90):
        m = algo.train()
        returns.append(m["episode_return_mean"])
    algo.stop()
    assert max(returns) > 60, returns


def test_appo_two_learners_smoke(cluster):
    from ray_tpu_torch.rl import APPOConfig

    algo = APPOConfig(
        env="CartPole-v1",
        num_env_runners=2,
        num_envs_per_runner=2,
        rollout_length=32,
        num_learners=2,
        target_update_freq=2,
        seed=2,
        device="cpu",
    ).build()
    for _ in range(4):
        m = algo.train()
        assert np.isfinite(m["loss"])
    state = algo.get_state()
    assert "target_params" in state
    # ranks stayed in lockstep: both report the same update counter
    counts = algo.learner_group.foreach_learner("get_state")
    assert counts[0]["updates_done"] == counts[1]["updates_done"] == 4
    algo.stop()


def test_ppo_multilearner_checkpoint_roundtrip(cluster, tmp_path):
    algo = PPOConfig(env="CartPole-v1", num_env_runners=1,
                     num_envs_per_runner=2, rollout_length=32, epochs=1,
                     num_learners=2, seed=5, device="cpu").build()
    algo.train()
    path = algo.save_checkpoint(str(tmp_path))
    state = algo.get_state()
    algo2 = PPOConfig(env="CartPole-v1", num_env_runners=1,
                      num_envs_per_runner=2, rollout_length=32, epochs=1,
                      num_learners=2, seed=5, device="cpu").build()
    algo2.restore_from_checkpoint(path)
    s2 = algo2.get_state()
    for a, b in zip(_leaves(state["params"]), _leaves(s2["params"])):
        np.testing.assert_array_equal(a, b)
    algo.stop()
    algo2.stop()


def test_ppo_int8_grad_sync_loss_parity(cluster):
    """The convergence contract of the quantized tier: a 2-learner PPO
    stream with int8+error-feedback grad sync stays within 2% of the fp32
    run's loss, with ranks bitwise-identical to each other."""
    obs_dim, n_actions = 4, 2
    base_cfg = PPOConfig(env="CartPole-v1", epochs=2, num_minibatches=4,
                         seed=3, device="cpu")
    g_fp32 = _make_group(base_cfg)
    g_int8 = _make_group(dataclasses.replace(base_cfg,
                                             grad_compression="int8"))
    try:
        rng = np.random.default_rng(0)
        losses = {"fp32": [], "int8": []}
        for step in range(6):
            batch = _synthetic_batch(rng, 256, obs_dim, n_actions)
            losses["fp32"].append(g_fp32.update(dict(batch))["loss"])
            losses["int8"].append(g_int8.update(dict(batch))["loss"])
        # loss parity within 2% at every step of the stream
        for lf, lq in zip(losses["fp32"], losses["int8"]):
            assert abs(lq - lf) <= 0.02 * max(abs(lf), 1e-3), (lf, lq)
        # quantized ranks still agree with each other bitwise
        params = g_int8.foreach_learner("get_params")
        for a, b in zip(_leaves(params[0]), _leaves(params[1])):
            np.testing.assert_array_equal(a, b)
        # and the parameter trees end close to the fp32 group's
        for a, b in zip(_leaves(g_fp32.get_params()),
                        _leaves(g_int8.get_params())):
            # relative on real-magnitude leaves, absolute floor for
            # near-zero bias leaves (whole-tree scale ~1e-1)
            assert np.abs(a - b).max() < 0.05 * np.abs(a).max() + 2e-3
    finally:
        g_fp32.shutdown()
        g_int8.shutdown()
