"""The RL slice held as a whole: the port's DQN (runners on the port's
numpy CartPole, the replay buffer, the double-Q learner) against the JAX
package's DQN, on the CPU, from the same initial parameters (flax's,
carried across by ``from_jax_params`` / ``from_jax_opt_state``).

DQN's runners are deterministic given the params and the seed (argmax of Q
plus numpy's epsilon draws), so the two packages' rollouts, and so their
replay buffers, are equal; the learners' parameters agree within the fp32
update bound of ``test_torch_rl_parity`` (UPDATE_REL of lr a step).

A JAX cluster and a port cluster run side by side in this process; every
JAX-side call runs on a thread with a timeout (``jax_side``). Nothing here
imports JAX or the JAX package at module level."""

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.models.convert import from_jax_opt_state, from_jax_params

pytest.importorskip("flax")

from test_torch_data import jax_side  # noqa: E402
from test_torch_rl_parity import _assert_params_close, _np  # noqa: E402

T = 120  # seconds, each JAX-side call


@pytest.fixture(scope="module")
def clusters():
    import ray_tpu

    ray_tpu.shutdown()
    ray_tpu.init(num_cpus=4)
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, device="cpu")
    yield
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def _configs(**kw):
    from ray_tpu.rl import DQNConfig as JCfg

    from ray_tpu_torch.rl import DQNConfig as PCfg

    return JCfg(**kw), PCfg(device="cpu", **kw)


def _seed_port(palgo, jalgo):
    """The port's learner takes the JAX learner's params, target and
    optimizer state."""
    ln = palgo.learner
    ln.set_params(from_jax_params(_np(jalgo.params)))
    ln.target_params = {k: v for k, v in from_jax_params(
        _np(jalgo.target_params)).items()}
    ln.opt_state = from_jax_opt_state(_np(jalgo.opt_state))


def test_dqn_update_matches_jax(clusters):
    """Six double-Q updates on prioritized batches (with importance
    weights) from the same params: the loss and TD errors within 1e-4 of
    their scale, the params within the update bound."""
    import jax.numpy as jnp

    jcfg, pcfg = _configs(num_env_runners=1, num_envs_per_runner=1,
                          rollout_length=8, seed=7)
    jalgo = jax_side(jcfg.build, T)
    palgo = pcfg.build()
    try:
        _seed_port(palgo, jalgo)
        rng = np.random.default_rng(3)
        params, target, opt = (jalgo.params, jalgo.target_params,
                               jalgo.opt_state)
        for _ in range(6):
            n = 64
            batch = {"obs": rng.standard_normal((n, 4)).astype(np.float32),
                     "next_obs": rng.standard_normal((n, 4)).astype(
                         np.float32),
                     "actions": rng.integers(0, 2, n).astype(np.int32),
                     "rewards": np.ones(n, np.float32),
                     "dones": (rng.random(n) < 0.2).astype(np.float32),
                     "weights": rng.uniform(0.2, 1, n).astype(np.float32)}
            params, opt, jloss, jtd = jalgo._update(
                params, target, opt, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
            ploss, ptd = palgo.learner.update(batch)
            assert abs(float(ploss) - float(jloss)) <= 1e-4 * max(
                abs(float(jloss)), 1.0)
            np.testing.assert_allclose(ptd.numpy(), np.asarray(jtd),
                                       rtol=1e-4, atol=1e-5)
        _assert_params_close(palgo.learner.params, params, pcfg.lr, 6,
                             "dqn")
    finally:
        palgo.stop()
        jax_side(jalgo.stop, T)


def test_dqn_train_matches_jax(clusters):
    """Five ``train()`` iterations of both packages' DQN (2 runners x 2
    CartPoles, prioritized replay, learning from the second iteration, a
    target sync): the same results per iteration (returns, epsilon, env
    steps, buffer size), replay buffers with equal transitions, priorities
    within fp32 TD noise, and params within the update bound."""
    kw = dict(num_env_runners=2, num_envs_per_runner=2, rollout_length=32,
              learning_starts=256, updates_per_iteration=8,
              train_batch_size=32, target_update_freq=200, seed=3)
    jcfg, pcfg = _configs(**kw)
    jalgo = jax_side(jcfg.build, T)
    palgo = pcfg.build()
    try:
        _seed_port(palgo, jalgo)
        for it in range(5):
            rj = jax_side(jalgo.train, T)
            rp = palgo.train()
            for k in ("episode_return_mean", "epsilon",
                      "num_env_steps_sampled", "buffer_size"):
                assert rp[k] == rj[k], (it, k, rp[k], rj[k])
            assert abs(rp["loss"] - rj["loss"]) <= 1e-4 * max(
                abs(rj["loss"]), 1.0), (it, rp["loss"], rj["loss"])
        sj, sp = jalgo.buffer.state(), palgo.buffer.state()
        assert sj["size"] == sp["size"] == 5 * 2 * 2 * 32
        for k in sj["storage"]:
            np.testing.assert_array_equal(sp["storage"][k],
                                          sj["storage"][k])
        np.testing.assert_allclose(sp["prios"], sj["prios"], rtol=1e-4)
        updates = 4 * kw["updates_per_iteration"]  # from iteration 2 on
        _assert_params_close(palgo.learner.params, jalgo.params, pcfg.lr,
                             updates, "dqn params")
        _assert_params_close(palgo.learner.target_params,
                             jalgo.target_params, pcfg.lr, updates,
                             "dqn target")
        assert palgo.learner.opt_state.count == updates
        assert not any(ray_tpu_torch.get(
            [r.cuda_initialized.remote() for r in palgo.runners],
            timeout=60))
    finally:
        palgo.stop()
        jax_side(jalgo.stop, T)
