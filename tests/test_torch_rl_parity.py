"""The port's RL library (``ray_tpu_torch/rl``, ``models/actor_critic.py``)
against the JAX package's, on the CPU, piece by piece, from the same seeded
inputs and the same parameters (flax's init, carried across by
``from_jax_params`` / ``from_jax_opt_state``):

- the numpy CartPole and Pendulum and the SAME_STEP vector wrapper against
  gymnasium, bit for bit (reset, 600 seeded steps, autoreset, final_obs);
- each net's forward against flax (fp32, FWD_TOL), and the port's init laws;
- Adam and the global-norm clip against optax (ADAM_TOL);
- GAE (through both PPO runners on a scripted env), V-trace and the APPO
  loss against the JAX functions (FWD_TOL);
- the PPO, IMPALA, SAC (fed the JAX key's noise), BC and MARWIL updates
  against the JAX learners on one batch (UPDATE_TOL);
- the replay buffers' draws (equal).

No cluster is needed: learners and runners are built in-process. JAX and
flax are imported inside the tests only."""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("flax")

from ray_tpu_torch.models import actor_critic as pac  # noqa: E402
from ray_tpu_torch.models.convert import (from_jax_opt_state,  # noqa: E402
                                          from_jax_params)
from ray_tpu_torch.rl import envs as penvs  # noqa: E402

# Forward passes: fp32 sums of the same products in other orders; the nets'
# outputs are O(1), so 1e-5 absolute and relative covers a few ulps of the
# largest partial sums.
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
# Adam from the same gradients: the same algebra, op for op, in fp32; the
# square root and divisions round within an ulp, 1e-6 of a step.
ADAM_TOL = dict(rtol=1e-6, atol=1e-7)
# An update from the same params and batch: the gradients differ by fp32
# summation order (relative ~1e-6); Adam's normalised step turns that into
# at most ~1e-6 of lr a step where a gradient is not near zero, and a
# gradient within fp32 noise of zero can take any step in (-lr, lr) in
# either package. The bound is 1e-3 of lr a step, summed over the steps,
# on the largest gap of any leaf.
UPDATE_REL = 1e-3


def _np(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def _assert_params_close(got, want_flax, lr, steps, what):
    want = from_jax_params(_np(want_flax))
    assert set(got) == set(want), (what, sorted(got), sorted(want))
    bound = UPDATE_REL * lr * steps
    gaps = {k: float((torch.as_tensor(np.asarray(got[k].detach()))
                      - want[k]).abs().max()) for k in want}
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= bound, (what, worst, gaps[worst], bound)
    return gaps


# ---------------------------------------------------------------------------
# environments against gymnasium
# ---------------------------------------------------------------------------


def _actions(name, rng, n):
    if name == "CartPole-v1":
        return rng.integers(0, 2, n)
    return rng.uniform(-2.5, 2.5, (n, 1)).astype(np.float32)


@pytest.mark.parametrize("name", ["CartPole-v1", "Pendulum-v1"])
def test_env_matches_gymnasium_bit_for_bit(name):
    """One env behind its TimeLimit: reset at two seeds and 600 seeded
    actions, through terminations (reset without a seed, as the vector
    wrapper does) and the time limit: observations, rewards, flags equal."""
    gym = pytest.importorskip("gymnasium")
    g, p = gym.make(name), penvs.make(name)
    assert p.action_space.shape == g.action_space.shape
    assert p.observation_space.shape == g.observation_space.shape
    np.testing.assert_array_equal(p.observation_space.low,
                                  g.observation_space.low)
    np.testing.assert_array_equal(p.observation_space.high,
                                  g.observation_space.high)
    if name == "CartPole-v1":
        assert p.action_space.n == g.action_space.n
    else:
        np.testing.assert_array_equal(p.action_space.low, g.action_space.low)
        np.testing.assert_array_equal(p.action_space.high,
                                      g.action_space.high)
    for seed in (0, 7):
        og, _ = g.reset(seed=seed)
        op, _ = p.reset(seed=seed)
        assert og.dtype == op.dtype and og.tobytes() == op.tobytes()
        rng = np.random.default_rng(seed)
        ends = 0
        for a in _actions(name, rng, 600):
            rg, rp = g.step(a), p.step(a)
            assert rg[0].tobytes() == rp[0].tobytes()
            assert rg[1] == rp[1] and type(rg[2]) is type(rp[2])
            assert rg[2:4] == rp[2:4]
            if rg[2] or rg[3]:
                ends += 1
                og, _ = g.reset()
                op, _ = p.reset()
                assert og.tobytes() == op.tobytes()
        assert ends >= 2  # the episode boundaries were crossed


@pytest.mark.parametrize("name", ["CartPole-v1", "Pendulum-v1"])
def test_vector_env_autoreset_matches_gymnasium(name):
    """``SyncVectorEnv`` of 3 envs, SAME_STEP autoreset, 600 seeded steps:
    observations, rewards, terminations and truncations equal with their
    dtypes, and ``final_obs`` (with its mask) equal wherever an env ended."""
    gym = pytest.importorskip("gymnasium")
    from gymnasium.vector import AutoresetMode

    from ray_tpu_torch.rl.env_runner import make_vec_env

    g = gym.vector.SyncVectorEnv([lambda: gym.make(name) for _ in range(3)],
                                 autoreset_mode=AutoresetMode.SAME_STEP)
    og, _ = g.reset(seed=11)
    p, op = make_vec_env(name, 3, 11)
    assert og.dtype == op.dtype and og.tobytes() == op.tobytes()
    rng = np.random.default_rng(3)
    done_steps = 0
    for t in range(600):
        a = _actions(name, rng, 3)
        rg, rp = g.step(a), p.step(a)
        for x, y in zip(rg[:4], rp[:4]):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), t
        assert sorted(rg[4]) == sorted(rp[4]), t
        if "final_obs" in rg[4]:
            done_steps += 1
            np.testing.assert_array_equal(rg[4]["_final_obs"],
                                          rp[4]["_final_obs"])
            for u, v in zip(rg[4]["final_obs"], rp[4]["final_obs"]):
                assert (u is None) == (v is None)
                if u is not None:
                    assert u.tobytes() == v.tobytes()
    assert done_steps >= 3


# ---------------------------------------------------------------------------
# networks
# ---------------------------------------------------------------------------


def _flax_net(kind, obs_dim, act_dim, hidden):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import actor_critic as jac

    key = jax.random.PRNGKey(5)
    obs = jnp.zeros((1, obs_dim))
    if kind == "q":
        m = jac.QNetwork(act_dim, hidden)
        port = pac.QNetwork(obs_dim, act_dim, hidden)
    elif kind == "ac":
        m = jac.ActorCritic(act_dim, hidden)
        port = pac.ActorCritic(obs_dim, act_dim, hidden)
    elif kind == "actor":
        m = jac.SquashedGaussianActor(act_dim, hidden)
        port = pac.SquashedGaussianActor(obs_dim, act_dim, hidden)
    else:
        m = jac.ContinuousQ(hidden)
        port = pac.ContinuousQ(obs_dim, act_dim, hidden)
        return m, m.init(key, obs, jnp.zeros((1, act_dim)))["params"], port
    return m, m.init(key, obs)["params"], port


@pytest.mark.parametrize("kind", ["q", "ac", "actor", "cq"])
def test_net_forward_matches_flax(kind):
    """Each net on flax's params (converted as a plain copy: same keys,
    same shapes) gives flax's outputs on 33 random observations; the SAC
    actor's sample too, fed the JAX key's normal draw."""
    import jax
    import jax.numpy as jnp

    obs_dim, act_dim, hidden = 5, 3, (24, 16)
    m, fparams, port = _flax_net(kind, obs_dim, act_dim, hidden)
    params = from_jax_params(_np(fparams))
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: tuple(v.shape) for k, v in port.state_dict().items()}
    rng = np.random.default_rng(0)
    obs = rng.standard_normal((33, obs_dim)).astype(np.float32)
    act = rng.uniform(-1, 1, (33, act_dim)).astype(np.float32)
    tobs, tact = torch.from_numpy(obs), torch.from_numpy(act)
    if kind == "cq":
        want = [m.apply({"params": fparams}, obs, act)]
        got = [port.run(params, tobs, tact)]
    else:
        want = m.apply({"params": fparams}, obs)
        got = port.run(params, tobs)
        want, got = (want, got) if isinstance(want, tuple) else ([want],
                                                                 [got])
    if kind == "actor":
        key = jax.random.PRNGKey(9)
        want = list(want) + list(m.apply({"params": fparams}, jnp.asarray(obs),
                                         key, method=m.sample))
        eps = np.array(jax.random.normal(key, (33, act_dim)))
        got = list(got) + list(pac.squashed_sample(*got[:2],
                                                   torch.from_numpy(eps)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   **FWD_TOL)


def test_port_init_follows_flax_laws():
    """lecun_normal kernels cut at two deviations, zero biases, orthogonal
    heads at their scales; the same seed gives the same bits."""
    net = pac.ActorCritic(6, 2, (64, 64))
    p = net.init_params(3)
    assert all(torch.equal(p[k], v) for k, v in
               pac.ActorCritic(6, 2, (64, 64)).init_params(3).items())
    for name, fan_in in (("torso_0", 6), ("torso_1", 64)):
        std = (1.0 / fan_in) ** 0.5 / pac._TRUNCATED_STD
        k = p[f"{name}.kernel"]
        assert float(k.abs().max()) <= 2 * std
        assert abs(float(k.std()) - std * pac._TRUNCATED_STD) < 0.2 * std
        assert not p[f"{name}.bias"].any()
    for head, scale in (("pi", 0.01), ("vf", 1.0)):
        k = p[f"{head}.kernel"].double()
        torch.testing.assert_close(k.T @ k / scale ** 2,
                                   torch.eye(k.shape[1], dtype=k.dtype),
                                   rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("clip", [None, 0.5])
def test_adam_and_clip_match_optax(clip):
    """Five steps of ``adam(lr)`` (behind ``clip_by_global_norm(0.5)``
    where given) on the same params and gradients, the second's gradients
    large enough that the clip acts: params and both moments within
    ADAM_TOL of optax's, counts equal."""
    import jax.numpy as jnp
    import optax

    from ray_tpu_torch.rl.optim import Adam, clip_by_global_norm, global_norm

    rng = np.random.default_rng(1)
    shapes = {"a.kernel": (4, 3), "a.bias": (3,), "b": ()}
    params = {k: np.asarray(rng.standard_normal(s), np.float32)
              for k, s in shapes.items()}
    tx = optax.adam(3e-3) if clip is None else optax.chain(
        optax.clip_by_global_norm(clip), optax.adam(3e-3))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = tx.init(jp)
    opt = Adam(3e-3, clip=clip)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = opt.init(tp)
    for step in range(5):
        scale = 10.0 if step == 1 else 0.1
        grads = {k: np.asarray(scale * rng.standard_normal(s), np.float32)
                 for k, s in shapes.items()}
        upd, js = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                            js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step(tp, {k: torch.from_numpy(v) for k, v in grads.items()}, ts)
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   **ADAM_TOL)
    state = from_jax_opt_state(_np(js))
    assert state.count == ts.count == 5
    for k in shapes:
        np.testing.assert_allclose(ts.mu[k].numpy(), state.mu[k].numpy(),
                                   **ADAM_TOL)
        np.testing.assert_allclose(ts.nu[k].numpy(), state.nu[k].numpy(),
                                   **ADAM_TOL)
    g = {k: torch.from_numpy(np.asarray(3 * rng.standard_normal(s),
                                        np.float32))
         for k, s in shapes.items()}
    clipped = clip_by_global_norm(g, 0.5)
    want, _ = optax.clip_by_global_norm(0.5).update(
        {k: jnp.asarray(v.numpy()) for k, v in g.items()}, None)
    assert float(global_norm(g)) > 0.5
    for k in shapes:
        np.testing.assert_allclose(clipped[k].numpy(), np.asarray(want[k]),
                                   **ADAM_TOL)


# ---------------------------------------------------------------------------
# GAE, V-trace, the APPO loss
# ---------------------------------------------------------------------------


class _ScriptedVecEnv:
    """A vector env that ignores actions: observation, reward and
    termination of step t come from arrays."""

    def __init__(self, obs, rew, term, n_actions=2):
        self.obs, self.rew, self.term, self.t = obs, rew, term, 0

        class _Space:
            n = n_actions
            shape = obs.shape[2:]

        self.single_action_space = self.single_observation_space = _Space

    def step(self, action):
        t = self.t
        self.t += 1
        return (self.obs[t + 1], self.rew[t], self.term[t],
                np.zeros_like(self.term[t]), {})


def test_gae_matches_the_jax_runner():
    """Both packages' PPO runners on one scripted env (rewards, dones and
    observations from arrays) with their policies' values from one table:
    advantages, returns, observations and finished episodes equal within
    FWD_TOL (the same float32 recursion)."""
    import cloudpickle
    import jax.numpy as jnp

    from ray_tpu.rl import ppo as jppo
    from ray_tpu_torch.rl import ppo as pppo

    T, N = 32, 3
    rng = np.random.default_rng(4)
    obs = rng.standard_normal((T + 1, N, 4)).astype(np.float32)
    rew = rng.standard_normal((T, N)).astype(np.float32)
    term = rng.random((T, N)) < 0.1
    vals = rng.standard_normal((T + 1, N)).astype(np.float32)
    logits = np.zeros((N, 2), np.float32)
    kw = dict(num_envs_per_runner=N, rollout_length=T, seed=2)

    jr = jppo.EnvRunner._cls(cloudpickle.dumps(jppo.PPOConfig(**kw)), 0)
    jr.envs, jr.obs = _ScriptedVecEnv(obs, rew, term), obs[0]
    calls = iter(range(T + 1))
    jr._apply = lambda p, o: (jnp.asarray(logits), jnp.asarray(vals[next(
        calls)]))
    want = jr.sample(None)

    from ray_tpu_torch._private.serialization import dumps

    pr = pppo.EnvRunner._cls(dumps(pppo.PPOConfig(device="cpu", **kw)), 0)
    pr.envs, pr.obs = _ScriptedVecEnv(obs, rew, term), obs[0]
    calls2 = iter(range(T + 1))

    class _Table:
        def load_params(self, params):
            pass

        def __call__(self, o):
            return (torch.from_numpy(logits),
                    torch.from_numpy(vals[next(calls2)]))

    pr.net = _Table()
    got = pr.sample(None)
    for k in ("advantages", "returns", "obs", "episode_returns"):
        np.testing.assert_allclose(got[k], want[k], **FWD_TOL)
    adv = pppo.gae(rew, vals, term.astype(np.float32), 0.99, 0.95)
    np.testing.assert_array_equal(adv.reshape(-1), got["advantages"])


def test_vtrace_matches_jax():
    import jax.numpy as jnp

    from ray_tpu.rl.impala import vtrace_returns as jv
    from ray_tpu_torch.rl.impala import vtrace_returns as pv

    rng = np.random.default_rng(6)
    T, B = 20, 5
    values = rng.standard_normal((T, B)).astype(np.float32)
    last = rng.standard_normal(B).astype(np.float32)
    rewards = rng.standard_normal((T, B)).astype(np.float32)
    dones = (rng.random((T, B)) < 0.15).astype(np.float32)
    rhos = np.exp(0.5 * rng.standard_normal((T, B))).astype(np.float32)
    kw = dict(gamma=0.97, rho_clip=1.0, c_clip=0.9)
    want = jv(*map(jnp.asarray, (values, last, rewards, dones, rhos)), **kw)
    got = pv(*map(torch.from_numpy, (values, last, rewards, dones, rhos)),
             **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FWD_TOL)


def _impala_batch(rng, T, B, obs_dim, n_act):
    return {
        "obs": rng.standard_normal((T, B, obs_dim)).astype(np.float32),
        "actions": rng.integers(0, n_act, (T, B)).astype(np.int32),
        "behavior_logp": (np.log(1.0 / n_act) + 0.2 * rng.standard_normal(
            (T, B))).astype(np.float32),
        "rewards": rng.standard_normal((T, B)).astype(np.float32),
        "dones": (rng.random((T, B)) < 0.1).astype(np.float32),
        "last_obs": rng.standard_normal((B, obs_dim)).astype(np.float32),
    }


@pytest.mark.parametrize("use_kl", [False, True])
def test_appo_loss_matches_jax(use_kl):
    """The APPO loss of the JAX learner core (``_make_loss``) and the
    port's ``appo_loss`` on the same params, target params and batch."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.rl.appo import APPOConfig as JCfg, _AppoLearnerCore
    from ray_tpu_torch.rl.appo import APPOConfig as PCfg, appo_loss

    kw = dict(seed=1, use_kl_loss=use_kl, hidden=(32, 32))
    core = _AppoLearnerCore(JCfg(**kw), 4, 2)
    target = jax.tree.map(lambda x: x * 1.1 + 0.01, core.params)
    rng = np.random.default_rng(2)
    batch = _impala_batch(rng, 12, 3, 4, 2)
    total, aux = core._make_loss()(core.params, (target,), {
        k: jnp.asarray(v) for k, v in batch.items()})
    model = pac.ActorCritic(4, 2, (32, 32))
    got_total, mvec = appo_loss(
        model, from_jax_params(_np(core.params)),
        from_jax_params(_np(target)),
        {k: torch.from_numpy(v) for k, v in batch.items()},
        PCfg(device="cpu", **kw))
    want = [total] + [aux[k] for k in ("pg_loss", "vf_loss", "entropy",
                                       "mean_ratio")]
    np.testing.assert_allclose(mvec.detach().numpy(),
                               np.asarray(want, np.float32), **FWD_TOL)
    assert float(got_total) == float(mvec[0])


# ---------------------------------------------------------------------------
# learner updates from the same params on one batch
# ---------------------------------------------------------------------------


def _ppo_batch(rng, n, obs_dim, n_actions):
    return {
        "obs": rng.standard_normal((n, obs_dim)).astype(np.float32),
        "actions": rng.integers(0, n_actions, n).astype(np.int32),
        "logp": (-np.log(n_actions)
                 + 0.1 * rng.standard_normal(n)).astype(np.float32),
        "advantages": rng.standard_normal(n).astype(np.float32),
        "returns": rng.standard_normal(n).astype(np.float32),
    }


def test_ppo_update_matches_jax_learner():
    """The default PPO learner (8 epochs x 4 minibatches = 32 clipped Adam
    steps, the same seeded minibatch order) on one 1024-sample batch."""
    from ray_tpu.rl.ppo import PPOConfig as JCfg, PPOLearner as JLearner
    from ray_tpu_torch.rl.ppo import PPOConfig as PCfg, PPOLearner

    jl = JLearner(JCfg(seed=4), 4, 2)
    pl = PPOLearner(PCfg(seed=4, device="cpu"), 4, 2)
    pl.set_params(from_jax_params(_np(jl.params)))
    batch = _ppo_batch(np.random.default_rng(0), 1024, 4, 2)
    mj = jl.update(dict(batch))
    mp = pl.update(dict(batch))
    for k in ("loss", "pg_loss", "vf_loss", "entropy"):
        assert abs(mp[k] - mj[k]) <= 1e-3 * max(abs(mj[k]), 1.0), (k, mp, mj)
    assert pl.opt_state.count == 32
    _assert_params_close(pl.params, jl.params, 1e-3, 32, "ppo")


def test_impala_update_matches_jax_learner():
    from ray_tpu.rl.impala import (IMPALAConfig as JCfg,
                                   _ImpalaLearnerCore as JCore)
    from ray_tpu_torch.rl.impala import (IMPALAConfig as PCfg,
                                         _ImpalaLearnerCore)

    jc = JCore(JCfg(seed=2), 4, 2)
    pc = _ImpalaLearnerCore(PCfg(seed=2, device="cpu"), 4, 2)
    pc.set_params(from_jax_params(_np(jc.params)))
    rng = np.random.default_rng(5)
    for _ in range(3):
        batch = _impala_batch(rng, 16, 4, 4, 2)
        mj, mp = jc.update(dict(batch)), pc.update(dict(batch))
        for k in mj:
            assert abs(mp[k] - mj[k]) <= 1e-4 * max(abs(mj[k]), 1.0), (k, mp,
                                                                       mj)
    _assert_params_close(pc.params, jc.params, 1e-3, 3, "impala")


def test_sac_update_matches_jax_learner():
    """Three SAC steps (twin critics, actor, temperature, polyak) with the
    port fed the noise the JAX learner draws from its key: every net, the
    targets and log_alpha within the update bound."""
    import jax

    from ray_tpu.rl.sac import SACConfig as JCfg, SACLearner as JLearner
    from ray_tpu_torch.rl.sac import SACConfig as PCfg, SACLearner

    kw = dict(seed=3, hidden=(32, 32))
    jl = JLearner(JCfg(**kw), 3, 1)
    pl = SACLearner(PCfg(device="cpu", **kw), 3, 1)
    pl.set_state({
        "actor": from_jax_params(_np(jl.actor_params)),
        "q1": from_jax_params(_np(jl.q1_params)),
        "q2": from_jax_params(_np(jl.q2_params)),
        "q1_target": from_jax_params(_np(jl.q1_target)),
        "q2_target": from_jax_params(_np(jl.q2_target)),
        "log_alpha": np.asarray(jl.log_alpha),
        "actor_opt": from_jax_opt_state(_np(jl.actor_opt_state)),
        "q1_opt": from_jax_opt_state(_np(jl.q1_opt_state)),
        "q2_opt": from_jax_opt_state(_np(jl.q2_opt_state)),
        "alpha_opt": from_jax_opt_state(_np(jl.alpha_opt_state),
                                        name="log_alpha")})
    rng = np.random.default_rng(8)
    B = 64
    st, key = jl.state_tuple(), jl._key
    for _ in range(3):
        batch = {"obs": rng.standard_normal((B, 3)).astype(np.float32),
                 "actions": rng.uniform(-1, 1, (B, 1)).astype(np.float32),
                 "rewards": rng.standard_normal(B).astype(np.float32),
                 "dones": (rng.random(B) < 0.1).astype(np.float32),
                 "next_obs": rng.standard_normal((B, 3)).astype(np.float32)}
        key, sub = jax.random.split(key)
        st, mj = jl._step(st, batch, sub)
        _, k_next, k_pi = jax.random.split(sub, 3)
        mp = pl.step(batch, np.asarray(jax.random.normal(k_next, (B, 1))),
                     np.asarray(jax.random.normal(k_pi, (B, 1))))
        for k in mj:
            assert abs(float(mp[k]) - float(mj[k])) <= 1e-4 * max(
                abs(float(mj[k])), 1.0), (k, mp, mj)
    jl.load_state_tuple(st)
    for name, got, want in (("actor", pl.actor_params, jl.actor_params),
                            ("q1", pl.q1_params, jl.q1_params),
                            ("q2", pl.q2_params, jl.q2_params),
                            ("q1_target", pl.q1_target, jl.q1_target),
                            ("q2_target", pl.q2_target, jl.q2_target)):
        _assert_params_close(got, want, 3e-4, 3, name)
    assert abs(float(pl.log_alpha.detach()) - float(jl.log_alpha)) <= \
        UPDATE_REL * 3e-4 * 3


@pytest.mark.parametrize("beta", [0.0, 1.0], ids=["bc", "marwil"])
def test_offline_update_matches_jax_learner(beta):
    from ray_tpu.rl.offline import BCConfig as JCfg, _OfflineLearner as JL
    from ray_tpu_torch.rl.offline import BCConfig as PCfg, _OfflineLearner

    jl = JL(JCfg(seed=6, beta=beta), 4, 2)
    pl = _OfflineLearner(PCfg(seed=6, beta=beta, device="cpu"), 4, 2)
    pl.set_params(from_jax_params(_np(jl.params)))
    rng = np.random.default_rng(9)
    for _ in range(4):
        batch = {"obs": rng.standard_normal((256, 4)).astype(np.float32),
                 "actions": rng.integers(0, 2, 256).astype(np.int32),
                 "returns": rng.standard_normal(256).astype(np.float32)}
        mj, mp = jl.update(dict(batch)), pl.update(dict(batch))
        for k in mj:
            assert abs(mp[k] - mj[k]) <= 1e-4 * max(abs(mj[k]), 1.0), (k, mp,
                                                                       mj)
    _assert_params_close(pl.params, jl.params, 1e-3, 4, f"beta={beta}")


def test_multi_agent_update_matches_jax():
    """One policy's ``epochs`` full-batch clipped steps (the JAX
    ``lax.scan``) from the same params on one batch."""
    import jax
    import jax.numpy as jnp
    import optax

    from ray_tpu.models.actor_critic import ActorCritic as JAC
    from ray_tpu.rl.multi_agent import (MultiAgentPPO as JMA,
                                        MultiAgentPPOConfig as JCfg)
    from ray_tpu_torch.rl.multi_agent import (MultiAgentPPOConfig as PCfg,
                                              multi_agent_loss)
    from ray_tpu_torch.rl.optim import Adam

    cfg = JCfg(seed=0)
    jma = JMA.__new__(JMA)  # the update's factory alone: no runners
    jma.config = cfg
    jma.opt = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(cfg.lr))
    model = JAC(3, cfg.hidden)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 2)))["params"]
    rng = np.random.default_rng(1)
    n = 256
    batch = {"obs": rng.random((n, 2)).astype(np.float32),
             "actions": rng.integers(0, 3, n).astype(np.int32),
             "logp": (np.log(1 / 3) + 0.1 * rng.standard_normal(n)).astype(
                 np.float32),
             "adv": rng.standard_normal(n).astype(np.float32),
             "returns": rng.standard_normal(n).astype(np.float32),
             "values": rng.standard_normal(n).astype(np.float32),
             "rewards": rng.random(n).astype(np.float32),
             "dones": np.zeros(n, np.float32)}
    jp, _, jloss = jma._build_update(model)(
        params, jma.opt.init(params), {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    pcfg = PCfg(seed=0, device="cpu")
    pm = pac.ActorCritic(2, 3, pcfg.hidden)
    pp = {k: v.requires_grad_(True) for k, v in
          from_jax_params(_np(params)).items()}
    opt = Adam(pcfg.lr, clip=0.5)
    st = opt.init(pp)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in range(pcfg.epochs):
        loss, _ = multi_agent_loss(pm, pp, tb, pcfg)
        opt.step(pp, dict(zip(pp, torch.autograd.grad(loss, list(
            pp.values())))), st)
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-4 * max(abs(float(jloss)),
                                                         1.0)
    _assert_params_close(pp, jp, pcfg.lr, pcfg.epochs, "multi-agent")


# ---------------------------------------------------------------------------
# replay buffers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prioritized", [False, True])
def test_replay_buffer_draws_match_jax(prioritized):
    """The same adds, samples and priority updates from the same seed: the
    same indices, rows and importance weights, and the same state."""
    from ray_tpu.rl import replay_buffer as jrb
    from ray_tpu_torch.rl import replay_buffer as prb

    name = "PrioritizedReplayBuffer" if prioritized else "ReplayBuffer"
    jb, pb = getattr(jrb, name)(300, seed=4), getattr(prb, name)(300, seed=4)
    rng = np.random.default_rng(2)
    for step in range(8):
        batch = {"x": rng.standard_normal((64, 3)).astype(np.float32),
                 "a": rng.integers(0, 5, 64).astype(np.int32)}
        jb.add_batch(batch)
        pb.add_batch(batch)
        sj, sp = jb.sample(32), pb.sample(32)
        assert sorted(sj) == sorted(sp)
        for k in sj:
            np.testing.assert_array_equal(sp[k], sj[k])
        if prioritized:
            td = rng.standard_normal(32)
            jb.update_priorities(sj["idx"], td)
            pb.update_priorities(sp["idx"], td)
    js, ps = jb.state(), pb.state()
    assert sorted(js) == sorted(ps)
    for k in js["storage"]:
        np.testing.assert_array_equal(ps["storage"][k], js["storage"][k])


def test_configs_mirror_the_jax_fields():
    """Every JAX config's fields, with their defaults, are the port's; the
    port adds ``device`` alone."""
    import ray_tpu.rl as jrl

    import ray_tpu_torch.rl as prl

    assert sorted(prl.__all__) == sorted(jrl.__all__)
    for name in ("PPOConfig", "IMPALAConfig", "APPOConfig", "DQNConfig",
                 "SACConfig", "BCConfig", "MARWILConfig",
                 "MultiAgentPPOConfig"):
        jf = {f.name: f.default for f in dataclasses.fields(
            getattr(jrl, name)) if f.default is not dataclasses.MISSING}
        pf = {f.name: f.default for f in dataclasses.fields(
            getattr(prl, name)) if f.default is not dataclasses.MISSING}
        assert pf.pop("device") is None
        assert pf == jf, name
