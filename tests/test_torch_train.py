"""The port's training step against the JAX package's, on the CPU.

``make_optimizer`` is held against optax fed the same gradients, and
``TrainStepBundle`` against the JAX ``TrainStepBundle`` on a one-device mesh:
the same flax params (``from_jax_params``), the same batches (``make_batch``
draws with the same numpy call), fp32 compute on both sides. The port's
attention runs through ``FlashAttention`` (its plain forward and backward on
the CPU), the JAX model's through its reference attention.
"""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("flax")  # the JAX reference; the card's machine lacks it

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from ray_tpu.models.transformer import CONFIGS as JAX_CONFIGS
from ray_tpu.parallel import TrainStepBundle as JaxBundle
from ray_tpu.parallel import create_mesh
from ray_tpu.parallel import make_optimizer as jax_make_optimizer
from ray_tpu_torch.models import CONFIGS, from_jax_opt_state, from_jax_params
from ray_tpu_torch.parallel import OptState, TrainStepBundle, make_optimizer

# 2 layers at head_dim 64 (a head dim the kernels take), 2 query heads over
# 1 KV head, fp32 compute
SHAPE = dict(d_model=128, n_heads=2, n_kv_heads=1)
OPT = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)
BATCH, SEQ, STEPS = 4, 32, 4
# the same fp32 arithmetic in other sum orders: the loss (~5.6) to 1e-5
LOSS_RTOL = 1e-5
# Params after the steps, from Adam's update size: a step moves an element
# by lr_t * |m_hat / (sqrt(v_hat) + eps)| plus the decay lr_t * wd * |p|;
# for b1 = 0.9, b2 = 0.95 the ratio stays below 1.2 (Cauchy-Schwarz over the
# moments' weights). Where an element's gradient is so small that fp32
# rounding decides its sign, the two runs move it in opposite directions,
# so they can part by 2 * 1.2 * sum(lr_t) (+ the decay, < 1e-4 of that here).
ADAM_RATIO = 1.2


def _param_atol(opt_kw, steps, start=0):
    sched = make_optimizer(**opt_kw).schedule
    return 2 * ADAM_RATIO * sum(sched(t) for t in range(start, start + steps))


def _configs(remat):
    jcfg = dataclasses.replace(JAX_CONFIGS["tiny"], dtype=jnp.float32,
                               remat=remat, **SHAPE)
    tcfg = dataclasses.replace(CONFIGS["tiny"], dtype=torch.float32,
                               remat=remat, **SHAPE)
    assert tcfg.head_dim == 64
    return jcfg, tcfg


def _jax_bundle(cfg):
    mesh = create_mesh({"data": 1, "fsdp": 1, "seq": 1, "tensor": 1,
                        "expert": 1}, devices=jax.devices()[:1])
    return JaxBundle(cfg, mesh, optimizer=jax_make_optimizer(**OPT))


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_params_close(got, jax_params, atol):
    want = from_jax_params(_to_numpy(jax_params))
    assert set(got) == set(want)
    worst = max((got[k].detach() - want[k]).abs().max().item() for k in want)
    assert worst <= atol, f"params part by {worst:.3e} > {atol:.3e}"


def _jax_run(remat):
    """The JAX bundle for STEPS steps, with its state after 2 steps kept as
    numpy for the resume test."""
    jcfg, _ = _configs(remat)
    bundle = _jax_bundle(jcfg)
    params, opt = bundle.init(jax.random.PRNGKey(0))
    init = _to_numpy(params)
    batch = bundle.make_batch(np.random.default_rng(0), BATCH, SEQ)
    eval_loss = float(bundle.eval_step(params, batch))
    losses, mid = [], None
    for i in range(STEPS):
        if i == 2:
            mid = (_to_numpy(params), _to_numpy(opt))
        params, opt, loss = bundle.step(params, opt, batch)
        losses.append(float(loss))
    return dict(init=init, batch=_to_numpy(batch), eval_loss=eval_loss,
                losses=losses, params=params, mid=mid)


@pytest.fixture(scope="module")
def jax_runs():
    """remat -> the JAX run, each taken once for the module."""
    runs = {}

    def get(remat):
        if remat not in runs:
            runs[remat] = _jax_run(remat)
        return runs[remat]

    return get


@pytest.mark.parametrize("remat", [False, True], ids=["remat_off", "remat_on"])
def test_train_steps_match_jax(jax_runs, remat):
    """4 fp32 steps from the same params and batch, remat on or off on both
    sides: the loss of every step and the params after the last."""
    jax_run = jax_runs(remat)
    _, tcfg = _configs(remat)
    bundle = TrainStepBundle(tcfg, device="cpu",
                             optimizer=make_optimizer(**OPT))
    params = from_jax_params(jax_run["init"])
    opt = bundle.optimizer.init(params)
    batch = bundle.make_batch(np.random.default_rng(0), BATCH, SEQ)
    for key in ("tokens", "targets", "mask"):  # the same draws as JAX's
        np.testing.assert_array_equal(batch[key].numpy(),
                                      jax_run["batch"][key])
    np.testing.assert_allclose(bundle.eval_step(params, batch).item(),
                               jax_run["eval_loss"], rtol=LOSS_RTOL)
    losses = []
    for _ in range(STEPS):
        params, opt, loss = bundle.step(params, opt, batch)
        assert loss.dim() == 0 and not loss.requires_grad
        losses.append(loss.item())
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=LOSS_RTOL)
    assert opt.count == STEPS
    _assert_params_close(params, jax_run["params"],
                         _param_atol(OPT, STEPS))


def test_resume_from_jax_opt_state(jax_runs):
    """JAX's params and optimizer state after 2 steps, carried across, give
    the same 2 further steps in the port."""
    jax_run = jax_runs(False)
    j_params, j_opt = jax_run["mid"]
    opt = from_jax_opt_state(j_opt)
    assert isinstance(opt, OptState) and opt.count == 2
    assert set(opt.mu) == set(opt.nu) == set(from_jax_params(j_params))
    _, tcfg = _configs(remat=False)
    bundle = TrainStepBundle(tcfg, device="cpu",
                             optimizer=make_optimizer(**OPT))
    params = from_jax_params(j_params)
    batch = bundle.make_batch(np.random.default_rng(0), BATCH, SEQ)
    losses = []
    for _ in range(STEPS - 2):
        params, opt, loss = bundle.step(params, opt, batch)
        losses.append(loss.item())
    np.testing.assert_allclose(losses, jax_run["losses"][2:], rtol=LOSS_RTOL)
    assert opt.count == STEPS
    _assert_params_close(params, jax_run["params"],
                         _param_atol(OPT, STEPS - 2, start=2))


def test_loss_falls_on_one_batch():
    """The port's counterpart of tests/test_models_ops.py's train-step test:
    the tiny config memorises one batch under the default optimizer."""
    bundle = TrainStepBundle(CONFIGS["tiny"], device="cpu")
    params, opt = bundle.init(seed=0)
    batch = bundle.make_batch(np.random.default_rng(0), 4, 64)
    losses = []
    for _ in range(5):
        params, opt, loss = bundle.step(params, opt, batch)
        losses.append(loss.item())
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def _tree(rng, scale):
    return {"a": {"kernel": (scale * rng.standard_normal((3, 4))).astype(
                np.float32)},
            "b": (scale * rng.standard_normal((5,))).astype(np.float32),
            "c": {"d": {"scale": (scale * rng.standard_normal((2, 2, 2)))
                        .astype(np.float32)}}}


@pytest.mark.parametrize("grad_scale", [1e-2, 10.0],
                         ids=["below_clip", "above_clip"])
def test_optimizer_matches_optax(grad_scale):
    """Several steps of the port's AdamW against optax's chain on the same
    params and gradients, through the warmup, the cosine and past its end;
    gradients far below and far above the clip norm. Both run the same fp32
    elementwise math, so the params agree to a few fp32 ulps of |p| ~ 1."""
    kw = dict(learning_rate=1e-2, warmup_steps=3, total_steps=6,
              weight_decay=0.1, clip=1.0)
    rng = np.random.default_rng(0)
    params = _tree(rng, 1.0)
    jax_opt = jax_make_optimizer(**kw)
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    j_state = jax_opt.init(j_params)
    opt = make_optimizer(**kw)
    t_params = from_jax_params(params)
    state = opt.init(t_params)
    for _ in range(8):
        grads = _tree(rng, grad_scale)
        updates, j_state = jax_opt.update(
            jax.tree_util.tree_map(jnp.asarray, grads), j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        flat = from_jax_params(grads)
        opt.update(t_params, [flat[k] for k in t_params], state)
        want = from_jax_params(_to_numpy(j_params))
        for key in want:
            np.testing.assert_allclose(t_params[key].numpy(),
                                       want[key].numpy(), rtol=1e-6,
                                       atol=1e-6)
    assert state.count == 8
    # the moments are sums of terms below 1 in size (clipped gradients and
    # their squares), each side's rounded to fp32 in its own order: a few
    # fp32 ulps of 1
    carried = from_jax_opt_state(_to_numpy(j_state))
    assert carried.count == 8
    for key in t_params:
        for got, want in ((state.mu, carried.mu), (state.nu, carried.nu)):
            np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                       rtol=1e-6, atol=5e-7)


@pytest.mark.parametrize("warmup,total", [(3, 10), (0, 10), (5, 5)])
def test_schedule_matches_optax(warmup, total):
    """lr 0 at step 0 (after a warmup), the peak at the warmup's end, the
    cosine down to 0 at max(total, warmup + 1), flat after."""
    want = optax.warmup_cosine_decay_schedule(0.0, 3e-4, warmup,
                                              max(total, warmup + 1))
    opt = make_optimizer(learning_rate=3e-4, warmup_steps=warmup,
                         total_steps=total)
    for count in sorted({0, 1, warmup, warmup + 1, (warmup + total) // 2,
                         total, total + 5}):
        np.testing.assert_allclose(opt.schedule(count), float(want(count)),
                                   rtol=1e-6, atol=1e-12)
