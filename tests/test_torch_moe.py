"""The port's MoE decoder against the JAX package's, on the CPU.

``MoEMLP`` alone, the MoE ``Transformer`` and the training step are each
run on the same flax params (``from_jax_params``) and the same numpy inputs
as their JAX counterparts, in fp32. The port dispatches and combines with
index operations where the JAX model multiplies one-hot tensors; in fp32
both give the same rows and the same sums.
"""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("flax")  # the JAX reference; the card's machine lacks it

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models.transformer import CONFIGS as JAX_CONFIGS
from ray_tpu.models.transformer import MoEMLP as JaxMoEMLP
from ray_tpu.models.transformer import Transformer as JaxTransformer
from ray_tpu.parallel import TrainStepBundle as JaxBundle
from ray_tpu.parallel import create_mesh
from ray_tpu.parallel import make_optimizer as jax_make_optimizer
from ray_tpu_torch.models import (CONFIGS, MoEMLP, Transformer,
                                  from_jax_params, init_params, lm_loss)
from ray_tpu_torch.models.convert import check_params
from ray_tpu_torch.models.transformer import state_dict_shapes
from ray_tpu_torch.parallel import TrainStepBundle, make_optimizer

# fp32, the same products summed in other orders: outputs and grads of one
# layer to atol 1e-5 (values of order 1), its aux (a mean of ~1) to 1e-6
LAYER_ATOL = 1e-5
AUX_RTOL = 1e-6
# the whole model: two layers of attention and experts, as the dense
# model's fp32 parity (tests/test_torch_model.py)
MODEL_TOL = dict(atol=1e-5, rtol=1e-4)
# the training step: losses to 1e-5, params within Adam's update bound
# 2 x 1.2 x sum(lr_t) (tests/test_torch_train.py derives it)
LOSS_RTOL = 1e-5
ADAM_RATIO = 1.2


def _unbox(tree):
    return jax.tree_util.tree_map(np.asarray, fnn.meta.unbox(tree))


def _fp32(name, **kw):
    jcfg = dataclasses.replace(JAX_CONFIGS[name], dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(CONFIGS[name], dtype=torch.float32, **kw)
    return jcfg, tcfg


def _slots(expert, n_experts, capacity):
    """Each (token, k) slot's position in its expert's buffer and whether
    it fits, counted one slot at a time in (token, k) order per group."""
    pos = np.zeros(expert.shape, np.int64)
    for grp in range(expert.shape[0]):
        filled = np.zeros(n_experts, np.int64)
        for n in range(expert.shape[1]):
            for k in range(expert.shape[2]):
                pos[grp, n, k] = filled[expert[grp, n, k]]
                filled[expert[grp, n, k]] += 1
    return pos, pos < capacity


# (batch, seq, capacity_factor, group_size): one group of 24 whose
# capacity C = g holds every slot; and 60 tokens in 4 groups of 15 (the
# largest divisor of 60 up to 16) at half capacity, so slots are dropped
LAYER_CASES = {"one_group_no_drops": (2, 12, None, None),
               "groups_with_drops": (3, 20, 0.5, 16)}


@pytest.mark.parametrize("k", [1, 2], ids=["K1", "K2"])
@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_moe_layer_matches_jax(monkeypatch, case, k):
    """One ``MoEMLP`` (moe-tiny width: 4 experts, D 64, F 128), fp32: the
    routing (experts from the JAX router's logits, slots counted one by
    one), the output, the aux and the grads of sum(out * R) + aux with
    respect to x and every weight."""
    B, S, cf, group = LAYER_CASES[case]
    E = CONFIGS["moe-tiny"].n_experts
    cf = E / k if cf is None else cf  # C = g: no slot can be dropped
    if group is not None:
        monkeypatch.setattr(JaxMoEMLP, "GROUP_SIZE", group)
        monkeypatch.setattr(MoEMLP, "GROUP_SIZE", group)
    jcfg, tcfg = _fp32("moe-tiny", experts_per_token=k, capacity_factor=cf)
    rng = np.random.default_rng(k)
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    jmod = JaxMoEMLP(jcfg)
    params = _unbox(jmod.init(jax.random.PRNGKey(k), jnp.asarray(x)))["params"]

    def jax_loss(p, xs):
        (out, cols) = jmod.apply({"params": p}, xs, mutable=["losses"])
        aux = cols["losses"]["moe_aux"][0]
        return (out * cot).sum() + aux, (out, aux)

    (_, (want_out, want_aux)), (want_gp, want_gx) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    _, cols = jmod.apply({"params": params}, jnp.asarray(x),
                         capture_intermediates=True)
    logits = cols["intermediates"]["router"]["__call__"][0]
    _, want_expert = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)

    layer = MoEMLP(tcfg, device="cpu")
    layer.load_state_dict(from_jax_params(params))
    xt = torch.from_numpy(x).requires_grad_()
    g = layer.group_size(B * S)
    assert g == (15 if group else B * S)
    routing = layer.route(xt.detach().reshape(-1, g, tcfg.d_model))
    want_pos, want_keep = _slots(np.asarray(want_expert), E,
                                 routing.capacity)
    np.testing.assert_array_equal(routing.expert.numpy(),
                                  np.asarray(want_expert))
    np.testing.assert_array_equal(routing.pos.numpy(), want_pos)
    np.testing.assert_array_equal(routing.keep.numpy(), want_keep)
    assert bool(want_keep.all()) == (group is None)  # drops where meant

    out, aux = layer(xt)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               atol=LAYER_ATOL, rtol=0)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=AUX_RTOL)
    names = [n for n, _ in layer.named_parameters()]
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum() + aux,
                                [xt] + list(layer.parameters()))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(want_gx),
                               atol=LAYER_ATOL, rtol=0)
    want_flat = from_jax_params(jax.tree_util.tree_map(np.asarray, want_gp))
    assert set(names) == set(want_flat)
    for name, got in zip(names, grads[1:]):
        np.testing.assert_allclose(got.numpy(), want_flat[name].numpy(),
                                   atol=LAYER_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("remat", [False, True], ids=["remat_off", "remat_on"])
@pytest.mark.parametrize("moe_every", [1, 2])
def test_moe_transformer_matches_jax(moe_every, remat):
    """A 2-layer MoE model, fp32: the logits and each MoE layer's aux
    against ``apply(..., mutable=["losses"])``; with moe_every 2 only
    layer 0 holds experts."""
    jcfg, tcfg = _fp32("moe-tiny", moe_every=moe_every, remat=remat)
    toks = np.random.default_rng(3).integers(0, 256, (2, 24)).astype(np.int32)
    jmodel = JaxTransformer(jcfg)
    params = _unbox(jmodel.init(jax.random.PRNGKey(2), jnp.asarray(toks)))
    params = {"params": params["params"]}  # init also sows a "losses" entry
    want, cols = jmodel.apply(params, jnp.asarray(toks), mutable=["losses"])
    want_aux = {".".join(p.key for p in path[:-1]): float(leaf)
                for path, leaf in jax.tree_util.tree_leaves_with_path(
                    cols["losses"])}
    model = Transformer(tcfg, device="cpu", params=from_jax_params(params))
    got, aux = model(torch.from_numpy(toks).long(), return_aux=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **MODEL_TOL)
    assert sorted(aux) == sorted(want_aux) == [
        f"layer_{i}.moe.moe_aux" for i in range(0, 2, moe_every)]
    for key, value in want_aux.items():
        np.testing.assert_allclose(aux[key].item(), value, rtol=AUX_RTOL)


# 2 layers of experts at head_dim 64 (a head dim the kernels take), MHA as
# moe-1b, fp32
TRAIN_SHAPE = dict(d_model=128, n_heads=2, n_kv_heads=2)
OPT = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)
BATCH, SEQ, STEPS = 4, 32, 4


def _jax_moe_run(remat):
    jcfg, _ = _fp32("moe-tiny", remat=remat, **TRAIN_SHAPE)
    mesh = create_mesh({"data": 1, "fsdp": 1, "seq": 1, "tensor": 1,
                        "expert": 1}, devices=jax.devices()[:1])
    bundle = JaxBundle(jcfg, mesh, optimizer=jax_make_optimizer(**OPT))
    params, opt = bundle.init(jax.random.PRNGKey(0))
    init = jax.tree_util.tree_map(np.asarray, params)
    batch = bundle.make_batch(np.random.default_rng(0), BATCH, SEQ)
    eval_loss = float(bundle.eval_step(params, batch))
    losses = []
    for _ in range(STEPS):
        params, opt, loss = bundle.step(params, opt, batch)
        losses.append(float(loss))
    return dict(init=init, eval_loss=eval_loss, losses=losses,
                params=jax.tree_util.tree_map(np.asarray, params))


@pytest.fixture(scope="module")
def jax_moe_runs():
    runs = {}

    def get(remat):
        if remat not in runs:
            runs[remat] = _jax_moe_run(remat)
        return runs[remat]

    return get


@pytest.mark.parametrize("remat", [False, True], ids=["remat_off", "remat_on"])
def test_moe_train_steps_match_jax(jax_moe_runs, remat):
    """4 fp32 steps of the MoE model from the same params and batch against
    the JAX ``TrainStepBundle`` on a one-device mesh: every step's loss
    (lm_loss + moe_aux_coef * aux) and the params after the last."""
    run = jax_moe_runs(remat)
    _, tcfg = _fp32("moe-tiny", remat=remat, **TRAIN_SHAPE)
    bundle = TrainStepBundle(tcfg, device="cpu",
                             optimizer=make_optimizer(**OPT))
    params = from_jax_params(run["init"])
    opt = bundle.optimizer.init(params)
    batch = bundle.make_batch(np.random.default_rng(0), BATCH, SEQ)
    losses = []
    for _ in range(STEPS):
        params, opt, loss = bundle.step(params, opt, batch)
        losses.append(loss.item())
    np.testing.assert_allclose(losses, run["losses"], rtol=LOSS_RTOL)
    sched = make_optimizer(**OPT).schedule
    atol = 2 * ADAM_RATIO * sum(sched(t) for t in range(STEPS))
    want = from_jax_params(run["params"])
    assert set(params) == set(want)
    worst = max((params[k].detach() - want[k]).abs().max().item()
                for k in want)
    assert worst <= atol, f"params part by {worst:.3e} > {atol:.3e}"


def test_moe_eval_step_leaves_out_the_aux(jax_moe_runs):
    """``eval_step`` is the JAX bundle's: lm_loss alone. The step's loss is
    that plus moe_aux_coef times the layers' aux."""
    run = jax_moe_runs(False)
    _, tcfg = _fp32("moe-tiny", remat=False, **TRAIN_SHAPE)
    bundle = TrainStepBundle(tcfg, device="cpu",
                             optimizer=make_optimizer(**OPT))
    params = from_jax_params(run["init"])
    batch = bundle.make_batch(np.random.default_rng(0), BATCH, SEQ)
    got = bundle.eval_step(params, batch).item()
    np.testing.assert_allclose(got, run["eval_loss"], rtol=LOSS_RTOL)
    with torch.no_grad():
        logits, aux = bundle.model(batch["tokens"], return_aux=True)
    assert len(aux) == tcfg.n_layers
    np.testing.assert_allclose(
        got, lm_loss(logits, batch["targets"], batch["mask"]).item(),
        rtol=1e-6)
    with_aux = got + tcfg.moe_aux_coef * sum(a.item() for a in aux.values())
    np.testing.assert_allclose(run["losses"][0], with_aux, rtol=LOSS_RTOL)
    assert with_aux > got


def test_moe_tiny_params_convert_leaf_for_leaf():
    """Every leaf of a flax MoE tree has its flax path and shape in the
    port: ``from_jax_params`` copies them all, ``check_params`` accepts
    them, and the model loads them with no key left over."""
    cfg = CONFIGS["moe-tiny"]
    tree = _unbox(JaxTransformer(JAX_CONFIGS["moe-tiny"]).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32)))
    leaves = jax.tree_util.tree_leaves_with_path(tree["params"])
    sd = from_jax_params(tree)
    assert len(sd) == len(leaves)
    for path, leaf in leaves:
        np.testing.assert_array_equal(
            sd[".".join(p.key for p in path)].numpy(), leaf)
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        state_dict_shapes(cfg)
    check_params(sd, cfg)
    model = Transformer(cfg, device="cpu", params=sd)
    assert set(model.state_dict()) == set(sd)


def test_moe_1b_shapes_match_flax():
    """moe-1b's flax tree, by shape only (``jax.eval_shape``): experts in
    the even layers (moe_every 2), dense MLPs in the odd ones."""
    cfg = CONFIGS["moe-1b"]
    abstract = jax.eval_shape(
        lambda: fnn.meta.unbox(JaxTransformer(JAX_CONFIGS["moe-1b"]).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32))))
    want = {".".join(p.key for p in path): leaf.shape
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                abstract["params"])}
    assert want == state_dict_shapes(cfg)
    assert "layer_0.moe.down_proj" in want and "layer_1.mlp.up_proj.kernel" \
        in want


def test_moe_init_params_laws():
    """The router is drawn with std 0.02 and the expert stacks with the
    projections' 0.02 / sqrt(2 L), as the flax initialisers."""
    cfg = dataclasses.replace(CONFIGS["moe-tiny"], d_model=128, d_ff=256)
    p = init_params(cfg, seed=0, device="cpu")
    check_params(p, cfg)
    proj_std = 0.02 / np.sqrt(2 * cfg.n_layers)
    assert abs(p["layer_0.moe.router.kernel"].std().item() - 0.02) < 0.002
    for name in ("gate_proj", "up_proj", "down_proj"):
        assert abs(p[f"layer_1.moe.{name}"].std().item() - proj_std) \
            < 0.05 * proj_std


def test_moe_layer_alone_draws_its_weights(monkeypatch):
    """``MoEMLP`` built on its own resolves its device as every entry point
    does (None is the card) and draws its weights from ``seed`` with the
    model's laws, so it is never left with uninitialised memory."""
    from ray_tpu_torch.models import transformer

    asked = []
    monkeypatch.setattr(transformer, "resolve_device",
                        lambda d: asked.append(d) or torch.device("cpu"))
    cfg = dataclasses.replace(CONFIGS["moe-tiny"], d_model=128, d_ff=256)
    layer = MoEMLP(cfg, seed=3)
    assert asked == [None]
    again = MoEMLP(cfg, device="cpu", seed=3).state_dict()
    other = MoEMLP(cfg, device="cpu", seed=4).state_dict()
    proj_std = 0.02 / np.sqrt(2 * cfg.n_layers)
    assert abs(layer.router.kernel.std().item() - 0.02) < 0.002
    for name, w in layer.state_dict().items():
        assert torch.equal(w, again[name]) and not torch.equal(w, other[name])
        if name != "router.kernel":
            assert abs(w.std().item() - proj_std) < 0.05 * proj_std, name


def test_moe_route_replays_a_given_choice():
    """``route(x, expert=...)`` runs the given experts: with the router's
    own top-K it is ``route(x)`` exactly; with another choice its slots
    are counted in (token, k) order and its gates are the router's
    probabilities at those experts, normalised over the K."""
    cfg = dataclasses.replace(CONFIGS["moe-tiny"], dtype=torch.float32,
                              capacity_factor=0.5)
    layer = MoEMLP(cfg, device="cpu", seed=0)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32))
    own = layer.route(x)
    replay = layer.route(x, expert=own.expert)
    for a, b in zip(own, replay):
        assert a == b if isinstance(a, int) else torch.equal(a, b)
    other = torch.flip(own.expert, dims=(1,))  # token n takes token -n's
    forced = layer.route(x, expert=other)
    pos, keep = _slots(other.numpy(), cfg.n_experts, forced.capacity)
    np.testing.assert_array_equal(forced.pos.numpy(), pos)
    np.testing.assert_array_equal(forced.keep.numpy(), keep)
    assert not keep.all()  # half capacity: slots are dropped
    gate = own.probs.gather(-1, other)
    torch.testing.assert_close(forced.gate, gate / gate.sum(-1, keepdim=True),
                               atol=0, rtol=0)


# Mirrors of tests/test_moe_vit.py's MoE tests, on the port


def test_moe_forward_shape_and_aux():
    cfg = CONFIGS["moe-tiny"]
    model = Transformer(cfg, device="cpu")
    logits, aux = model(torch.zeros((2, 32), dtype=torch.long),
                        return_aux=True)
    assert logits.shape == (2, 32, cfg.vocab_size)
    assert len(aux) == cfg.n_layers  # every block is MoE at moe_every=1
    # balanced-router aux is ~1.0; catastrophically unbalanced >> 1
    assert all(0.5 < a.item() < 4.0 for a in aux.values())


def test_moe_has_expert_params():
    cfg = CONFIGS["moe-tiny"]
    model = Transformer(cfg, device="cpu")
    assert hasattr(model.layer_0, "moe") and not hasattr(model.layer_0,
                                                         "mlp")
    assert model.layer_0.moe.gate_proj.shape == (cfg.n_experts, cfg.d_model,
                                                 cfg.d_ff)


def test_moe_loss_falls_over_ten_steps():
    bundle = TrainStepBundle(CONFIGS["moe-tiny"], device="cpu")
    params, opt = bundle.init(seed=0)
    batch = bundle.make_batch(np.random.default_rng(0), 8, 64)
    losses = []
    for _ in range(10):
        params, opt, loss = bundle.step(params, opt, batch)
        losses.append(loss.item())
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], f"MoE loss did not decrease: {losses}"


def test_moe_num_params_counts_experts():
    dense = dataclasses.replace(CONFIGS["moe-tiny"], n_experts=0)
    moe = CONFIGS["moe-tiny"]
    assert moe.num_params() > dense.num_params()
    assert moe.num_params() == sum(
        int(np.prod(s)) for s in state_dict_shapes(moe).values())
