"""The port's mesh and data-parallel training step against the JAX package's.

- The mesh's tables: ``param_logical_axes`` against flax's partition specs
  of the JAX model (``jax.eval_shape``, no weights) for tiny, moe-tiny and
  1b; ``default_mesh_axes`` against JAX's; ``mesh_placements`` from the
  rules.
- ``TrainStepBundle`` on a ``data=2`` mesh, on one gloo world of 2 ranks
  (``run_world``), ``CONFIGS["tiny"]`` in fp32, the JAX bundle's initial
  weights carried over, a clip low enough to engage (as the JAX
  ``sharded_bundle`` fixture), three steps of each flavour, against the
  JAX bundle on a 2-device mesh fed the same batch: the data-parallel step
  (``shard_update`` off), the sharded step (on), uneven masks and
  ``grad_dtype="bf16"``. Losses at rtol 1e-5 and parameters within Adam's
  update bound ``2 x 1.2 x sum(lr_t)`` (tests/test_torch_train.py). The
  port's sharded step against its unsharded step with the same optimizer:
  bit for bit. The ranks import this module, so it loads torch, numpy and
  the port only.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from test_torch_collective import run_world

from ray_tpu_torch.models import CONFIGS
from ray_tpu_torch.parallel import (AXES, LOGICAL_RULES, TrainStepBundle,
                                    default_mesh_axes, make_optimizer,
                                    param_logical_axes)

DP = 2
OPT = dict(learning_rate=1e-2, warmup_steps=2, total_steps=100, clip=0.05)
BATCH, SEQ, STEPS = 4, 32, 3
LOSS_RTOL = 1e-5
ADAM_RATIO = 1.2  # tests/test_torch_train.py: Adam's step is below 1.2 lr_t


def _param_atol(steps=STEPS):
    sched = make_optimizer(**OPT).schedule
    return 2 * ADAM_RATIO * sum(sched(t) for t in range(steps))


def _cfg():
    return dataclasses.replace(CONFIGS["tiny"], dtype=torch.float32)


def _factory(spec_fn):
    return make_optimizer(**OPT, clip_spec_fn=spec_fn)


def _uneven(mask: np.ndarray) -> np.ndarray:
    """Rank 0's rows hold 4 valid tokens, rank 1's all of theirs."""
    mask = np.zeros_like(mask)
    mask[0, :4] = 1.0
    mask[BATCH // 2:] = 1.0
    return mask


# -- the mesh's tables --------------------------------------------------------


def _jax():
    # the JAX reference; the card's machine lacks flax
    pytest.importorskip("flax")
    import jax

    return jax


@pytest.mark.parametrize("name", ["tiny", "moe-tiny", "1b"])
def test_param_logical_axes_match_flax(name):
    jax = _jax()
    import flax.linen as nn
    import jax.numpy as jnp

    from ray_tpu.models.transformer import CONFIGS as JAX_CONFIGS
    from ray_tpu.models.transformer import Transformer as JaxTransformer

    cfg = JAX_CONFIGS[name]
    abstract = jax.eval_shape(
        lambda rng: JaxTransformer(cfg).init(
            rng, jnp.zeros((1, 8), jnp.int32))["params"],
        jax.random.PRNGKey(0))
    specs = jax.tree_util.tree_flatten_with_path(
        nn.get_partition_spec(abstract),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    want = {".".join(str(k.key) for k in path): tuple(spec)
            for path, spec in specs}
    assert param_logical_axes(CONFIGS[name]) == want


def test_default_mesh_axes_match_jax():
    _jax()
    from ray_tpu.parallel.mesh import AXES as JAX_AXES
    from ray_tpu.parallel.mesh import LOGICAL_RULES as JAX_RULES
    from ray_tpu.parallel.mesh import default_mesh_axes as jax_default

    assert AXES == JAX_AXES and LOGICAL_RULES == JAX_RULES
    for n in range(1, 17):
        assert default_mesh_axes(n) == jax_default(n), n


def test_logical_to_mesh_axes_match_flax():
    _jax()
    import flax.linen as nn

    from ray_tpu_torch.parallel.mesh import logical_to_mesh_axes

    for names in set(param_logical_axes(CONFIGS["moe-tiny"]).values()) | {
            ("batch", "seq", "embed"), ("batch", "seq", "vocab")}:
        want = nn.logical_to_mesh_axes(names, LOGICAL_RULES)
        assert tuple(logical_to_mesh_axes(names)) == tuple(want), names


# -- the step on a data=2 mesh ------------------------------------------------


def _mesh(axes, world):
    from ray_tpu_torch.parallel import create_mesh

    return create_mesh({**dict.fromkeys(AXES, 1), **axes}, device="cpu")


def _run(bundle, params, batch, steps=STEPS, sharded=False):
    params = {k: v.clone() for k, v in params.items()}
    opt = (bundle.init_sharded if sharded else bundle.init)(0)[1]
    losses = []
    for _ in range(steps):
        params, opt, loss = bundle.step(params, opt, batch)
        losses.append(loss.item())
    return {"losses": losses, "opt": opt,
            "params": {k: v.detach().clone() for k, v in params.items()}}


def train_rank(rank: int, world: int, store: str, params_path: str) -> dict:
    """One rank's runs of every flavour (what ``run_world`` calls)."""
    from ray_tpu_torch import collective as col
    from ray_tpu_torch.parallel import mesh_placements

    col.init_collective_group(world, rank, group_name="dp", device="cpu",
                              init_method=f"file://{store}")
    init = torch.load(params_path)
    mesh = _mesh({"data": world}, world)
    cfg = _cfg()
    dp = TrainStepBundle(cfg, mesh=mesh, optimizer_factory=_factory)
    sharded = TrainStepBundle(cfg, mesh=mesh, shard_update=True,
                              optimizer_factory=_factory)
    # the unsharded step with the sharded step's optimizer: its clip takes
    # the norm in the same pinned association
    pinned = TrainStepBundle(cfg, mesh=mesh, optimizer=sharded.optimizer)
    bf16 = TrainStepBundle(cfg, mesh=mesh, optimizer_factory=_factory,
                           grad_dtype="bf16")
    batch = dp.make_batch(np.random.default_rng(0), BATCH, SEQ)
    uneven = dict(batch, mask=torch.from_numpy(_uneven(batch["mask"].numpy())))
    out = {"dp": _run(dp, init, batch),
           "sharded": _run(sharded, init, batch, sharded=True),
           "pinned": _run(pinned, init, batch),
           "bf16": _run(bf16, init, batch),
           "uneven": _run(dp, init, uneven),
           "clip_in_dp": dp.optimizer.clip_spec_fn is None,
           "clip_in_sharded": sharded.optimizer.clip_spec_fn is not None}
    s = out["sharded"]
    out["sharded_bytes"] = sharded.opt_state_bytes_per_replica(s["opt"])
    out["dp_bytes"] = dp.opt_state_bytes_per_replica(out["dp"]["opt"])
    out["total_bytes"] = sharded.opt_state_bytes_total()
    s["opt"] = sharded.unshard_opt_state(s["opt"])
    # the global masked mean against the mean of the ranks' means
    out["uneven_global"] = dp.eval_step(init, uneven).item()
    local = {k: v[rank * BATCH // world:(rank + 1) * BATCH // world]
             for k, v in uneven.items()}
    out["uneven_local_mean"] = dp.eval_step(init, local).item()
    out["placements"] = [("shard", p.dim) if p.is_shard() else ("replicate",)
                         for p in mesh_placements(mesh, ("embed", "mlp"))]
    single = TrainStepBundle(cfg, device="cpu")
    single._bind(init)
    grads = torch.autograd.grad(single._loss(batch),
                                list(single._params.values()))
    out["grad_norm"] = torch.linalg.vector_norm(
        torch.stack([g.norm() for g in grads])).item()
    out["grad_l1"] = sum(g.abs().sum().item() for g in grads)
    errors = {}
    for what, call, exc in (
            ("moe", lambda: TrainStepBundle(
                dataclasses.replace(CONFIGS["moe-tiny"], n_experts=3,
                                    dtype=torch.float32),
                mesh=_mesh({"expert": world}, world)), ValueError),
            ("rows", lambda: dp.step(init, dp.init(0)[1], dp.make_batch(
                np.random.default_rng(0), 3, SEQ)), ValueError),
            ("mesh_size", lambda: _mesh({"data": 2 * world}, world),
             ValueError)):
        try:
            call()
        except exc as e:
            errors[what] = str(e)
    seq = TrainStepBundle(cfg, mesh=_mesh({"seq": world}, world))
    try:
        seq.step(init, seq.init(0)[1], seq.make_batch(
            np.random.default_rng(0), BATCH, SEQ + 1))
    except ValueError as e:
        errors["seq"] = str(e)
    out["errors"] = errors
    for flavour in ("dp", "sharded", "pinned", "bf16", "uneven"):
        opt = out[flavour]["opt"]
        out[flavour]["opt"] = {"mu": opt.mu, "nu": opt.nu}
    col.destroy_collective_group("dp")
    return out


def _jax_runs(params_path: str) -> dict:
    """The JAX bundle on a data=2 mesh of the 8 CPU devices: each flavour
    for STEPS steps from one init; the init saved for the ranks."""
    jax = _jax()
    import jax.numpy as jnp

    from ray_tpu.models.transformer import CONFIGS as JAX_CONFIGS
    from ray_tpu.parallel import TrainStepBundle as JaxBundle
    from ray_tpu.parallel import create_mesh
    from ray_tpu.parallel import make_optimizer as jax_make_optimizer
    from ray_tpu_torch.models import from_jax_params

    cfg = dataclasses.replace(JAX_CONFIGS["tiny"], dtype=jnp.float32)
    mesh = create_mesh({**dict.fromkeys(AXES, 1), "data": DP},
                       devices=jax.devices()[:DP])

    def factory(spec_fn):
        return jax_make_optimizer(**OPT, clip_spec_fn=spec_fn)

    def to_torch(tree):
        return from_jax_params(jax.tree_util.tree_map(np.asarray, tree))

    dp = JaxBundle(cfg, mesh, optimizer_factory=factory)
    params, _ = dp.init(jax.random.PRNGKey(0))
    torch.save(to_torch(params), params_path)
    batch = dp.make_batch(np.random.default_rng(0), BATCH, SEQ)
    mask = _uneven(np.asarray(batch["mask"]))
    uneven = dict(batch, mask=jax.device_put(mask, dp.batch_sharding))

    def run(bundle, batch, sharded=False):
        p, s = (bundle.init_sharded if sharded else bundle.init)(
            jax.random.PRNGKey(0))
        losses = []
        for _ in range(STEPS):
            p, s, loss = bundle.step(p, s, batch)
            losses.append(float(loss))
        return {"losses": losses, "params": to_torch(p), "opt": s}

    sharded = JaxBundle(cfg, mesh, optimizer_factory=factory,
                        shard_update=True)
    bf16 = JaxBundle(cfg, mesh, optimizer_factory=factory, grad_dtype="bf16")
    out = {"dp": run(dp, batch), "uneven": run(dp, uneven),
           "sharded": run(sharded, batch, sharded=True),
           "bf16": run(bf16, batch)}
    opt = out["sharded"]["opt"]
    out["sharded_bytes"] = sharded.opt_state_bytes_per_replica(opt)
    out["dp_bytes"] = dp.opt_state_bytes_per_replica(out["dp"]["opt"])
    # optax's two int32 step counts (scale_by_adam's and the schedule's):
    # the port keeps its one count on the host, not among the moments
    out["count_bytes"] = sum(np.asarray(x).nbytes
                             for x in jax.tree_util.tree_leaves(opt)
                             if np.ndim(x) == 0)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX runs, then the port's on one gloo world of 2 (rank 0's and
    rank 1's results)."""
    tmp = tmp_path_factory.mktemp("dp2")
    jax_out = _jax_runs(str(tmp / "init.pt"))
    ranks = run_world(os.path.abspath(__file__), "train_rank", DP, tmp,
                      timeout=240, params_path=str(tmp / "init.pt"))
    return jax_out, ranks


def _assert_params_close(got, want, atol):
    assert set(got) == set(want)
    worst = max((got[k] - want[k]).abs().max().item() for k in want)
    assert worst <= atol, f"params part by {worst:.3e} > {atol:.3e}"


@pytest.mark.parametrize("flavour", ["dp", "sharded", "uneven"])
def test_steps_match_jax(runs, flavour):
    """Three fp32 steps of the port's data-parallel step (shard_update off,
    on, and with uneven masks) against the JAX bundle's on a data=2
    mesh."""
    jax_out, ranks = runs
    for r in ranks:
        np.testing.assert_allclose(r[flavour]["losses"],
                                   jax_out[flavour]["losses"],
                                   rtol=LOSS_RTOL)
        _assert_params_close(r[flavour]["params"],
                             jax_out[flavour]["params"], _param_atol())


def test_bf16_grads_match_jax(runs):
    """grad_dtype="bf16" against JAX's bf16 flavour. The port rounds each
    rank's gradient to bf16 and sums in bf16 (the wire carries bf16); the
    JAX program sums in fp32 and rounds the sum once. So the gradients part
    by up to three bf16 roundings (2^-8 of a gradient each), and Adam's
    normalised step m_hat / sqrt(v_hat), with the clip's factor, by a few
    more: 2^-6 of its size at most, which is below 1.2 lr_t. Parameters:
    within Adam's update bound. Losses: the first two steps see the same
    parameters (the rate is 0 at step 0); after that the loss moves by at
    most sum_i |g_i| |dp_i|, so |loss - loss_jax| <= |g|_1 x 1.2 x 2^-6 x
    sum(lr_s), |g|_1 the first step's gradient. The bf16 rounding must
    show: the third loss differs from the fp32 run's."""
    jax_out, ranks = runs
    sched = make_optimizer(**OPT).schedule
    for r in ranks:
        got, want = r["bf16"]["losses"], jax_out["bf16"]["losses"]
        assert got[:2] == r["dp"]["losses"][:2]
        np.testing.assert_allclose(got[:2], want[:2], rtol=LOSS_RTOL)
        for t in range(2, STEPS):
            bound = r["grad_l1"] * ADAM_RATIO * 2.0 ** -6 * sum(
                sched(s) for s in range(t))
            assert abs(got[t] - want[t]) <= bound, (t, got[t], want[t],
                                                     bound)
        assert got[2] != r["dp"]["losses"][2]
        _assert_params_close(r["bf16"]["params"], jax_out["bf16"]["params"],
                             _param_atol())


def test_ranks_hold_the_same_state(runs):
    _, (r0, r1) = runs
    for flavour in ("dp", "sharded", "pinned", "bf16", "uneven"):
        assert r0[flavour]["losses"] == r1[flavour]["losses"]
        for k, p in r0[flavour]["params"].items():
            assert torch.equal(p, r1[flavour]["params"][k]), (flavour, k)


def test_sharded_step_bitexact_vs_unsharded(runs):
    """tests/test_train.py's contract: the sharded update reproduces the
    unsharded step bit for bit in fp32 over 3 steps with the engaged clip,
    params and the moments after gathering, when both take the global
    norm in the pinned association (the unsharded step computes every
    shard's partial sum itself; at world 2 the reduce-scatter's sums and
    the all-reduce's are the same a + b)."""
    _, ranks = runs
    for r in ranks:
        s, p = r["sharded"], r["pinned"]
        assert s["losses"] == p["losses"]
        for k in p["params"]:
            assert torch.equal(s["params"][k], p["params"][k]), k
            assert torch.equal(s["opt"]["mu"][k], p["opt"]["mu"][k]), k
            assert torch.equal(s["opt"]["nu"][k], p["opt"]["nu"][k]), k
        assert r["clip_in_dp"] and r["clip_in_sharded"]


def test_clip_engages(runs):
    """The global gradient norm at the first step is above the clip's 0.05,
    so every flavour's clip scales (tests/test_train.py's fixture)."""
    _, ranks = runs
    assert all(r["grad_norm"] > OPT["clip"] for r in ranks)


def test_opt_state_bytes_match_jax(runs):
    """tests/test_train.py:267: the sharded state's bytes a replica, half
    the unsharded state's at data=2 (every tiny leaf has an even first
    dim), equal to JAX's but for optax's two int32 step counts, which the
    port keeps as one count on the host."""
    jax_out, ranks = runs
    for r in ranks:
        assert r["sharded_bytes"] == jax_out["sharded_bytes"] - \
            jax_out["count_bytes"]
        assert r["dp_bytes"] == jax_out["dp_bytes"] - jax_out["count_bytes"]
        assert r["dp_bytes"] == r["total_bytes"] == DP * r["sharded_bytes"]


def test_uneven_masks_take_the_global_mean(runs):
    """With 4 valid tokens on rank 0 and 64 on rank 1 the step's loss is
    the masked mean over the whole batch, not the mean of the ranks'
    means."""
    _, ranks = runs
    local_means = [r["uneven_local_mean"] for r in ranks]
    for r in ranks:
        first = r["uneven"]["losses"][0]
        np.testing.assert_allclose(first, r["uneven_global"], rtol=1e-6)
        assert abs(first - np.mean(local_means)) > 1e-3


def test_refusals(runs):
    """Experts the expert axis does not split, rows the seq axis does not
    split, a batch the data axis does not split and a mesh that does not
    match the world raise, naming why."""
    _, ranks = runs
    for r in ranks:
        errors = r["errors"]
        assert "layer_0.moe." in errors["moe"]
        assert "(expert, 3)" in errors["moe"]
        assert "expert axis's 2" in errors["moe"]
        assert "seq axis's 2" in errors["seq"]
        assert "does not split" in errors["rows"]
        assert "need" in errors["mesh_size"]
        # an (embed, mlp) kernel: embed on fsdp, mlp on tensor
        assert r["placements"] == [("replicate",), ("shard", 0),
                                   ("replicate",), ("shard", 1),
                                   ("replicate",)]


def test_compression_raises():
    with pytest.raises(ValueError, match="queue 1"):
        TrainStepBundle(_cfg(), device="cpu", compression="int8")
    with pytest.raises(ValueError, match="grad_dtype"):
        TrainStepBundle(_cfg(), device="cpu", grad_dtype="fp16")
