"""The port's train step on meshes with the seq and expert axes against the
JAX bundle's on the same meshes, and the MoE layer on virtual ranks.

- ``TrainStepBundle`` on four gloo meshes (``RankWorld``: the three of 8
  ranks one after the other in one world, while the parent runs the JAX
  references), fp32, the JAX bundle's initial
  weights carried over (``from_jax_params``), a clip low enough to
  engage, three steps on one batch of 4 x 32:

  - ``moe-tiny`` on seq 2 x tensor 2 x expert 2 (the mesh of
    tests/test_moe_vit.py's test_moe_trains_on_expert_mesh);
  - ``moe-tiny`` on data 2 x fsdp 2 x expert 2: the 128 tokens are one
    routing group, which spans all four token ranks;
  - ``tiny`` on data 2 x seq 2 x tensor 2: 2 query heads and 1 KV head a
    rank, repeated to 2 for the ring;
  - ``tiny`` on seq 4: the ring's causal skip across four ranks.

  Against the JAX bundle on a mesh of the CPU devices with the same axes:
  the first step's gradient of every leaf (which Adam's normalised step
  would hide: a leaf's gradient counted twice moves no parameter; taken
  on the config's first mesh, the expert mesh for moe-tiny); losses,
  and ``eval_step`` before the first and after the last step, at rtol 1e-5;
  gathered parameters within Adam's update bound; placements and
  optimizer-state bytes against JAX's ``param_shardings``; with data > 1
  the sharded update too.
- In one process: ``MoEMLP`` split over virtual token, tensor and expert
  ranks (``expert_parallel.VirtualRanks``) against the whole layer, with
  groups that span token ranks; and two mutations that count aux per
  rank, which the same check must catch.

The ranks import this module, so it loads torch, numpy and the port only;
the JAX package is imported in the parent's reference helpers.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from test_torch_collective import RankWorld
from test_torch_mesh import (_assert_params_close, _factory, _mesh,
                             _param_atol, _run, _spec_of_placements, _jax,
                             init_leaf)

from ray_tpu_torch.models import CONFIGS
from ray_tpu_torch.models.transformer import MoEMLP, state_dict_shapes
from ray_tpu_torch.parallel import AXES, TrainStepBundle
from ray_tpu_torch.parallel import expert_parallel

OPT = dict(learning_rate=1e-2, warmup_steps=2, total_steps=100, clip=0.05)
BATCH, SEQ, STEPS = 4, 32, 3
LOSS_RTOL = 1e-5
# A leaf's first-step gradient against JAX's, ||got - want|| / ||want||: the
# same fp32 products summed in other orders (GSPMD's partial sums against
# the ranks' collectives), a few units of 2^-24 relative at each of some
# tens of roundings along the longest path; 1e-5 leaves room, and a leaf
# counted twice or half (the aux, an expert replica) parts by 0.5 or more.
GRAD_RTOL = 1e-5
# mesh -> (config, axes, world)
MESHES = {
    "moe_seq2_tp2_ep2": ("moe-tiny", {"seq": 2, "tensor": 2, "expert": 2}, 8),
    "moe_dp2_fsdp2_ep2": ("moe-tiny", {"data": 2, "fsdp": 2, "expert": 2},
                          8),
    "tiny_dp2_seq2_tp2": ("tiny", {"data": 2, "seq": 2, "tensor": 2}, 8),
    "tiny_seq4": ("tiny", {"seq": 4}, 4),
}


def _cfg(name):
    return dataclasses.replace(CONFIGS[name], dtype=torch.float32)


# -- the ranks ----------------------------------------------------------------


def mesh_rank(rank: int, world: int, store: str, cases: dict) -> dict:
    """One rank's runs of the step on each mesh of ``cases`` (name ->
    config, axes, the initial weights' path), one after the other in one
    world (what ``RankWorld`` runs); the results by mesh."""
    from ray_tpu_torch import collective as col

    col.init_collective_group(world, rank, group_name="mesh", device="cpu",
                              init_method=f"file://{store}")
    results = {name: _mesh_run(config, axes, torch.load(path))
               for name, (config, axes, path) in cases.items()}
    col.destroy_collective_group("mesh")
    return results


def _mesh_run(config: str, axes: dict, init: dict) -> dict:
    mesh = _mesh(axes)
    cfg = _cfg(config)
    plain = TrainStepBundle(cfg, mesh=mesh, optimizer_factory=_factory)
    batch = plain.make_batch(np.random.default_rng(0), BATCH, SEQ)
    loss, grads = plain.gradients(init, batch)
    out = {"grad_loss": loss.item(), "grads": plain.gather_leaves(grads),
           "eval": plain.eval_step(init, batch).item(),
           "plain": _run(plain, init, batch)}
    if axes.get("data", 1) > 1:
        sharded = TrainStepBundle(cfg, mesh=mesh, shard_update=True,
                                  optimizer_factory=_factory)
        out["sharded"] = _run(sharded, init, batch, sharded=True)
    shapes = state_dict_shapes(cfg)
    out["placements"] = {
        k: _spec_of_placements(pl, mesh.mesh_dim_names, len(shapes[k]))
        for k, pl in plain.param_placements.items()}
    out["coords"] = plain.coords
    return out


# -- the JAX reference --------------------------------------------------------


def _jax_cfg(name):
    import jax.numpy as jnp

    from ray_tpu.models.transformer import CONFIGS as JAX_CONFIGS

    return dataclasses.replace(JAX_CONFIGS[name], dtype=jnp.float32)


def _jax_init(config: str, params_path: str):
    """The JAX bundle's initial weights of ``config`` (one device), saved
    for the ranks; the numpy tree."""
    jax = _jax()

    from ray_tpu.parallel import TrainStepBundle as JaxBundle
    from ray_tpu.parallel import create_mesh
    from ray_tpu_torch.models import from_jax_params

    bundle = JaxBundle(_jax_cfg(config), create_mesh(
        dict.fromkeys(AXES, 1), devices=jax.devices()[:1]))
    params = jax.tree_util.tree_map(np.asarray,
                                    bundle.init(jax.random.PRNGKey(0))[0])
    torch.save(from_jax_params(params), params_path)
    return params


def _jax_run(init, config: str, axes: dict, world: int,
             grads: bool) -> dict:
    """The JAX bundle on a mesh of ``axes`` over the first ``world`` CPU
    devices: ``eval_step`` before and after, STEPS steps from ``init``,
    placements and optimizer-state bytes; with ``grads``, the first step's
    gradients too."""
    jax = _jax()

    from ray_tpu.parallel import TrainStepBundle as JaxBundle
    from ray_tpu.parallel import create_mesh
    from ray_tpu.parallel import make_optimizer as jax_make_optimizer
    from ray_tpu_torch.models import from_jax_params

    mesh = create_mesh({**dict.fromkeys(AXES, 1), **axes},
                       devices=jax.devices()[:world])
    bundle = JaxBundle(_jax_cfg(config), mesh, optimizer_factory=lambda fn:
                       jax_make_optimizer(**OPT, clip_spec_fn=fn))
    params = jax.device_put(init, bundle.param_shardings)
    # the optimizer's fresh state, eagerly (no init program to compile)
    opt = jax.device_put(bundle.optimizer.init(init), bundle.opt_shardings)
    batch = bundle.make_batch(np.random.default_rng(0), BATCH, SEQ)

    def numpy(tree):
        return from_jax_params(jax.tree_util.tree_map(np.asarray, tree))

    out = {"eval": float(bundle.eval_step(params, batch))}
    if grads:
        out["grads"] = numpy(jax.jit(jax.grad(bundle._loss_fn))(
            params, batch["tokens"], batch["targets"], batch["mask"]))
    losses = []
    for _ in range(STEPS):
        params, opt, loss = bundle.step(params, opt, batch)
        losses.append(float(loss))
    specs = jax.tree_util.tree_flatten_with_path(
        bundle.param_shardings, is_leaf=lambda x: hasattr(x, "spec"))[0]
    out.update(
        losses=losses, eval_final=float(bundle.eval_step(params, batch)),
        params=numpy(params),
        bytes=bundle.opt_state_bytes_per_replica(opt)
        # optax's two int32 step counts: the port keeps one on the host
        - sum(np.asarray(x).nbytes for x in jax.tree_util.tree_leaves(opt)
              if np.ndim(x) == 0),
        placements={".".join(str(k.key) for k in path): tuple(s.spec) + (
            None,) * (np.ndim(init_leaf(init, path)) - len(s.spec))
            for path, s in specs})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's ranks and the JAX runs, overlapped: once the initial
    weights are saved, one world of 8 ranks runs the meshes of 8 one after
    the other while the parent runs the JAX bundle on every mesh (the
    first mesh of each config also takes the gradients, which every mesh
    of the config is held against: the JAX bundle computes the global
    function on every mesh); then a world of 4 runs seq 4. Returns mesh ->
    (the JAX run, each rank's results)."""
    tmp = tmp_path_factory.mktemp("seq_expert")
    inits, refs, grads = {}, {}, {}
    for config in ("tiny", "moe-tiny"):
        path = str(tmp / f"{config}.pt")
        inits[config] = (_jax_init(config, path), path)

    def start(n):
        cases = {name: (config, axes, inits[config][1])
                 for name, (config, axes, world) in MESHES.items()
                 if world == n}
        (tmp / f"world{n}").mkdir()
        return cases, RankWorld(os.path.abspath(__file__), "mesh_rank", n,
                                tmp / f"world{n}", cases=cases)

    worlds = [start(8)]
    for name, (config, axes, n) in MESHES.items():
        refs[name] = _jax_run(inits[config][0], config, axes, n,
                              grads=config not in grads)
        grads.setdefault(config, refs[name].get("grads"))
        refs[name]["grads"] = grads[config]
    worlds[0] = (worlds[0][0], worlds[0][1].wait(300))
    cases, world4 = start(4)
    worlds.append((cases, world4.wait(300)))
    return {name: (refs[name], [r[name] for r in ranks])
            for cases, ranks in worlds for name in cases}


# -- the steps against JAX ----------------------------------------------------


@pytest.mark.parametrize("mesh", list(MESHES))
def test_gradients_match_jax(runs, mesh):
    """The first step's gradient of every leaf, gathered whole, against
    JAX's on the same mesh within GRAD_RTOL of its norm: among them the
    router's (split over expert, used whole by every expert rank), the
    expert stacks' (whose rows each expert rank computes alone, summed over
    the token ranks) and ``attn_norm.scale`` (replicated over every axis)."""
    ref, ranks = runs[mesh]
    for r in ranks:
        assert set(r["grads"]) == set(ref["grads"])
        for k, want in ref["grads"].items():
            err = ((r["grads"][k] - want).norm() / want.norm()).item()
            assert err <= GRAD_RTOL, f"{k}: {err:.3e}"


@pytest.mark.parametrize("mesh", list(MESHES))
def test_steps_match_jax(runs, mesh):
    """Three steps: losses at rtol 1e-5 (the step's loss before it, the MoE
    aux counted once), ``eval_step`` on the initial and on the final
    parameters likewise, whole parameters within Adam's update bound; with
    data > 1 the sharded update against the same reference."""
    ref, ranks = runs[mesh]
    for r in ranks:
        np.testing.assert_allclose(r["grad_loss"], ref["losses"][0],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["eval"], ref["eval"], rtol=LOSS_RTOL)
        for flavour in ("plain", "sharded"):
            if flavour not in r:
                continue
            np.testing.assert_allclose(r[flavour]["losses"], ref["losses"],
                                       rtol=LOSS_RTOL)
            np.testing.assert_allclose(r[flavour]["eval_final"],
                                       ref["eval_final"], rtol=LOSS_RTOL)
            _assert_params_close(r[flavour]["params"], ref["params"],
                                 _param_atol())
        assert ("sharded" in r) == (MESHES[mesh][1].get("data", 1) > 1)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_placements_and_bytes_match_jax(runs, mesh):
    """Each leaf's placements as a partition spec equal JAX's
    ``param_shardings`` (the expert stacks' experts and the router's
    columns on ``expert``); the optimizer state's bytes a replica equal
    JAX's but for optax's step counts; every rank ends with the same
    parameters."""
    ref, ranks = runs[mesh]
    for r in ranks:
        assert r["placements"] == ref["placements"]
        assert r["plain"]["bytes"] == ref["bytes"]
        for k, p in ranks[0]["plain"]["params"].items():
            assert torch.equal(p, r["plain"]["params"][k]), k
    if MESHES[mesh][0] == "moe-tiny" and "expert" in MESHES[mesh][1]:
        assert ref["placements"]["layer_0.moe.gate_proj"][0] == "expert"
        assert ref["placements"]["layer_0.moe.router.kernel"][1] == "expert"


def test_ranks_take_seq_inside_the_rows(runs):
    """On data 2 x seq 2 x tensor 2 the ranks are (data, seq, tensor) in
    row-major order, as the JAX mesh lays the devices out."""
    _, ranks = runs["tiny_dp2_seq2_tp2"]
    got = [(r["coords"]["data"], r["coords"]["seq"], r["coords"]["tensor"])
           for r in ranks]
    assert got == [(d, s, t) for d in range(2) for s in range(2)
                   for t in range(2)]


# -- the MoE layer on virtual ranks -------------------------------------------

# (rows, seq, tensor, experts): tokens over rows and seq chunks, the expert
# FFN's mlp dim over tensor, the experts over expert
VIRTUAL = [(2, 1, 1, 1), (1, 2, 1, 1), (4, 1, 1, 1), (1, 1, 1, 2),
           (1, 1, 1, 4), (1, 1, 2, 2), (2, 2, 2, 2)]
AUX_COEF = 3.0  # large, so that a mis-counted aux shows in every leaf


def _check_layer(axes, layer, x, dout) -> None:
    """The layer on ``axes`` against the whole layer at 1e-5 relative:
    each rank's output (its tokens'), aux, input gradient, and each weight's
    gradient summed over the token ranks (the router's whole, each stack's
    piece: its experts' rows, its mlp columns)."""
    out, aux = layer(x)
    loss = (out * dout).sum() + AUX_COEF * aux
    names = [k for k, _ in layer.named_parameters()]
    want = dict(zip(["x"] + names, torch.autograd.grad(
        loss, [x] + list(layer.parameters()))))
    got = axes.layer_grads(layer, x, dout, AUX_COEF)
    _, _, tensor, experts = axes.shape
    for i in range(axes.size):
        torch.testing.assert_close(got["out"][i], axes.local(i, out),
                                   rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(got["aux"][i], aux, rtol=1e-5, atol=0)
        torch.testing.assert_close(got["dx"][i], axes.local(i, want["x"]),
                                   rtol=1e-5, atol=1e-7)
    for (t, e, name), g in got["dw"].items():
        w = want[name]
        if name != "router.kernel":
            mlp_dim = 1 if name == "down_proj" else 2
            w = w.chunk(experts, 0)[e].chunk(tensor, mlp_dim)[t]
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6 * w.abs().max(),
                                   msg=lambda m, n=name: f"{n}: {m}")


def _layer_case(monkeypatch):
    """moe-tiny's layer in fp32 on 4 x 16 tokens in groups of 32 (two
    groups, each of two rows: at 4 row ranks a group spans two of them),
    at a capacity that drops slots."""
    monkeypatch.setattr(MoEMLP, "GROUP_SIZE", 32)
    cfg = dataclasses.replace(_cfg("moe-tiny"), capacity_factor=1.0)
    layer = MoEMLP(cfg, device="cpu", seed=1)
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(4, 16, cfg.d_model, generator=gen, requires_grad=True)
    dout = torch.randn(4, 16, cfg.d_model, generator=gen)
    return layer, x, dout


@pytest.mark.parametrize("shape", VIRTUAL)
def test_moe_layer_on_virtual_ranks_matches_the_layer(monkeypatch, shape):
    """``MoEMLP.forward_ranks`` on virtual ranks (``VirtualRanks``: every
    rank's module, its tokens and the collectives in one process) equals
    the whole layer at 1e-5: routing groups that span token ranks, slots
    counted in global order (a slot dropped on one device is dropped on
    the ranks), aux from global statistics; each rank's experts and mlp
    columns with the right share of the gradient."""
    layer, x, dout = _layer_case(monkeypatch)
    routing = layer.route(x.detach().reshape(-1, 32, x.shape[-1]))
    assert not routing.keep.all()  # the capacity drops slots
    _check_layer(expert_parallel.VirtualRanks(*shape), layer, x, dout)


class _LocalAux(expert_parallel.VirtualRanks):
    """A mutation: each rank's aux from its own tokens' statistics."""

    def sum_tokens(self, xs):
        return list(xs)


class _AuxGradOnce(expert_parallel.VirtualRanks):
    """A mutation: the statistics summed over the token ranks with an
    identity backward (each rank's router gets 1 / R of the aux's
    gradient)."""

    def sum_tokens(self, xs):
        out = super().sum_tokens([x.detach() for x in xs])
        return [o.detach() + x - x.detach() for o, x in zip(out, xs)]


@pytest.mark.parametrize("mutant", [_LocalAux, _AuxGradOnce])
def test_aux_counted_per_rank_fails(monkeypatch, mutant):
    """Counting aux per rank, from local statistics or with the global
    value's gradient split over the ranks, fails the check that the real
    axes pass (on 4 token ranks)."""
    layer, x, dout = _layer_case(monkeypatch)
    _check_layer(expert_parallel.VirtualRanks(4, 1, 1, 1), layer, x, dout)
    with pytest.raises(AssertionError):
        _check_layer(mutant(4, 1, 1, 1), layer, x, dout)
