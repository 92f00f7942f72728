"""The port's train step on meshes of data x fsdp x tensor against the JAX
bundle's on the same meshes.

- ``TrainStepBundle`` on three gloo worlds (``run_world``), each run once:
  ``data 2 x fsdp 2 x tensor 2`` (world 8, the mesh of
  tests/test_models_ops.py's dp/fsdp/tp step), ``fsdp 2 x tensor 2``
  (world 4) and ``default_mesh_axes(4)``, i.e. ``fsdp 4`` (world 4, the JAX
  package's own layout for 4 devices). ``CONFIGS["tiny"]`` in fp32, the
  JAX bundle's initial weights carried over (``from_jax_params``), a clip
  low enough to engage, three steps on one batch, against the JAX bundle
  on a mesh of the 8 CPU devices of the same axes fed the same batch:
  losses at rtol 1e-5 and gathered parameters within Adam's update bound
  ``2 x 1.2 x sum(lr_t)`` (tests/test_torch_train.py). On the world of 8
  also ``shard_update=True`` (and the unsharded step with its pinned
  clip, bit for bit) and ``grad_dtype="bf16"``, its bound stated.
- Each leaf's placements against the JAX bundle's ``param_shardings``,
  leaf for leaf; ``opt_state_bytes_per_replica`` against JAX's; every
  rank's gathered parameters identical.
- In one process: the tensor axis's operators at T = 2 and 4 against
  their plain versions (the embedding, the cross entropy), the model's
  forward and backward on T ranks run as threads through the port's own
  modules, the single-device step bit for bit what the model, ``lm_loss``
  and the optimizer compose, and the refusals.

The ranks import this module, so it loads torch, numpy and the port only;
the JAX package is imported in the parent's reference helpers.
"""

import concurrent.futures
import dataclasses
import functools
import os
import threading

import numpy as np
import pytest
import torch

from test_torch_collective import run_world

from ray_tpu_torch.models import CONFIGS, Transformer
from ray_tpu_torch.models.transformer import (lm_loss, masked_mean,
                                              state_dict_shapes)
from ray_tpu_torch.parallel import (AXES, TrainStepBundle, default_mesh_axes,
                                    make_optimizer, param_layout)
from ray_tpu_torch.parallel.mesh import cut_leaf, piece_shape
from ray_tpu_torch.parallel.tensor_parallel import (StackedRanks, TensorAxis,
                                                    bind_tensor,
                                                    embedding_partial,
                                                    vocab_parallel_lm_loss,
                                                    vocab_parallel_nll)

OPT = dict(learning_rate=1e-2, warmup_steps=2, total_steps=100, clip=0.05)
BATCH, SEQ, STEPS = 4, 32, 3
LOSS_RTOL = 1e-5
ADAM_RATIO = 1.2  # tests/test_torch_train.py: Adam's step is below 1.2 lr_t
# mesh -> (axes, world, flavours of the step run on it)
MESHES = {
    "dp2_fsdp2_tp2": ({"data": 2, "fsdp": 2, "tensor": 2}, 8,
                      ("plain", "sharded", "pinned", "bf16")),
    "fsdp2_tp2": ({"fsdp": 2, "tensor": 2}, 4, ("plain",)),
    "fsdp4": ({k: n for k, n in default_mesh_axes(4).items() if n > 1}, 4,
              ("plain",)),
}
JAX_FLAVOURS = ("plain", "sharded", "bf16")


def _param_atol(steps=STEPS):
    sched = make_optimizer(**OPT).schedule
    return 2 * ADAM_RATIO * sum(sched(t) for t in range(steps))


def _cfg(name="tiny"):
    return dataclasses.replace(CONFIGS[name], dtype=torch.float32)


def _factory(spec_fn):
    return make_optimizer(**OPT, clip_spec_fn=spec_fn)


def _mesh(axes):
    from ray_tpu_torch.parallel import create_mesh

    return create_mesh({**dict.fromkeys(AXES, 1), **axes}, device="cpu")


def _spec_of_placements(placements, names, ndim):
    """DTensor placements (one a mesh axis) as a partition spec: each dim's
    mesh axis or None."""
    spec = [None] * ndim
    for axis, p in zip(names, placements):
        if p.is_shard():
            spec[p.dim] = axis
    return tuple(spec)


# -- the ranks ----------------------------------------------------------------


def _run(bundle, params, batch, sharded=False):
    opt = (bundle.init_sharded if sharded else bundle.init)(0)[1]
    losses = []
    for _ in range(STEPS):
        params, opt, loss = bundle.step(params, opt, batch)
        losses.append(loss.item())
    out = {"losses": losses, "params": bundle.gather_params(),
           "eval_final": bundle.eval_step(params, batch).item(),
           "bytes": bundle.opt_state_bytes_per_replica(opt)}
    if sharded:  # the moments back on this rank's pieces
        opt = bundle.unshard_opt_state(opt)
    out["opt"] = {"mu": opt.mu, "nu": opt.nu}
    return out


def _refusals(world: int) -> dict:
    """What the step refuses on a world of 4, by message."""
    errors = {}
    cases = (
        ("seq", lambda: TrainStepBundle(_cfg(), mesh=_mesh({"seq": world}))),
        ("expert", lambda: TrainStepBundle(_cfg(),
                                           mesh=_mesh({"expert": world}))),
        ("moe_fsdp", lambda: TrainStepBundle(_cfg("moe-tiny"),
                                             mesh=_mesh({"fsdp": world}))),
        ("moe_tensor", lambda: TrainStepBundle(
            _cfg("moe-tiny"), mesh=_mesh({"tensor": world}))),
        ("kv_heads", lambda: TrainStepBundle(_cfg(),
                                             mesh=_mesh({"tensor": world}))))
    for what, call in cases:
        try:
            call()
        except (NotImplementedError, ValueError) as e:
            errors[what] = f"{type(e).__name__}: {e}"
    return errors


def mesh_rank(rank: int, world: int, store: str, params_path: str,
              axes: dict, flavours: tuple) -> dict:
    """One rank's runs of the step on the mesh of ``axes`` (what
    ``run_world`` calls)."""
    from ray_tpu_torch import collective as col

    col.init_collective_group(world, rank, group_name="mesh", device="cpu",
                              init_method=f"file://{store}")
    init = torch.load(params_path)
    mesh = _mesh(axes)
    cfg = _cfg()
    plain = TrainStepBundle(cfg, mesh=mesh, optimizer_factory=_factory)
    batch = plain.make_batch(np.random.default_rng(0), BATCH, SEQ)
    shapes = state_dict_shapes(cfg)
    out = {"eval": plain.eval_step(init, batch).item(),
           "plain": _run(plain, init, batch)}
    if "sharded" in flavours:
        sharded = TrainStepBundle(cfg, mesh=mesh, shard_update=True,
                                  optimizer_factory=_factory)
        out["sharded"] = _run(sharded, init, batch, sharded=True)
        pinned = TrainStepBundle(cfg, mesh=mesh, optimizer=sharded.optimizer)
        out["pinned"] = _run(pinned, init, batch)
    if "bf16" in flavours:
        bf16 = TrainStepBundle(cfg, mesh=mesh, optimizer_factory=_factory,
                               grad_dtype="bf16")
        out["bf16"] = _run(bf16, init, batch)
        single = TrainStepBundle(cfg, device="cpu")
        leaves = list(single._bind(init).values())
        grads = torch.autograd.grad(single._loss(batch), leaves)
        out["grad_l1"] = sum(g.abs().sum().item() for g in grads)
    out["placements"] = {
        k: _spec_of_placements(pl, mesh.mesh_dim_names, len(shapes[k]))
        for k, pl in plain.param_placements.items()}
    out["coords"] = plain.coords
    if "sharded" not in flavours and axes.get("fsdp") == world:
        out["errors"] = _refusals(world)
    col.destroy_collective_group("mesh")
    return out


# -- the JAX reference ----------------------------------------------------------


def _jax():
    # the JAX reference; the card's machine lacks flax
    pytest.importorskip("flax")
    import jax

    return jax


def _jax_init(params_path: str):
    """The JAX bundle's initial weights (one device), saved for the ranks;
    the numpy tree."""
    jax = _jax()

    from ray_tpu.parallel import TrainStepBundle as JaxBundle
    from ray_tpu.parallel import create_mesh
    from ray_tpu_torch.models import from_jax_params

    bundle = JaxBundle(_jax_cfg(), create_mesh(
        dict.fromkeys(AXES, 1), devices=jax.devices()[:1]))
    params = jax.tree_util.tree_map(np.asarray,
                                    bundle.init(jax.random.PRNGKey(0))[0])
    torch.save(from_jax_params(params), params_path)
    return params


def _jax_cfg():
    import jax.numpy as jnp

    from ray_tpu.models.transformer import CONFIGS as JAX_CONFIGS

    return dataclasses.replace(JAX_CONFIGS["tiny"], dtype=jnp.float32)


def _jax_runs(init, axes: dict, world: int, flavours) -> dict:
    """The JAX bundle on a mesh of ``axes`` over the first ``world`` CPU
    devices: each flavour for STEPS steps from ``init``; its placements and
    optimizer-state bytes."""
    jax = _jax()

    from ray_tpu.parallel import TrainStepBundle as JaxBundle
    from ray_tpu.parallel import create_mesh
    from ray_tpu.parallel import make_optimizer as jax_make_optimizer
    from ray_tpu_torch.models import from_jax_params

    mesh = create_mesh({**dict.fromkeys(AXES, 1), **axes},
                       devices=jax.devices()[:world])

    def factory(spec_fn):
        return jax_make_optimizer(**OPT, clip_spec_fn=spec_fn)

    out = {}
    for flavour in flavours:
        bundle = JaxBundle(_jax_cfg(), mesh, optimizer_factory=factory,
                           shard_update=flavour == "sharded",
                           grad_dtype="bf16" if flavour == "bf16" else "fp32")
        _, opt = (bundle.init_sharded if flavour == "sharded"
                  else bundle.init)(jax.random.PRNGKey(0))
        params = jax.device_put(init, bundle.param_shardings)
        batch = bundle.make_batch(np.random.default_rng(0), BATCH, SEQ)
        losses = []
        for _ in range(STEPS):
            params, opt, loss = bundle.step(params, opt, batch)
            losses.append(float(loss))
        out[flavour] = {
            "losses": losses,
            "eval_final": float(bundle.eval_step(params, batch)),
            "params": from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                             params)),
            "bytes": bundle.opt_state_bytes_per_replica(opt),
            # optax's two int32 step counts (scale_by_adam's and the
            # schedule's): the port keeps its one count on the host
            "count_bytes": sum(np.asarray(x).nbytes
                               for x in jax.tree_util.tree_leaves(opt)
                               if np.ndim(x) == 0)}
        if flavour == "plain":
            out["eval"] = float(bundle.eval_step(
                jax.device_put(init, bundle.param_shardings), batch))
            specs = jax.tree_util.tree_flatten_with_path(
                bundle.param_shardings,
                is_leaf=lambda x: hasattr(x, "spec"))[0]
            out["placements"] = {
                ".".join(str(k.key) for k in path): tuple(s.spec) + (None,) * (
                    np.ndim(init_leaf(init, path)) - len(s.spec))
                for path, s in specs}
    return out


def init_leaf(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """For each mesh: the JAX runs, then the port's ranks' results (one
    after the other, so that the CPU holds one world's ranks at a
    time)."""
    tmp = tmp_path_factory.mktemp("mesh")
    params_path = str(tmp / "init.pt")
    init = _jax_init(params_path)
    out = {}
    for name, (axes, n, flavours) in MESHES.items():
        ref = _jax_runs(init, axes, n,
                        [f for f in flavours if f in JAX_FLAVOURS])
        where = tmp / name
        where.mkdir()
        out[name] = (ref, run_world(
            os.path.abspath(__file__), "mesh_rank", n, where, timeout=240,
            params_path=params_path, axes=axes, flavours=flavours))
    return out


def _assert_params_close(got, want, atol):
    assert set(got) == set(want)
    worst = max((got[k] - want[k]).abs().max().item() for k in want)
    assert worst <= atol, f"params part by {worst:.3e} > {atol:.3e}"


# -- the steps against JAX ------------------------------------------------------


@pytest.mark.parametrize("mesh,flavour", [("dp2_fsdp2_tp2", "plain"),
                                          ("dp2_fsdp2_tp2", "sharded"),
                                          ("fsdp2_tp2", "plain"),
                                          ("fsdp4", "plain")])
def test_steps_match_jax(runs, mesh, flavour):
    """Three fp32 steps of the port's step against the JAX bundle's on the
    same mesh: losses at rtol 1e-5, and ``eval_step`` on the parameters the
    last step left likewise (the loss after every update, the third
    included), whole parameters within Adam's update bound."""
    ref, ranks = runs[mesh]
    for r in ranks:
        np.testing.assert_allclose(r[flavour]["losses"],
                                   ref[flavour]["losses"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(r[flavour]["eval_final"],
                                   ref[flavour]["eval_final"], rtol=LOSS_RTOL)
        _assert_params_close(r[flavour]["params"], ref[flavour]["params"],
                             _param_atol())


def test_bf16_grads_match_jax(runs):
    """grad_dtype="bf16" on data 2 x fsdp 2 x tensor 2 against JAX's bf16
    flavour. The port rounds each rank's gradient to bf16, sums it over
    fsdp (a reduce-scatter) and over data (an all-reduce) in bf16, one
    rounding a sum; the JAX program sums in fp32 and rounds the sum once.
    So the gradients part by up to four bf16 roundings (2^-8 of a gradient
    each), and Adam's normalised step m_hat / sqrt(v_hat), with the clip's
    factor, by twice that: 2^-5 of its size at most, which is below 1.2
    lr_t. Parameters: within Adam's update bound. Losses: the first two
    steps see the same parameters (the rate is 0 at step 0); after that the
    loss moves by at most sum_i |g_i| |dp_i|, so |loss - loss_jax| <= |g|_1
    x 1.2 x 2^-5 x sum(lr_s), |g|_1 the first step's gradient; likewise
    ``eval_step`` on the last step's parameters, after all three updates.
    The bf16 rounding must show: the third loss differs from the fp32
    run's."""
    ref, ranks = runs["dp2_fsdp2_tp2"]
    sched = make_optimizer(**OPT).schedule
    for r in ranks:
        g_l1 = r["grad_l1"]
        got, want = r["bf16"]["losses"], ref["bf16"]["losses"]
        assert got[:2] == r["plain"]["losses"][:2]
        np.testing.assert_allclose(got[:2], want[:2], rtol=LOSS_RTOL)
        got = got + [r["bf16"]["eval_final"]]
        want = want + [ref["bf16"]["eval_final"]]
        for t in range(2, STEPS + 1):
            bound = g_l1 * ADAM_RATIO * 2.0 ** -5 * sum(
                sched(s) for s in range(t))
            assert abs(got[t] - want[t]) <= bound, (t, got[t], want[t],
                                                     bound)
        assert got[2] != r["plain"]["losses"][2]
        _assert_params_close(r["bf16"]["params"], ref["bf16"]["params"],
                             _param_atol())


def test_sharded_step_bitexact_vs_pinned(runs):
    """On data 2 x fsdp 2 x tensor 2, the sharded update reproduces the
    unsharded step with the same pinned clip bit for bit in fp32 (each
    rank's part of its piece: the same values as the unsharded piece's
    chunk, and the norm summed in the same order): the parameters, and the
    moments once ``unshard_opt_state`` has gathered them back onto the
    pieces."""
    _, ranks = runs["dp2_fsdp2_tp2"]
    for r in ranks:
        s, p = r["sharded"], r["pinned"]
        assert s["losses"] == p["losses"]
        for k in p["params"]:
            assert torch.equal(s["params"][k], p["params"][k]), k
            for m in ("mu", "nu"):
                assert torch.equal(s["opt"][m][k], p["opt"][m][k]), (m, k)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_ranks_hold_the_same_state(runs, mesh):
    """Every rank's gathered parameters and losses are identical."""
    _, ranks = runs[mesh]
    for r in ranks[1:]:
        for flavour in MESHES[mesh][2]:
            assert r[flavour]["losses"] == ranks[0][flavour]["losses"]
            for k, p in ranks[0][flavour]["params"].items():
                assert torch.equal(p, r[flavour]["params"][k]), (flavour, k)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_placements_match_jax(runs, mesh):
    """Each leaf's placements on the port's mesh, as a partition spec,
    equal the JAX bundle's ``param_shardings`` on the same mesh, leaf for
    leaf (tests/test_models_ops.py's test_param_shardings_cover_mesh): the
    fsdp axis on each leaf's embed dim, tensor on its heads, mlp or vocab
    dim."""
    ref, ranks = runs[mesh]
    for r in ranks:
        assert r["placements"] == ref["placements"]
    specs = set(ref["placements"].values())
    for axis in ("fsdp", "tensor"):
        assert any(axis in s for s in specs)


@pytest.mark.parametrize("mesh,flavour", [("dp2_fsdp2_tp2", "plain"),
                                          ("dp2_fsdp2_tp2", "sharded"),
                                          ("fsdp2_tp2", "plain"),
                                          ("fsdp4", "plain")])
def test_opt_state_bytes_match_jax(runs, mesh, flavour):
    """The optimizer state's bytes a replica equal the JAX bundle's, but for
    optax's two int32 step counts (the port keeps one count on the host):
    each rank holds the moments of its pieces, and with the sharded update
    of its parts, a half at data 2."""
    ref, ranks = runs[mesh]
    want = ref[flavour]["bytes"] - ref[flavour]["count_bytes"]
    for r in ranks:
        assert r[flavour]["bytes"] == want
    if flavour == "sharded":
        assert 2 * want == ref["plain"]["bytes"] - ref["plain"]["count_bytes"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_eval_step_matches_jax(runs, mesh):
    """``eval_step`` on the mesh (every rank on the whole batch, the
    weights gathered, the tensor axis's cross entropy) against the JAX
    bundle's on the same weights, at rtol 1e-5."""
    ref, ranks = runs[mesh]
    for r in ranks:
        np.testing.assert_allclose(r["eval"], ref["eval"], rtol=LOSS_RTOL)


def test_ranks_take_the_batch_by_data_and_fsdp(runs):
    """The mesh's ranks are (data, fsdp, tensor) in row-major order, tensor
    innermost, as the JAX mesh lays the devices out."""
    _, ranks = runs["dp2_fsdp2_tp2"]
    got = [(r["coords"]["data"], r["coords"]["fsdp"], r["coords"]["tensor"])
           for r in ranks]
    assert got == [(d, f, t) for d in range(2) for f in range(2)
                   for t in range(2)]


def test_refusals(runs):
    """seq and expert axes above 1 and a MoE config on a sharded batch or a
    tensor axis raise, naming the slice to come; a KV-head count that the
    tensor axis does not divide raises ValueError naming the leaf and the
    axis (tiny's 2 KV heads at tensor 4, and the 1b's 8 at 16)."""
    _, ranks = runs["fsdp4"]
    for r in ranks:
        errors = r["errors"]
        assert errors["seq"].startswith("NotImplementedError")
        assert "seq axis" in errors["seq"] and "ROADMAP" in errors["seq"]
        assert "expert axis" in errors["expert"]
        for what in ("moe_fsdp", "moe_tensor"):
            assert "expert-parallel" in errors[what]
        assert errors["kv_heads"].startswith("ValueError")
        assert "k_proj.kernel" in errors["kv_heads"]
        assert "tensor" in errors["kv_heads"]
    with pytest.raises(ValueError, match=r"layer_0\.attn\.k_proj\.kernel.*"
                                         r"tensor axis's 16"):
        param_layout(CONFIGS["1b"], {"fsdp": 1, "tensor": 16})


# -- in one process -------------------------------------------------------------


def test_single_device_step_is_the_plain_composition():
    """Without a mesh the bundle's step is bit for bit the model's forward
    (no gather, no tensor axis), ``lm_loss``, one backward and the
    optimizer, as before the mesh's axes were added."""
    cfg = _cfg()
    bundle = TrainStepBundle(cfg, device="cpu", optimizer=make_optimizer(
        **OPT))
    params, opt = bundle.init(0)
    init = {k: v.detach().clone() for k, v in params.items()}
    batch = bundle.make_batch(np.random.default_rng(0), BATCH, SEQ)
    model = Transformer(cfg, device="cpu", params=init)
    assert all(m.gather is None for m in model.modules()
               if hasattr(type(m), "gather"))
    assert all(m.tensor is None for m in model.modules()
               if hasattr(type(m), "tensor"))
    optimizer = make_optimizer(**OPT)
    state = optimizer.init(dict(model.named_parameters()))
    for _ in range(STEPS):
        params, opt, loss = bundle.step(params, opt, batch)
        want = lm_loss(model(batch["tokens"]), batch["targets"],
                       batch["mask"])
        grads = torch.autograd.grad(want, list(model.parameters()))
        optimizer.update(dict(model.named_parameters()), grads, state)
        assert torch.equal(loss, want.detach())
    for k, p in model.named_parameters():
        assert torch.equal(params[k], p), k


@pytest.mark.parametrize("T", [2, 4])
def test_vocab_parallel_embedding_matches_plain(T):
    """The lookup summed over T ranks' vocabulary slices equals the whole
    table's, and each slice's gradient is its rows of the whole table's
    gradient, exactly (each token has one nonzero term)."""
    gen = torch.Generator().manual_seed(T)
    V, d = 256, 64
    weight = torch.randn(V, d, generator=gen, requires_grad=True)
    tokens = torch.randint(0, V, (BATCH, SEQ), generator=gen)
    dout = torch.randn(BATCH, SEQ, d, generator=gen)
    ref = weight[tokens]
    slices = [w.detach().clone().requires_grad_()
              for w in weight.chunk(T, 0)]
    got = sum(embedding_partial(w, tokens, t * (V // T))
              for t, w in enumerate(slices))
    assert torch.equal(got, ref)
    want = torch.autograd.grad(ref, weight, dout)[0]
    grads = torch.autograd.grad(got, slices, dout)
    assert torch.equal(torch.cat(grads), want)


@pytest.mark.parametrize("T", [2, 4])
@pytest.mark.parametrize("masked", [False, True])
def test_vocab_parallel_cross_entropy_matches_lm_loss(T, masked):
    """The cross entropy from T ranks' slices of the fp32 logits (the ranks
    stacked in one process) against ``lm_loss`` on the whole logits: each
    rank's token NLL within fp32's sums (the sum of exponentials over V =
    256 in other orders and one more addition a rank, a few 2^-24 of it,
    and the NLL's own rounding: 1e-6 plus 4 units of the last place, 2^-22
    of the NLL), the loss of a rank's copy with ``mask`` and ``count``
    likewise, and d logits (softmax minus one-hot, times the
    loss's gradient, which reaches every rank's copy) within 1e-7 at a
    token weight of at most 1/64."""
    gen = torch.Generator().manual_seed(T)
    V = 256
    logits = 3 * torch.randn(BATCH, SEQ, V, generator=gen)
    targets = torch.randint(0, V, (BATCH, SEQ), generator=gen)
    mask = ((torch.rand(BATCH, SEQ, generator=gen) > 0.3).float()
            if masked else None)
    count = torch.tensor(100.0) if masked else None
    whole = logits.clone().requires_grad_()
    ref = lm_loss(whole, targets, mask, count)
    ref_nll = -torch.log_softmax(logits, -1).gather(-1, targets[..., None])
    axis = StackedRanks(T)
    starts = axis.starts(V // T, 2)
    stacked = logits.reshape(BATCH, SEQ, T, V // T).permute(2, 0, 1, 3) \
        .contiguous().requires_grad_()
    nll = vocab_parallel_nll(stacked, targets, starts, axis)
    for t in range(T):
        torch.testing.assert_close(nll[t], ref_nll[..., 0], atol=1e-6,
                                   rtol=2.0 ** -22)
    torch.testing.assert_close(masked_mean(nll[0], mask, count), ref,
                               atol=1e-6, rtol=2.0 ** -22)
    token = ref_nll[..., 0].clone().requires_grad_()
    dnll = torch.autograd.grad(masked_mean(token, mask, count), token)[0]
    want = torch.autograd.grad(ref, whole)[0]
    got = torch.autograd.grad(nll, stacked, dnll.expand(T, BATCH, SEQ))[0]
    got = got.permute(1, 2, 0, 3).reshape(BATCH, SEQ, V)
    torch.testing.assert_close(got, want, atol=1e-7, rtol=0)


class ThreadRanks:
    """T ranks of a tensor axis as T threads of one process: rank t's axis
    (``rank(t)``) waits in each ``all_reduce`` for every rank's tensor and
    returns their sum (or max) in rank order, what the group's all-reduce
    gives every rank. On the CPU each thread's backward runs on that thread,
    so the backward's reductions meet as the forward's do."""

    def __init__(self, size: int):
        self.size = size
        self.slots = [None] * size
        self.barrier = threading.Barrier(size, timeout=60)

    def rank(self, t: int) -> TensorAxis:
        ranks = self

        class Rank(TensorAxis):
            size = ranks.size

            def all_reduce(self, x, op="sum"):
                ranks.slots[t] = x
                ranks.barrier.wait()
                out = functools.reduce(
                    torch.maximum if op == "max" else torch.add, ranks.slots)
                ranks.barrier.wait()
                return out

        return Rank()

    def run(self, body):
        """``body(t)`` on every rank's thread; their results in rank
        order."""
        def guarded(t):
            try:
                return body(t)
            except BaseException:
                self.barrier.abort()  # the other ranks raise, not hang
                raise

        with concurrent.futures.ThreadPoolExecutor(self.size) as pool:
            return [f.result() for f in [pool.submit(guarded, t)
                                         for t in range(self.size)]]


@pytest.mark.parametrize("T", [2, 4])
def test_block_on_tensor_ranks_matches_the_block(T):
    """The model on T tensor ranks in one process, each rank a thread
    (``ThreadRanks``) running the port's own modules on its pieces
    (``Transformer(pieces=...)``, ``bind_tensor``): the vocabulary-parallel
    embedding, each block's attention on its query and KV heads and MLP on
    its columns through ``copy_to_region`` and ``reduce_from_region``, the
    lm_head on its vocabulary and the vocabulary-parallel cross entropy.
    Against the whole model (tiny, 4 query and 4 KV heads, fp32): every
    rank's loss, and every gradient (each rank's own of a leaf the axis
    does not split, its pieces concatenated for the others) within fp32's
    sums in other orders (1e-5 relative)."""
    cfg = dataclasses.replace(_cfg(), n_kv_heads=4)
    whole = Transformer(cfg, device="cpu", seed=T)
    gen = torch.Generator().manual_seed(T)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=gen)
    targets = torch.roll(tokens, -1, 1)
    mask = (torch.rand(BATCH, SEQ, generator=gen) > 0.2).float()
    ref = lm_loss(whole(tokens), targets, mask)
    names = [k for k, _ in whole.named_parameters()]
    want = dict(zip(names, torch.autograd.grad(ref, list(whole.parameters()))))
    sizes = {"tensor": T}
    dims = param_layout(cfg, sizes)
    ranks = ThreadRanks(T)

    def rank(t):
        model = Transformer(cfg, device="cpu", pieces={
            k: piece_shape(p.shape, dims[k], sizes)
            for k, p in whole.named_parameters()})
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(cut_leaf(dict(whole.named_parameters())[k], dims[k],
                                 sizes, {"tensor": t}))
        bind_tensor(model, ranks.rank(t), t)
        loss = vocab_parallel_lm_loss(model(tokens), targets,
                                      model.vocab_start, model.tensor, mask)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        return loss.detach(), dict(zip(names, grads))

    results = ranks.run(rank)
    for loss, grads in results:
        torch.testing.assert_close(loss, ref.detach(), atol=1e-6, rtol=1e-5)
        for k in names:
            if "tensor" not in dims[k]:
                torch.testing.assert_close(grads[k], want[k], atol=1e-6,
                                           rtol=1e-5, msg=lambda m, k=k:
                                           f"{k}: {m}")
    split = [k for k in names if "tensor" in dims[k]]
    assert {k.rpartition(".")[2] for k in split} >= {"embed", "lm_head",
                                                     "kernel"}
    for k in split:
        got = torch.cat([grads[k] for _, grads in results],
                        dims[k]["tensor"])
        torch.testing.assert_close(got, want[k], atol=1e-6, rtol=1e-5,
                                   msg=lambda m, k=k: f"{k}: {m}")
