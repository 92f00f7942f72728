"""The port's traced train step against the JAX bundle's, on gloo worlds.

``TrainStepBundle(CONFIGS["tiny"])`` in fp32 on meshes of ``data`` 2 and 4
(``RankWorld``; every other axis 1), ``shard_update=True`` and tracing on,
so that the step is the traced sharded step: the local backward, one
reduce-scatter per bucket of ``bucket_plan`` (``BUCKET_BYTES``: several
buckets), the sharded update. Against the JAX bundle on a mesh of as many
CPU devices, from the JAX bundle's initial weights and the same batch:

- the bucket plan, bucket for bucket;
- the first step's reduced gradients, leaf for leaf, for fp32, the bf16
  wire (``grad_dtype="bf16"``) and the int8, fp8 and bf16 codecs: the JAX
  side's are its bundle's own ``_fwd_bwd_local`` fed to each flavour's
  ``_bucket_programs``; the port's are its step's own functions
  (``_local_backward``, ``_start_leaf_reduce``). fp32 within 1e-5 of each
  leaf's norm; the others within ``_wire_bound``, derived from where each
  wire rounds;
- STEPS steps: fp32 losses at rtol 1e-5, the first loss of every flavour
  too (it precedes any update), and parameters within Adam's update bound
  ``2 x 1.2 x sum(lr_t)`` (tests/test_torch_train.py), which holds
  whatever the gradients' rounding; on data 2 also with uneven masks (the
  ``m_local * dp / m_global`` reweighting);
- the span tree: ``train.step`` > ``train.fwd_bwd`` > one
  ``train.bucket_allreduce`` per bucket, then ``train.optimizer``; the
  histograms and the goodput ledger's counts.

Also: ``ValueError`` where the JAX bundle raises for ``compression``, its
warning once when tracing is off (the fp32 step then runs), and the
phase-split traced step on a mesh without a data axis (``fsdp`` 2), equal
to the untraced step bit for bit. The ranks import this module, so it
loads torch, numpy and the port only; the JAX package is imported in the
parent's reference helpers.
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

from test_torch_collective import RankWorld

from ray_tpu_torch.models import CONFIGS
from ray_tpu_torch.parallel import AXES, TrainStepBundle, make_optimizer

OPT = dict(learning_rate=1e-2, warmup_steps=2, total_steps=100, clip=0.05)
BATCH, SEQ, STEPS = 4, 32, 3
BUCKET_BYTES = 128 << 10
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5  # fp32: ||got - want|| against ||want||, leaf for leaf
ADAM_RATIO = 1.2  # tests/test_torch_train.py: Adam's step is below 1.2 lr_t
# flavour -> the bundle's keyword arguments
FLAVOURS = {"fp32": {}, "bf16_wire": {"grad_dtype": "bf16"},
            "int8": {"compression": "int8"}, "fp8": {"compression": "fp8"},
            "bf16": {"compression": "bf16"}}


def _param_atol(steps=STEPS):
    sched = make_optimizer(**OPT).schedule
    return 2 * ADAM_RATIO * sum(sched(t) for t in range(steps))


def _cfg():
    return dataclasses.replace(CONFIGS["tiny"], dtype=torch.float32)


def _factory(spec_fn):
    return make_optimizer(**OPT, clip_spec_fn=spec_fn)


def _uneven(mask: np.ndarray) -> np.ndarray:
    """Rank 0's rows hold 4 valid tokens, rank 1's all of theirs (data 2)."""
    mask = np.zeros_like(mask)
    mask[0, :4] = 1.0
    mask[BATCH // 2:] = 1.0
    return mask


# -- the ranks ------------------------------------------------------------------


def _mesh(axes):
    from ray_tpu_torch.parallel import create_mesh

    return create_mesh({**dict.fromkeys(AXES, 1), **axes}, device="cpu")


def _first_grads(bundle, init, batch):
    """The first step's reduced gradients as the traced sharded step takes
    them, gathered to whole leaves."""
    params = bundle._bind(init)
    _, _, grads = bundle._local_backward(params, batch)
    out = {}
    for k in params:
        part = bundle._start_leaf_reduce(k, grads[k])()
        layout = bundle._layouts[k]
        out[k] = part if layout is None else bundle._gather(part, layout)
    return out


def _steps(bundle, init, batch):
    from ray_tpu_torch.util import tracing

    params = {k: v.clone() for k, v in init.items()}
    opt = bundle.init_sharded(0)[1] if bundle.shard_update else \
        bundle.init(0)[1]
    losses, spans = [], None
    for step in range(STEPS):
        tracing.clear()
        params, opt, loss = bundle.step(params, opt, batch)
        losses.append(loss.item())
        if step == 0:
            spans = tracing.get_spans()
    return {"losses": losses, "params": bundle.gather_params(),
            "spans": spans}


def traced_rank(rank: int, world: int, store: str, params_path: str) -> dict:
    """One rank's runs (what ``RankWorld`` calls)."""
    from ray_tpu_torch import collective as col
    from ray_tpu_torch.util import goodput, metrics, tracing

    col.init_collective_group(world, rank, group_name="traced", device="cpu",
                              init_method=f"file://{store}")
    init = torch.load(params_path)
    mesh = _mesh({"data": world})
    cfg = _cfg()
    out = {"grads": {}, "runs": {}}
    tracing.enable()
    goodput.reset()
    for flavour, kw in FLAVOURS.items():
        bundle = TrainStepBundle(cfg, mesh=mesh, shard_update=True,
                                 optimizer_factory=_factory,
                                 bucket_bytes=BUCKET_BYTES, **kw)
        batch = bundle.make_batch(np.random.default_rng(0), BATCH, SEQ)
        out["grads"][flavour] = _first_grads(bundle, init, batch)
        out["runs"][flavour] = _steps(bundle, init, batch)
        if flavour == "fp32":
            out["plan"] = [(b.index, b.paths, b.nbytes, b.owner)
                           for b in bundle.bucket_plan.buckets]
            if world == 2:
                uneven = dict(batch, mask=torch.from_numpy(
                    _uneven(batch["mask"].numpy())))
                out["runs"]["uneven"] = _steps(bundle, init, uneven)
    scraped = metrics.scrape_metrics()
    out["metrics"] = {name: scraped[name]["data"]["counts"]
                      for name in ("ray_tpu.train.step_seconds",
                                   "ray_tpu.train.fwd_bwd_seconds",
                                   "ray_tpu.train.optimizer_seconds",
                                   "ray_tpu.train.bucket_reduce_seconds")}
    out["ledger"] = goodput.snapshot()
    # tracing off: the JAX bundle's warning, once, and the fp32 step
    tracing.disable()
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    log = logging.getLogger("ray_tpu_torch.parallel.train")
    log.addHandler(handler)
    try:
        q = TrainStepBundle(cfg, mesh=mesh, shard_update=True,
                            optimizer_factory=_factory, compression="int8")
        fp32 = TrainStepBundle(cfg, mesh=mesh, shard_update=True,
                               optimizer_factory=_factory)
        batch = q.make_batch(np.random.default_rng(0), BATCH, SEQ)
        out["untraced"] = {name: _steps(b, init, batch)
                           for name, b in (("int8", q), ("fp32", fp32))}
    finally:
        log.removeHandler(handler)
    out["warnings"] = [r.getMessage() for r in records]
    errors = {}
    try:
        TrainStepBundle(cfg, mesh=mesh, compression="int8")
    except ValueError as e:
        errors["unsharded"] = str(e)
    out["errors"] = errors
    if world == 2:  # the phase-split traced step on a mesh of fsdp alone
        fsdp = _mesh({"fsdp": world})
        b = TrainStepBundle(cfg, mesh=fsdp, optimizer_factory=_factory)
        batch = b.make_batch(np.random.default_rng(0), BATCH, SEQ)
        untraced = _steps(b, init, batch)
        tracing.enable()
        out["phases"] = {"untraced": untraced,
                         "traced": _steps(b, init, batch)}
    col.destroy_collective_group("traced")
    return out


# -- the JAX reference ----------------------------------------------------------


def _jax_runs(world: int, params_path: str, ranks_ready) -> dict:
    """The JAX bundle on a data=``world`` mesh with tracing on: its initial
    weights (saved for the ranks, which ``ranks_ready`` then starts), each
    flavour's first reduced gradients and the local gradients under them,
    STEPS traced steps of fp32 (and on data 2 with uneven masks), and the
    first step of every other flavour."""
    pytest.importorskip("flax")
    import jax
    import jax.numpy as jnp

    from ray_tpu.models.transformer import CONFIGS as JAX_CONFIGS
    from ray_tpu.parallel import TrainStepBundle as JaxBundle
    from ray_tpu.parallel import create_mesh
    from ray_tpu.parallel import make_optimizer as jax_make_optimizer
    from ray_tpu.util import tracing as jax_tracing
    from ray_tpu_torch.models import from_jax_params

    cfg = dataclasses.replace(JAX_CONFIGS["tiny"], dtype=jnp.float32)
    mesh = create_mesh({**dict.fromkeys(AXES, 1), "data": world},
                       devices=jax.devices()[:world])

    def factory(spec_fn):
        return jax_make_optimizer(**OPT, clip_spec_fn=spec_fn)

    def to_torch(tree):
        return from_jax_params(jax.tree_util.tree_map(np.asarray, tree))

    def bundle(**kw):
        return JaxBundle(cfg, mesh, optimizer_factory=factory,
                         shard_update=True, bucket_bytes=BUCKET_BYTES, **kw)

    fp32 = bundle()
    params, _ = fp32.init(jax.random.PRNGKey(0))
    torch.save(to_torch(params), params_path)
    ranks = ranks_ready()
    batch = fp32.make_batch(np.random.default_rng(0), BATCH, SEQ)
    was = jax_tracing.enabled()
    jax_tracing.enable()
    try:
        fp32._build_explicit()
        _, _, local = fp32._fwd_bwd_local(params, batch["tokens"],
                                          batch["targets"], batch["mask"])
        by_path = dict(zip(fp32._grad_paths,
                           jax.tree_util.tree_leaves(local)))
        out = {"plan": fp32.bucket_plan, "grads": {}, "runs": {},
               "local": {p: np.asarray(x) for p, x in by_path.items()},
               "dims": {}}
        for flavour, kw in FLAVOURS.items():
            b = fp32 if flavour == "fp32" else bundle(**kw)
            b._build_explicit()
            reduced = {}
            for bucket, prog in b._bucket_programs:
                outs = prog(*[by_path[p] for p in bucket.paths])
                reduced.update(zip(bucket.paths, outs))
            out["grads"][flavour] = to_torch(jax.tree_util.tree_unflatten(
                b._grad_treedef, [reduced[p] for p in b._grad_paths]))

        def run(b, batch, steps):
            _, s = b.init_sharded(jax.random.PRNGKey(0))
            # a fresh copy: the step donates its parameters
            p = jax.device_put(jax.tree_util.tree_map(np.asarray, params),
                               b.param_shardings)
            losses = []
            for _ in range(steps):
                p, s, loss = b.step(p, s, batch)
                losses.append(float(loss))
            return {"losses": losses, "params": to_torch(p)}

        out["runs"]["fp32"] = run(fp32, batch, STEPS)
        if world == 2:
            mask = _uneven(np.asarray(batch["mask"]))
            uneven = dict(batch, mask=jax.device_put(mask,
                                                     fp32.batch_sharding))
            out["runs"]["uneven"] = run(fp32, uneven, STEPS)
        # the update dim of each data-split leaf (None: replicated)
        gsh = dict(zip(fp32._grad_paths, jax.tree_util.tree_leaves(
            fp32.grad_shardings, is_leaf=lambda x: hasattr(x, "spec"))))
        for path, sh in gsh.items():
            dims = [d for d, e in enumerate(tuple(sh.spec)) if e is not None
                    and "data" in ((e,) if isinstance(e, str) else e)]
            out["dims"][path] = dims[0] if dims else None
        try:
            JaxBundle(cfg, mesh, optimizer_factory=factory,
                      compression="int8")
        except ValueError as e:
            out["unsharded_error"] = str(e)
    finally:
        if not was:
            jax_tracing._enabled = False
    return out, ranks


@pytest.fixture(scope="module", params=[2, 4])
def runs(request, tmp_path_factory):
    """The JAX reference and the port's ranks of one world, run together."""
    world = request.param
    tmp = tmp_path_factory.mktemp(f"traced{world}")
    path = str(tmp / "init.pt")
    jax_out, ranks = _jax_runs(world, path, lambda: RankWorld(
        __file__, "traced_rank", world, tmp, params_path=path))
    return world, jax_out, ranks.wait(timeout=240)


def _jax_path(path: str) -> str:
    return "".join(f"['{part}']" for part in path.split("."))


def test_bucket_plan_equals_the_jax_bundle(runs):
    world, jax_out, ranks = runs
    plan = jax_out["plan"]
    assert plan.num_buckets >= 3
    for r in ranks:
        assert [(i, tuple(_jax_path(p) for p in paths), n, o)
                for i, paths, n, o in r["plan"]] == [
            (b.index, b.paths, b.nbytes, b.owner) for b in plan.buckets]


def test_first_grads_fp32_match_jax(runs):
    _, jax_out, ranks = runs
    want = jax_out["grads"]["fp32"]
    for r in ranks:
        for k, w in want.items():
            err = (r["grads"]["fp32"][k] - w).norm().item()
            assert err <= GRAD_RTOL * w.norm().item(), (k, err)


def _wire_bound(flavour: str, local: np.ndarray, dim, world: int):
    """Per element of the reduced leaf, how far the port's and the JAX
    bundle's results may part on the ``flavour`` wire, from the JAX ranks'
    local gradients ``local`` (world, *shape) and the leaf's update dim.
    Each rank's contribution may round to neighbouring codes on the two
    sides (the local gradients agree to fp32's rounding, not bit for bit),
    one code step apart at most:

    - int8: one step is the block's scale, amax / 127; the scales
      themselves may part by fp32's rounding of the amax, which moves up to
      127 codes by far less than 1 % of a step;
    - fp8 (e4m3, 3 mantissa bits): one step is at most 2^-3 of the value,
      or 2^-9 of the scale (amax / 448) among the subnormals;
    - bf16 codec: one step is at most 2^-7 of the value;
    - bf16 wire: the same step at each rank's value, and the bf16 sums of
      the two sides (each of world - 1 additions within 2^-8 of a partial
      sum at most sum |x_r|).

    The steps add over the ranks, and the sum is scaled by 1 / world."""
    absx = np.abs(local)
    if flavour in ("bf16", "bf16_wire"):
        bound = 2.0 ** -7 * absx.sum(axis=0)
        if flavour == "bf16_wire":
            bound += 2 * (world - 1) * 2.0 ** -8 * absx.sum(axis=0)
        return bound / world
    block = 256
    # each rank's (owner part, block) amax, laid out as the leaf
    x = np.moveaxis(local, dim + 1, 1)
    shape = x.shape
    flat = x.reshape(world, world, -1)
    m = flat.shape[-1]
    nb = -(-m // block)
    padded = np.zeros((world, world, nb * block), np.float32)
    padded[..., :m] = np.abs(flat)
    amax = padded.reshape(world, world, nb, block).max(axis=-1)
    qmax = 127.0 if flavour == "int8" else 448.0
    scale = np.repeat(amax / qmax, block, axis=-1)[..., :m]
    if flavour == "int8":
        step = 1.01 * scale
    else:
        step = 2.0 ** -3 * np.abs(flat) + 2.0 ** -9 * scale
    step = step.sum(axis=0).reshape(shape[1:]) / world
    return np.moveaxis(step, 0, dim)


@pytest.mark.parametrize("flavour", ["bf16_wire", "int8", "fp8", "bf16"])
def test_first_grads_on_each_wire_match_jax(runs, flavour):
    world, jax_out, ranks = runs
    want = jax_out["grads"][flavour]
    fp32 = jax_out["grads"]["fp32"]
    worst = 0.0
    for k, w in want.items():
        jk = _jax_path(k)
        dim = jax_out["dims"][jk]
        if dim is None:  # replicated leaves stay fp32 on every wire
            bound = np.zeros(tuple(w.shape), np.float32)
        else:
            bound = _wire_bound(flavour, jax_out["local"][jk], dim, world)
        # the fp32 parts' slack, as the fp32 check's
        slack = GRAD_RTOL * fp32[k].norm().item()
        for r in ranks:
            err = (r["grads"][flavour][k] - w).abs().numpy()
            assert (err <= bound + slack).all(), (k, err.max())
            worst = max(worst, float((err / (bound + slack)).max()))
    assert worst > 0.0  # the two sides do round apart somewhere


@pytest.mark.parametrize("flavour", list(FLAVOURS))
def test_steps_match_jax(runs, flavour):
    """fp32: every loss at rtol 1e-5; every flavour: the first loss at rtol
    1e-5 and the parameters within Adam's bound of the JAX fp32 run's."""
    _check_steps(runs, flavour)


@pytest.mark.parametrize("runs", [2], indirect=True)
def test_uneven_masks_match_jax(runs):
    """Uneven masks on data 2: the reweighting by m_local * dp / m_global
    gives the JAX traced step's losses and parameters."""
    _check_steps(runs, "uneven")


def _check_steps(runs, flavour):
    world, jax_out, ranks = runs
    want = jax_out["runs"]["uneven" if flavour == "uneven" else "fp32"]
    for r in ranks:
        got = r["runs"][flavour]
        n = STEPS if flavour in ("fp32", "uneven") else 1
        np.testing.assert_allclose(got["losses"][:n], want["losses"][:n],
                                   rtol=LOSS_RTOL)
        worst = max((got["params"][k] - w).abs().max().item()
                    for k, w in want["params"].items())
        assert worst <= _param_atol(), worst
    # the ranks hold the same parameters
    for r in ranks[1:]:
        for k, w in ranks[0]["runs"][flavour]["params"].items():
            assert torch.equal(r["runs"][flavour]["params"][k], w)


def test_span_tree(runs):
    world, jax_out, ranks = runs
    n = jax_out["plan"].num_buckets
    for r in ranks:
        for flavour in FLAVOURS:
            spans = r["runs"][flavour]["spans"]
            by_id = {s["span_id"]: s for s in spans}
            names = sorted(s["name"] for s in spans)
            assert names == sorted(["train.step", "train.fwd_bwd",
                                    "train.optimizer"]
                                   + ["train.bucket_allreduce"] * n)
            parent = {s["name"]: by_id.get(s["parent_id"], {}).get("name")
                      for s in spans}
            assert parent["train.step"] is None
            assert parent["train.fwd_bwd"] == "train.step"
            assert parent["train.optimizer"] == "train.step"
            buckets = [s for s in spans
                       if s["name"] == "train.bucket_allreduce"]
            assert all(by_id[s["parent_id"]]["name"] == "train.fwd_bwd"
                       for s in buckets)
            assert [s["bucket"] for s in buckets] == list(range(n))
            fwd = next(s for s in spans if s["name"] == "train.fwd_bwd")
            opt = next(s for s in spans if s["name"] == "train.optimizer")
            assert fwd["buckets"] == n
            assert all(fwd["ts"] <= s["ts"] and s["ts"] + s["dur"]
                       <= fwd["ts"] + fwd["dur"] + 1e-6 for s in buckets)
            assert opt["ts"] >= fwd["ts"] + fwd["dur"] - 1e-6


def test_histograms_and_ledger(runs):
    world, jax_out, ranks = runs
    traced_steps = len(FLAVOURS) * STEPS + (STEPS if world == 2 else 0)
    n = jax_out["plan"].num_buckets
    for r in ranks:
        m = r["metrics"]
        assert sum(m["ray_tpu.train.step_seconds"]["{}"]) == traced_steps
        assert sum(m["ray_tpu.train.fwd_bwd_seconds"]["{}"]) == traced_steps
        assert sum(m["ray_tpu.train.optimizer_seconds"]["{}"]) == \
            traced_steps
        assert sum(m["ray_tpu.train.bucket_reduce_seconds"]["{}"]) == \
            traced_steps * n
        ledger = r["ledger"]
        # one traced_sharded program per bundle: its first batch key
        # compiles, an uneven mask is the same key
        assert ledger["counters"]["steps"] == traced_steps
        assert ledger["counters"]["compiles"] == len(FLAVOURS)
        assert "recompiles" not in ledger["counters"]
        assert ledger["buckets"]["compile"] > 0.0
        assert ledger["buckets"]["step_compute"] > 0.0


def test_untraced_compression_warns_once_and_runs_fp32(runs):
    _, _, ranks = runs
    for r in ranks:
        assert len(r["warnings"]) == 1
        assert "tracing is disabled" in r["warnings"][0]
        got, want = r["untraced"]["int8"], r["untraced"]["fp32"]
        assert got["losses"] == want["losses"]
        for k, w in want["params"].items():
            assert torch.equal(got["params"][k], w)
        assert got["spans"] == []


def test_compression_raises_where_jax_raises(runs):
    _, jax_out, ranks = runs
    assert "requires shard_update=True" in jax_out["unsharded_error"]
    for r in ranks:
        assert "requires shard_update=True" in r["errors"]["unsharded"]
    for kw in ({}, {"shard_update": True}):
        with pytest.raises(ValueError, match="requires shard_update=True"):
            TrainStepBundle(_cfg(), device="cpu", compression="int8", **kw)
    with pytest.raises(ValueError):
        TrainStepBundle(_cfg(), device="cpu", compression="int9")


@pytest.mark.parametrize("runs", [2], indirect=True)
def test_phase_split_on_a_mesh_without_data(runs):
    _, _, ranks = runs
    for r in ranks:
        got, want = r["phases"]["traced"], r["phases"]["untraced"]
        assert got["losses"] == want["losses"]
        for k, w in want["params"].items():
            assert torch.equal(got["params"][k], w)
        assert want["spans"] == []
        assert sorted(s["name"] for s in got["spans"]) == [
            "train.fwd_bwd", "train.optimizer", "train.step"]


def test_single_device_traced_step_equals_untraced():
    """One device: the traced step is the phase-split step, the untraced
    step's math bit for bit, under train.step > fwd_bwd, optimizer."""
    from ray_tpu_torch.util import tracing

    was = tracing.enabled()
    cfg = _cfg()
    runs = {}
    try:
        for traced in (False, True):
            (tracing.enable if traced else tracing.disable)()
            bundle = TrainStepBundle(cfg, device="cpu",
                                     optimizer=make_optimizer(**OPT))
            params, opt = bundle.init(0)
            batch = bundle.make_batch(np.random.default_rng(0), BATCH, SEQ)
            runs[traced] = _steps(bundle, params, batch)
    finally:
        (tracing.enable if was else tracing.disable)()
    assert runs[True]["losses"] == runs[False]["losses"]
    for k, w in runs[False]["params"].items():
        assert torch.equal(runs[True]["params"][k], w)
    assert sorted(s["name"] for s in runs[True]["spans"]) == [
        "train.fwd_bwd", "train.optimizer", "train.step"]


@pytest.mark.parametrize("flavour", list(FLAVOURS))
def test_smoke_virtual_ranks_match_jax(runs, flavour):
    """``chip_smoke.VirtualAxis`` (the card's virtual data ranks) through
    ``start_leaf_reduce``, fed the JAX ranks' own local gradients, gives
    what the JAX bundle's bucket programs give: within ``_wire_bound`` on
    the quantized and bf16 wires, 1e-5 of the leaf's norm in fp32."""
    import chip_smoke

    from ray_tpu_torch.collective.quant import resolve_codec
    from ray_tpu_torch.parallel.train import start_leaf_reduce

    world, jax_out, _ = runs
    kw = FLAVOURS[flavour]
    codec = resolve_codec(kw.get("compression"))
    axis = chip_smoke.VirtualAxis(world)
    for k, want in jax_out["grads"][flavour].items():
        jk = _jax_path(k)
        dim = jax_out["dims"][jk]
        local = torch.from_numpy(np.array(jax_out["local"][jk]))
        layout = None if dim is None else (dim, world)
        waits = [start_leaf_reduce(axis.rank(r), local[r], layout, codec,
                                   kw.get("grad_dtype", "fp32"))
                 for r in range(world)]
        parts = [wait() for wait in waits]
        axis.reset()
        got = parts[0] if dim is None else torch.cat(parts, dim)
        slack = GRAD_RTOL * jax_out["grads"]["fp32"][k].norm().item()
        bound = (0.0 if dim is None or flavour == "fp32" else
                 _wire_bound(flavour, jax_out["local"][jk], dim, world))
        err = (got - want).abs().numpy()
        assert (err <= bound + slack).all(), (k, err.max())


def moe_rank(rank: int, world: int, store: str, params_path: str) -> dict:
    """moe-tiny's traced sharded step on one rank of data ``world``: the
    first reduced gradients and STEPS losses and parameters."""
    from ray_tpu_torch import collective as col
    from ray_tpu_torch.util import tracing

    col.init_collective_group(world, rank, group_name="moe", device="cpu",
                              init_method=f"file://{store}")
    init = torch.load(params_path)
    tracing.enable()
    bundle = TrainStepBundle(
        dataclasses.replace(CONFIGS["moe-tiny"], dtype=torch.float32),
        mesh=_mesh({"data": world}), shard_update=True,
        optimizer_factory=_factory, bucket_bytes=BUCKET_BYTES)
    batch = bundle.make_batch(np.random.default_rng(0), BATCH, SEQ)
    out = {"grads": _first_grads(bundle, init, batch),
           **_steps(bundle, init, batch)}
    col.destroy_collective_group("moe")
    return out


def test_moe_traced_sharded_step_matches_jax(tmp_path):
    """moe-tiny at data 2: each rank's MoE layers route its own rows and
    its loss takes their aux, as under the JAX bundle's shard_map; the
    first reduced gradients within 1e-5 of each leaf's norm, the losses at
    rtol 1e-5 and the parameters within Adam's bound."""
    pytest.importorskip("flax")
    import jax
    import jax.numpy as jnp

    from ray_tpu.models.transformer import CONFIGS as JAX_CONFIGS
    from ray_tpu.parallel import TrainStepBundle as JaxBundle
    from ray_tpu.parallel import create_mesh
    from ray_tpu.parallel import make_optimizer as jax_make_optimizer
    from ray_tpu.util import tracing as jax_tracing
    from ray_tpu_torch.models import from_jax_params

    def to_torch(tree):
        return from_jax_params(jax.tree_util.tree_map(np.asarray, tree))

    world, path = 2, str(tmp_path / "init.pt")
    bundle = JaxBundle(
        dataclasses.replace(JAX_CONFIGS["moe-tiny"], dtype=jnp.float32),
        create_mesh({**dict.fromkeys(AXES, 1), "data": world},
                    devices=jax.devices()[:world]),
        optimizer_factory=lambda spec_fn: jax_make_optimizer(
            **OPT, clip_spec_fn=spec_fn),
        shard_update=True, bucket_bytes=BUCKET_BYTES)
    params, _ = bundle.init(jax.random.PRNGKey(0))
    torch.save(to_torch(params), path)
    ranks = RankWorld(__file__, "moe_rank", world, tmp_path,
                      params_path=path)
    batch = bundle.make_batch(np.random.default_rng(0), BATCH, SEQ)
    was = jax_tracing.enabled()
    jax_tracing.enable()
    try:
        bundle._build_explicit()
        _, _, local = bundle._fwd_bwd_local(params, batch["tokens"],
                                            batch["targets"], batch["mask"])
        by_path = dict(zip(bundle._grad_paths,
                           jax.tree_util.tree_leaves(local)))
        reduced = {}
        for bucket, prog in bundle._bucket_programs:
            reduced.update(zip(bucket.paths,
                               prog(*[by_path[p] for p in bucket.paths])))
        want = to_torch(jax.tree_util.tree_unflatten(
            bundle._grad_treedef, [reduced[p] for p in bundle._grad_paths]))
        _, state = bundle.init_sharded(jax.random.PRNGKey(0))
        p = jax.device_put(jax.tree_util.tree_map(np.asarray, params),
                           bundle.param_shardings)
        losses = []
        for _ in range(STEPS):
            p, state, loss = bundle.step(p, state, batch)
            losses.append(float(loss))
    finally:
        if not was:
            jax_tracing._enabled = False
    final = to_torch(p)
    for r in ranks.wait(timeout=240):
        for k, w in want.items():
            err = (r["grads"][k] - w).norm().item()
            assert err <= GRAD_RTOL * w.norm().item(), (k, err)
        np.testing.assert_allclose(r["losses"], losses, rtol=LOSS_RTOL)
        worst = max((r["params"][k] - w).abs().max().item()
                    for k, w in final.items())
        assert worst <= _param_atol(), worst
