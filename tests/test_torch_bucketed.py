"""The port's bucketed collectives (``ray_tpu_torch/collective/bucketed.py``)
against the JAX package's ``ray_tpu/collective/bucketed.py``.

- ``plan_buckets(leaf_meta(...))`` over the port's parameter shapes equals
  the JAX plan over the flax tree's (``jax.eval_shape``, no weights) for
  ``tiny``, ``moe-tiny`` and ``1b`` at 64 KiB, 1 MiB and 32 MiB buckets on
  worlds of 1, 2 and 4: the same buckets of the same paths (the port's
  ``layer_0.attn.q_proj.kernel`` is JAX's
  ``['layer_0']['attn']['q_proj']['kernel']``), bytes, owners and leaf
  order; and ``TrainStepBundle.bucket_plan`` equals the JAX bundle's.
- On gloo worlds of 2 and 4 (``run_world``), the contracts of
  tests/test_quant_comms.py's explicit tier, on its gradient trees:
  ``AsyncBucketReducer`` with ``compression=None`` gives the rank-ordered
  sum bit for bit; with int8, fp8 and bf16 it gives, bit for bit, what the
  JAX package's numpy codecs give on the same buckets (encode, then
  ``reduce_wire_payloads``, then decode), the same on every rank, int8 with
  at least 3.5x fewer wire bytes than fp32; ``ShardedBucketOptimizer`` over
  3 steps of ``AdamW`` set up as ``optax.adam`` (``_adam``) with the global
  clip, fp32 against ``optax.adam`` on the summed and clipped gradients
  within the bound stated at ``_OPT_TOL``, and int8 with every rank
  bitwise equal and within 5 % of it.

The ranks import this module, so it loads torch, numpy and the port only;
the JAX package is imported in the parent's reference helpers.
"""

import numpy as np
import pytest
import torch

from test_torch_collective import RankWorld

from ray_tpu_torch.collective.bucketed import (AsyncBucketReducer,
                                               ShardedBucketOptimizer,
                                               init_sharded_optimizer_groups,
                                               leaf_meta, plan_buckets,
                                               tree_order)
from ray_tpu_torch.models import CONFIGS
from ray_tpu_torch.models.transformer import state_dict_shapes
from ray_tpu_torch.parallel import make_optimizer

BUCKET_BYTES = (64 << 10, 1 << 20, 32 << 20)
CODECS = (None, "int8", "fp8", "bf16")
REDUCE_BUCKETS = (1 << 16, 1 << 15)  # one bucket of both leaves; one each
OPT_STEPS, OPT_BUCKET, OPT_CLIP, OPT_LR = 3, 1 << 14, 0.5, 1e-2
# ShardedBucketOptimizer (fp32) against optax.adam on the same summed
# gradients: the two round apart in the clip's norm (other summation orders
# of 2^13 squares: about 13 units of 2^-24 of the sum, so 2^-20 of the
# factor) and in Adam's few elementwise operations (within a few 2^-24 of
# the step each), so a step of at most 1.2 lr moves by far less than
# 2^-16 of 1.2 lr; the parameter's own additions round within 2^-24 of it.
_OPT_TOL = (OPT_STEPS * 1.2 * OPT_LR * 2.0 ** -16, 2.0 ** -22)


def _adam():
    """The port's AdamW as ``optax.adam(OPT_LR)``: no clip, no decay, no
    warmup, b2 0.999, and a cosine so long that the rate stays OPT_LR (to
    1e-16 over these steps)."""
    return make_optimizer(learning_rate=OPT_LR, weight_decay=0.0,
                          warmup_steps=0, total_steps=10 ** 9, b2=0.999,
                          clip=None)


def _grad_tree(seed: int, scale_kb: int = 64):
    """tests/test_quant_comms.py's gradient tree, as tensors."""
    rng = np.random.default_rng(seed)
    n = scale_kb * 256 // 2  # fp32 elements over the two leaves
    return {"wide": torch.from_numpy(
                rng.normal(size=(n // 16, 16)).astype(np.float32)),
            "deep": torch.from_numpy(rng.normal(size=(n,))
                                     .astype(np.float32))}


# -- the plan -------------------------------------------------------------------


def _jax_path(path: str) -> str:
    return "".join(f"['{part}']" for part in path.split("."))


def _jax_meta(name: str):
    pytest.importorskip("flax")
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from ray_tpu.collective.bucketed import leaf_meta as jax_leaf_meta
    from ray_tpu.models.transformer import CONFIGS as JAX_CONFIGS
    from ray_tpu.models.transformer import Transformer as JaxTransformer

    model = JaxTransformer(JAX_CONFIGS[name])
    abstract = jax.eval_shape(
        lambda r: model.init(r, jnp.zeros((1, 8), jnp.int32))["params"],
        jax.random.PRNGKey(0))
    return jax_leaf_meta(nn.unbox(abstract))


def _same_plan(ours, theirs):
    assert ours.num_buckets == theirs.num_buckets
    assert ours.world_size == theirs.world_size
    assert ours.bucket_bytes == theirs.bucket_bytes
    assert [_jax_path(p) for p in ours.leaf_order] == list(theirs.leaf_order)
    for a, b in zip(ours.buckets, theirs.buckets):
        assert (a.index, a.nbytes, a.owner) == (b.index, b.nbytes, b.owner)
        assert tuple(_jax_path(p) for p in a.paths) == b.paths
    assert ours.stats() == theirs.stats()


@pytest.mark.parametrize("name", ["tiny", "moe-tiny", "1b"])
def test_plan_equals_the_jax_plan(name):
    from ray_tpu.collective.bucketed import plan_buckets as jax_plan

    meta = _jax_meta(name)
    shapes = state_dict_shapes(CONFIGS[name])
    ours_meta = leaf_meta({k: torch.empty(s, device="meta")
                           for k, s in shapes.items()})
    assert [_jax_path(p) for p in ours_meta] == list(meta)
    assert [s for s, _ in ours_meta.values()] == [s for s, _ in
                                                  meta.values()]
    for bucket_bytes in BUCKET_BYTES:
        for world in (1, 2, 4):
            _same_plan(plan_buckets(ours_meta, bucket_bytes, world),
                       jax_plan(meta, bucket_bytes, world))


@pytest.mark.parametrize("name", ["tiny", "moe-tiny"])
def test_bundle_plan_equals_the_jax_bundle(name):
    pytest.importorskip("flax")
    import jax

    from ray_tpu.models.transformer import CONFIGS as JAX_CONFIGS
    from ray_tpu.parallel import TrainStepBundle as JaxBundle
    from ray_tpu.parallel import create_mesh
    from ray_tpu_torch.parallel import AXES, TrainStepBundle

    jax_bundle = JaxBundle(JAX_CONFIGS[name], create_mesh(
        dict.fromkeys(AXES, 1), devices=jax.devices()[:1]),
        bucket_bytes=64 << 10)
    bundle = TrainStepBundle(CONFIGS[name], device="cpu",
                             bucket_bytes=64 << 10)
    _same_plan(bundle.bucket_plan, jax_bundle.bucket_plan)


def test_plan_packs_and_splits_as_documented():
    meta = leaf_meta({"b": torch.empty(4), "a": torch.empty(1000),
                      "c.x": torch.empty(2), "c.w": torch.empty(3)})
    assert list(meta) == ["a", "b", "c.w", "c.x"]
    plan = plan_buckets(meta, bucket_bytes=64, world_size=2)
    # a (4000 bytes) alone; b, c.w, c.x (36 bytes) packed together
    assert [b.paths for b in plan.buckets] == [("a",), ("b", "c.w", "c.x")]
    assert [b.owner for b in plan.buckets] == [0, 1]
    assert tree_order(["layer_2.x", "layer_10.x", "layer_1.x"]) == \
        ["layer_1.x", "layer_10.x", "layer_2.x"]
    with pytest.raises(ValueError):
        plan_buckets(meta, bucket_bytes=0)


# -- the ranks ------------------------------------------------------------------


def explicit_rank(rank: int, world: int, store: str) -> dict:
    """One rank of the explicit tier (what ``run_world`` calls): each codec's
    ``reduce_tree`` at each bucket size, then the sharded optimizer in fp32
    and int8."""
    from ray_tpu_torch import collective as col

    base = init_sharded_optimizer_groups(world, rank, device="cpu",
                                         init_method=f"file://{store}")
    out = {"reduce": {}, "opt": {}}
    tree = _grad_tree(rank)
    for bucket_bytes in REDUCE_BUCKETS:
        plan = plan_buckets(leaf_meta(tree), bucket_bytes, world)
        for comp in CODECS:
            red = AsyncBucketReducer(base, plan, compression=comp)
            try:
                reduced = red.reduce_tree(tree)
                stats = red.wire_stats()
            finally:
                red.shutdown()
            out["reduce"][f"{bucket_bytes}/{comp}"] = {"tree": reduced,
                                                       "stats": stats}
    # a failing bucket collective surfaces through the handle
    plan = plan_buckets(leaf_meta(tree), 1 << 16, world)
    red = AsyncBucketReducer(base, plan)
    try:
        red.submit(plan.buckets[0], {"deep": tree["deep"],
                                     "wide": "not a tensor"}).result(60)
    except Exception as e:  # noqa: BLE001 - the reducer's own error
        out["error"] = type(e).__name__
    finally:
        red.shutdown()
    params = _grad_tree(1000)
    plan = plan_buckets(leaf_meta(params), OPT_BUCKET, world)
    for comp in (None, "int8"):
        opt = ShardedBucketOptimizer(base, plan, rank, _adam(), params,
                                     clip_global_norm=OPT_CLIP,
                                     compression=comp)
        try:
            for step in range(OPT_STEPS):
                new, stats = opt.step(_grad_tree(step * world + rank))
        finally:
            opt.shutdown()
        out["opt"][str(comp)] = {"params": new, "stats": stats}
    for name in (base, f"{base}.norm"):
        col.destroy_collective_group(name)
    return out


# -- the references -------------------------------------------------------------


def _np_bucket_reduce(trees, plan, comp):
    """Each bucket's leaves packed in bucket order on every rank, then the
    JAX package's numpy codec path: encode, reduce_wire_payloads, decode;
    the leaves cut back out."""
    from ray_tpu.collective import quant as np_quant

    codec = np_quant.QuantCodec(comp)
    out = {}
    for bucket in plan.buckets:
        payloads = []
        for tree in trees:
            flat = np.concatenate([tree[p].numpy().reshape(-1)
                                   for p in bucket.paths])
            payloads.append(np_quant.to_wire(np_quant.quantize(flat, codec)))
        summed = np_quant.dequantize(np_quant.from_wire(
            np_quant.reduce_wire_payloads(payloads, codec.spec())))
        off = 0
        for p in bucket.paths:
            shape = tuple(trees[0][p].shape)
            n = int(np.prod(shape))
            out[p] = summed[off:off + n].reshape(shape).astype(np.float32)
            off += n
    return out


def _optax_reference(world: int):
    """tests/test_quant_comms.py's fp32 trajectory: optax.adam on the summed
    gradients, clipped by their global norm folded in leaf order."""
    import optax

    ref = {k: v.numpy() for k, v in _grad_tree(1000).items()}
    opt = optax.adam(OPT_LR)
    state = opt.init(ref)
    for step in range(OPT_STEPS):
        summed = {k: np.stack([_grad_tree(step * world + r)[k].numpy()
                               for r in range(world)]).sum(axis=0)
                  for k in ref}
        acc = np.float32(0.0)
        for key in sorted(ref):
            acc = np.float32(acc + np.float32(
                np.sum(np.square(summed[key].astype(np.float32)))))
        factor = np.float32(OPT_CLIP / max(float(np.sqrt(acc)), OPT_CLIP))
        clipped = {k: (v * factor).astype(v.dtype)
                   for k, v in summed.items()}
        upd, state = opt.update(clipped, state, ref)
        ref = optax.apply_updates(ref, upd)
    return {k: np.asarray(v) for k, v in ref.items()}


@pytest.fixture(scope="module", params=[2, 4])
def explicit_world(request, tmp_path_factory):
    world = request.param
    ranks = RankWorld(__file__, "explicit_rank", world,
                      tmp_path_factory.mktemp(f"explicit{world}"))
    pytest.importorskip("flax")
    reference = _optax_reference(world)  # while the ranks run
    return world, ranks.wait(timeout=180), reference


@pytest.mark.parametrize("bucket_bytes", REDUCE_BUCKETS)
def test_reducer_uncompressed_is_the_rank_ordered_sum(explicit_world,
                                                      bucket_bytes):
    world, outs, _ = explicit_world
    trees = [_grad_tree(r) for r in range(world)]
    for key in ("wide", "deep"):
        want = np.stack([t[key].numpy() for t in trees]).sum(axis=0)
        for out in outs:
            got = out["reduce"][f"{bucket_bytes}/None"]
            assert np.array_equal(got["tree"][key].numpy(), want)
            assert got["stats"]["compression"] is None
            assert got["stats"]["buckets_quantized"] == 0
            assert got["stats"]["bytes_wire"] == 0


@pytest.mark.parametrize("comp", ["int8", "fp8", "bf16"])
@pytest.mark.parametrize("bucket_bytes", REDUCE_BUCKETS)
def test_reducer_quantized_equals_the_numpy_codecs(explicit_world, comp,
                                                   bucket_bytes):
    world, outs, _ = explicit_world
    trees = [_grad_tree(r) for r in range(world)]
    plan = plan_buckets(leaf_meta(trees[0]), bucket_bytes, world)
    want = _np_bucket_reduce(trees, plan, comp)
    first = outs[0]["reduce"][f"{bucket_bytes}/{comp}"]
    for out in outs:
        got = out["reduce"][f"{bucket_bytes}/{comp}"]
        for key in ("wide", "deep"):
            assert np.array_equal(got["tree"][key].numpy(), want[key]), key
            assert torch.equal(got["tree"][key], first["tree"][key])
        stats = got["stats"]
        assert stats["compression"] == comp
        assert stats["buckets_quantized"] == plan.num_buckets
    if comp == "int8":
        assert first["stats"]["wire_reduction_x"] >= 3.5
    # and within tests/test_quant_comms.py's 2 % of the exact sum (int8)
    exact = {k: np.stack([t[k].numpy() for t in trees]).sum(axis=0)
             for k in ("wide", "deep")}
    for key, x in exact.items():
        rel = np.abs(first["tree"][key].numpy() - x).max() / np.abs(x).max()
        assert rel < {"int8": 0.02, "fp8": 0.06, "bf16": 0.02}[comp]


def test_reducer_surfaces_a_failed_collective(explicit_world):
    _, outs, _ = explicit_world
    assert all(out["error"] == "AttributeError" for out in outs)


def test_sharded_optimizer_fp32_tracks_optax_adam(explicit_world):
    world, outs, reference = explicit_world
    atol, rtol = _OPT_TOL
    for out in outs:
        got = out["opt"]["None"]
        for key, want in reference.items():
            err = np.abs(got["params"][key].numpy() - want)
            assert (err <= atol + rtol * np.abs(want)).all(), (
                key, err.max())
        assert got["stats"]["grad_norm"] > OPT_CLIP  # the clip engaged
    firsts = outs[0]["opt"]["None"]["params"]
    for out in outs[1:]:
        for key in firsts:
            assert torch.equal(out["opt"]["None"]["params"][key],
                               firsts[key])
    owned = [set(out["opt"]["None"]["stats"]["owned_buckets"])
             for out in outs]
    assert set().union(*owned) == set(range(
        plan_buckets(leaf_meta(_grad_tree(1000)), OPT_BUCKET,
                     world).num_buckets))
    assert sum(map(len, owned)) == len(set().union(*owned))


def test_sharded_optimizer_int8_ranks_identical(explicit_world):
    _, outs, reference = explicit_world
    first = outs[0]["opt"]["int8"]
    for out in outs[1:]:
        for key in first["params"]:
            assert torch.equal(out["opt"]["int8"]["params"][key],
                               first["params"][key])
    stats = first["stats"]
    assert stats["compression"] == "int8"
    assert stats["broadcast_wire_bytes"] < 0.5 * stats["broadcast_fp32_bytes"]
    assert stats["reduce_wire"]["wire_reduction_x"] >= 3.5
    for key, want in reference.items():
        err = np.abs(first["params"][key].numpy() - want).max()
        assert err < 0.05 * np.abs(want).max()


def test_adamw_as_adam_matches_optax_in_process():
    pytest.importorskip("flax")
    import optax

    params = {k: v.clone() for k, v in _grad_tree(5, 4).items()}
    ref = {k: v.numpy().copy() for k, v in params.items()}
    opt, ours = optax.adam(OPT_LR), _adam()
    state, our_state = opt.init(ref), ours.init(params)
    for step in range(OPT_STEPS):
        grads = _grad_tree(10 + step, 4)
        upd, state = opt.update({k: v.numpy() for k, v in grads.items()},
                                state, ref)
        ref = optax.apply_updates(ref, upd)
        ours.update(params, [grads[k].clone() for k in params], our_state)
    atol, rtol = _OPT_TOL
    for key in params:
        want = np.asarray(ref[key])
        assert (np.abs(params[key].numpy() - want)
                <= atol + rtol * np.abs(want)).all()


def test_sharded_optimizer_refuses_a_clipping_optimizer():
    plan = plan_buckets(leaf_meta(_grad_tree(0, 4)), 1 << 16, 1)
    with pytest.raises(ValueError, match="clip_global_norm"):
        ShardedBucketOptimizer("unused", plan, 0, make_optimizer(),
                               _grad_tree(0, 4))
