"""Ring and Ulysses attention of the port against the JAX package's, on gloo.

The JAX functions run under ``shard_map`` on 2- and 4-device CPU meshes
(the shapes of tests/test_models_ops.py), the port's on gloo worlds of 2
and 4 ranks, each rank a process of its own (``run_world``), fed the same
fp32 inputs drawn with numpy; each rank takes its sequence shard. Outputs
and the gradients of sum(out * cotangent), the cotangent drawn from the
same seed, are held at atol 1e-5 (both sides fp32; the port merges the
blocks by their lse, the JAX ring by a running max and sum). The ranks
import this module, so it loads torch, numpy and the port only.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_collective import run_world

ATOL = 1e-5
RING_SHAPE = (2, 64, 2, 16)  # (B, S, H, D): tests/test_models_ops.py:49
ULYSSES_SHAPE = (2, 32, 4, 16)  # tests/test_models_ops.py:69
CAUSAL = (True, False)


def _inputs(shape, seed: int):
    """q, k, v and the cotangent, fp32, from one numpy seed."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def attention_rank(rank: int, world: int, store: str, kinds) -> dict:
    """This rank's outputs and gradients for each (function, causal) in
    ``kinds`` (what ``run_world`` calls in each process)."""
    from ray_tpu_torch import collective as col
    from ray_tpu_torch.ops.ring_attention import (ring_attention,
                                                  ulysses_attention)

    group = col.init_collective_group(world, rank, group_name="seq",
                                      device="cpu",
                                      init_method=f"file://{store}")
    fns = {"ring": (ring_attention, RING_SHAPE),
           "ulysses": (ulysses_attention, ULYSSES_SHAPE)}
    out = {}
    for kind in kinds:
        fn, shape = fns[kind]
        local = shape[1] // world
        rows = slice(rank * local, (rank + 1) * local)
        for causal in CAUSAL:
            q, k, v, ct = (torch.from_numpy(x[:, rows].copy())
                           for x in _inputs(shape, seed=len(kind)))
            q, k, v = (x.requires_grad_() for x in (q, k, v))
            o = fn(q, k, v, group, causal)
            grads = torch.autograd.grad((o * ct).sum(), (q, k, v))
            out[kind, causal] = [o.detach(), *grads]
    # Ulysses cuts heads across ranks: a head count the world does not
    # divide raises
    try:
        q = torch.zeros(1, 4, world + 1, 8)
        ulysses_attention(q, q, q, group)
    except ValueError as e:
        out["heads_error"] = str(e)
    col.destroy_collective_group("seq")
    return out


def _jax_reference(kind: str, world: int, causal: bool):
    """The JAX function under shard_map on a ``world``-device mesh: the
    output and the gradients of sum(out * cotangent)."""
    # the JAX reference; the card's machine lacks flax
    pytest.importorskip("flax")
    import jax
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from ray_tpu.ops.ring_attention import ring_attention, ulysses_attention
    from ray_tpu.parallel import create_mesh

    fn, shape = {"ring": (ring_attention, RING_SHAPE),
                 "ulysses": (ulysses_attention, ULYSSES_SHAPE)}[kind]
    mesh = create_mesh({"seq": world}, devices=jax.devices()[:world])
    sharded = shard_map(lambda q, k, v: fn(q, k, v, "seq", causal=causal),
                        mesh=mesh, in_specs=(P(None, "seq"),) * 3,
                        out_specs=P(None, "seq"), check_rep=False)

    @jax.jit
    def run(q, k, v, ct):  # the output, and its VJP of ct: the gradients
        out, vjp = jax.vjp(sharded, q, k, v)
        return (out, *vjp(ct))

    return [np.asarray(x) for x in run(*_inputs(shape, seed=len(kind)))]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """world size -> every rank's results: ring and Ulysses at 2, the ring
    at 4 (one gloo world each)."""
    here = os.path.abspath(__file__)
    return {2: run_world(here, "attention_rank", 2,
                         tmp_path_factory.mktemp("seq2"),
                         kinds=("ring", "ulysses")),
            4: run_world(here, "attention_rank", 4,
                         tmp_path_factory.mktemp("seq4"), kinds=("ring",))}


def _check(ranks, kind, world, causal):
    want = _jax_reference(kind, world, causal)
    got = [torch.cat([r[kind, causal][i] for r in ranks[world]], dim=1)
           for i in range(4)]
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL,
                                   err_msg=f"{kind} world {world} {name}")


@pytest.mark.parametrize("causal", CAUSAL, ids=["causal", "full"])
@pytest.mark.parametrize("world", [2, 4])
def test_ring_attention_matches_jax(ranks, world, causal):
    _check(ranks, "ring", world, causal)


@pytest.mark.parametrize("causal", CAUSAL, ids=["causal", "full"])
def test_ulysses_attention_matches_jax(ranks, causal):
    _check(ranks, "ulysses", 2, causal)


def test_ulysses_needs_heads_divisible_by_world(ranks):
    assert all("divisible" in r["heads_error"] for r in ranks[2])


def test_ring_block_math_on_one_process():
    """The per-step functions alone, as the chip smoke drives them for N
    virtual ranks: the blocks of rank i merged by lse are attention over
    the whole sequence, and the block backward fed the merged lse and
    Delta sums to its gradients (fp64, so exact to 1e-12)."""
    from ray_tpu_torch.ops.attention import (attention_delta,
                                             flash_attention_bwd_plain,
                                             flash_attention_fwd_plain)
    from ray_tpu_torch.ops.ring_attention import (attend_block,
                                                  block_backward,
                                                  merge_blocks)

    n, (B, S, H, D) = 4, (1, 32, 2, 8)
    gen = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(B, S, H, D, generator=gen,
                               dtype=torch.float64) for _ in range(4))
    o_ref, lse_ref = flash_attention_fwd_plain(q, k, v, True)
    dq_ref, dk_ref, dv_ref = flash_attention_bwd_plain(q, k, v, o_ref,
                                                       lse_ref, do, True)
    sl = [slice(r * S // n, (r + 1) * S // n) for r in range(n)]
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for i in range(n):
        o = lse = None
        for j in range(i + 1):  # causal: blocks of ranks after i are skipped
            o_b, lse_b = attend_block(q[:, sl[i]], k[:, sl[j]], v[:, sl[j]],
                                      j == i)
            o, lse = ((o_b, lse_b) if o is None
                      else merge_blocks(o, lse, o_b, lse_b))
        torch.testing.assert_close(o.double(), o_ref[:, sl[i]], atol=1e-6,
                                   rtol=0)
        o = o_ref[:, sl[i]]
        delta = attention_delta(o, do[:, sl[i]])
        dq = torch.zeros(q[:, sl[i]].shape, dtype=torch.float32)
        for j in range(i + 1):
            dk_b, dv_b = block_backward(q[:, sl[i]], k[:, sl[j]],
                                        v[:, sl[j]], do[:, sl[i]], lse,
                                        delta, j == i, dq)
            dk[:, sl[j]] += dk_b
            dv[:, sl[j]] += dv_b
        torch.testing.assert_close(dq.double(), dq_ref[:, sl[i]], atol=1e-6,
                                   rtol=0)
    torch.testing.assert_close(dk, dk_ref, atol=1e-12, rtol=0)
    torch.testing.assert_close(dv, dv_ref, atol=1e-12, rtol=0)
