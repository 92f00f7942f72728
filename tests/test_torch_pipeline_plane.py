"""The port's pipeline plane (``ray_tpu_torch/train/pipeline``) on the CPU: a
mirror of ``tests/test_pipeline_plane.py``, plus per-module parity with
the JAX package.

- schedule geometry: the 1F1B and interleaved goldens, properties and
  bubble bounds, and the port's schedules equal to the JAX ones on a grid
  of (S, M, V);
- partitioning: the stage keys cover the model disjointly and equal the
  JAX ones; each stage kind's ``StagePrograms`` (first, middle, last;
  dense and MoE) gives the JAX ``StagePrograms``' forward and backward on
  the same params (``from_jax_params``) and inputs;
- the slice as a whole: two-stage pipelines (V = 1 and V = 2) on a port
  cluster hold their losses and merged params within atol 1e-5 of the JAX
  ``TrainStepBundle._fused_step`` over 3 steps from the same initial params
  and microbatches (the yardstick the JAX pipeline is held to), with the
  timeline golden off the same run and a stage kill -> gang re-form ->
  per-stage manifest restore that keeps matching;
- a throughput smoke (single device vs pipeline tokens/s, the simulated
  bubble under its bound), the bucketed stage apply against the whole-tree
  apply, and a gloo ``dp_group`` of two replicas.

fp32, ``attention_impl="xla"`` on both sides. Nothing here imports JAX at
module level: the port's workers may import this module.
"""

import os
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.train.pipeline import (
    PipelineConfig,
    PipelineTrainer,
    bubble_upper_bound,
    build_interleaved_schedule,
    build_schedule,
    make_microbatches,
    max_inflight_activations,
    partition_layers,
    simulate,
    stage_param_keys,
)

ATOL = 1e-5


def _jcfg(**kw):
    import jax.numpy as jnp

    from ray_tpu.models.transformer import TransformerConfig

    base = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                n_kv_heads=4, d_ff=64, max_seq_len=32, remat=False,
                dtype=jnp.float32, attention_impl="xla")
    base.update(kw)
    return TransformerConfig(**base)


def _cfg(**kw):
    """The port's config of the JAX file's ``_cfg``."""
    from ray_tpu_torch.models.transformer import TransformerConfig

    base = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                n_kv_heads=4, d_ff=64, max_seq_len=32, remat=False,
                dtype=torch.float32, attention_impl="xla")
    base.update(kw)
    return TransformerConfig(**base)


def _jax_init(jcfg, seed):
    """The full model's flax params (numpy) drawn from ``seed``."""
    import flax.linen as nn
    import jax

    from ray_tpu.models.transformer import Transformer

    params = nn.unbox(Transformer(jcfg).init(
        jax.random.PRNGKey(seed), np.zeros((1, 16), np.int32))["params"])
    return jax.tree_util.tree_map(np.asarray, params)


def _port_params(jparams):
    from ray_tpu_torch.models import from_jax_params

    return from_jax_params(jparams)


class _Reference:
    """The JAX fused single-mesh step on a one-device mesh, from the given
    params, fed the concatenated microbatches of each step."""

    def __init__(self, jcfg, jparams, pipe, seed):
        import jax

        from ray_tpu.parallel import create_mesh
        from ray_tpu.parallel.train import TrainStepBundle, make_optimizer

        mesh = create_mesh({"data": 1, "fsdp": 1, "seq": 1, "tensor": 1,
                            "expert": 1}, devices=jax.devices()[:1])
        self.bundle = TrainStepBundle(jcfg, mesh, optimizer=make_optimizer(),
                                      donate=False)
        self.params = jparams
        self.opt_state = self.bundle.optimizer.init(jparams)
        self.jcfg, self.pipe, self.seed = jcfg, pipe, seed

    def step(self, step):
        mbs = make_microbatches(self.jcfg, self.pipe, self.seed, step)
        batch = {k: np.concatenate([m[k] for m in mbs]) for k in mbs[0]}
        self.params, self.opt_state, loss = self.bundle._fused_step(
            self.params, self.opt_state, batch)
        return float(loss)

    def assert_params_close(self, merged):
        import jax

        want = _port_params(jax.tree_util.tree_map(np.asarray, self.params))
        assert set(merged) == set(want)
        for k in want:
            np.testing.assert_allclose(
                merged[k].double().numpy(), want[k].double().numpy(),
                rtol=0, atol=ATOL, err_msg=k)


@pytest.fixture(scope="module")
def cluster():
    from ray_tpu_torch.util import tracing

    prev = os.environ.get("RAY_TPU_ENABLE_TRACING")
    os.environ["RAY_TPU_ENABLE_TRACING"] = "1"
    tracing.enable()
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=8, device="cpu")
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()
    # fully restore tracing state: _enabled is a process-level cache, and
    # leaving it on would put every later test module in this pytest
    # process on the traced paths
    if prev is None:
        os.environ.pop("RAY_TPU_ENABLE_TRACING", None)
    else:
        os.environ["RAY_TPU_ENABLE_TRACING"] = prev
    tracing._enabled = None


# ---------------------------------------------------------------------------
# schedule geometry (pure, no cluster)
# ---------------------------------------------------------------------------


def test_1f1b_schedule_golden_2x4():
    sched = build_schedule(2, 4)
    assert [tuple(op) for op in sched[0]] == [
        ("fwd", 0, 0), ("send_f", 0, 0),
        ("fwd", 1, 0), ("send_f", 1, 0), ("recv_b", 0, 0), ("bwd", 0, 0),
        ("fwd", 2, 0), ("send_f", 2, 0), ("recv_b", 1, 0), ("bwd", 1, 0),
        ("fwd", 3, 0), ("send_f", 3, 0), ("recv_b", 2, 0), ("bwd", 2, 0),
        ("recv_b", 3, 0), ("bwd", 3, 0),
    ]
    assert [tuple(op) for op in sched[1]] == [
        ("recv_f", 0, 0), ("fwd", 0, 0), ("bwd", 0, 0), ("send_b", 0, 0),
        ("recv_f", 1, 0), ("fwd", 1, 0), ("bwd", 1, 0), ("send_b", 1, 0),
        ("recv_f", 2, 0), ("fwd", 2, 0), ("bwd", 2, 0), ("send_b", 2, 0),
        ("recv_f", 3, 0), ("fwd", 3, 0), ("bwd", 3, 0), ("send_b", 3, 0),
    ]


def test_1f1b_schedule_properties_4x8():
    S, M = 4, 8
    sched = build_schedule(S, M)
    for s, ops in enumerate(sched):
        kinds = [op.kind for op in ops]
        # every microbatch runs exactly one fwd and one bwd per stage
        assert kinds.count("fwd") == M and kinds.count("bwd") == M
        # warmup depth: S-1-s warmup forwards + the first steady-state
        # forward run before the first backward
        first_bwd = kinds.index("bwd")
        assert kinds[:first_bwd].count("fwd") == min(S - s, M)
        # in-flight stash never exceeds the 1F1B bound
        inflight = peak = 0
        for k, *_ in ops:
            if k == "fwd":
                inflight += 1
                peak = max(peak, inflight)
            elif k == "bwd":
                inflight -= 1
        assert peak <= max_inflight_activations(s, S)
        # interior stages send/recv every microbatch both ways
        if 0 < s < S - 1:
            assert kinds.count("send_f") == kinds.count("send_b") == M
            assert kinds.count("recv_f") == kinds.count("recv_b") == M


def test_1f1b_bubble_matches_analytic_bound():
    for S, M in [(2, 4), (2, 8), (4, 8), (4, 16), (8, 32)]:
        sim = simulate(S, M, t_fwd=1.0, t_bwd=2.0)
        bound = bubble_upper_bound(S, M)
        assert sim["bubble_fraction"] <= bound + 1e-9, (S, M)
        # with equal per-mb costs 1F1B achieves the bound exactly
        assert abs(sim["bubble_fraction"] - bound) < 1e-9, (S, M)
    # communication costs only ever add bubble
    assert simulate(4, 8, t_comm=0.5)["bubble_fraction"] >= \
        bubble_upper_bound(4, 8)


def test_interleaved_schedule_golden_2x4_v2():
    """Exact per-rank op streams for S=2, V=2, M=4 (virtual stages
    q = chunk*2 + rank; warmup = 2*(S-1-rank) + (V-1)*S)."""
    sched = build_interleaved_schedule(2, 4, 2)
    assert [tuple(op) for op in sched[0]] == [
        ("fwd", 0, 0), ("send_f", 0, 0),
        ("fwd", 1, 0), ("send_f", 1, 0),
        ("recv_f", 0, 1), ("fwd", 0, 1), ("send_f", 0, 1),
        ("recv_f", 1, 1), ("fwd", 1, 1), ("send_f", 1, 1),
        ("fwd", 2, 0), ("send_f", 2, 0),
        ("recv_b", 0, 1), ("bwd", 0, 1), ("send_b", 0, 1),
        ("fwd", 3, 0), ("send_f", 3, 0),
        ("recv_b", 1, 1), ("bwd", 1, 1), ("send_b", 1, 1),
        ("recv_f", 2, 1), ("fwd", 2, 1), ("send_f", 2, 1),
        ("recv_b", 0, 0), ("bwd", 0, 0),
        ("recv_f", 3, 1), ("fwd", 3, 1), ("send_f", 3, 1),
        ("recv_b", 1, 0), ("bwd", 1, 0),
        ("recv_b", 2, 1), ("bwd", 2, 1), ("send_b", 2, 1),
        ("recv_b", 3, 1), ("bwd", 3, 1), ("send_b", 3, 1),
        ("recv_b", 2, 0), ("bwd", 2, 0),
        ("recv_b", 3, 0), ("bwd", 3, 0),
    ]
    assert [tuple(op) for op in sched[1]] == [
        ("recv_f", 0, 0), ("fwd", 0, 0), ("send_f", 0, 0),
        ("recv_f", 1, 0), ("fwd", 1, 0), ("send_f", 1, 0),
        ("recv_f", 0, 1), ("fwd", 0, 1), ("bwd", 0, 1), ("send_b", 0, 1),
        ("recv_f", 1, 1), ("fwd", 1, 1), ("bwd", 1, 1), ("send_b", 1, 1),
        ("recv_f", 2, 0), ("fwd", 2, 0), ("send_f", 2, 0),
        ("recv_b", 0, 0), ("bwd", 0, 0), ("send_b", 0, 0),
        ("recv_f", 3, 0), ("fwd", 3, 0), ("send_f", 3, 0),
        ("recv_b", 1, 0), ("bwd", 1, 0), ("send_b", 1, 0),
        ("recv_f", 2, 1), ("fwd", 2, 1), ("bwd", 2, 1), ("send_b", 2, 1),
        ("recv_f", 3, 1), ("fwd", 3, 1), ("bwd", 3, 1), ("send_b", 3, 1),
        ("recv_b", 2, 0), ("bwd", 2, 0), ("send_b", 2, 0),
        ("recv_b", 3, 0), ("bwd", 3, 0), ("send_b", 3, 0),
    ]


def test_interleaved_schedule_properties_and_validation():
    # every (chunk, mb) runs exactly one fwd + one bwd on its rank
    for S, M, V in [(2, 4, 2), (4, 8, 2), (2, 4, 4), (3, 6, 2)]:
        sched = build_interleaved_schedule(S, M, V)
        for r, ops in enumerate(sched):
            fwds = [(op.chunk, op.mb) for op in ops if op.kind == "fwd"]
            bwds = [(op.chunk, op.mb) for op in ops if op.kind == "bwd"]
            want = {(c, m) for c in range(V) for m in range(M)}
            assert set(fwds) == want and len(fwds) == M * V, (S, M, V, r)
            assert set(bwds) == want and len(bwds) == M * V, (S, M, V, r)
            # in-flight stash bounded by the interleaved warmup depth
            inflight = peak = 0
            for k, *_ in ops:
                if k == "fwd":
                    inflight += 1
                    peak = max(peak, inflight)
                elif k == "bwd":
                    inflight -= 1
            assert peak <= max_inflight_activations(r, S, V), (S, M, V, r)
    # V=1 degenerates to the plain schedule, exactly
    assert build_interleaved_schedule(2, 4, 1) == build_schedule(2, 4)
    # the chunk rotation only closes on whole groups of S
    with pytest.raises(ValueError, match="divisible"):
        build_interleaved_schedule(2, 3, 2)
    with pytest.raises(ValueError, match="chunk"):
        build_interleaved_schedule(2, 4, 0)


def test_interleaved_bubble_matches_analytic_bound():
    """The simulator (real channel semantics: FIFO edges + finite ring
    depth) hits (S-1)/(S-1+V*M) exactly at equal per-chunk costs — and
    never deadlocks or desyncs, which the simulator raises on."""
    shapes = [(2, 4, 2), (2, 8, 2), (4, 8, 2), (2, 4, 4), (3, 6, 2),
              (4, 4, 2), (2, 8, 1), (4, 8, 1)]
    for S, M, V in shapes:
        for depth in (0, 2):
            sim = simulate(S, M, t_fwd=1.0, t_bwd=2.0, num_chunks=V,
                           channel_depth=depth)
            bound = bubble_upper_bound(S, M, V)
            assert abs(sim["bubble_fraction"] - bound) < 1e-9, \
                (S, M, V, depth)
    # interleaving strictly shrinks the bubble at fixed S, M
    assert bubble_upper_bound(4, 8, 2) < bubble_upper_bound(4, 8, 1)


def test_schedules_equal_the_jax_schedules():
    """The port's op streams, bounds, stash depths and simulations are the
    JAX package's on a grid of (S, M, V)."""
    pytest.importorskip("flax")
    from ray_tpu.train.pipeline import schedule as jsched

    from ray_tpu_torch.train.pipeline import schedule as psched

    for S in (1, 2, 3, 4):
        for V in (1, 2, 3):
            for M in (S, 2 * S, 4 * S):
                got = psched.build_interleaved_schedule(S, M, V)
                want = jsched.build_interleaved_schedule(S, M, V)
                assert [[tuple(op) for op in ops] for ops in got] == \
                    [[tuple(op) for op in ops] for ops in want], (S, M, V)
                assert psched.bubble_upper_bound(S, M, V) == \
                    jsched.bubble_upper_bound(S, M, V)
                for r in range(S):
                    assert psched.max_inflight_activations(r, S, V) == \
                        jsched.max_inflight_activations(r, S, V)
                for depth in (0, 2):
                    assert psched.simulate(
                        S, M, t_fwd=1.0, t_bwd=2.0, t_comm=0.25,
                        num_chunks=V, channel_depth=depth) == \
                        jsched.simulate(S, M, t_fwd=1.0, t_bwd=2.0,
                                        t_comm=0.25, num_chunks=V,
                                        channel_depth=depth), (S, M, V)
        assert psched.build_schedule(S, 2 * S) == \
            jsched.build_schedule(S, 2 * S)


# ---------------------------------------------------------------------------
# partitioning and the stage programs
# ---------------------------------------------------------------------------


def test_partition_keys_cover_model_disjointly():
    cfg = _cfg(n_layers=5)
    for S in (1, 2, 3, 5):
        bounds = partition_layers(cfg.n_layers, S)
        assert bounds[0][0] == 0 and bounds[-1][1] == cfg.n_layers
        seen = []
        for s in range(S):
            seen += stage_param_keys(cfg, s, S)
        expected = {"embed", "final_norm", "lm_head"} | {
            f"layer_{i}" for i in range(cfg.n_layers)}
        assert set(seen) == expected and len(seen) == len(set(seen))


def test_partition_keys_equal_the_jax_keys():
    """Layer cuts, stage keys, interleaved chunk keys, the split of a full
    state dict and the repartition plan are the JAX package's."""
    pytest.importorskip("flax")
    from ray_tpu.train.pipeline import controller as jctl
    from ray_tpu.train.pipeline import partition as jpart

    from ray_tpu_torch.models import init_params
    from ray_tpu_torch.train.pipeline import controller as pctl
    from ray_tpu_torch.train.pipeline import partition as ppart

    for L in (2, 4, 5, 7):
        jcfg, pcfg = _jcfg(n_layers=L), _cfg(n_layers=L)
        for S in range(1, L + 1):
            assert ppart.partition_layers(L, S) == jpart.partition_layers(L, S)
            for s in range(S):
                assert ppart.stage_param_keys(pcfg, s, S) == \
                    jpart.stage_param_keys(jcfg, s, S)
            for V in (1, 2):
                if S * V > L:
                    continue
                for r in range(S):
                    assert ppart.rank_chunk_keys(pcfg, r, S, V) == \
                        jpart.rank_chunk_keys(jcfg, r, S, V)
            for S2 in range(1, L + 1):
                assert pctl.repartition_manifest_leaves(
                    "/x", pcfg, S, S2) == jctl.repartition_manifest_leaves(
                    "/x", jcfg, S, S2)
    # the split of the port's flat state dict selects the JAX split's leaves
    cfg = _cfg(n_layers=4)
    full = init_params(cfg, seed=0, device="cpu")
    jsplit = jpart.split_params(_jax_init(_jcfg(n_layers=4), 0),
                                _jcfg(n_layers=4), 3)
    for got, want in zip(ppart.split_params(full, cfg, 3), jsplit):
        assert set(got) == set(_port_params(want))
    assert ppart.merge_params(ppart.split_params(full, cfg, 3)).keys() == \
        full.keys()


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
@pytest.mark.parametrize("kind", ["first", "middle", "last"])
def test_stage_programs_match_jax(kind, moe):
    """Each stage kind's forward and backward against the JAX
    ``StagePrograms`` of the same stage (3 stages over 3 layers), with the
    same params and inputs: outputs, aux, every parameter gradient and the
    input gradient within atol 1e-5."""
    pytest.importorskip("flax")
    import jax
    import optax

    from ray_tpu.train.pipeline.partition import StagePrograms as JaxPrograms
    from ray_tpu.train.pipeline.partition import split_params

    from ray_tpu_torch.train.pipeline import StagePrograms
    from ray_tpu_torch.train.pipeline.partition import make_stage_optimizer

    extra = dict(n_experts=4, experts_per_token=2) if moe else {}
    jcfg, cfg = _jcfg(n_layers=3, **extra), _cfg(n_layers=3, **extra)
    stage = {"first": 0, "middle": 1, "last": 2}[kind]
    jfull = _jax_init(jcfg, 3)
    jparams = split_params(jfull, jcfg, 3)[stage]
    jp = JaxPrograms(jcfg, stage, 3, optax.sgd(0.1))
    pp = StagePrograms(cfg, stage, 3, make_stage_optimizer(), device="cpu")
    params = _port_params(jparams)
    rng = np.random.default_rng(11)
    B, S, D = 2, 8, cfg.d_model
    tokens = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    dy = rng.standard_normal((B, S, D)).astype(np.float32)
    targets = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)

    def close(got, want, what):
        np.testing.assert_allclose(
            torch.as_tensor(got).detach().double().numpy(),
            np.asarray(want, np.float64), rtol=0, atol=ATOL, err_msg=what)

    def close_grads(got, want):
        want = _port_params(jax.tree_util.tree_map(np.asarray, want))
        assert set(got) == set(want)
        for k in want:
            close(got[k], want[k], k)

    inp = tokens if kind == "first" else x
    if kind != "last":
        y, aux = pp.fwd(params, inp)
        jy, jaux = jp.fwd(jparams, inp)
        close(y, jy, "y")
        close(aux, jaux, "aux")
        out = pp.bwd(params, inp, torch.from_numpy(dy))
        jout = jp.bwd(jparams, inp, dy)
        if kind == "first":
            close_grads(out, jout)
        else:
            close_grads(out[0], jout[0])
            close(out[1], jout[1], "dx")
    else:
        loss, aux, dparams, dx = pp.bwd(params, inp, targets, mask)
        jloss, jaux, jdparams, jdx = jp.bwd(jparams, inp, targets, mask)
        close(loss, jloss, "loss")
        close(aux, jaux, "aux")
        close_grads(dparams, jdparams)
        close(dx, jdx, "dx")
        floss, _ = pp.fwd_loss(params, inp, targets, mask)
        close(floss, jloss, "fwd_loss")
    if moe:  # the MoE layers' aux reaches the loss and its cotangent
        assert float(aux) > 0


def test_tied_embeddings_single_stage_and_rejection():
    from ray_tpu_torch.train.pipeline import StagePrograms
    from ray_tpu_torch.train.pipeline.partition import make_stage_optimizer

    cfg = _cfg(tie_embeddings=True)
    # S > 1 cannot host a tied head (the table would live on two stages)
    with pytest.raises(ValueError, match="tie_embeddings"):
        StagePrograms(cfg, 0, 2, make_stage_optimizer(), device="cpu")
    # S == 1 ties logits to the embed table — no phantom lm_head param
    progs = StagePrograms(cfg, 0, 1, make_stage_optimizer(), device="cpu")
    params = progs.init(0)
    assert "lm_head" not in params and "embed" in params
    mbs = make_microbatches(cfg, PipelineConfig(
        num_stages=1, num_microbatches=1, microbatch_size=1, seq_len=8),
        0, 0)
    loss, _ = progs.fwd_loss(params, mbs[0]["tokens"], mbs[0]["targets"],
                             mbs[0]["mask"])
    assert np.isfinite(float(loss))
    # the card is the default device: asking for it without one raises
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            StagePrograms(_cfg(), 0, 2, make_stage_optimizer())
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PipelineTrainer(_cfg(), PipelineConfig())


# ---------------------------------------------------------------------------
# end-to-end acceptance flow, one gang + one single-mesh JAX reference:
# (1) 2-stage loss/param parity vs the fused TrainStepBundle step,
# (2) timeline golden off the same run (cross-process flow pairs per mb),
# (3) stage kill -> per-stage manifest restore -> deterministic resume
#     that KEEPS matching the single-mesh run (ckpt round-trip fidelity)
# ---------------------------------------------------------------------------


def test_two_stage_parity_timeline_kill_restore(cluster, tmp_path):
    pytest.importorskip("flax")
    from ray_tpu_torch.util import tracing

    jcfg, cfg = _jcfg(), _cfg()
    M = 4
    pipe = PipelineConfig(num_stages=2, num_microbatches=M,
                          microbatch_size=2, seq_len=16,
                          clip_global_norm=1.0, ckpt_every=2,
                          step_timeout_s=60.0)
    steps = 3
    jparams = _jax_init(jcfg, 5)
    tracing.clear()
    trainer = PipelineTrainer(cfg, pipe, params=_port_params(jparams),
                              seed=5, ckpt_root=str(tmp_path), device="cpu")
    try:
        stats = trainer.train(steps)  # saves per-stage manifests at step 2
        pipe_losses = [s["loss"] for s in stats]

        # -- (1) parity: same init params, same data, the fused step with
        # optax.chain(clip_by_global_norm(1.0), adamw(schedule)) --
        ref = _Reference(jcfg, jparams, pipe, 5)
        ref_losses = [ref.step(s) for s in range(steps)]
        np.testing.assert_allclose(pipe_losses, ref_losses, rtol=0,
                                   atol=ATOL)
        ref.assert_params_close(trainer.merged_params())
        # activations actually crossed the channel plane
        assert stats[0]["activation_bytes_per_mb"] > 0

        # -- (2) timeline golden off the same run: pipe.send/pipe.recv
        # spans pair up across the two stage processes per microbatch --
        def _spans():
            spans = tracing.get_spans()
            sends = [s for s in spans if s["name"] == "pipe.send"]
            recvs = [s for s in spans if s["name"] == "pipe.recv"]
            # per step: M activation sends + M grad sends, mirrored recvs
            want = 2 * M * steps
            return (sends, recvs, spans) if len(sends) >= want \
                and len(recvs) >= want else None

        deadline = time.time() + 30
        got = _spans()
        while got is None and time.time() < deadline:
            time.sleep(0.5)
            got = _spans()
        assert got is not None, "pipe.send/recv spans never surfaced"
        sends, recvs, all_spans = got
        by_id = {s["span_id"]: s for s in sends}
        paired = 0
        for r in recvs:
            parent = by_id.get(r.get("parent_id"))
            if parent is None:
                continue
            paired += 1
            assert parent["mb"] == r["mb"]
            assert parent["pid"] != r["pid"], \
                "send/recv must sit on different stage processes"
        assert paired >= 2 * M * steps
        events = tracing.spans_to_chrome_events(sends + recvs)
        flow_s = {e["id"] for e in events if e.get("ph") == "s"}
        flow_f = {e["id"] for e in events if e.get("ph") == "f"}
        assert flow_s and flow_s == flow_f
        assert len(flow_s) >= 2 * M * steps
        # fwd/bwd compute spans carry the per-microbatch tags the
        # timeline groups by (the bubble is visible per microbatch)
        fwd = [s for s in all_spans if s["name"] == "pipe.fwd"]
        assert {(s["stage"], s["mb"]) for s in fwd} >= {
            (st, mb) for st in (0, 1) for mb in range(M)}

        # -- (3) failure: kill stage 1 and train on. The dead actor (or
        # its wedged neighbor) surfaces on the controller's wait-any; the
        # gang re-forms at a fresh channel generation and restores every
        # stage from its step-2 manifest --
        assert trainer.last_saved_step == 2
        for s in range(2):
            assert os.path.isdir(str(tmp_path / f"stage{s}")), \
                "per-stage ckpt store missing"
        ray_tpu_torch.kill(trainer.actors[1])
        more = trainer.train(5)

        assert trainer.recoveries == 1
        assert trainer.restored_steps == [2], \
            "gang must resume from the step-2 per-stage manifests"
        assert trainer.step == 5
        # deterministic replay: the re-run of step 2 (restored state +
        # regenerated microbatches) reproduces the original loss exactly
        rerun_step2 = next(s for s in more if s["step"] == 2)
        np.testing.assert_allclose(rerun_step2["loss"], stats[2]["loss"],
                                   rtol=0, atol=1e-6)
        # restore fidelity: the post-recovery steps 3 and 4 STILL match
        # the single-mesh run — the per-stage manifests round-tripped
        # params AND optimizer state byte-faithfully
        ref_more = [ref.step(3), ref.step(4)]
        np.testing.assert_allclose(
            [s["loss"] for s in more if s["step"] in (3, 4)], ref_more,
            rtol=0, atol=ATOL)
        ref.assert_params_close(trainer.merged_params())
    finally:
        trainer.shutdown()
        tracing.clear()
    # the shutdown swept every ring of both generations
    from ray_tpu_torch.train.pipeline.stage import channel_shm_paths

    for gen in (0, 1):
        assert not any(os.path.exists(p)
                       for p in channel_shm_paths(trainer.run_name, gen, 2))


def test_interleaved_two_stage_parity_v2(cluster, tmp_path):
    """S=2, V=2 (4 virtual stages on 2 ranks, non-contiguous chunks):
    fp32 loss AND param parity vs the fused single-mesh step, plus a
    ckpt save through the chunked manifest layout."""
    pytest.importorskip("flax")
    jcfg, cfg = _jcfg(n_layers=4), _cfg(n_layers=4)
    M = 4
    pipe = PipelineConfig(num_stages=2, num_microbatches=M,
                          microbatch_size=2, seq_len=16,
                          clip_global_norm=1.0, virtual_stages=2,
                          ckpt_every=2, step_timeout_s=60.0)
    steps = 3
    jparams = _jax_init(jcfg, 9)
    trainer = PipelineTrainer(cfg, pipe, params=_port_params(jparams),
                              seed=9, ckpt_root=str(tmp_path), device="cpu")
    try:
        stats = trainer.train(steps)
        pipe_losses = [s["loss"] for s in stats]
        ref = _Reference(jcfg, jparams, pipe, 9)
        ref_losses = [ref.step(s) for s in range(steps)]
        np.testing.assert_allclose(pipe_losses, ref_losses, rtol=0,
                                   atol=ATOL)
        ref.assert_params_close(trainer.merged_params())

        # chunked-manifest layout: the ckpt_every=2 save committed per-rank
        # manifests nesting per virtual stage under ``chunks``, and the
        # chunk param keys across ranks re-merge to the full model's key
        # set
        assert trainer.last_saved_step == 2
        from ray_tpu_torch import ckpt as ckpt_plane

        seen_keys = set()
        for s in range(pipe.num_stages):
            store = ckpt_plane.CheckpointStore(
                str(tmp_path / f"stage{s}"), name=f"{trainer.run_name}-s{s}")
            man = store.latest()
            assert man is not None and man.step == 2
            tree = ckpt_plane.restore_tree(store, man.ckpt_id)
            assert set(tree["chunks"]) == {str(v * 2 + s) for v in range(2)}
            for sub in tree["chunks"].values():
                seen_keys |= set(sub["params"])
        assert seen_keys == set(_port_params(jparams))
    finally:
        trainer.shutdown()


# ---------------------------------------------------------------------------
# throughput smoke: what the JAX file's bench smoke reads off its harness
# ---------------------------------------------------------------------------


def test_pipeline_throughput_smoke(cluster):
    """A single-device step and a 2-stage pipeline on the same batch: both
    report positive tokens/s, activations cross the channel plane, and the
    schedule's simulated bubble obeys the 1F1B bound."""
    from ray_tpu_torch.parallel import TrainStepBundle

    cfg = _cfg()
    M, mb, seq = 2, 1, 16
    pipe = PipelineConfig(num_stages=2, num_microbatches=M,
                          microbatch_size=mb, seq_len=seq,
                          step_timeout_s=60.0)
    tokens = M * mb * seq
    bundle = TrainStepBundle(cfg, device="cpu")
    params, opt = bundle.init(0)
    mbs = make_microbatches(cfg, pipe, 0, 0)
    batch = {k: torch.from_numpy(np.concatenate([m[k] for m in mbs]))
             for k in mbs[0]}
    bundle.step(params, opt, batch)  # warm
    t0 = time.perf_counter()
    bundle.step(params, opt, batch)
    single_tps = tokens / (time.perf_counter() - t0)
    trainer = PipelineTrainer(cfg, pipe, device="cpu")
    try:
        trainer.train(1)  # warm the channels
        t0 = time.perf_counter()
        stats = trainer.train(2)
        pipe_tps = tokens / (time.perf_counter() - t0)
    finally:
        trainer.shutdown()
    assert single_tps > 0 and pipe_tps > 0
    assert stats[-1]["activation_bytes_per_mb"] == mb * seq * cfg.d_model * 4
    sim = simulate(2, M, num_chunks=1, channel_depth=pipe.channel_depth)
    assert sim["bubble_fraction"] <= bubble_upper_bound(2, M) + 1e-9
    hop = stats[-1]["hop"][0]
    assert hop["send_wire_bytes"] > stats[-1]["send_bytes"][0]  # + headers
    assert hop["send_skel_bytes"] < hop["send_wire_bytes"]


# ---------------------------------------------------------------------------
# bucketed apply and the stage-level data-parallel group
# ---------------------------------------------------------------------------


def _seed_store(name, cfg, seed):
    from ray_tpu_torch.models import init_params
    from ray_tpu_torch.weights import WeightStore

    store = WeightStore(name)
    store.publish({"params": init_params(cfg, seed=seed, device="cpu")},
                  durable=True)
    return store


def _stop(actors):
    for a in actors:
        try:
            ray_tpu_torch.get(a.shutdown.remote(), timeout=10)
        except Exception:  # teardown: the stage may be dead already
            pass
        ray_tpu_torch.kill(a)


def test_bucketed_stage_apply_matches_whole_tree(cluster, tmp_path):
    """``bucket_bytes`` routes a stage through the bucketed optimizer apply
    (per-bucket opt state, ``pipe.bucket_apply`` spans). Adam-family
    transforms are per-leaf, so the bucketed apply must reproduce the
    whole-tree apply bit-for-bit — asserted on two single-stage actors fed
    IDENTICAL microbatches, one per mode."""
    from ray_tpu_torch._private.serialization import dumps
    from ray_tpu_torch.train.pipeline import schedule as sched
    from ray_tpu_torch.train.pipeline.stage import PipelineStage

    cfg = _cfg()
    cfg_blob = dumps(cfg)
    M = 2
    store = _seed_store("bk_seed", cfg, 7)
    stages = {
        label: PipelineStage.options(num_cpus=1).remote(
            0, 1, cfg_blob, None, f"bk_{label}", 0,
            bucket_bytes=bucket_bytes, device="cpu")
        for label, bucket_bytes in (("whole", None), ("bucketed", 4 << 10))
    }
    try:
        ray_tpu_torch.get([a.init_weights.remote("bk_seed")
                           for a in stages.values()], timeout=120)
        ops = [list(op) for op in sched.build_schedule(1, M)[0]]
        mbs = make_microbatches(cfg, PipelineConfig(
            num_stages=1, num_microbatches=M, microbatch_size=2,
            seq_len=16), seed=11, step=0)
        results = ray_tpu_torch.get(
            [a.run_schedule.remote(0, ops, mbs) for a in stages.values()],
            timeout=120)
        assert results[0]["losses"] == results[1]["losses"]
        ray_tpu_torch.get([a.apply_grads.remote(1.0 / M)
                           for a in stages.values()], timeout=60)
        trees = ray_tpu_torch.get([a.pull_params.remote()
                                   for a in stages.values()], timeout=60)
        assert set(trees[0]) == set(trees[1]) and len(trees[0]) > 4
        for k in trees[0]:
            assert torch.equal(trees[0][k], trees[1][k]), k
    finally:
        _stop(stages.values())
        store.shutdown()


def test_stage_dp_group_bucketed_allreduce(cluster, tmp_path):
    """Two data-parallel replicas of a single-stage pipeline, fed
    DIFFERENT microbatches over a gloo group: run_schedule launches every
    grad bucket's allreduce asynchronously, and after apply_grads both
    replicas hold the IDENTICAL params — proof the cross-replica sum
    reached both sides."""
    from ray_tpu_torch._private.serialization import dumps
    from ray_tpu_torch.train.pipeline import schedule as sched
    from ray_tpu_torch.train.pipeline.stage import PipelineStage

    cfg = _cfg()
    cfg_blob = dumps(cfg)
    M = 2
    store = _seed_store("dp_bucket_seed", cfg, 3)
    rendezvous = f"file://{tmp_path}/dpb_rendezvous"
    replicas = [
        PipelineStage.options(num_cpus=1).remote(
            0, 1, cfg_blob, None, f"dpb_r{r}", 0,
            bucket_bytes=4 << 10, device="cpu",
            dp_group={"name": "dpb", "world_size": 2, "rank": r,
                      "backend": "cpu", "init_method": rendezvous})
        for r in range(2)
    ]
    try:
        ray_tpu_torch.get([a.ready.remote() for a in replicas], timeout=60)
        ray_tpu_torch.get([a.init_weights.remote("dp_bucket_seed")
                           for a in replicas], timeout=120)
        ops = [list(op) for op in sched.build_schedule(1, M)[0]]
        refs = []
        for r, a in enumerate(replicas):
            mbs = make_microbatches(cfg, PipelineConfig(
                num_stages=1, num_microbatches=M, microbatch_size=2,
                seq_len=16), seed=100 + r, step=0)  # different data!
            refs.append(a.run_schedule.remote(0, ops, mbs))
        results = ray_tpu_torch.get(refs, timeout=120)
        assert all(res["reduce_launched"] for res in results)
        assert results[0]["losses"] != results[1]["losses"]
        sq = ray_tpu_torch.get([a.grad_sqnorm.remote() for a in replicas],
                               timeout=60)
        assert sq[0] == pytest.approx(sq[1])  # both see the summed grads
        ray_tpu_torch.get([a.apply_grads.remote(1.0 / (2 * M))
                           for a in replicas], timeout=60)
        trees = ray_tpu_torch.get([a.pull_params.remote()
                                   for a in replicas], timeout=60)
        for k in trees[0]:
            assert torch.equal(trees[0][k], trees[1][k]), k
    finally:
        _stop(replicas)
        store.shutdown()
