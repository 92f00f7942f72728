"""The port's Tune held against the JAX package's, on the CPU.

Search: for seeds 0-2 and one mixed param space, ``generate_variants``
and every searcher propose the same configs in the same order (TPE's after
its warm-up, on the same ``on_trial_complete`` stream). Schedulers: ASHA,
HyperBand, median stopping and PBT return the same decision (PBT the same
mutated config and checkpoint) for every report of one fixed stream. The
sweep: a ``Tuner`` of the tiny transformer, ASHA over 4 learning rates with
one trial at a time, on each package's own runtime from the same initial
params (``from_jax_params``): the same trials stop at the same steps, the
best config is the same, and every loss agrees within the fp32 training
tolerance (rtol 1e-5, as ``tests/test_torch_train.py``).
"""

import dataclasses
import math

import numpy as np
import pytest

pytest.importorskip("flax")  # the JAX reference; the card's machine lacks it

from ray_tpu import tune as jtune  # noqa: E402
from ray_tpu.tune import schedulers as jsched  # noqa: E402
from ray_tpu.tune import searchers as jsearch  # noqa: E402
from ray_tpu_torch import tune as ttune  # noqa: E402
from ray_tpu_torch.tune import schedulers as tsched  # noqa: E402
from ray_tpu_torch.tune import searchers as tsearch  # noqa: E402


def _space(tune):
    return {"layers": tune.grid_search([1, 2, 3]),
            "lr": tune.loguniform(1e-4, 1e-1),
            "dropout": tune.uniform(0.0, 0.5),
            "act": tune.choice(["relu", "gelu", "silu"]),
            "width": tune.randint(16, 256),
            "seed": 7}


def _score(cfg) -> float:
    """A deterministic objective of a config (for the searchers' stream)."""
    return (-abs(math.log10(cfg["lr"]) + 2.5) - cfg["dropout"]
            + 0.1 * cfg["layers"] + (cfg["act"] == "gelu") * 0.2
            - abs(cfg["width"] - 128) / 256)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_generate_variants_match(seed):
    from ray_tpu.tune.search import generate_variants as jgen
    from ray_tpu_torch.tune.search import generate_variants as tgen

    want = jgen(_space(jtune), num_samples=3, seed=seed)
    got = tgen(_space(ttune), num_samples=3, seed=seed)
    assert len(got) == 9
    assert got == want


def _drain(searcher, n, mode="max", feed=True):
    out = []
    for i in range(n + 1):
        cfg = searcher.suggest(f"trial_{i:05d}")
        if cfg is None:
            break
        out.append(cfg)
        if feed:
            score = _score(cfg)
            searcher.on_trial_complete(f"trial_{i:05d}", {
                "score": score if mode == "max" else -score,
                "__config__": cfg})
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", ["basic", "quasi_random", "tpe"])
def test_searchers_propose_the_same_configs(kind, seed):
    if kind == "basic":
        want = _drain(jsearch.BasicVariantSearcher(_space(jtune), 2, seed), 6)
        got = _drain(tsearch.BasicVariantSearcher(_space(ttune), 2, seed), 6)
        assert len(got) == 6
    elif kind == "quasi_random":
        want = _drain(jsearch.QuasiRandomSearcher(_space(jtune), 8, seed), 8)
        got = _drain(tsearch.QuasiRandomSearcher(_space(ttune), 8, seed), 8)
        assert len(got) == 8
    else:
        kw = dict(num_samples=12, metric="score", mode="min", n_warmup=4,
                  seed=seed)
        want = _drain(jsearch.TPESearcher(_space(jtune), **kw), 12, "min")
        got = _drain(tsearch.TPESearcher(_space(ttune), **kw), 12, "min")
        assert len(got) == 12
        # past the warm-up the proposals come from the observations
        assert got[4:] == want[4:]
    assert got == want


def _stream():
    """One fixed report stream: 6 trials reporting a noisy rising score,
    interleaved, each trial id's iterations counted by the stream."""
    rng = np.random.default_rng(3)
    quality = rng.uniform(0.1, 1.0, 6)
    its = [0] * 6
    out = []
    order = [0, 1, 2, 0, 3, 1, 4, 5, 2, 0, 3, 1, 4, 5, 2, 0, 1, 3, 4, 5] * 3
    for i in order:
        its[i] += 1
        score = float(quality[i] * (1 - 0.5 ** its[i])
                      + rng.normal(0, 0.02))
        out.append((f"trial_{i:05d}", {"score": score,
                                       "training_iteration": its[i]}))
    return out


@pytest.mark.parametrize("name", ["fifo", "asha", "hyperband", "median",
                                  "pbt"])
@pytest.mark.parametrize("mode", ["max", "min"])
def test_schedulers_decide_the_same(name, mode):
    def make(mod):
        if name == "fifo":
            return mod.FIFOScheduler()
        if name == "asha":
            return mod.ASHAScheduler(metric="score", mode=mode, max_t=12,
                                     grace_period=1, reduction_factor=2)
        if name == "hyperband":
            return mod.HyperBandScheduler(metric="score", mode=mode, max_t=12,
                                          reduction_factor=2)
        if name == "median":
            return mod.MedianStoppingRule(metric="score", mode=mode,
                                          grace_period=2,
                                          min_samples_required=2)
        return mod.PopulationBasedTraining(
            metric="score", mode=mode, perturbation_interval=3,
            hyperparam_mutations={"lr": (1e-4, 1.0),
                                  "act": ["relu", "gelu"]},
            quantile_fraction=0.34, seed=5)

    j, t = make(jsched), make(tsched)
    decisions = []
    for k, (tid, metrics) in enumerate(_stream()):
        for s in (j, t):
            if name == "pbt":
                if metrics["training_iteration"] == 1:
                    s.register_trial(tid, {"lr": 0.01 * (1 + int(tid[-1])),
                                           "act": "relu",
                                           "__checkpoint__": None})
                s.record_checkpoint(tid, {"step": k})
        want = j.on_result(tid, dict(metrics))
        got = t.on_result(tid, dict(metrics))
        assert got == want, (k, tid, metrics)
        decisions.append(got if isinstance(got, str) else got[0])
    if name in ("asha", "hyperband", "median"):
        assert "STOP" in decisions
    if name == "pbt":
        assert "EXPLOIT" in decisions


# ---------------------------------------------------------------------------
# the sweep: the tiny transformer under ASHA on each package's runtime
# ---------------------------------------------------------------------------

SHAPE = dict(d_model=128, n_heads=2, n_kv_heads=1)
BATCH, SEQ = 2, 32
LRS = [3e-4, 1e-3, 3e-3, 1e-2]
MAX_T = 6  # the chip smoke's ASHA: grace 2, reduction 2, max_t 6
LOSS_RTOL = 1e-5


def _asha(mod):
    return mod.ASHAScheduler(metric="loss", mode="min", max_t=MAX_T,
                             grace_period=2, reduction_factor=2)


def _jax_sweep():
    import ray_tpu

    def trainable(config):
        import jax
        import jax.numpy as jnp

        from ray_tpu import tune
        from ray_tpu.models.transformer import CONFIGS
        from ray_tpu.parallel import TrainStepBundle, create_mesh, make_optimizer

        cfg = dataclasses.replace(CONFIGS["tiny"], dtype=jnp.float32, **SHAPE)
        mesh = create_mesh({"data": 1, "fsdp": 1, "seq": 1, "tensor": 1,
                            "expert": 1}, devices=jax.devices()[:1])
        bundle = TrainStepBundle(cfg, mesh, optimizer=make_optimizer(
            learning_rate=config["lr"], warmup_steps=1))
        params, opt = bundle.init(jax.random.PRNGKey(0))
        batch = bundle.make_batch(np.random.default_rng(0), BATCH, SEQ)
        losses = []
        for t in range(1, MAX_T + 1):
            params, opt, loss = bundle.step(params, opt, batch)
            losses.append(float(loss))
            tune.report({"loss": losses[-1], "losses": list(losses),
                         "training_iteration": t})
        return {"loss": losses[-1]}

    ray_tpu.shutdown()
    ray_tpu.init(num_cpus=2)
    try:
        return jtune.Tuner(
            trainable, param_space={"lr": jtune.grid_search(LRS)},
            tune_config=jtune.TuneConfig(metric="loss", mode="min",
                                         max_concurrent_trials=1,
                                         scheduler=_asha(jsched))).fit()
    finally:
        ray_tpu.shutdown()


def _init_params():
    """The JAX bundle's initial params (PRNGKey 0) in the port's layout, as
    numpy."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models.transformer import CONFIGS
    from ray_tpu.parallel import TrainStepBundle, create_mesh
    from ray_tpu_torch.models import from_jax_params

    cfg = dataclasses.replace(CONFIGS["tiny"], dtype=jnp.float32, **SHAPE)
    mesh = create_mesh({"data": 1, "fsdp": 1, "seq": 1, "tensor": 1,
                        "expert": 1}, devices=jax.devices()[:1])
    params, _ = TrainStepBundle(cfg, mesh).init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    return {k: v.numpy() for k, v in from_jax_params(tree).items()}


def _torch_sweep(init):
    import ray_tpu_torch

    def trainable(config):
        import torch

        from ray_tpu_torch import tune
        from ray_tpu_torch.models import CONFIGS
        from ray_tpu_torch.parallel import TrainStepBundle, make_optimizer

        torch.set_num_threads(1)
        cfg = dataclasses.replace(CONFIGS["tiny"], dtype=torch.float32,
                                  **SHAPE)
        bundle = TrainStepBundle(cfg, device="cpu", optimizer=make_optimizer(
            learning_rate=config["lr"], warmup_steps=1))
        params = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
        opt = bundle.optimizer.init(params)
        batch = bundle.make_batch(np.random.default_rng(0), BATCH, SEQ)
        losses = []
        for t in range(1, MAX_T + 1):
            params, opt, loss = bundle.step(params, opt, batch)
            losses.append(float(loss))
            tune.report({"loss": losses[-1], "losses": list(losses),
                         "training_iteration": t})
        return {"loss": losses[-1]}

    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2, device="cpu")
    try:
        return ttune.Tuner(
            trainable, param_space={"lr": ttune.grid_search(LRS)},
            tune_config=ttune.TuneConfig(metric="loss", mode="min",
                                         max_concurrent_trials=1,
                                         scheduler=_asha(tsched))).fit()
    finally:
        ray_tpu_torch.shutdown()


def test_tiny_sweep_matches_jax():
    want = _jax_sweep()
    got = _torch_sweep(_init_params())

    def by_trial(grid):
        return {r.trial_id: r for r in grid.results}

    w, g = by_trial(want), by_trial(got)
    assert sorted(g) == sorted(w) and len(g) == len(LRS)
    for tid in w:
        assert g[tid].error is None and w[tid].error is None, \
            (g[tid].error, w[tid].error)
        assert g[tid].config == w[tid].config
        wl, gl = w[tid].metrics["losses"], g[tid].metrics["losses"]
        # the same trials stopped at the same steps
        assert (len(gl), g[tid].stopped_early) == (len(wl),
                                                   w[tid].stopped_early)
        np.testing.assert_allclose(gl, wl, rtol=LOSS_RTOL)
    # ASHA cut at least one trial before max_t, and the best agrees
    assert min(len(r.metrics["losses"]) for r in want.results) < MAX_T
    assert got.get_best_result().config == want.get_best_result().config
