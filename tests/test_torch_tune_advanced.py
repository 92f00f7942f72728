"""Advanced Tune on the port's runtime, on the CPU: a mirror of
``tests/test_tune_advanced.py`` (HyperBand, median stopping, PBT, the
quasi-random and TPE searchers; reference tier:
tune/tests/test_trial_scheduler*.py, test_searchers.py), each test
asserting what its twin asserts."""

import pytest

import ray_tpu_torch
from ray_tpu_torch import tune
from ray_tpu_torch.tune import (
    HyperBandScheduler,
    MedianStoppingRule,
    PopulationBasedTraining,
    QuasiRandomSearcher,
    TPESearcher,
    TuneConfig,
    Tuner,
)


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=8, device="cpu")
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _trainable(config):
    """Score converges toward `quality`; bad configs plateau low."""
    score = 0.0
    for i in range(12):
        score = score + (config["quality"] - score) * 0.5
        tune.report({"score": score})
    return {"score": score}


def test_hyperband_finds_best_and_prunes(cluster):
    tuner = Tuner(
        _trainable,
        param_space={"quality": tune.grid_search([0.1, 0.3, 0.5, 0.7, 1.0])},
        tune_config=TuneConfig(
            metric="score", mode="max", num_samples=1,
            scheduler=HyperBandScheduler(metric="score", mode="max", max_t=12),
        ),
        resources_per_trial={"CPU": 1.0},
    )
    grid = tuner.fit()
    best = grid.get_best_result()
    assert best.config["quality"] == 1.0
    assert any(r.stopped_early for r in grid.results)


def test_median_stopping(cluster):
    tuner = Tuner(
        _trainable,
        param_space={"quality": tune.grid_search([0.05, 0.1, 0.9, 0.95, 1.0])},
        tune_config=TuneConfig(
            metric="score", mode="max",
            scheduler=MedianStoppingRule(metric="score", mode="max",
                                         grace_period=3),
        ),
    )
    grid = tuner.fit()
    assert grid.get_best_result().config["quality"] == 1.0


def _pbt_trainable(config):
    """Linear progress whose rate is the (mutable) lr; checkpoints carry
    accumulated progress across exploits."""
    ckpt = config.get("__checkpoint__") or {"progress": 0.0}
    progress = ckpt["progress"]
    for i in range(12):
        progress += config["lr"]
        tune.report({"score": progress}, checkpoint={"progress": progress})
    return {"score": progress}


def test_pbt_exploits_good_configs(cluster):
    pbt = PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=4,
        hyperparam_mutations={"lr": (0.001, 1.0)}, seed=1)
    tuner = Tuner(
        _pbt_trainable,
        param_space={"lr": tune.grid_search([0.001, 0.002, 0.5, 1.0])},
        tune_config=TuneConfig(metric="score", mode="max", scheduler=pbt,
                               max_concurrent_trials=4),
    )
    grid = tuner.fit()
    # every surviving trial should end far better than the worst seed
    # configs could reach alone (0.001 * 12 = 0.012)
    best = grid.get_best_result()
    assert float(best.metrics["score"]) > 1.0
    # at least one exploit happened: some trial ran with a config not in
    # the original grid (mutated by 0.8x/1.2x)
    seen = {r.config["lr"] for r in grid.results}
    assert any(lr not in (0.001, 0.002, 0.5, 1.0) for lr in seen) or \
        any("__checkpoint__" in r.config for r in grid.results)


def test_quasi_random_searcher(cluster):
    searcher = QuasiRandomSearcher(
        {"quality": tune.uniform(0.0, 1.0)}, num_samples=6)
    tuner = Tuner(
        _trainable,
        param_space={},
        tune_config=TuneConfig(metric="score", mode="max",
                               search_alg=searcher),
    )
    grid = tuner.fit()
    assert len(grid) == 6
    qs = [r.config["quality"] for r in grid.results]
    assert len(set(round(q, 6) for q in qs)) == 6  # spread, not repeated


def test_tpe_searcher_improves_over_warmup(cluster):
    searcher = TPESearcher(
        {"quality": tune.uniform(0.0, 1.0)}, num_samples=12,
        metric="score", mode="max", n_warmup=4, seed=3)
    tuner = Tuner(
        _trainable,
        param_space={},
        tune_config=TuneConfig(metric="score", mode="max",
                               search_alg=searcher, max_concurrent_trials=2),
    )
    grid = tuner.fit()
    assert len(grid) == 12
    # results complete out of order: sort by suggestion order (trial id)
    ordered = sorted((r for r in grid.results if r.error is None),
                     key=lambda r: r.trial_id)
    scores = [float(r.metrics["score"]) for r in ordered]
    assert len(scores) >= 10
    warmup_avg = sum(scores[:4]) / 4
    later = scores[6:]
    later_avg = sum(later) / len(later)
    assert later_avg >= warmup_avg * 0.8  # guided phase shouldn't collapse
