"""The port's Tune on its runtime, on the CPU: a mirror of
``tests/test_tune.py`` (reference tier: python/ray/tune/tests basics +
ASHA), each test asserting what its twin asserts."""

import pytest

import ray_tpu_torch
from ray_tpu_torch import tune
from ray_tpu_torch.tune import ASHAScheduler, TuneConfig, Tuner


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, device="cpu")
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_grid_and_random_search(cluster):
    def objective(config):
        score = -(config["x"] - 3) ** 2 + config["bonus"]
        tune.report({"score": score})
        return {"score": score}

    tuner = Tuner(
        objective,
        param_space={
            "x": tune.grid_search([1, 2, 3, 4]),
            "bonus": tune.choice([0.0]),
        },
        tune_config=TuneConfig(metric="score", mode="max", num_samples=1,
                               max_concurrent_trials=3),
    )
    grid = tuner.fit()
    assert len(grid) == 4
    best = grid.get_best_result()
    assert best.config["x"] == 3
    assert best.metrics["score"] == 0.0


def test_trial_error_isolated(cluster):
    def objective(config):
        if config["x"] == 2:
            raise ValueError("bad trial")
        tune.report({"score": config["x"]})
        return {"score": config["x"]}

    grid = Tuner(
        objective,
        param_space={"x": tune.grid_search([1, 2, 3])},
        tune_config=TuneConfig(metric="score", mode="max"),
    ).fit()
    errors = [r for r in grid.results if r.error]
    assert len(errors) == 1
    assert grid.get_best_result().config["x"] == 3


def test_asha_stops_bad_trials(cluster):
    def objective(config):
        for step in range(1, 20):
            score = config["lr"] * step
            tune.report({"score": score, "training_iteration": step})
        return {"score": score}

    grid = Tuner(
        objective,
        param_space={"lr": tune.grid_search([0.01, 0.1, 1.0, 10.0])},
        tune_config=TuneConfig(
            metric="score", mode="max", max_concurrent_trials=2,
            scheduler=ASHAScheduler(metric="score", mode="max", max_t=19,
                                    grace_period=2, reduction_factor=2)),
    ).fit()
    best = grid.get_best_result()
    assert best.config["lr"] == 10.0
    stopped = [r for r in grid.results if r.stopped_early]
    assert stopped  # at least one loser stopped before max_t


def test_result_dataframe(cluster):
    def objective(config):
        tune.report({"score": config["x"]})
        return {"score": config["x"]}

    grid = Tuner(
        objective,
        param_space={"x": tune.grid_search([5, 7])},
        tune_config=TuneConfig(metric="score", mode="max"),
    ).fit()
    df = grid.get_dataframe()
    assert set(df["config/x"]) == {5, 7}
