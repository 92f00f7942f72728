"""Trial schedulers: FIFO, ASHA, HyperBand, median stopping, PBT.

Reference: python/ray/tune/schedulers — async_hyperband.py (ASHA),
hyperband.py, median_stopping_rule.py, pbt.py. Schedulers see every
``tune.report`` through the central report hub and answer CONTINUE/STOP
(PBT may instead answer with an EXPLOIT directive carrying a new config +
checkpoint, which restarts the trial from the better trial's state).

The port of ``ray_tpu/tune/schedulers.py``: the same decisions for the
same report stream.
"""

from __future__ import annotations

import math
import random
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Tuple

CONTINUE = "CONTINUE"
STOP = "STOP"
EXPLOIT = "EXPLOIT"


class FIFOScheduler:
    def on_result(self, trial_id: str, metrics: Dict) -> str:
        return CONTINUE


class ASHAScheduler:
    """Async successive halving (reference: async_hyperband.py): rungs at
    grace_period * reduction_factor^k; a trial reaching a rung stops unless
    its metric is in the top 1/reduction_factor recorded at that rung."""

    def __init__(self, metric: str = "score", mode: str = "max",
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: int = 3, time_attr: str = "training_iteration"):
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.grace_period = grace_period
        self.rf = reduction_factor
        self.time_attr = time_attr
        self.rungs: List[int] = []
        t = grace_period
        while t < max_t:
            self.rungs.append(t)
            t *= reduction_factor
        self.rung_results: Dict[int, List[float]] = defaultdict(list)

    def on_result(self, trial_id: str, metrics: Dict) -> str:
        t = int(metrics.get(self.time_attr, 0))
        value = metrics.get(self.metric)
        if value is None:
            return CONTINUE
        value = float(value)
        if self.mode == "min":
            value = -value
        if t >= self.max_t:
            return STOP
        for rung in self.rungs:
            if t == rung:
                results = self.rung_results[rung]
                results.append(value)
                if len(results) < self.rf:
                    return CONTINUE  # not enough data; optimistic continue
                cutoff_idx = max(0, math.ceil(len(results) / self.rf) - 1)
                cutoff = sorted(results, reverse=True)[cutoff_idx]
                return CONTINUE if value >= cutoff else STOP
        return CONTINUE


class HyperBandScheduler:
    """Multiple successive-halving brackets with different exploration/
    exploitation tradeoffs (reference: tune/schedulers/hyperband.py, run
    here in the async style: each bracket is an ASHA instance and trials
    are spread across brackets round-robin)."""

    def __init__(self, metric: str = "score", mode: str = "max",
                 max_t: int = 100, reduction_factor: int = 3,
                 time_attr: str = "training_iteration"):
        self.metric = metric
        self.mode = mode
        rf = reduction_factor
        graces = []
        g = 1
        while g * rf <= max_t:  # integer loop: no float-log truncation
            graces.append(g)
            g *= rf
        self._brackets = [
            ASHAScheduler(metric=metric, mode=mode, max_t=max_t,
                          grace_period=grace, reduction_factor=rf,
                          time_attr=time_attr)
            for grace in (graces or [1])
        ]
        self._assignment: Dict[str, int] = {}
        self._next = 0

    def on_result(self, trial_id: str, metrics: Dict) -> str:
        idx = self._assignment.get(trial_id)
        if idx is None:
            idx = self._assignment[trial_id] = self._next % len(self._brackets)
            self._next += 1
        return self._brackets[idx].on_result(trial_id, metrics)


class MedianStoppingRule:
    """Stop a trial whose best result so far is worse than the median of
    the other trials' running averages (reference:
    tune/schedulers/median_stopping_rule.py)."""

    def __init__(self, metric: str = "score", mode: str = "max",
                 grace_period: int = 3, min_samples_required: int = 3,
                 time_attr: str = "training_iteration"):
        self.metric = metric
        self.mode = mode
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        self.time_attr = time_attr
        self._history: Dict[str, List[float]] = defaultdict(list)

    def on_result(self, trial_id: str, metrics: Dict) -> str:
        value = metrics.get(self.metric)
        if value is None:
            return CONTINUE
        value = float(value)
        if self.mode == "min":
            value = -value
        self._history[trial_id].append(value)
        t = int(metrics.get(self.time_attr, len(self._history[trial_id])))
        if t < self.grace_period:
            return CONTINUE
        others = [vals for tid, vals in self._history.items()
                  if tid != trial_id and vals]
        if len(others) < self.min_samples:
            return CONTINUE
        running_avgs = [sum(vals) / len(vals) for vals in others]
        median = sorted(running_avgs)[len(running_avgs) // 2]
        best = max(self._history[trial_id])
        return STOP if best < median else CONTINUE


class PopulationBasedTraining:
    """PBT (reference: tune/schedulers/pbt.py): every
    ``perturbation_interval`` iterations, trials in the bottom quantile
    clone the checkpoint of a random top-quantile trial and continue with
    perturbed hyperparameters. Requires trials to pass ``checkpoint=`` to
    ``tune.report`` and to restore from ``config["__checkpoint__"]``."""

    def __init__(self, metric: str = "score", mode: str = "max",
                 perturbation_interval: int = 4,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25, seed: int = 0,
                 time_attr: str = "training_iteration",
                 synch: bool = True):
        self.metric = metric
        self.mode = mode
        self.interval = perturbation_interval
        # synchronized PBT (reference: pbt.py synch=True): trials rendezvous
        # at perturbation boundaries so exploit decisions always see the
        # whole population — without it, fast trials finish before slow
        # ones even start and no exploit can ever fire. Deviation from the
        # reference: synch defaults ON (the deterministic mode).
        self.synch_interval = perturbation_interval if synch else None
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.time_attr = time_attr
        self._rng = random.Random(seed)
        # populated via the report hub
        self._scores: Dict[str, float] = {}
        self._configs: Dict[str, Dict] = {}
        self._checkpoints: Dict[str, Any] = {}

    # hub integration points -------------------------------------------

    def register_trial(self, trial_id: str, config: Dict):
        config = {k: v for k, v in config.items() if k != "__checkpoint__"}
        self._configs[trial_id] = config

    def record_checkpoint(self, trial_id: str, checkpoint: Any):
        self._checkpoints[trial_id] = checkpoint

    # -------------------------------------------------------------------

    def _mutate(self, config: Dict) -> Dict:
        out = dict(config)
        for key, spec in self.mutations.items():
            if key not in out:
                continue
            if isinstance(spec, list):
                out[key] = self._rng.choice(spec)
            elif isinstance(spec, tuple) and len(spec) == 2:
                lo, hi = spec
                # standard PBT perturbation: scale by 0.8 or 1.2, clamped
                factor = self._rng.choice([0.8, 1.2])
                out[key] = min(hi, max(lo, out[key] * factor))
            elif callable(spec):
                out[key] = spec()
        return out

    def on_result(self, trial_id: str, metrics: Dict):
        value = metrics.get(self.metric)
        if value is None:
            return CONTINUE
        value = float(value)
        if self.mode == "min":
            value = -value
        self._scores[trial_id] = value
        t = int(metrics.get(self.time_attr, 0))
        if t == 0 or t % self.interval != 0:
            return CONTINUE
        ranked = sorted(self._scores.items(), key=lambda kv: kv[1])
        n = len(ranked)
        if n < 3:
            return CONTINUE
        k = max(1, int(n * self.quantile))
        bottom = {tid for tid, _ in ranked[:k]}
        top = [tid for tid, _ in ranked[-k:]
               if tid != trial_id and tid in self._checkpoints]
        if trial_id in bottom and top:
            donor = self._rng.choice(top)
            new_config = self._mutate(self._configs.get(donor, {}))
            self._configs[trial_id] = dict(new_config)
            return (EXPLOIT, {"config": new_config,
                              "checkpoint": self._checkpoints[donor]})
        return CONTINUE
