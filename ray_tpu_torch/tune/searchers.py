"""Search algorithms that propose configs sequentially.

Reference: python/ray/tune/search — the Searcher interface
(search/searcher.py: suggest / on_trial_complete) with concrete
dependency-free implementations standing in for the optuna/hyperopt
integrations: a quasi-random low-discrepancy sampler and a TPE-style
good/bad density searcher.

The port of ``ray_tpu/tune/searchers.py``: with the same seed, each
searcher proposes the configs the JAX package's proposes.
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.tune.search import GridSearch, Sampler


class Searcher:
    """suggest() -> config (or None when exhausted); observe completions."""

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str, result: Dict[str, Any]):
        pass


class BasicVariantSearcher(Searcher):
    """Random/grid sampling of the param space (the default)."""

    def __init__(self, param_space: Dict[str, Any], num_samples: int,
                 seed: int = 0):
        from ray_tpu_torch.tune.search import generate_variants

        self._variants = generate_variants(param_space, num_samples, seed)
        self._i = 0

    def suggest(self, trial_id: str):
        if self._i >= len(self._variants):
            return None
        cfg = self._variants[self._i]
        self._i += 1
        return cfg


class QuasiRandomSearcher(Searcher):
    """Halton-sequence sampling over continuous dims: better coverage than
    iid uniform for small budgets (stands in for ax/skopt sobol)."""

    PRIMES = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29]

    def __init__(self, param_space: Dict[str, Any], num_samples: int,
                 seed: int = 0):
        self.space = param_space
        self.num_samples = num_samples
        self._rng = random.Random(seed)
        self._i = 0

    @staticmethod
    def _halton(index: int, base: int) -> float:
        f, r = 1.0, 0.0
        i = index + 1
        while i > 0:
            f /= base
            r += f * (i % base)
            i //= base
        return r

    def suggest(self, trial_id: str):
        if self._i >= self.num_samples:
            return None
        cfg: Dict[str, Any] = {}
        dim = 0
        for key, spec in self.space.items():
            if isinstance(spec, GridSearch):
                cfg[key] = spec.values[self._i % len(spec.values)]
            elif isinstance(spec, Sampler):
                u = self._halton(self._i, self.PRIMES[dim % len(self.PRIMES)])
                dim += 1
                if spec.ppf is not None:
                    # inverse-CDF keeps the low-discrepancy stratification
                    cfg[key] = spec.ppf(u)
                else:
                    cfg[key] = spec.sample(random.Random(int(u * 1e9)))
            else:
                cfg[key] = spec
        self._i += 1
        return cfg


class TPESearcher(Searcher):
    """Tree-structured-Parzen-style: after warmup, sample candidates and
    keep the one most preferred by the good/bad observation split
    (reference role: tune's optuna TPE integration)."""

    def __init__(self, param_space: Dict[str, Any], num_samples: int,
                 metric: str = "score", mode: str = "max",
                 n_warmup: int = 4, gamma: float = 0.33,
                 n_candidates: int = 16, seed: int = 0):
        self.space = param_space
        self.num_samples = num_samples
        self.metric = metric
        self.mode = mode
        self.n_warmup = n_warmup
        self.gamma = gamma
        self.n_candidates = n_candidates
        self._rng = random.Random(seed)
        self._i = 0
        self._observations: List[Tuple[Dict, float]] = []

    def _draw(self) -> Dict[str, Any]:
        cfg = {}
        for key, spec in self.space.items():
            if isinstance(spec, GridSearch):
                cfg[key] = self._rng.choice(spec.values)
            elif isinstance(spec, Sampler):
                cfg[key] = spec.sample(self._rng)
            else:
                cfg[key] = spec
        return cfg

    def _score_candidate(self, cfg: Dict, good: List[Dict],
                         bad: List[Dict]) -> float:
        """log(p_good / p_bad) with Gaussian kernels over numeric dims and
        match counts over categorical dims."""

        def density(points: List[Dict]) -> float:
            if not points:
                return 1e-9
            total = 0.0
            for p in points:
                sim = 1.0
                for k, v in cfg.items():
                    pv = p.get(k)
                    if isinstance(v, (int, float)) and isinstance(pv, (int, float)):
                        scale = abs(pv) * 0.3 + 1e-3
                        sim *= math.exp(-((v - pv) ** 2) / (2 * scale ** 2))
                    else:
                        sim *= 1.0 if v == pv else 0.1
                total += sim
            return total / len(points) + 1e-12

        return math.log(density(good) / density(bad))

    def suggest(self, trial_id: str):
        if self._i >= self.num_samples:
            return None
        self._i += 1
        if len(self._observations) < self.n_warmup:
            return self._draw()
        obs = sorted(self._observations, key=lambda o: -o[1])
        n_good = max(1, int(len(obs) * self.gamma))
        good = [c for c, _ in obs[:n_good]]
        bad = [c for c, _ in obs[n_good:]] or good
        cands = [self._draw() for _ in range(self.n_candidates)]
        return max(cands, key=lambda c: self._score_candidate(c, good, bad))

    def on_trial_complete(self, trial_id: str, result: Dict[str, Any]):
        value = result.get(self.metric)
        if value is None:
            return
        value = float(value)
        if self.mode == "min":
            value = -value
        config = result.get("__config__", {})
        self._observations.append((config, value))
