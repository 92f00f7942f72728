"""Search space primitives + variant generation.

Reference: python/ray/tune/search (basic_variant grid/random sampling).

The port of ``ray_tpu/tune/search.py``, the same functions.
"""

from __future__ import annotations

import itertools
import random
from dataclasses import dataclass
from typing import Any, Callable, Dict, List


@dataclass
class GridSearch:
    values: List[Any]


@dataclass
class Sampler:
    sample: Callable[[random.Random], Any]
    # inverse CDF: maps a quantile u in [0,1) to a value (lets quasi-random
    # searchers keep their low-discrepancy stratification)
    ppf: Callable[[float], Any] = None


def grid_search(values: List[Any]) -> GridSearch:
    return GridSearch(list(values))


def choice(values: List[Any]) -> Sampler:
    values = list(values)
    return Sampler(lambda rng: rng.choice(values),
                   ppf=lambda u: values[min(int(u * len(values)), len(values) - 1)])


def uniform(low: float, high: float) -> Sampler:
    return Sampler(lambda rng: rng.uniform(low, high),
                   ppf=lambda u: low + u * (high - low))


def loguniform(low: float, high: float) -> Sampler:
    import math

    return Sampler(
        lambda rng: math.exp(rng.uniform(math.log(low), math.log(high))),
        ppf=lambda u: math.exp(math.log(low) + u * (math.log(high) - math.log(low))))


def randint(low: int, high: int) -> Sampler:
    return Sampler(lambda rng: rng.randrange(low, high),
                   ppf=lambda u: min(low + int(u * (high - low)), high - 1))


def generate_variants(param_space: Dict[str, Any], num_samples: int,
                      seed: int = 0) -> List[Dict[str, Any]]:
    """Cross product over grid_search entries x num_samples draws of samplers."""
    rng = random.Random(seed)
    grid_keys = [k for k, v in param_space.items() if isinstance(v, GridSearch)]
    grids = [param_space[k].values for k in grid_keys]
    variants: List[Dict[str, Any]] = []
    combos = list(itertools.product(*grids)) if grid_keys else [()]
    for _ in range(max(num_samples, 1)):
        for combo in combos:
            cfg: Dict[str, Any] = {}
            for k, v in param_space.items():
                if isinstance(v, GridSearch):
                    cfg[k] = combo[grid_keys.index(k)]
                elif isinstance(v, Sampler):
                    cfg[k] = v.sample(rng)
                else:
                    cfg[k] = v
            variants.append(cfg)
    return variants
