"""Shared vector-env plumbing for env-runner actors: the port of
``ray_tpu/rl/env_runner.py``.

One place for the autoreset semantics so every algorithm gets them right:

- SAME_STEP autoreset: the obs returned at a done step is the NEXT
  episode's reset obs; the true terminal obs is in ``infos["final_obs"]``.
  ``true_next_obs`` recovers it so TD targets bootstrap from the state that
  was actually reached.
- ``term`` vs ``trunc``: only true termination should zero the bootstrap;
  truncation (time limits) should bootstrap from V(final_obs).

The environments are the port's own numpy copies (``envs.py``); a name it
does not hold goes to gymnasium.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ray_tpu_torch.rl import envs


def make_vec_env(env_name: str, num_envs: int, seed: int):
    """A SAME_STEP ``SyncVectorEnv`` of ``num_envs`` copies of the env,
    reset with env ``i`` seeded ``seed + i``; returns (envs, first obs)."""
    vec = envs.SyncVectorEnv([lambda: envs.make(env_name)
                              for _ in range(num_envs)])
    obs, _ = vec.reset(seed=seed)
    return vec, obs


def true_next_obs(step_obs: np.ndarray, done: np.ndarray, info: dict
                  ) -> np.ndarray:
    """Next-state observations for TD targets: where an episode just ended,
    substitute the terminal obs recorded in info for the reset obs."""
    finals = info.get("final_obs", info.get("final_observation"))
    if finals is None or not np.any(done):
        return step_obs
    out = np.array(step_obs, copy=True)
    for i in np.nonzero(done)[0]:
        if finals[i] is not None:
            out[i] = finals[i]
    return out


class WeightSync:
    """Env-runner-side weight subscription over the weight plane.

    An env-runner constructs one of these next to its policy and calls
    :meth:`poll` between rollouts: if the learner published a newer version
    to the store, ``apply_fn(tree)`` installs it and the new version number
    is returned (None otherwise). Versions are monotonic: a runner never
    regresses to older weights.
    """

    def __init__(self, store_name: str, apply_fn=None, start_after: int = -1):
        from ray_tpu_torch.weights import WeightStore

        self._store = WeightStore(store_name)
        self._sub = self._store.subscribe(start_after=start_after)
        self._apply = apply_fn
        self.weights = None
        self.version = start_after

    def poll(self, timeout: float = 0.0) -> Optional[int]:
        """Install the newest published weights if any. ``timeout`` > 0
        long-polls the store (blocking wait for the next publish)."""
        out = self._sub.poll(timeout=timeout)
        if out is None:
            return None
        version, tree = out
        assert version > self.version, (version, self.version)
        self.version = version
        if self._apply is not None:
            self._apply(tree)
        else:
            self.weights = tree
        return version


class EpisodeTracker:
    """Accumulates per-env returns; pops finished-episode returns."""

    def __init__(self, num_envs: int):
        self._acc = np.zeros(num_envs)
        self._finished: List[float] = []

    def step(self, rewards: np.ndarray, done: np.ndarray) -> None:
        self._acc += rewards
        for i in np.nonzero(done)[0]:
            self._finished.append(float(self._acc[i]))
            self._acc[i] = 0.0

    def pop(self) -> np.ndarray:
        out, self._finished = self._finished, []
        return np.asarray(out, np.float32)
