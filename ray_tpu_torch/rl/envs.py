"""The environments the RL library names, in numpy: a stand-in for the parts
of gymnasium that ``env_runner.make_vec_env`` uses.

The JAX package steps gymnasium's ``CartPole-v1`` (the default of
``algorithm.py`` and ``offline.py``) and ``Pendulum-v1`` (``sac.py``) in a
``SyncVectorEnv`` with SAME_STEP autoreset. The card's machine has no
gymnasium, so the port keeps its own copy of those two environments (the
dynamics, rewards, termination, and the ``TimeLimit`` of 500 and 200
steps), of their spaces as far as the algorithms read them
(``Discrete.n``; ``Box.shape``, ``.low`` and ``.high``), of gymnasium's
seeding (a PCG64 generator over ``SeedSequence(seed)``; env ``i`` of a
vector seeded ``seed + i``), and of the vector wrapper: at a done step the
observation returned is the next episode's reset observation, and the
terminal one is in ``infos["final_obs"]`` (an object array, ``None`` where
the env is not done). Same seeds and actions give gymnasium's observations
and rewards bit for bit.

``make`` of any other name imports gymnasium when called, and raises an
``ImportError`` naming the environment where it is missing.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np


def np_random(seed: Optional[int] = None) -> np.random.Generator:
    """gymnasium's ``utils.seeding.np_random``: a PCG64 generator over
    ``SeedSequence(seed)`` (fresh entropy where ``seed`` is None)."""
    if seed is not None and not (isinstance(seed, int) and seed >= 0):
        raise ValueError(f"seed must be a non-negative int, not {seed!r}")
    return np.random.Generator(np.random.PCG64(np.random.SeedSequence(seed)))


class Discrete:
    """The actions ``0 .. n - 1``."""

    def __init__(self, n: int):
        self.n = int(n)
        self.shape = ()
        self.dtype = np.dtype(np.int64)

    def contains(self, x) -> bool:
        if isinstance(x, (int, np.integer)) or (
                isinstance(x, np.ndarray) and x.shape == ()
                and np.issubdtype(x.dtype, np.integer)):
            return 0 <= int(x) < self.n
        return False

    def __repr__(self) -> str:
        return f"Discrete({self.n})"


class Box:
    """A box of ``shape`` between ``low`` and ``high`` (each broadcast to
    the shape and cast to ``dtype``)."""

    def __init__(self, low, high, shape: Optional[Sequence[int]] = None,
                 dtype=np.float32):
        self.dtype = np.dtype(dtype)
        if shape is None:
            shape = np.shape(low) if np.ndim(low) else np.shape(high)
        self.shape = tuple(int(s) for s in shape)
        self.low = np.full(self.shape, low, self.dtype)
        self.high = np.full(self.shape, high, self.dtype)

    def __repr__(self) -> str:
        return f"Box({self.low}, {self.high}, {self.shape}, {self.dtype})"


class Env:
    """gymnasium's ``Env`` as far as seeding goes: ``reset(seed=s)`` makes
    a new generator, ``reset()`` goes on with the one it has."""

    observation_space: Any = None
    action_space: Any = None
    _np_random: Optional[np.random.Generator] = None

    @property
    def np_random(self) -> np.random.Generator:
        if self._np_random is None:
            self._np_random = np_random(None)
        return self._np_random

    def reset(self, *, seed: Optional[int] = None,
              options: Optional[dict] = None):
        if seed is not None:
            self._np_random = np_random(seed)

    def close(self) -> None:
        pass


class CartPoleEnv(Env):
    """gymnasium's ``envs/classic_control/cartpole.py`` (Barto, Sutton and
    Anderson's cart-pole, Euler integration): reward 1 a step, the
    termination step included; terminated when the pole leans past 12
    degrees or the cart leaves +-2.4."""

    def __init__(self):
        self.gravity = 9.8
        self.masscart = 1.0
        self.masspole = 0.1
        self.total_mass = self.masspole + self.masscart
        self.length = 0.5  # half the pole's length
        self.polemass_length = self.masspole * self.length
        self.force_mag = 10.0
        self.tau = 0.02  # seconds between state updates
        self.theta_threshold_radians = 12 * 2 * math.pi / 360
        self.x_threshold = 2.4
        high = np.array([self.x_threshold * 2, np.inf,
                         self.theta_threshold_radians * 2, np.inf],
                        dtype=np.float32)
        self.action_space = Discrete(2)
        self.observation_space = Box(-high, high, dtype=np.float32)
        self.state: Optional[np.ndarray] = None
        self.steps_beyond_terminated: Optional[int] = None

    def step(self, action):
        if not self.action_space.contains(action):
            raise ValueError(f"{action!r} ({type(action)}) invalid")
        if self.state is None:
            raise RuntimeError("call reset before step")
        x, x_dot, theta, theta_dot = self.state
        force = self.force_mag if action == 1 else -self.force_mag
        costheta = np.cos(theta)
        sintheta = np.sin(theta)
        temp = (force + self.polemass_length * np.square(theta_dot)
                * sintheta) / self.total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * np.square(costheta)
                           / self.total_mass))
        xacc = temp - self.polemass_length * thetaacc * costheta \
            / self.total_mass
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        self.state = np.array((x, x_dot, theta, theta_dot), dtype=np.float64)
        terminated = bool(x < -self.x_threshold or x > self.x_threshold
                          or theta < -self.theta_threshold_radians
                          or theta > self.theta_threshold_radians)
        if not terminated:
            reward = 1.0
        elif self.steps_beyond_terminated is None:
            self.steps_beyond_terminated = 0
            reward = 1.0
        else:
            self.steps_beyond_terminated += 1
            reward = 0.0
        return np.array(self.state, dtype=np.float32), reward, terminated, \
            False, {}

    def reset(self, *, seed: Optional[int] = None,
              options: Optional[dict] = None):
        super().reset(seed=seed)
        low, high = -0.05, 0.05
        if options is not None:
            low = float(options.get("low", low))
            high = float(options.get("high", high))
        self.state = self.np_random.uniform(low=low, high=high, size=(4,))
        self.steps_beyond_terminated = None
        return np.array(self.state, dtype=np.float32), {}


class PendulumEnv(Env):
    """gymnasium's ``envs/classic_control/pendulum.py``: torque in [-2, 2],
    cost theta^2 + 0.1 theta_dot^2 + 0.001 u^2 (theta normalised to
    [-pi, pi)), never terminated."""

    def __init__(self, g: float = 10.0):
        self.max_speed = 8
        self.max_torque = 2.0
        self.dt = 0.05
        self.g = g
        self.m = 1.0
        self.l = 1.0  # noqa: E741
        high = np.array([1.0, 1.0, self.max_speed], dtype=np.float32)
        self.action_space = Box(low=-self.max_torque, high=self.max_torque,
                                shape=(1,), dtype=np.float32)
        self.observation_space = Box(low=-high, high=high, dtype=np.float32)
        self.state: Optional[np.ndarray] = None
        self.last_u = None

    def step(self, u):
        th, thdot = self.state
        g, m, l, dt = self.g, self.m, self.l, self.dt  # noqa: E741
        u = np.clip(u, -self.max_torque, self.max_torque)[0]
        self.last_u = u
        costs = _angle_normalize(th) ** 2 + 0.1 * thdot ** 2 + 0.001 * (u ** 2)
        newthdot = thdot + (3 * g / (2 * l) * np.sin(th)
                            + 3.0 / (m * l ** 2) * u) * dt
        newthdot = np.clip(newthdot, -self.max_speed, self.max_speed)
        newth = th + newthdot * dt
        self.state = np.array([newth, newthdot])
        return self._get_obs(), -costs, False, False, {}

    def reset(self, *, seed: Optional[int] = None,
              options: Optional[dict] = None):
        super().reset(seed=seed)
        x, y = np.pi, 1.0
        if options is not None:
            x = float(options.get("x_init", x))
            y = float(options.get("y_init", y))
        high = np.array([x, y])
        self.state = self.np_random.uniform(low=-high, high=high)
        self.last_u = None
        return self._get_obs(), {}

    def _get_obs(self):
        theta, thetadot = self.state
        return np.array([np.cos(theta), np.sin(theta), thetadot],
                        dtype=np.float32)


def _angle_normalize(x):
    return ((x + np.pi) % (2 * np.pi)) - np.pi


class TimeLimit:
    """gymnasium's ``TimeLimit`` wrapper: truncated once an episode has
    taken ``max_episode_steps`` steps."""

    def __init__(self, env: Env, max_episode_steps: int):
        self.env = env
        self.max_episode_steps = max_episode_steps
        self._elapsed_steps: Optional[int] = None

    @property
    def observation_space(self):
        return self.env.observation_space

    @property
    def action_space(self):
        return self.env.action_space

    @property
    def unwrapped(self) -> Env:
        return self.env

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self._elapsed_steps += 1
        if self._elapsed_steps >= self.max_episode_steps:
            truncated = True
        return obs, reward, terminated, truncated, info

    def reset(self, *, seed: Optional[int] = None,
              options: Optional[dict] = None):
        self._elapsed_steps = 0
        return self.env.reset(seed=seed, options=options)

    def close(self) -> None:
        self.env.close()


# name -> (constructor, the registration's max_episode_steps)
REGISTRY: Dict[str, tuple] = {
    "CartPole-v1": (CartPoleEnv, 500),
    "Pendulum-v1": (PendulumEnv, 200),
}


def make(name: str, **kwargs):
    """The named environment behind its time limit, as ``gymnasium.make``
    builds it. A name the port does not hold goes to gymnasium, imported
    here; without gymnasium that raises an ``ImportError`` naming it."""
    if name in REGISTRY:
        ctor, steps = REGISTRY[name]
        return TimeLimit(ctor(**kwargs), steps)
    try:
        import gymnasium
    except ImportError as e:
        raise ImportError(
            f"environment {name!r} is not one of the port's own "
            f"({', '.join(sorted(REGISTRY))}); it needs gymnasium, which is "
            f"not installed") from e
    return gymnasium.make(name, **kwargs)


class SyncVectorEnv:
    """gymnasium's ``SyncVectorEnv`` with ``AutoresetMode.SAME_STEP``, over
    environments with gymnasium's API: ``reset`` seeds env ``i`` with
    ``seed + i``; ``step`` steps each env in turn and, where one is done,
    records its terminal observation in ``infos["final_obs"]`` (an object
    array, ``None`` elsewhere, with the mask ``infos["_final_obs"]``) and
    its ``info`` in ``infos["final_info"]``, then resets it (on its own
    generator) and returns the reset observation in its row."""

    def __init__(self, env_fns: Sequence[Callable[[], Any]]):
        self.envs: List[Any] = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        self.single_observation_space = self.envs[0].observation_space
        self.single_action_space = self.envs[0].action_space
        space = self.single_observation_space
        self._observations = np.zeros((self.num_envs,) + tuple(space.shape),
                                      dtype=space.dtype)
        self._rewards = np.zeros((self.num_envs,), dtype=np.float64)
        self._terminations = np.zeros((self.num_envs,), dtype=np.bool_)
        self._truncations = np.zeros((self.num_envs,), dtype=np.bool_)

    def reset(self, *, seed=None, options: Optional[dict] = None):
        if seed is None:
            seed = [None] * self.num_envs
        elif isinstance(seed, int):
            seed = [seed + i for i in range(self.num_envs)]
        if len(seed) != self.num_envs:
            raise ValueError(f"{len(seed)} seeds for {self.num_envs} envs")
        self._terminations[:] = False
        self._truncations[:] = False
        infos: Dict[str, Any] = {}
        for i, (env, s) in enumerate(zip(self.envs, seed)):
            self._observations[i], info = env.reset(seed=s, options=options)
            infos = self._add_info(infos, info, i)
        return self._observations.copy(), infos

    def step(self, actions):
        infos: Dict[str, Any] = {}
        for i, env in enumerate(self.envs):
            (obs, self._rewards[i], self._terminations[i],
             self._truncations[i], info) = env.step(actions[i])
            if self._terminations[i] or self._truncations[i]:
                infos = self._add_info(
                    infos, {"final_obs": obs, "final_info": info}, i)
                obs, info = env.reset()
            self._observations[i] = obs
            infos = self._add_info(infos, info, i)
        return (self._observations.copy(), np.copy(self._rewards),
                np.copy(self._terminations), np.copy(self._truncations),
                infos)

    def _add_info(self, infos: Dict[str, Any], info: Dict[str, Any],
                  i: int) -> Dict[str, Any]:
        """gymnasium's ``VectorEnv._add_info``: each key's values in an
        array over the envs, beside a ``_key`` mask of the envs that set
        it; ``final_obs`` in an object array, nested dicts recursively."""
        for key, value in info.items():
            if key == "final_obs":
                array = infos.get(key)
                if array is None:
                    array = np.full(self.num_envs, None, dtype=object)
                array[i] = value
            elif isinstance(value, dict):
                array = self._add_info(infos.get(key, {}), value, i)
            else:
                array = infos.get(key)
                if array is None:
                    if type(value) in (int, float, bool) or issubclass(
                            type(value), np.number):
                        array = np.zeros(self.num_envs, dtype=type(value))
                    elif isinstance(value, np.ndarray):
                        array = np.zeros((self.num_envs,) + value.shape,
                                         dtype=value.dtype)
                    else:
                        array = np.full(self.num_envs, None, dtype=object)
                array[i] = value
            mask = infos.get(f"_{key}")
            if mask is None:
                mask = np.zeros(self.num_envs, dtype=np.bool_)
            mask[i] = True
            infos[key], infos[f"_{key}"] = array, mask
        return infos

    def close(self) -> None:
        for env in self.envs:
            env.close()
