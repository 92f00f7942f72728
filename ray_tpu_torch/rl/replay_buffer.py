"""Replay buffers: the port of ``ray_tpu/rl/replay_buffer.py`` (reference:
rllib/utils/replay_buffers/).

Uniform transition buffer + proportional prioritized variant (sum-tree).
Buffers are host-side numpy ring buffers: the card only sees the sampled
minibatch, which keeps its memory free for the learner and makes sampling
O(1) per item regardless of capacity. The draws are numpy's, as in the JAX
package, so the same seed gives the same indices.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class ReplayBuffer:
    """Uniform FIFO transition buffer over named arrays."""

    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = int(capacity)
        self._storage: Dict[str, np.ndarray] = {}
        self._next = 0
        self._size = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def add_batch(self, batch: Dict[str, np.ndarray]) -> None:
        n = len(next(iter(batch.values())))
        if not self._storage:
            for k, v in batch.items():
                v = np.asarray(v)
                self._storage[k] = np.zeros((self.capacity,) + v.shape[1:],
                                            v.dtype)
        idx = (self._next + np.arange(n)) % self.capacity
        for k, v in batch.items():
            self._storage[k][idx] = v
        self._next = int((self._next + n) % self.capacity)
        self._size = min(self._size + n, self.capacity)

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, self._size, size=batch_size)
        return {k: v[idx] for k, v in self._storage.items()}

    def state(self) -> dict:
        return {"storage": {k: v[: self._size].copy()
                            for k, v in self._storage.items()},
                "next": self._next, "size": self._size}

    def set_state(self, state: dict) -> None:
        self._storage = {}
        for k, v in state["storage"].items():
            arr = np.zeros((self.capacity,) + v.shape[1:], v.dtype)
            arr[: len(v)] = v
            self._storage[k] = arr
        self._next = state["next"]
        self._size = state["size"]


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritization (PER) via a flat sum-tree.

    Reference: rllib/utils/replay_buffers/prioritized_episode_buffer.py.
    ``sample`` also returns ``weights`` (importance corrections) and ``idx``
    for ``update_priorities`` after the TD errors are known.
    """

    def __init__(self, capacity: int, alpha: float = 0.6, beta: float = 0.4,
                 seed: int = 0):
        super().__init__(capacity, seed)
        self.alpha = alpha
        self.beta = beta
        # binary-heap-layout sum tree: leaves at [capacity, 2*capacity)
        self._tree = np.zeros(2 * self.capacity, np.float64)
        self._max_prio = 1.0

    def _set_prio(self, idx: np.ndarray, prio: np.ndarray) -> None:
        pos = np.asarray(idx) + self.capacity
        self._tree[pos] = prio
        pos = np.unique(pos // 2)
        while pos.size and pos[0] >= 1:
            self._tree[pos] = self._tree[2 * pos] + self._tree[2 * pos + 1]
            pos = np.unique(pos // 2)
            pos = pos[pos >= 1]

    def add_batch(self, batch: Dict[str, np.ndarray]) -> None:
        n = len(next(iter(batch.values())))
        idx = (self._next + np.arange(n)) % self.capacity
        super().add_batch(batch)
        self._set_prio(idx, np.full(n, self._max_prio ** self.alpha))

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        total = self._tree[1]
        targets = self._rng.uniform(0, total, size=batch_size)
        idx = np.empty(batch_size, np.int64)
        for i, t in enumerate(targets):
            pos = 1
            while pos < self.capacity:
                left = 2 * pos
                if t <= self._tree[left]:
                    pos = left
                else:
                    t -= self._tree[left]
                    pos = left + 1
            idx[i] = pos - self.capacity
        idx = np.minimum(idx, max(self._size - 1, 0))
        probs = self._tree[idx + self.capacity] / max(total, 1e-12)
        weights = (self._size * probs + 1e-12) ** (-self.beta)
        weights /= weights.max() + 1e-12
        out = {k: v[idx] for k, v in self._storage.items()}
        out["weights"] = weights.astype(np.float32)
        out["idx"] = idx
        return out

    def update_priorities(self, idx: np.ndarray, td_errors: np.ndarray) -> None:
        prio = (np.abs(td_errors) + 1e-6)
        self._max_prio = max(self._max_prio, float(prio.max()))
        self._set_prio(np.asarray(idx), prio ** self.alpha)

    def state(self) -> dict:
        d = super().state()
        d["prios"] = self._tree[self.capacity: self.capacity + self._size].copy()
        d["max_prio"] = self._max_prio
        return d

    def set_state(self, state: dict) -> None:
        super().set_state(state)
        self._tree[:] = 0.0
        if state["size"]:
            self._set_prio(np.arange(state["size"]), state["prios"])
        self._max_prio = state["max_prio"]
