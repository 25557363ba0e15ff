"""Uniform ring-buffer replay on preallocated NumPy arrays.

The port's own copy of ``d4pg_tpu/replay/uniform.py``, cut to what the
learner uses: columnar float32 storage, O(1) vectorized batched writes,
gather-based sampling, per-slot write generations and the monotone
``total_added`` counter the device-ring mirror diffs against.
Snapshots and uint8 pixel storage wait for ROADMAP A5 and A10.

Transitions carry an explicit per-sample ``discount`` = γ^m·(1−terminal)
so the learner's projection needs no gamma/n plumbing.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import numpy as np


class Transition(NamedTuple):
    """One (possibly n-step-collapsed) transition, or a batch of them."""

    obs: np.ndarray        # s_t
    action: np.ndarray     # a_t
    reward: np.ndarray     # R_t = sum_{k<m} gamma^k r_{t+k}
    next_obs: np.ndarray   # s_{t+m}
    discount: np.ndarray   # gamma^m * (1 - terminal)


class ReplayBuffer:
    """Columnar ring buffer. Single-threaded: the learner loop is the only
    reader and writer."""

    def __init__(self, capacity: int, obs_dim: int, action_dim: int):
        self.capacity = int(capacity)
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.action = np.zeros((capacity, action_dim), np.float32)
        self.reward = np.zeros((capacity,), np.float32)
        self.next_obs = np.zeros((capacity, obs_dim), np.float32)
        self.discount = np.zeros((capacity,), np.float32)
        # Per-slot write generation, bumped on every overwrite, so a
        # priority write-back for a slot recycled since it was sampled is
        # dropped instead of stamping the new transition.
        self._gen = np.zeros((capacity,), np.int64)
        self._pos = 0
        self._size = 0
        # Monotone lifetime write counter (never wraps): the device-ring
        # mirror (replay/device_ring.py) diffs it to find the slots
        # written since its last flush. Write j (0-based) landed at slot
        # j % capacity.
        self._total_added = 0

    def __len__(self) -> int:
        return self._size

    @property
    def total_added(self) -> int:
        """Monotone count of rows ever written (including overwrites)."""
        return self._total_added

    def add_batch(self, t: Transition) -> np.ndarray:
        """Insert a batch of transitions; returns the slot indices written."""
        obs = np.atleast_2d(np.asarray(t.obs, np.float32))
        n = obs.shape[0]
        idx = (self._pos + np.arange(n)) % self.capacity
        self.obs[idx] = obs
        self.action[idx] = np.atleast_2d(np.asarray(t.action, np.float32))
        self.reward[idx] = np.asarray(t.reward, np.float32).reshape(n)
        self.next_obs[idx] = np.atleast_2d(np.asarray(t.next_obs, np.float32))
        self.discount[idx] = np.asarray(t.discount, np.float32).reshape(n)
        self._gen[idx] += 1
        self._pos = int((self._pos + n) % self.capacity)
        self._size = int(min(self._size + n, self.capacity))
        self._total_added += n
        return idx

    def gather(self, idx: np.ndarray) -> Mapping[str, np.ndarray]:
        return {
            "obs": self.obs[idx],
            "action": self.action[idx],
            "reward": self.reward[idx],
            "next_obs": self.next_obs[idx],
            "discount": self.discount[idx],
        }

    def sample(self, batch_size: int, rng: np.random.Generator):
        """Uniform sample of stacked arrays."""
        idx = rng.integers(0, self._size, size=batch_size)
        return self.gather(idx)
