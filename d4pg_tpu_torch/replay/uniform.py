"""Uniform ring-buffer replay on preallocated NumPy arrays.

The port's own copy of ``d4pg_tpu/replay/uniform.py``, cut to what the
learner uses: columnar float32 storage, O(1) vectorized batched writes,
gather-based sampling, per-slot write generations, the monotone
``total_added`` counter the device-ring mirror diffs against, and
``.npz`` snapshots in the JAX package's layout (either package restores
the other's), and the uint8 storage of pixel observations
(``obs_dtype=np.uint8``): ``clip(rint(x·255), 0, 255)`` in float32 at
the write (``np.rint`` rounds half to even), decoded as ``/255`` in
float32 at the sample, or kept as bytes for the uint8 wire
(``decode_on_sample=False``).

One re-entrant lock (``_lock``, ``lockwitness.named_rlock``, made once here)
guards every write, gather, snapshot copy and restore, so the priority write-back
thread never reads a torn row; the prioritized subclass takes the same
lock around its trees and calls back into these methods while it holds
it.

Transitions carry an explicit per-sample ``discount`` = γ^m·(1−terminal)
so the learner's projection needs no gamma/n plumbing.
"""

from __future__ import annotations

import os
from typing import Mapping, NamedTuple

import numpy as np

from d4pg_tpu_torch.analysis import lockwitness


class Transition(NamedTuple):
    """One (possibly n-step-collapsed) transition, or a batch of them."""

    obs: np.ndarray        # s_t
    action: np.ndarray     # a_t
    reward: np.ndarray     # R_t = sum_{k<m} gamma^k r_{t+k}
    next_obs: np.ndarray   # s_{t+m}
    discount: np.ndarray   # gamma^m * (1 - terminal)


class ReplayBuffer:
    """Columnar ring buffer; thread-safe (see the module docstring)."""

    def __init__(self, capacity: int, obs_dim: int, action_dim: int,
                 obs_dtype=np.float32, decode_on_sample: bool = True):
        """``obs_dtype=np.uint8`` stores observations in [0, 1] as bytes
        (pixel envs: a quarter of float32's memory).
        ``decode_on_sample=False`` (uint8 storage only) returns sampled
        observations as their stored bytes, for the uint8 wire; the
        consumer divides them by 255."""
        self.capacity = int(capacity)
        self.obs_dtype = np.dtype(obs_dtype)
        self._quantized = self.obs_dtype == np.uint8
        self._decode_on_sample = bool(decode_on_sample)
        self.obs = np.zeros((capacity, obs_dim), self.obs_dtype)
        self.action = np.zeros((capacity, action_dim), np.float32)
        self.reward = np.zeros((capacity,), np.float32)
        self.next_obs = np.zeros((capacity, obs_dim), self.obs_dtype)
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
        # j % capacity. Plain-int reads are safe off the lock: a reader one
        # batch behind ships the rows at its next flush.
        self._total_added = 0
        # Re-entrant: the PER subclass holds it around its trees and calls
        # add_batch / gather / _snapshot_arrays of this class inside.
        self._lock = lockwitness.named_rlock("ReplayBuffer._lock")

    def _encode_obs(self, obs) -> np.ndarray:
        if self._quantized and np.asarray(obs).dtype == np.uint8:
            # already the stored bytes: the fleet's u8 wire, whose rows
            # were quantized by this same rule on the actor
            return np.atleast_2d(np.asarray(obs))
        obs = np.atleast_2d(np.asarray(obs, np.float32))
        if self._quantized:
            return np.clip(np.rint(obs * 255.0), 0.0, 255.0).astype(np.uint8)
        return obs

    def _decode_obs(self, stored: np.ndarray) -> np.ndarray:
        if self._quantized and self._decode_on_sample:
            return stored.astype(np.float32) / 255.0
        return stored

    def __len__(self) -> int:
        return self._size

    @property
    def total_added(self) -> int:
        """Monotone count of rows ever written (including overwrites)."""
        return self._total_added

    def add_batch(self, t: Transition) -> np.ndarray:
        """Insert a batch of transitions; returns the slot indices written."""
        obs = self._encode_obs(t.obs)
        n = obs.shape[0]
        with self._lock:
            idx = (self._pos + np.arange(n)) % self.capacity
            self.obs[idx] = obs
            self.action[idx] = np.atleast_2d(np.asarray(t.action, np.float32))
            self.reward[idx] = np.asarray(t.reward, np.float32).reshape(n)
            self.next_obs[idx] = self._encode_obs(t.next_obs)
            self.discount[idx] = np.asarray(t.discount, np.float32).reshape(n)
            self._gen[idx] += 1
            self._pos = int((self._pos + n) % self.capacity)
            self._size = int(min(self._size + n, self.capacity))
            self._total_added += n
        return idx

    def add(self, obs, action, reward, next_obs, discount) -> np.ndarray:
        """Insert one transition (the n-step and hindsight writers' path):
        a one-row :meth:`add_batch`, so a prioritized buffer gives the row
        the max priority."""
        return self.add_batch(
            Transition(
                np.asarray(obs)[None],
                np.asarray(action)[None],
                np.asarray([reward]),
                np.asarray(next_obs)[None],
                np.asarray([discount]),
            )
        )

    def gather(self, idx: np.ndarray) -> Mapping[str, np.ndarray]:
        with self._lock:  # never a torn row
            return {
                "obs": self._decode_obs(self.obs[idx]),
                "action": self.action[idx],
                "reward": self.reward[idx],
                "next_obs": self._decode_obs(self.next_obs[idx]),
                "discount": self.discount[idx],
            }

    def sample(self, batch_size: int, rng: np.random.Generator):
        """Uniform sample of stacked arrays."""
        idx = rng.integers(0, self._size, size=batch_size)
        return self.gather(idx)

    # ------------------------------------------------------------- snapshot
    def _snapshot_arrays(self) -> dict:
        """Stored rows in ring order [0, size) as LIVE VIEWS, plus the write
        head and the fill count. The caller holds ``_lock`` and copies
        every value before releasing it."""
        n = self._size
        return {
            "obs": self.obs[:n],
            "action": self.action[:n],
            "reward": self.reward[:n],
            "next_obs": self.next_obs[:n],
            "discount": self.discount[:n],
            "pos": np.asarray(self._pos),
            "size": np.asarray(n),
        }

    def snapshot(self, path: str) -> None:
        """Write the buffer contents to ``path`` (.npz, atomically by
        rename), so ``--resume`` keeps its experience."""
        with self._lock:
            # real copies: a writer may mutate the live arrays while the
            # file is written below, unlocked
            data = {k: np.array(v, copy=True) for k, v in self._snapshot_arrays().items()}
        tmp = f"{path}.tmp.npz"  # savez appends .npz unless present
        # Uncompressed: replay rows are high-entropy floats (deflate gains
        # ~10%) and compression would stall the learner at 1M rows.
        np.savez(tmp, **data)
        os.replace(tmp, path)

    def _restore_arrays(self, data) -> int:
        n = int(np.asarray(data["size"]).item())
        if n > self.capacity:
            raise ValueError(
                f"snapshot holds {n} rows > capacity {self.capacity}; "
                "raise --rmsize to restore it"
            )
        if data["obs"].shape[1] != self.obs.shape[1]:
            raise ValueError("snapshot obs_dim does not match this buffer")
        self.obs[:n] = data["obs"]
        self.action[:n] = data["action"]
        self.reward[:n] = data["reward"]
        self.next_obs[:n] = data["next_obs"]
        self.discount[:n] = data["discount"]
        # Every row changed identity: invalidate the generation stamps of
        # samples taken before the restore.
        self._gen += 1
        self._size = n
        # Same capacity: resume the saved write head so FIFO eviction order
        # survives a wrapped ring; otherwise the data sits at [0, n).
        saved_pos = int(np.asarray(data["pos"]).item())
        self._pos = saved_pos if n == self.capacity else n % self.capacity
        # Re-derive the lifetime counter so total_added % capacity == pos
        # and min(total_added, capacity) == size keep holding: the
        # device-ring mirror's slot math rests on both, and a fresh mirror
        # (synced = 0) then resyncs the whole restored buffer.
        self._total_added = self._pos + self.capacity if n == self.capacity else n
        return n

    def restore(self, path: str) -> int:
        """Load a :meth:`snapshot`; returns the number of rows restored."""
        with np.load(path, allow_pickle=False) as data:
            with self._lock:
                return self._restore_arrays(data)
