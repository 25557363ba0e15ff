"""Prioritized experience replay with vectorized proportional sampling.

The port's own copy of ``d4pg_tpu/replay/per.py`` on NumPy trees: new
samples enter at ``max_priority**alpha``, sampling is stratified and
proportional to priority mass, importance weights are ``(p·N)^{−β}``
normalized by the max weight (via the min tree), priorities update as
``(|td| + ε)^α``, and β anneals as a pure function of the learner step.

The draw consumes the seeded ``np.random.Generator`` exactly as the JAX
package's NumPy backend does (one ``uniform`` over the B equal-mass
strata per batch), so the same adds, seed and priority updates give the
same indices and IS weights in both packages.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from d4pg_tpu_torch.replay.schedules import linear_schedule
from d4pg_tpu_torch.replay.segment_tree import MinTree, SumTree
from d4pg_tpu_torch.replay.uniform import ReplayBuffer, Transition


class SampledIndices(NamedTuple):
    """Slot indices plus the write generations they were sampled at; a
    write-back for a slot recycled since then is dropped."""

    idx: np.ndarray  # [B] int
    gen: np.ndarray  # [B] int64


class PrioritizedReplayBuffer(ReplayBuffer):
    def __init__(
        self,
        capacity: int,
        obs_dim: int,
        action_dim: int,
        alpha: float = 0.6,
        beta0: float = 0.4,
        beta_steps: int = 100_000,
        eps: float = 1e-6,
    ):
        super().__init__(capacity, obs_dim, action_dim)
        if alpha < 0:
            raise ValueError(f"alpha must be >= 0, got {alpha}")
        self.alpha = alpha
        self.beta0 = beta0
        self.beta_steps = beta_steps
        self.eps = eps
        self._sum = SumTree(self.capacity)
        self._min = MinTree(self.capacity)
        self._max_priority = 1.0

    def add_batch(self, t: Transition) -> np.ndarray:
        idx = super().add_batch(t)
        p = self._max_priority**self.alpha
        self._sum.set(idx, np.full(idx.shape, p))
        self._min.set(idx, np.full(idx.shape, p))
        return idx

    def beta(self, step: int) -> float:
        return linear_schedule(step, self.beta_steps, self.beta0, 1.0)

    def _draw(self, batch_size: int, rng: np.random.Generator, step: int):
        """One stratified draw: (idx, IS weights, generation stamps)."""
        total = self._sum.sum()
        bounds = np.linspace(0.0, total, batch_size + 1)
        prefixes = rng.uniform(bounds[:-1], bounds[1:])
        # a prefix equal to the total would fall off the last nonzero leaf
        prefixes = np.minimum(prefixes, np.nextafter(total, 0.0))
        idx = self._sum.find_prefixsum_idx(prefixes)
        idx = np.minimum(idx, self._size - 1)
        p = self._sum.get(idx) / total
        beta = self.beta(step)
        weights = (p * self._size) ** (-beta)
        min_p = self._min.min() / total
        max_w = (min_p * self._size) ** (-beta)
        weights = weights / max_w
        return idx, weights.astype(np.float32), self._gen[idx].copy()

    def sample(self, batch_size: int, rng: np.random.Generator, step: int = 0):
        """Stratified proportional sample: a batch dict with the extra keys
        ``indices`` (for the priority write-back) and ``weights`` (IS
        weights, max-normalized)."""
        idx, weights, gen = self._draw(batch_size, rng, step)
        batch = dict(self.gather(idx))
        batch["indices"] = SampledIndices(idx, gen)
        batch["weights"] = weights
        return batch

    def update_priorities(self, indices, priorities: np.ndarray) -> None:
        """(|priority| + ε)^α into both trees. ``indices`` is a raw index
        array or the :class:`SampledIndices` that :meth:`sample` returned;
        with the latter, entries whose slot was recycled are dropped."""
        pri = np.abs(np.asarray(priorities, np.float64)).ravel() + self.eps
        if isinstance(indices, SampledIndices):
            idx, sample_gen = indices.idx, indices.gen
        else:
            idx, sample_gen = indices, None
        idx = np.asarray(idx, np.int64).ravel()
        if idx.size != pri.size:
            raise ValueError(f"{idx.size} indices for {pri.size} priorities")
        if sample_gen is not None:
            live = self._gen[idx] == np.asarray(sample_gen, np.int64).ravel()
            idx, pri = idx[live], pri[live]
            if idx.size == 0:
                return
        pa = pri**self.alpha
        self._sum.set(idx, pa)
        self._min.set(idx, pa)
        self._max_priority = max(self._max_priority, float(pri.max()))
