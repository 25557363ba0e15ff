"""Array-based segment trees with batched, vectorized operations.

The port's own copy of ``d4pg_tpu/replay/segment_tree.py``: the NumPy
trees (the native C++ ones are ``replay/native.py``). Flat NumPy arrays and
level-synchronous vector ops instead of per-element recursive Python, so a
256-sample PER batch costs ~log2(capacity) vectorized passes in total.

Layout: ``tree[1]`` is the root; leaves live at ``[capacity, 2*capacity)``.
"""

from __future__ import annotations

import numpy as np


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class _SegmentTreeBase:
    def __init__(self, capacity: int, neutral: float, dtype=np.float64):
        self.capacity = _next_pow2(capacity)
        self.neutral = neutral
        self.tree = np.full(2 * self.capacity, neutral, dtype=dtype)
        self.depth = int(np.log2(self.capacity))

    def _combine(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def set(self, indices: np.ndarray, values: np.ndarray) -> None:
        """Batched leaf assignment + ancestor repair, O(log n) vector passes.

        Duplicate indices are allowed (last write wins, NumPy assignment
        semantics); ancestor recomputation from children is idempotent so
        shared ancestors are handled for free.
        """
        indices = np.atleast_1d(np.asarray(indices, np.int64))
        values = np.atleast_1d(values)
        pos = indices + self.capacity
        self.tree[pos] = values
        for _ in range(self.depth):
            pos = np.unique(pos // 2)
            self.tree[pos] = self._combine(self.tree[2 * pos], self.tree[2 * pos + 1])

    def get(self, indices) -> np.ndarray:
        return self.tree[np.asarray(indices, np.int64) + self.capacity]

    @property
    def root(self) -> float:
        return float(self.tree[1])


class SumTree(_SegmentTreeBase):
    """Sum-reduction tree supporting batched proportional sampling."""

    def __init__(self, capacity: int, dtype=np.float64):
        super().__init__(capacity, neutral=0.0, dtype=dtype)

    def _combine(self, a, b):
        return a + b

    def sum(self) -> float:
        return self.root

    def find_prefixsum_idx(self, prefixes: np.ndarray) -> np.ndarray:
        """Vectorized batch descent: for each prefix mass, the leaf index i
        with cumsum[0..i-1] <= prefix < cumsum[0..i] (reference
        ``prioritized_replay_memory.py:126-149``, one tree walk per sample —
        here one vector op per level for the whole batch)."""
        prefixes = np.asarray(prefixes, self.tree.dtype).copy()
        idx = np.ones(prefixes.shape[0], np.int64)
        for _ in range(self.depth):
            left = self.tree[2 * idx]
            # >= so a prefix landing exactly on a cumsum boundary selects the
            # next leaf, and zero-mass leaves are skipped.
            go_right = prefixes >= left
            prefixes -= np.where(go_right, left, 0.0)
            idx = 2 * idx + go_right
        return idx - self.capacity


class MinTree(_SegmentTreeBase):
    """Min-reduction tree for max-IS-weight normalization."""

    def __init__(self, capacity: int, dtype=np.float64):
        super().__init__(capacity, neutral=np.inf, dtype=dtype)

    def _combine(self, a, b):
        return np.minimum(a, b)

    def min(self) -> float:
        return self.root
