"""Running observation normalization (HER-DDPG, Andrychowicz et al. 2017),
the port's own copy of ``d4pg_tpu/ops/obs_norm.py``.

clip((x − μ)/σ, ±clip_range) with Welford running statistics — the
ingredient the HER paper pairs with sparse Fetch tasks beyond Reach (their
§4.1 implementation details). Statistics are folded once per OBSERVED env
step at collection time (the trainer's ``_ingest_obs`` choke point), NOT
per sampled training batch: updating from sampled batches would
double-count PER-favored transitions and keep the statistics drifting with
priorities even over a static buffer. Training batches, acting and eval
forwards all READ the same published statistics.

Host-side NumPy by design: normalization lives at the trainer's data
boundary (batches before their copy to the device, observations before
acting/eval forwards), so no TrainState, train_step, or acting-path
signature changes, and the steps are the same programs when the feature
is off. The reference has no counterpart (its normalize_env.py scales
actions only); this is a capability flag, default off.

Thread-safety note: in async-collect mode the COLLECTOR thread updates the
statistics (it ingests every observed env step) while the LEARNER thread
reads them (normalizing sampled batches), and the learner also snapshots
them at checkpoint time. ``update`` publishes ONE ``_stats`` tuple
``(count, mean_f64, m2_f64, mean_f32, std_f32)`` built after all math
completes; ``normalize`` and ``state_dict`` each read that tuple exactly
once — so a reader always sees a matched set from the same update, never a
torn mix of two updates (CPython attribute assignment is atomic). In
particular a checkpoint can never persist a (new mean, old m2/count)
triple. Staleness of one update is the same class as published actor
params and harmless for normalization.
"""

from __future__ import annotations

import numpy as np


class RunningObsNorm:
    """Welford running mean/variance over observation vectors."""

    def __init__(self, dim: int, clip_range: float = 5.0, eps: float = 1e-2):
        self.dim = int(dim)
        self.clip_range = float(clip_range)
        # eps floors the std (paper: 1e-2) so near-constant dims don't
        # explode the normalized scale before statistics accumulate.
        self.eps = float(eps)
        self.count = 0.0
        self.mean = np.zeros(dim, np.float64)
        self._m2 = np.zeros(dim, np.float64)
        self.std = np.ones(dim, np.float64)
        self._publish(self.count, self.mean, self._m2, self.std)

    def _publish(self, count, mean, m2, std) -> None:
        """The single-tuple publication EVERY cross-thread read goes
        through (see thread-safety note): one atomic attribute assignment,
        after all math, carrying a matched (count, mean, m2, μ32, σ32)."""
        self._stats = (
            count,
            mean,
            m2,
            mean.astype(np.float32),
            std.astype(np.float32),
        )

    def update(self, x: np.ndarray) -> None:
        """Fold a batch [N, dim] (or single [dim]) into the statistics."""
        x = np.asarray(x, np.float64).reshape(-1, self.dim)
        n = x.shape[0]
        if n == 0:
            return
        b_mean = x.mean(axis=0)
        b_m2 = ((x - b_mean) ** 2).sum(axis=0)
        # Chan et al. parallel-Welford merge of (count, mean, M2) pairs.
        total = self.count + n
        delta = b_mean - self.mean
        mean = self.mean + delta * (n / total)
        m2 = self._m2 + b_m2 + delta**2 * (self.count * n / total)
        std = np.sqrt(np.maximum(m2 / total, 0.0))
        self.mean, self._m2, self.std, self.count = mean, m2, std, total
        # Single atomic publication AFTER all math (see thread-safety note).
        self._publish(total, mean, m2, std)

    def normalize(self, x: np.ndarray) -> np.ndarray:
        """clip((x − μ)/max(σ, eps), ±clip_range), float32."""
        _, _, _, mean, std = self._stats  # one read: matched set, never torn
        x = np.asarray(x, np.float32)
        out = (x - mean) / np.maximum(std, self.eps)
        return np.clip(out, -self.clip_range, self.clip_range)

    # ------------------------------------------------------------ persistence
    def state_dict(self) -> dict:
        # One tuple read — a concurrent update() can never tear the
        # persisted (count, mean, m2) triple (the checkpoint thread runs
        # while the collector ingests).
        count, mean, m2, _, _ = self._stats
        return {
            "count": float(count),
            "mean": mean.tolist(),
            "m2": m2.tolist(),
        }

    def load_state_dict(self, state: dict) -> None:
        self.count = float(state["count"])
        self.mean = np.asarray(state["mean"], np.float64)
        self._m2 = np.asarray(state["m2"], np.float64)
        self.std = (
            np.sqrt(np.maximum(self._m2 / self.count, 0.0))
            if self.count > 0
            else np.ones(self.dim, np.float64)
        )
        self._publish(self.count, self.mean, self._m2, self.std)
