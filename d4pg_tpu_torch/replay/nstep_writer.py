"""n-step transition accumulation at insert time (the port's own copy of
``d4pg_tpu/replay/nstep_writer.py``'s ``NStepWriter``).

The writer keeps a sliding window per actor and emits ``(s_t, a_t,
R_t^{(m)}, s_{t+m}, γ^m·(1−terminal))`` transitions one at a time through
the buffer's ``add``, with episode ends handled exactly:

- termination: every partial window flushes with bootstrap discount 0;
- truncation (timeout): partial windows flush with discount γ^m, since the
  value bootstrap is still valid at a timeout cut.

The pool's vectorised ``BatchedNStepWriter`` comes with the host actor
pool (ROADMAP A5 (d)).
"""

from __future__ import annotations

from collections import deque

import numpy as np


class NStepWriter:
    """Per-actor n-step window over a target buffer (uniform or PER)."""

    def __init__(self, buffer, n: int, gamma: float):
        assert n >= 1
        self.buffer = buffer
        self.n = n
        self.gamma = gamma
        self._window: deque = deque()

    def _emit_front(self, next_obs: np.ndarray, terminal: bool, m: int) -> None:
        obs, action, _ = self._window[0]
        ret = 0.0
        for k, (_, _, r) in enumerate(self._window):
            ret += (self.gamma**k) * r
        discount = 0.0 if terminal else self.gamma**m
        self.buffer.add(obs, action, ret, next_obs, discount)
        self._window.popleft()

    def add(self, obs, action, reward, next_obs, terminated: bool, truncated: bool = False) -> None:
        """Feed one raw env step; emits ready n-step transitions to the buffer."""
        self._window.append((np.asarray(obs), np.asarray(action), float(reward)))
        if len(self._window) == self.n:
            self._emit_front(np.asarray(next_obs), terminated, self.n)
        if terminated or truncated:
            # flush the partial windows against the episode's last state
            while self._window:
                self._emit_front(np.asarray(next_obs), terminated, len(self._window))

    def reset(self) -> None:
        """Drop any un-flushed window (e.g. on actor restart)."""
        self._window.clear()
