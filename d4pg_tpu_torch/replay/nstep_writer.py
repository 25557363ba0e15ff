"""n-step transition accumulation at insert time (the port's own copy of
``d4pg_tpu/replay/nstep_writer.py``'s ``NStepWriter``).

The writer keeps a sliding window per actor and emits ``(s_t, a_t,
R_t^{(m)}, s_{t+m}, γ^m·(1−terminal))`` transitions one at a time through
the buffer's ``add``, with episode ends handled exactly:

- termination: every partial window flushes with bootstrap discount 0;
- truncation (timeout): partial windows flush with discount γ^m, since the
  value bootstrap is still valid at a timeout cut.

:class:`BatchedNStepWriter` (the JAX package's, from the same file) is
the host actor pool's N-wide writer: one vectorized window append and one
``add_batch`` a pool step, with the per-actor semantics of
:class:`NStepWriter`.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from d4pg_tpu_torch.replay.uniform import Transition


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


class BatchedNStepWriter:
    """N-wide n-step writer for the host actor pool: one vectorized window
    append and ONE ``buffer.add_batch`` per pool step.

    The per-actor :class:`NStepWriter` loop costs N Python ``add`` calls —
    each a deque walk plus a single-row ``buffer.add`` with its own lock
    round-trip — per pool step; at 64 actors that loop IS the ingest wall.
    Here the N sliding windows live in preallocated circular arrays
    ``[N, n, ...]``, the steady-state emit (every window full, no episode
    end) is a handful of vectorized ops writing into reused emit buffers,
    and all ready transitions enter the buffer as one N-row block.

    Emission semantics per actor match :class:`NStepWriter` exactly
    (full-window emit with m=n, termination flush with discount 0,
    truncation flush with discount γ^m); episode-end steps fall back to an
    ordered per-actor path, so only the ring INSERTION ORDER across actors
    differs from the sequential loop (contents are identical — tested).

    The windows hold float32 observations; a pixel buffer (uint8 storage)
    quantizes them where every writer's rows are quantized, in
    ``ReplayBuffer.add_batch`` (``_encode_obs``).
    """

    def __init__(self, buffer, num_actors: int, n: int, gamma: float):
        assert n >= 1 and num_actors >= 1
        self.buffer = buffer
        self.num_actors = num_actors
        self.n = n
        self.gamma = gamma
        self._gamma_pows = gamma ** np.arange(n)  # float64
        self._start = np.zeros(num_actors, np.int64)
        self._len = np.zeros(num_actors, np.int64)
        self._obs_w = None  # allocated lazily: dims come from the first step

    def _alloc(self, obs: np.ndarray, action: np.ndarray) -> None:
        N, n = self.num_actors, self.n
        self._obs_w = np.zeros((N, n) + obs.shape[1:], np.float32)
        self._act_w = np.zeros((N, n) + action.shape[1:], np.float32)
        # float64 rewards so the n-step return accumulates at the precision
        # of the scalar writer's Python-float loop (bit-identical emits).
        self._rew_w = np.zeros((N, n), np.float64)
        # reusable steady-state emit buffers (zero-alloc fast path)
        self._e_obs = np.empty((N,) + obs.shape[1:], np.float32)
        self._e_act = np.empty((N,) + action.shape[1:], np.float32)
        self._e_ret = np.empty(N, np.float64)
        self._e_disc = np.empty(N, np.float64)

    def _front_return(self, rows: np.ndarray, m: int) -> np.ndarray:
        """Σ_{k<m} γ^k·r_k over each listed actor's window front, with the
        scalar writer's k-ascending accumulation order."""
        ret = np.zeros(len(rows), np.float64)
        start = self._start[rows]
        for k in range(m):
            ret += self._gamma_pows[k] * self._rew_w[rows, (start + k) % self.n]
        return ret

    def add_batch(
        self,
        obs: np.ndarray,
        actions: np.ndarray,
        rewards: np.ndarray,
        next_obs: np.ndarray,
        terminated: np.ndarray,
        truncated: np.ndarray,
        active: np.ndarray = None,
    ) -> int:
        """Feed one synchronized pool step for all N actors; emits every
        ready/flushed n-step transition as ONE ``add_batch``. Returns the
        number of transitions emitted.

        ``active`` (bool [N], optional) masks rows that did NOT step this
        call (supervised-pool worker down/rejoining/quarantined): masked
        actors' windows are untouched — their in-flight episode was
        either already dropped whole (:meth:`drop_actor`) or resumes on a
        later step. ``None`` means all rows stepped (the steady state)."""
        obs = np.asarray(obs)
        actions = np.asarray(actions)
        rewards = np.asarray(rewards, np.float64)
        next_obs = np.asarray(next_obs)
        terminated = np.asarray(terminated, bool)
        truncated = np.asarray(truncated, bool)
        N, n = self.num_actors, self.n
        if self._obs_w is None:
            self._alloc(obs, actions)
        if active is not None and not active.all():
            # Degraded step (rare): ordered per-actor path over the live
            # rows only — identical per-actor emission semantics, one
            # add_batch for the whole step.
            cols: list[tuple] = []
            pos = (self._start + self._len) % n
            for i in range(N):
                if not active[i]:
                    continue
                self._obs_w[i, pos[i]] = obs[i]
                self._act_w[i, pos[i]] = actions[i]
                self._rew_w[i, pos[i]] = rewards[i]
                self._len[i] += 1
                if self._len[i] == n:
                    cols.append(self._pop_front(i, next_obs[i], terminated[i]))
                if terminated[i] or truncated[i]:
                    while self._len[i] > 0:
                        cols.append(
                            self._pop_front(i, next_obs[i], terminated[i])
                        )
            if not cols:
                return 0
            self.buffer.add_batch(
                Transition(
                    np.stack([c[0] for c in cols]),
                    np.stack([c[1] for c in cols]),
                    np.asarray([c[2] for c in cols]),
                    np.stack([c[3] for c in cols]),
                    np.asarray([c[4] for c in cols]),
                )
            )
            return len(cols)
        rows = np.arange(N)
        pos = (self._start + self._len) % n
        self._obs_w[rows, pos] = obs
        self._act_w[rows, pos] = actions
        self._rew_w[rows, pos] = rewards
        self._len += 1
        done = terminated | truncated
        if not done.any():
            ready = self._len == n
            if not ready.any():
                return 0  # warmup: no window full yet
            all_ready = ready.all()
            r = rows if all_ready else rows[ready]
            k = len(r)
            start = self._start[r]
            self._e_obs[:k] = self._obs_w[r, start]
            self._e_act[:k] = self._act_w[r, start]
            self._e_ret[:k] = self._front_return(r, n)
            # no episode ended on this branch → bootstrap always survives
            self._e_disc[:k] = self.gamma**n
            self._start[r] = (start + 1) % n
            self._len[r] -= 1
            self.buffer.add_batch(
                Transition(
                    self._e_obs[:k], self._e_act[:k], self._e_ret[:k],
                    next_obs if all_ready else next_obs[r], self._e_disc[:k],
                )
            )
            return k
        # Episode boundary somewhere: ordered per-actor emit + flush
        # (identical per-actor sequence to NStepWriter.add), still one
        # add_batch for the whole step.
        cols: list[tuple] = []
        for i in range(N):
            if self._len[i] == n:
                cols.append(self._pop_front(i, next_obs[i], terminated[i]))
            if done[i]:
                while self._len[i] > 0:
                    cols.append(self._pop_front(i, next_obs[i], terminated[i]))
        if not cols:
            return 0
        self.buffer.add_batch(
            Transition(
                np.stack([c[0] for c in cols]),
                np.stack([c[1] for c in cols]),
                np.asarray([c[2] for c in cols]),
                np.stack([c[3] for c in cols]),
                np.asarray([c[4] for c in cols]),
            )
        )
        return len(cols)

    def _pop_front(self, i: int, next_obs_i: np.ndarray, terminal: bool):
        m = int(self._len[i])
        ret = float(self._front_return(np.array([i]), m)[0])
        s = self._start[i]
        row = (
            self._obs_w[i, s].copy(),
            self._act_w[i, s].copy(),
            ret,
            next_obs_i,
            0.0 if terminal else self.gamma**m,
        )
        self._start[i] = (s + 1) % self.n
        self._len[i] -= 1
        return row

    def drop_actor(self, i: int) -> None:
        """Drop actor ``i``'s in-flight window WHOLE (supervised-pool
        worker failure): the episode tore mid-window, so emitting any of
        it would store transitions whose tail the env never produced."""
        self._start[i] = 0
        self._len[i] = 0

    def reset(self) -> None:
        """Drop all unfinished windows (e.g. on pool restart)."""
        self._start[:] = 0
        self._len[:] = 0
