"""Shared retry/backoff policy: jittered exponential, bounded, monotonic
(the port's copy of ``d4pg_tpu/utils/retry.py``).

Every retry loop goes through :class:`Backoff`. The rules it encodes:

- **bounded attempts**: a retry loop without an attempt ceiling turns a
  persistent fault (dead worker, unwritable disk) into an infinite
  sleep-spin that looks like a hang from the outside;
- **monotonic deadlines**: wall-clock budgets jump with NTP/suspend,
  so the optional overall budget is measured on ``time.monotonic``;
- **jitter**: synchronized restarts (N workers killed by the same OOM
  sweep) must not retry in lockstep — each delay is spread uniformly
  over ``±jitter`` of its nominal value, from a *seedable* RNG so
  retrying runs stay deterministic.

Deliberately stdlib-only.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional


class Backoff:
    """Jittered exponential backoff schedule with bounded attempts.

    Two usage shapes:

    - **schedule**: call :meth:`next_delay`
      per consecutive failure — it returns the seconds to wait before
      the next attempt, or ``None`` once the attempt budget (or the
      monotonic deadline) is exhausted. Call :meth:`reset` on success
      so the next failure starts the schedule over.
    - **retry loop**: iterate — ``for attempt in Backoff(...)`` yields
      attempt indices (0-based), sleeping the backoff delay *between*
      attempts and stopping after ``max_attempts`` retries::

          for attempt in Backoff(max_attempts=4):
              try:
                  return connect()
              except OSError:
                  continue  # bounded: the iterator sleeps, then stops
          raise TimeoutError("gave up after bounded retries")
    """

    def __init__(
        self,
        *,
        base_s: float = 0.1,
        factor: float = 2.0,
        max_s: float = 30.0,
        max_attempts: int = 8,
        deadline_s: Optional[float] = None,
        jitter: float = 0.5,
        rng: Optional[random.Random] = None,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.monotonic,
    ):
        assert base_s >= 0.0 and factor >= 1.0 and 0.0 <= jitter <= 1.0
        assert max_attempts >= 0
        self.base_s = base_s
        self.factor = factor
        self.max_s = max_s
        self.max_attempts = max_attempts
        self.jitter = jitter
        self.attempts = 0  # retries consumed since the last reset()
        self._rng = rng if rng is not None else random.Random()
        self._sleep = sleep
        self._clock = clock
        self._deadline = None if deadline_s is None else clock() + deadline_s

    def next_delay(self) -> Optional[float]:
        """Seconds to wait before the next retry, or ``None`` when the
        budget (attempt count or monotonic deadline) is exhausted.
        Advances the attempt counter."""
        if self.attempts >= self.max_attempts:
            return None
        if self._deadline is not None and self._clock() >= self._deadline:
            return None
        nominal = min(self.max_s, self.base_s * self.factor**self.attempts)
        # uniform over [nominal·(1−jitter), nominal·(1+jitter)]
        delay = nominal * (1.0 + self.jitter * (2.0 * self._rng.random() - 1.0))
        self.attempts += 1
        return max(0.0, delay)

    def reset(self) -> None:
        """Success: the next failure restarts the schedule from base_s
        (so the schedule counts *consecutive* failures)."""
        self.attempts = 0

    def __iter__(self):
        attempt = 0
        yield attempt  # first attempt is free (no delay before it)
        while True:
            delay = self.next_delay()
            if delay is None:
                return
            self._sleep(delay)
            attempt += 1
            yield attempt

