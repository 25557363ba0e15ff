"""Hindsight experience replay, the "future" strategy (the port's own copy
of ``d4pg_tpu/replay/her.py``).

After an episode each transition is stored as it was and ``k_future``
more times with its desired goal replaced by the achieved goal of a step
drawn uniformly from its own step to the episode's end, the reward
recomputed under the substituted goal. Two deliberate fixes over the
original D4PG code that the JAX package keeps:

- a relabeled transition stores its own action, not the loop's final one;
- the original transitions are always stored; HER only adds relabeled
  copies.

Observations are goal-env dicts flattened as ``concat(observation, goal)``.
The future indices come from the caller's numpy ``Generator``, drawn in
the JAX package's order, so one seed writes the same rows in both.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List

import numpy as np

from d4pg_tpu_torch.replay.nstep_writer import NStepWriter


@dataclass
class _Step:
    observation: np.ndarray
    achieved_goal: np.ndarray
    desired_goal: np.ndarray
    action: np.ndarray
    reward: float
    next_observation: np.ndarray
    next_achieved_goal: np.ndarray
    terminated: bool


class HindsightWriter:
    """Buffers one episode, then writes it and ``k_future`` relabeled copies.

    ``compute_reward(achieved_goal, desired_goal) -> reward`` is the goal
    env's relabeling reward. With ``done_on_success`` a relabeled
    transition is terminal iff its reward reaches ``success_reward``.
    """

    def __init__(
        self,
        writer_factory: Callable[[], NStepWriter],
        compute_reward: Callable[[np.ndarray, np.ndarray], float],
        k_future: int = 4,
        rng: np.random.Generator | None = None,
        done_on_success: bool = True,
        success_reward: float = 0.0,
    ):
        self.writer_factory = writer_factory
        self.compute_reward = compute_reward
        self.k_future = k_future
        self.rng = rng or np.random.default_rng()
        self.done_on_success = done_on_success
        self.success_reward = success_reward
        self._episode: List[_Step] = []

    @staticmethod
    def flatten(observation: np.ndarray, goal: np.ndarray) -> np.ndarray:
        return np.concatenate([np.asarray(observation), np.asarray(goal)], axis=-1)

    def add(
        self,
        observation,
        achieved_goal,
        desired_goal,
        action,
        reward,
        next_observation,
        next_achieved_goal,
        terminated: bool,
    ) -> None:
        self._episode.append(
            _Step(
                np.asarray(observation),
                np.asarray(achieved_goal),
                np.asarray(desired_goal),
                np.asarray(action),
                float(reward),
                np.asarray(next_observation),
                np.asarray(next_achieved_goal),
                bool(terminated),
            )
        )

    def end_episode(self, truncated: bool = True) -> int:
        """Flush the episode: the original and the relabeled transitions.
        Returns the number of raw transitions written (before the n-step
        collapse)."""
        ep = self._episode
        self._episode = []
        if not ep:
            return 0
        count = 0
        # the original trajectory through a fresh n-step window
        w = self.writer_factory()
        for t, s in enumerate(ep):
            last = t == len(ep) - 1
            w.add(
                self.flatten(s.observation, s.desired_goal),
                s.action,
                s.reward,
                self.flatten(s.next_observation, s.desired_goal),
                terminated=s.terminated,
                truncated=last and truncated and not s.terminated,
            )
            count += 1
        for _ in range(self.k_future):
            w = self.writer_factory()
            # one future index f in [t, T) a step
            future = np.array([self.rng.integers(t, len(ep)) for t in range(len(ep))])
            for t, s in enumerate(ep):
                goal = ep[future[t]].next_achieved_goal
                r = float(self.compute_reward(s.next_achieved_goal, goal))
                done = self.done_on_success and (r >= self.success_reward)
                last = t == len(ep) - 1
                w.add(
                    self.flatten(s.observation, goal),
                    s.action,  # this step's own action
                    r,
                    self.flatten(s.next_observation, goal),
                    terminated=done,
                    truncated=last and not done,
                )
                count += 1
                if done:
                    # the relabeled episode ends at its success; the later
                    # steps start a new window
                    w = self.writer_factory()
        return count
