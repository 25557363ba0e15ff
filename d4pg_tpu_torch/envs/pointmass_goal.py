"""Goal-conditioned 2-D point mass on the device, batched over N envs
(counterpart of ``d4pg_tpu/envs/pointmass_goal.py``).

The physics state is ``[pos(2), vel(2), goal(2)]`` [N, 6]; the flat
observation is ``[pos, vel, goal]``. The reward is sparse (0 within
``success_threshold`` of the goal, −1 elsewhere), reaching the goal
terminates the episode, and :meth:`PointMassGoal.compute_reward` is the
relabeling reward for hindsight replay (which is not ported yet).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from d4pg_tpu_torch.envs.api import EnvState


class GoalObs(NamedTuple):
    observation: torch.Tensor    # [N, 4] position + velocity
    achieved_goal: torch.Tensor  # [N, 2] current position
    desired_goal: torch.Tensor   # [N, 2] target position


class PointMassGoal:
    observation_dim = 4  # pos(2) + vel(2); goal adds 2 when flattened
    goal_dim = 2
    action_dim = 2
    max_episode_steps = 50
    v_min = -50.0
    v_max = 0.0
    success_threshold = 0.1
    # termination == goal reached, so the evaluator reports success_rate
    reports_success = True

    def __init__(self, arena: float = 1.0, dt: float = 0.1, max_accel: float = 1.0):
        self.arena = arena
        self.dt = dt
        self.max_accel = max_accel

    @property
    def flat_obs_dim(self) -> int:
        return self.observation_dim + self.goal_dim

    def compute_reward(self, achieved_goal: torch.Tensor, desired_goal: torch.Tensor) -> torch.Tensor:
        """Sparse reward: 0 at the goal, −1 elsewhere (robotics-suite style)."""
        d = torch.linalg.vector_norm(achieved_goal - desired_goal, dim=-1)
        return torch.where(d < self.success_threshold, 0.0, -1.0)

    def goal_obs(self, state: EnvState) -> GoalObs:
        """Structured view for a hindsight writer."""
        p = state.physics
        return GoalObs(observation=p[:, :4], achieved_goal=p[:, :2], desired_goal=p[:, 4:6])

    def _draw(self, n: int, generator: torch.Generator, device) -> torch.Tensor:
        """pos, goal ~ U(±arena)², vel = 0."""
        u = (2.0 * torch.rand((n, 4), generator=generator, device=device) - 1.0) * self.arena
        return torch.cat([u[:, :2], torch.zeros_like(u[:, :2]), u[:, 2:]], dim=-1)

    def reset(self, n: int, generator: torch.Generator, device=None) -> Tuple[EnvState, torch.Tensor]:
        physics = self._draw(n, generator, device)
        state = EnvState(physics=physics, t=torch.zeros(n, dtype=torch.int32, device=device))
        return state, physics.clone()

    def reset_where(self, state: EnvState, obs: torch.Tensor, done: torch.Tensor,
                    generator: torch.Generator) -> Tuple[EnvState, torch.Tensor]:
        """Reset the envs where ``done`` is set; keep the others."""
        fresh = self._draw(obs.shape[0], generator, obs.device)
        mask = done.bool()
        physics = torch.where(mask[:, None], fresh, state.physics)
        t = torch.where(mask, torch.zeros_like(state.t), state.t)
        obs = torch.where(mask[:, None], fresh, obs)
        return EnvState(physics=physics, t=t), obs

    def step(self, state: EnvState, action: torch.Tensor):
        p = state.physics
        pos, vel, goal = p[:, :2], p[:, 2:4], p[:, 4:6]
        accel = action.clamp(-1.0, 1.0) * self.max_accel
        vel = (vel + accel * self.dt).clamp(-2.0, 2.0) * 0.95
        pos = (pos + vel * self.dt).clamp(-self.arena, self.arena)
        physics = torch.cat([pos, vel, goal], dim=-1)
        reward = self.compute_reward(pos, goal)
        # reaching the goal ends the episode
        terminated = (reward >= 0.0).to(torch.float32)
        t = state.t + 1
        truncated = (t >= self.max_episode_steps).to(torch.float32) * (1.0 - terminated)
        return EnvState(physics=physics, t=t), physics.clone(), reward, terminated, truncated
