"""Batched Pendulum on the device (counterpart of ``d4pg_tpu/envs/pendulum.py``).

The classic gym dynamics (g=10, m=1, l=1, dt=0.05, torque in [−2, 2],
reward −(θ² + 0.1·θ̇² + 0.001·u²), truncation at 200 steps, never
terminates), reset uniformly in θ ∈ [−π, π], θ̇ ∈ [−1, 1]; N envs step as
one set of tensor ops.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from d4pg_tpu_torch.envs.api import EnvState


def _angle_normalize(x: torch.Tensor) -> torch.Tensor:
    return torch.remainder(x + math.pi, 2 * math.pi) - math.pi


class Pendulum:
    observation_dim = 3
    action_dim = 1
    max_episode_steps = 200
    v_min = -300.0
    v_max = 0.0

    def __init__(self, g: float = 10.0, max_torque: float = 2.0, dt: float = 0.05):
        self.g = g
        self.max_torque = max_torque
        self.dt = dt
        self.m = 1.0
        self.l = 1.0
        self.max_speed = 8.0

    @staticmethod
    def _obs(physics: torch.Tensor) -> torch.Tensor:
        theta, thetadot = physics[:, 0], physics[:, 1]
        return torch.stack([torch.cos(theta), torch.sin(theta), thetadot], dim=-1)

    def _draw(self, n: int, generator: torch.Generator, device) -> torch.Tensor:
        """θ ~ U[−π, π), θ̇ ~ U[−1, 1) for n envs ([n, 2])."""
        u = 2.0 * torch.rand((n, 2), generator=generator, device=device) - 1.0
        return torch.stack([u[:, 0] * math.pi, u[:, 1]], dim=-1)

    def reset(self, n: int, generator: torch.Generator, device=None) -> Tuple[EnvState, torch.Tensor]:
        physics = self._draw(n, generator, device)
        state = EnvState(physics=physics, t=torch.zeros(n, dtype=torch.int32, device=device))
        return state, self._obs(physics)

    def reset_where(self, state: EnvState, obs: torch.Tensor, done: torch.Tensor,
                    generator: torch.Generator) -> Tuple[EnvState, torch.Tensor]:
        """Reset the envs where ``done`` is set; keep the others."""
        n = obs.shape[0]
        fresh = self._draw(n, generator, obs.device)
        mask = done.bool()
        physics = torch.where(mask[:, None], fresh, state.physics)
        t = torch.where(mask, torch.zeros_like(state.t), state.t)
        obs = torch.where(mask[:, None], self._obs(fresh), obs)
        return EnvState(physics=physics, t=t), obs

    def step(self, state: EnvState, action: torch.Tensor):
        theta, thetadot = state.physics[:, 0], state.physics[:, 1]
        # canonical (−1, 1) action scaled to the torque range
        u = action[:, 0].clamp(-1.0, 1.0) * self.max_torque
        cost = _angle_normalize(theta) ** 2 + 0.1 * thetadot**2 + 0.001 * u**2
        newthetadot = thetadot + (
            3 * self.g / (2 * self.l) * torch.sin(theta)
            + 3.0 / (self.m * self.l**2) * u
        ) * self.dt
        newthetadot = newthetadot.clamp(-self.max_speed, self.max_speed)
        newtheta = theta + newthetadot * self.dt
        physics = torch.stack([newtheta, newthetadot], dim=-1)
        t = state.t + 1
        truncated = (t >= self.max_episode_steps).to(torch.float32)
        terminated = torch.zeros_like(truncated)  # pendulum never terminates
        return EnvState(physics=physics, t=t), self._obs(physics), -cost, terminated, truncated
