"""Batched environment API (counterpart of ``d4pg_tpu/envs/api.py``).

The JAX package writes an env as pure functions of one env's state and
vmaps them. The port writes them over a batch of N envs whose state lives
on the device::

    state, obs = env.reset(n, generator, device)
    state, obs, reward, terminated, truncated = env.step(state, action)
    state, obs = env.reset_where(state, obs, done, generator)

with obs [N, obs_dim], action [N, action_dim] in the canonical (−1, 1) box,
and reward/terminated/truncated [N] float32.
"""

from __future__ import annotations

from typing import NamedTuple, Protocol, Tuple

import torch


class EnvState(NamedTuple):
    """Generic batched env state: physics [N, ...] + step counter [N]."""

    physics: torch.Tensor
    t: torch.Tensor


class Env(Protocol):
    observation_dim: int
    action_dim: int
    max_episode_steps: int

    def reset(
        self, n: int, generator: torch.Generator, device=None
    ) -> Tuple[EnvState, torch.Tensor]: ...

    def step(self, state: EnvState, action: torch.Tensor): ...

    def reset_where(
        self, state: EnvState, obs: torch.Tensor, done: torch.Tensor,
        generator: torch.Generator,
    ) -> Tuple[EnvState, torch.Tensor]: ...
