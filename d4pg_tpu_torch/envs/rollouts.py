"""Segment rollouts over a batch of envs on the device (counterpart of
``d4pg_tpu/envs/rollouts.py``).

The JAX package scans one env over T steps and vmaps that over N envs.
Here the N envs step together as one set of tensor ops and the T steps
are a Python loop over :func:`rollout_step`; the trajectory comes back
stacked as [N, T, ...]. The on-device loop calls :func:`rollout_step`
itself, one compiled program a step (``runtime/collect.py``).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from d4pg_tpu_torch.envs.api import EnvState


class Trajectory(NamedTuple):
    """[N, T, ...] stacked transitions of one rollout segment."""

    obs: torch.Tensor
    action: torch.Tensor
    reward: torch.Tensor
    next_obs: torch.Tensor
    terminated: torch.Tensor
    truncated: torch.Tensor


def _where(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``mask`` [N] selects rows of ``a`` over ``b``, broadcasting over the
    trailing axes."""
    return torch.where(mask.view(-1, *([1] * (a.dim() - 1))), a, b)


@torch.no_grad()
def rollout_step(
    env,
    policy: Callable,
    generator: torch.Generator,
    state: EnvState,
    obs: torch.Tensor,
    pstate: Any,
    policy_state_reset: Callable | None = None,
):
    """One step of every env under ``policy`` (see :func:`rollout`):
    returns (state, obs, policy_state, transition), where ``transition``
    is (obs, action, reward, next_obs, terminated, truncated) in
    :class:`Trajectory` field order, ``next_obs`` before the auto-reset."""
    action, pstate = policy(obs, generator, pstate)
    state2, obs2, reward, terminated, truncated = env.step(state, action)
    done = torch.maximum(terminated, truncated)
    transition = (obs, action, reward, obs2, terminated, truncated)
    state, obs = env.reset_where(state2, obs2, done, generator)
    if policy_state_reset is not None:
        mask = done.bool()
        reset = policy_state_reset(pstate)
        pstate = type(pstate)(*(_where(mask, r, s) for r, s in zip(reset, pstate)))
    return state, obs, pstate, transition


@torch.no_grad()
def rollout(
    env,
    policy: Callable,
    generator: torch.Generator,
    num_steps: int,
    init_state: EnvState,
    init_obs: torch.Tensor,
    policy_state: Any,
    policy_state_reset: Callable | None = None,
):
    """Roll ``num_steps`` steps of every env under a stateful policy
    ``policy(obs, generator, pstate) -> (action, pstate)``.

    An env whose episode ends (terminated or truncated) is reset in place,
    and its policy state passes through ``policy_state_reset`` (the
    per-episode noise reset), so the segment is always exactly
    ``num_steps`` transitions per env. ``next_obs`` is the observation
    before the reset. Returns (final_state, final_obs, final_policy_state,
    Trajectory).
    """
    state, obs, pstate = init_state, init_obs, policy_state
    cols = {k: [] for k in Trajectory._fields}
    for _ in range(num_steps):
        state, obs, pstate, transition = rollout_step(
            env, policy, generator, state, obs, pstate, policy_state_reset)
        for k, v in zip(Trajectory._fields, transition):
            cols[k].append(v)
    traj = Trajectory(**{k: torch.stack(v, dim=1) for k, v in cols.items()})
    return state, obs, pstate, traj
