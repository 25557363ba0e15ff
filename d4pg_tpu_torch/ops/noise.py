"""Exploration noise over an explicit state and an explicit generator.

Counterpart of ``d4pg_tpu/ops/noise.py`` (Gaussian and Ornstein-Uhlenbeck).
The JAX package vmaps a per-env state over the envs; here the state is
batched: ``epsilon`` broadcasts against the action block ([N, 1] for N
envs, or a scalar) and the OU value ``x`` is [N, action_dim]. Random draws
come from the ``torch.Generator`` the caller passes, never from the global
RNG.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class GaussianNoiseState(NamedTuple):
    epsilon: torch.Tensor  # scale multiplier, decayed on reset


class OUNoiseState(NamedTuple):
    x: torch.Tensor  # mean-reverting process value, [..., action_dim]
    epsilon: torch.Tensor


def gaussian_noise_init(
    epsilon: float = 0.3, batch: tuple = (), device=None
) -> GaussianNoiseState:
    return GaussianNoiseState(
        epsilon=torch.full(batch, float(epsilon), dtype=torch.float32, device=device)
    )


def gaussian_noise_sample(
    state: GaussianNoiseState,
    generator: torch.Generator,
    shape: tuple,
    mu: float = 0.0,
    sigma: float = 1.0,
) -> torch.Tensor:
    """ε·N(μ, σ)."""
    n = torch.randn(
        shape, generator=generator, device=state.epsilon.device, dtype=torch.float32
    )
    return state.epsilon * (mu + sigma * n)


def gaussian_noise_reset(
    state: GaussianNoiseState, decay: float = 0.001, epsilon_min: float = 0.0
) -> GaussianNoiseState:
    """Per-episode exponential ε decay."""
    return GaussianNoiseState(
        epsilon=torch.clamp_min(state.epsilon * (1.0 - decay), epsilon_min)
    )


def ou_noise_init(
    action_dim: int,
    epsilon: float = 1.0,
    x0: float = 0.0,
    batch: tuple = (),
    device=None,
) -> OUNoiseState:
    eps_shape = batch + (1,) if batch else ()
    return OUNoiseState(
        x=torch.full(batch + (action_dim,), float(x0), dtype=torch.float32, device=device),
        epsilon=torch.full(eps_shape, float(epsilon), dtype=torch.float32, device=device),
    )


def ou_noise_sample(
    state: OUNoiseState,
    generator: torch.Generator,
    theta: float = 0.15,
    mu: float = 0.0,
    sigma: float = 0.2,
    dt: float = 1e-2,
) -> tuple[torch.Tensor, OUNoiseState]:
    """x ← x + θ(μ−x)dt + σ√dt·N(0,1); returns (ε·x, new state)."""
    n = torch.randn(
        state.x.shape, generator=generator, device=state.x.device, dtype=torch.float32
    )
    x = state.x + (theta * (mu - state.x) * dt + sigma * dt**0.5 * n)
    return state.epsilon * x, OUNoiseState(x=x, epsilon=state.epsilon)


def ou_noise_reset(
    state: OUNoiseState,
    decay: float = 0.001,
    epsilon_min: float = 0.0,
    x0: float = 0.0,
) -> OUNoiseState:
    return OUNoiseState(
        x=torch.full_like(state.x, x0),
        epsilon=torch.clamp_min(state.epsilon * (1.0 - decay), epsilon_min),
    )
