"""Batched pixel-observation Pendulum on the device (counterpart of
``d4pg_tpu/envs/pixel_pendulum.py``).

The physics, reward, resets and episode limit are :class:`~d4pg_tpu_torch.
envs.pendulum.Pendulum`'s; the observation is a rendered image of the arm
instead of (cos θ, sin θ, θ̇). :func:`render_arm` draws a line segment from
the frame's centre at angle θ as a smooth stroke, ``sigmoid((width −
distance to the segment) / 0.5)``, in float32 tensor math on the envs'
device, the JAX formula term for term. A second channel renders the arm
at its previous position θ − θ̇·dt, so the observation shows the velocity
(a 2-frame stack folded into channels).

Observations are emitted flattened, ``[N, H·W·2]`` float32 in [0, 1]:
every pipeline stage (collection, n-step writers, replay, the rings)
carries a flat column, and the networks reshape it in front of their
:class:`~d4pg_tpu_torch.models.encoders.PixelEncoder` (``pixel_shape``).
"""

from __future__ import annotations

import torch

from d4pg_tpu_torch.envs.pendulum import Pendulum


def render_arm(theta: torch.Tensor, size: int, arm_frac: float = 0.4,
               width_px: float = 1.2) -> torch.Tensor:
    """[N, size, size] frames of a pendulum arm at angles ``theta`` [N].
    θ = 0 is up; rows grow downward."""
    c = (size - 1) / 2.0
    length = arm_frac * size
    ex = c + length * torch.sin(theta)
    ey = c - length * torch.cos(theta)
    rows = torch.arange(size, dtype=torch.float32, device=theta.device)
    py, px = torch.meshgrid(rows, rows, indexing="ij")
    dx = (ex - c)[:, None, None]
    dy = (ey - c)[:, None, None]
    seg_len_sq = dx * dx + dy * dy + 1e-8
    t = (((px - c) * dx + (py - c) * dy) / seg_len_sq).clamp(0.0, 1.0)
    nearest_x = c + t * dx
    nearest_y = c + t * dy
    dist = torch.sqrt((px - nearest_x) ** 2 + (py - nearest_y) ** 2)
    return torch.sigmoid((width_px - dist) / 0.5)


class PixelPendulum(Pendulum):
    """Pendulum with rendered-image observations, flattened to [N, H·W·2]."""

    def __init__(self, size: int = 48, **pendulum_kwargs):
        super().__init__(**pendulum_kwargs)
        self.size = size
        self.pixel_shape = (size, size, 2)
        self.observation_dim = size * size * 2

    def _obs(self, physics: torch.Tensor) -> torch.Tensor:
        theta, thetadot = physics[:, 0], physics[:, 1]
        now = render_arm(theta, self.size)
        prev = render_arm(theta - thetadot * self.dt, self.size)
        return torch.stack([now, prev], dim=-1).reshape(physics.shape[0], -1)
