"""Host (NumPy) twin of :mod:`d4pg_tpu_torch.envs.pixel_pendulum`: the
port's own copy of ``d4pg_tpu/envs/pixel_pendulum_host.py``.

The same physics (classic gym Pendulum: g=10, m=1, l=1, dt=0.05) and the
same anti-aliased two-channel arm render in float32 NumPy, for one env
stepped on the host with no tensor library near it: the env a host actor
process can run (ROADMAP A5 (d)'s actor pool). A learner training on
``pixel_pendulum`` consumes its transitions as the same MDP.

Interface: the host-env shape (``reset(seed) → obs``, ``step(a) → (obs,
r, terminated, truncated, info)``), flat [0, 1] float32 observations of
``H·W·2`` values.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _angle_normalize(x: float) -> float:
    return ((x + np.pi) % (2 * np.pi)) - np.pi


def render_arm_np(theta: float, size: int, arm_frac: float = 0.4,
                  width_px: float = 1.2) -> np.ndarray:
    """NumPy twin of :func:`d4pg_tpu_torch.envs.pixel_pendulum.render_arm`
    for one angle: the same smooth-stroke formula, term for term, in
    float32."""
    c = np.float32((size - 1) / 2.0)
    length = np.float32(arm_frac * size)
    theta = np.float32(theta)
    ex = c + length * np.sin(theta)
    ey = c - length * np.cos(theta)
    rows = np.arange(size, dtype=np.float32)
    cols = np.arange(size, dtype=np.float32)
    py, px = np.meshgrid(rows, cols, indexing="ij")
    dx, dy = ex - c, ey - c
    seg_len_sq = dx * dx + dy * dy + np.float32(1e-8)
    t = np.clip(((px - c) * dx + (py - c) * dy) / seg_len_sq, 0.0, 1.0)
    nearest_x = c + t * dx
    nearest_y = c + t * dy
    dist = np.sqrt((px - nearest_x) ** 2 + (py - nearest_y) ** 2)
    z = (np.float32(width_px) - dist) / np.float32(0.5)
    return (1.0 / (1.0 + np.exp(-z))).astype(np.float32)


class PixelPendulumHost:
    """One pixel pendulum in NumPy, stepped on the host."""

    action_dim = 1
    v_min = -300.0
    v_max = 0.0

    def __init__(self, size: int = 48, max_episode_steps: int = 200,
                 g: float = 10.0, max_torque: float = 2.0, dt: float = 0.05):
        self.size = int(size)
        self.pixel_shape = (self.size, self.size, 2)
        self.observation_dim = self.size * self.size * 2
        self.max_episode_steps = int(max_episode_steps)
        self.g, self.max_torque, self.dt = g, max_torque, dt
        self.m, self.l, self.max_speed = 1.0, 1.0, 8.0
        self._rng = np.random.default_rng()
        self._theta = 0.0
        self._thetadot = 0.0
        self._t = 0

    def _obs(self) -> np.ndarray:
        now = render_arm_np(self._theta, self.size)
        prev = render_arm_np(self._theta - self._thetadot * self.dt, self.size)
        return np.stack([now, prev], axis=-1).reshape(-1)

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._theta = float(self._rng.uniform(-np.pi, np.pi))
        self._thetadot = float(self._rng.uniform(-1.0, 1.0))
        self._t = 0
        return self._obs()

    def set_state(self, theta: float, thetadot: float) -> np.ndarray:
        """Pin the physics state (the parity tests drive this env and the
        batched one through the same states)."""
        self._theta, self._thetadot = float(theta), float(thetadot)
        return self._obs()

    def step(self, action: np.ndarray):
        u = float(np.clip(np.asarray(action).reshape(-1)[0], -1.0, 1.0))
        u *= self.max_torque
        cost = (
            _angle_normalize(self._theta) ** 2
            + 0.1 * self._thetadot**2
            + 0.001 * u**2
        )
        thetadot = self._thetadot + (
            3 * self.g / (2 * self.l) * np.sin(self._theta)
            + 3.0 / (self.m * self.l**2) * u
        ) * self.dt
        self._thetadot = float(np.clip(thetadot, -self.max_speed, self.max_speed))
        self._theta = self._theta + self._thetadot * self.dt
        self._t += 1
        truncated = self._t >= self.max_episode_steps
        return self._obs(), -cost, False, truncated, {}

    def close(self) -> None:
        pass
