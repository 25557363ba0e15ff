"""Planar locomotion envs on the device, batched over N envs (counterpart
of the planar half of ``d4pg_tpu/envs/locomotion.py``).

HalfCheetah, Hopper and Walker2d with gymnasium v5's observation layout
(``qpos[1:] ++ qvel``), rewards (forward velocity − control cost, plus the
healthy bonus of Hopper and Walker2d), reset noise and termination, over
the planar engine of :mod:`d4pg_tpu_torch.envs.planar` (penalty contacts,
the JAX package's documented difference from MuJoCo's soft-LCP). The
model data comes from the committed snapshot (``envs/assets/*.npz``); the
envs import neither ``mujoco`` nor ``gymnasium``.

The physics state is ``cat([q, q̇], -1)`` [N, 2·nq]. A row whose state
blows up (a non-finite value, or |q̇| ≥ 1e4) terminates with reward 0 and
its observation's non-finite values zeroed, so nothing non-finite reaches
the replay ring; every other reward is clipped to ±1e3.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from d4pg_tpu_torch.envs.api import EnvState
from d4pg_tpu_torch.envs.planar import PlanarModel, load_model, step_physics

_MODEL_CACHE: dict = {}


def _cached_model(asset: str) -> PlanarModel:
    if asset not in _MODEL_CACHE:
        _MODEL_CACHE[asset] = load_model(asset)
    return _MODEL_CACHE[asset]


def _state_finite(q: torch.Tensor, qd: torch.Tensor) -> torch.Tensor:
    """[N] bool: the row's physics state is finite and below blow-up speed."""
    return (
        torch.isfinite(q).all(-1)
        & torch.isfinite(qd).all(-1)
        & (qd.abs().amax(-1) < 1e4)
    )


def _sanitize_reward(reward: torch.Tensor, finite: torch.Tensor) -> torch.Tensor:
    """Zero the reward on a blown-up row and bound it elsewhere: a finite
    but diverging state can put a ~1e4 forward 'velocity' into the reward.
    Legit per-step rewards for these tasks are < ~10²."""
    reward = torch.nan_to_num(reward, nan=0.0, posinf=0.0, neginf=0.0)
    return torch.where(finite, reward.clamp(-1e3, 1e3), torch.zeros_like(reward))


class _PlanarLocomotion:
    """Shared reset/step machinery for the gym-v5-style planar tasks.

    Subclasses set the class attributes and override ``_is_healthy`` where
    semantics differ. Actions are the canonical (−1, 1) box (gym's
    ctrlrange for all three tasks), scaled by gear inside the engine.
    """

    asset: str
    nq: int
    observation_dim: int
    action_dim: int
    max_episode_steps = 1000
    mj_timestep: float           # MJCF opt.timestep
    frame_skip: int              # gym frame_skip → control dt
    substeps_per_frame: int      # penalty-contact substeps per MJCF step
    forward_reward_weight = 1.0
    ctrl_cost_weight: float
    healthy_reward = 0.0         # hopper/walker alive bonus
    reset_noise_scale: float
    uniform_vel_noise: bool      # v5: cheetah = N(0,s), hopper/walker = U(±s)
    vel_clip = math.inf          # hopper/walker clip qvel in obs to ±10

    def __init__(self, max_episode_steps: Optional[int] = None):
        self.model = _cached_model(self.asset)
        self.control_dt = self.mj_timestep * self.frame_skip
        self.n_substeps = self.frame_skip * self.substeps_per_frame
        self.substep_dt = self.mj_timestep / self.substeps_per_frame
        if max_episode_steps is not None:
            self.max_episode_steps = max_episode_steps
        self._qpos0: dict = {}

    def _split(self, physics: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return physics[:, : self.nq], physics[:, self.nq:]

    def _obs(self, q: torch.Tensor, qd: torch.Tensor) -> torch.Tensor:
        # gym v5 default excludes the absolute x position (qpos[0])
        if self.vel_clip != math.inf:
            qd = qd.clamp(-self.vel_clip, self.vel_clip)
        return torch.cat([q[:, 1:], qd], dim=-1)

    def _is_healthy(self, q: torch.Tensor, qd: torch.Tensor) -> torch.Tensor:
        return torch.ones(q.shape[0], dtype=torch.bool, device=q.device)

    def _init_qpos(self, device) -> torch.Tensor:
        dev = torch.device("cpu" if device is None else device)
        if dev not in self._qpos0:
            self._qpos0[dev] = torch.as_tensor(
                self.model.qpos0, dtype=torch.float32, device=dev
            )
        return self._qpos0[dev]

    def _draw(self, n: int, generator: torch.Generator, device) -> torch.Tensor:
        """gym v5: init_qpos (the XML pose) + U(±s); q̇ ~ U(±s) or s·N(0, 1)."""
        s = self.reset_noise_scale
        q = self._init_qpos(device) + (
            2.0 * torch.rand((n, self.nq), generator=generator, device=device) - 1.0
        ) * s
        if self.uniform_vel_noise:
            qd = (2.0 * torch.rand((n, self.nq), generator=generator, device=device) - 1.0) * s
        else:
            qd = s * torch.randn((n, self.nq), generator=generator, device=device)
        return torch.cat([q, qd], dim=-1)

    def reset(self, n: int, generator: torch.Generator, device=None) -> Tuple[EnvState, torch.Tensor]:
        physics = self._draw(n, generator, device)
        state = EnvState(physics=physics, t=torch.zeros(n, dtype=torch.int32, device=device))
        return state, self._obs(*self._split(physics))

    def reset_where(self, state: EnvState, obs: torch.Tensor, done: torch.Tensor,
                    generator: torch.Generator) -> Tuple[EnvState, torch.Tensor]:
        """Reset the envs where ``done`` is set; keep the others."""
        fresh = self._draw(obs.shape[0], generator, obs.device)
        mask = done.bool()
        physics = torch.where(mask[:, None], fresh, state.physics)
        t = torch.where(mask, torch.zeros_like(state.t), state.t)
        obs = torch.where(mask[:, None], self._obs(*self._split(fresh)), obs)
        return EnvState(physics=physics, t=t), obs

    def step(self, state: EnvState, action: torch.Tensor):
        a = action.clamp(-1.0, 1.0)
        q, qd = self._split(state.physics)
        q2, qd2 = step_physics(self.model, q, qd, a, self.n_substeps, self.substep_dt)
        x_velocity = (q2[:, 0] - q[:, 0]) / self.control_dt
        # a blow-up terminates (even for cheetah, whose _is_healthy is
        # constant True) and writes no non-finite value into the ring
        finite = _state_finite(q2, qd2)
        healthy = self._is_healthy(q2, qd2) & finite
        reward = (
            self.forward_reward_weight * x_velocity
            - self.ctrl_cost_weight * a.square().sum(-1)
            + self.healthy_reward * healthy.to(torch.float32)
        )
        reward = _sanitize_reward(reward, finite)
        t = state.t + 1
        terminated = 1.0 - healthy.to(torch.float32)
        truncated = (t >= self.max_episode_steps).to(torch.float32) * (1.0 - terminated)
        obs = torch.nan_to_num(self._obs(q2, qd2), nan=0.0, posinf=0.0, neginf=0.0)
        physics = torch.cat([q2, qd2], dim=-1)
        return EnvState(physics=physics, t=t), obs, reward, terminated, truncated


class HalfCheetah(_PlanarLocomotion):
    """HalfCheetah-v5 semantics: obs[17] = qpos[1:] (z, pitch, 6 joint
    angles) ++ qvel[9]; reward = x_velocity − 0.1·Σa²; never terminates;
    1000-step truncation. Control dt 0.05 (MuJoCo dt 0.01 × frame_skip 5)
    as 20 substeps of 2.5 ms."""

    asset = "half_cheetah.xml"
    nq = 9
    observation_dim = 17
    action_dim = 6
    mj_timestep = 0.01
    frame_skip = 5
    substeps_per_frame = 4
    ctrl_cost_weight = 0.1
    reset_noise_scale = 0.1
    uniform_vel_noise = False  # qvel ~ 0.1·N(0,1) (gym v5)
    v_min = 0.0
    v_max = 1000.0


class Hopper(_PlanarLocomotion):
    """Hopper-v5 semantics: obs[11] = qpos[1:] ++ clip(qvel, ±10); reward =
    1.0·healthy + x_velocity − 0.001·Σa²; terminates when unhealthy
    (z ≤ 0.7, |pitch| ≥ 0.2, or any state ≥ 100)."""

    asset = "hopper.xml"
    nq = 6
    observation_dim = 11
    action_dim = 3
    mj_timestep = 0.002
    frame_skip = 4
    substeps_per_frame = 1  # MJCF dt is already 2 ms
    ctrl_cost_weight = 1e-3
    healthy_reward = 1.0
    reset_noise_scale = 5e-3
    uniform_vel_noise = True
    vel_clip = 10.0
    v_min = 0.0
    v_max = 500.0

    def _is_healthy(self, q, qd):
        state = torch.cat([q[:, 2:], qd], dim=-1)
        return (q[:, 1] > 0.7) & (q[:, 2].abs() < 0.2) & (state.abs() < 100.0).all(-1)


class Walker2d(_PlanarLocomotion):
    """Walker2d-v5 semantics: obs[17] = qpos[1:] ++ clip(qvel, ±10); reward =
    1.0·healthy + x_velocity − 0.001·Σa²; terminates when unhealthy
    (z outside (0.8, 2.0) or |pitch| ≥ 1)."""

    asset = "walker2d.xml"
    nq = 9
    observation_dim = 17
    action_dim = 6
    mj_timestep = 0.002
    frame_skip = 4
    substeps_per_frame = 1
    ctrl_cost_weight = 1e-3
    healthy_reward = 1.0
    reset_noise_scale = 5e-3
    uniform_vel_noise = True
    vel_clip = 10.0
    v_min = 0.0
    v_max = 500.0

    def _is_healthy(self, q, qd):
        return (q[:, 1] > 0.8) & (q[:, 1] < 2.0) & (q[:, 2].abs() < 1.0)
