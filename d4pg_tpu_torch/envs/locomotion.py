"""Locomotion envs on the device, batched over N envs (counterpart of
``d4pg_tpu/envs/locomotion.py``).

HalfCheetah, Hopper and Walker2d with gymnasium v5's observation layout
(``qpos[1:] ++ qvel``), rewards (forward velocity − control cost, plus the
healthy bonus of Hopper and Walker2d), reset noise and termination, over
the planar engine of :mod:`d4pg_tpu_torch.envs.planar`; Humanoid and Ant
with the JAX package's proprioceptive observations (``qpos[2:] ++ qvel``,
45 and 27 dims), rewards and termination over the 3D engine of
:mod:`d4pg_tpu_torch.envs.spatial`. Both engines use penalty contacts (the
JAX package's documented difference from MuJoCo's soft-LCP); the 3D tasks
also keep its other deviations: no self-collision and no contact-cost
term. The model data comes from the committed snapshots
(``envs/assets/*.npz``); the envs import neither ``mujoco`` nor
``gymnasium``.

The physics state is ``cat([q, v], -1)`` [N, nq + nv] (nv = nq on the
planar tasks). A row whose state blows up (a non-finite value, or |v| ≥
1e4) terminates with reward 0 and its observation's non-finite values
zeroed, so nothing non-finite reaches the replay ring; every other reward
is clipped to ±1e3.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from d4pg_tpu_torch.envs import planar, spatial
from d4pg_tpu_torch.envs.api import EnvState

_MODEL_CACHE: dict = {}


def _cached_model(engine, asset: str):
    key = (engine.__name__, asset)
    if key not in _MODEL_CACHE:
        _MODEL_CACHE[key] = engine.load_model(asset)
    return _MODEL_CACHE[key]


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


def _uniform(n: int, width: int, s: float, generator, device) -> torch.Tensor:
    return (2.0 * torch.rand((n, width), generator=generator, device=device) - 1.0) * s


class _Locomotion:
    """Reset machinery shared by the planar and the 3D tasks: the state is
    ``cat([q, v], -1)``; subclasses draw it (``_draw``) and read it
    (``_obs``)."""

    engine = planar
    asset: str
    nq: int
    nv: int
    max_episode_steps = 1000
    mj_timestep: float           # MJCF opt.timestep
    frame_skip: int              # gym frame_skip → control dt
    substeps_per_frame: int      # penalty-contact substeps per MJCF step

    def __init__(self, max_episode_steps: Optional[int] = None):
        self.model = _cached_model(self.engine, self.asset)
        self.control_dt = self.mj_timestep * self.frame_skip
        self.n_substeps = self.frame_skip * self.substeps_per_frame
        self.substep_dt = self.mj_timestep / self.substeps_per_frame
        if max_episode_steps is not None:
            self.max_episode_steps = max_episode_steps
        self._qpos0: dict = {}

    def _split(self, physics: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return physics[:, : self.nq], physics[:, self.nq:]

    def _init_qpos(self, device) -> torch.Tensor:
        dev = torch.device("cpu" if device is None else device)
        if dev not in self._qpos0:
            self._qpos0[dev] = torch.as_tensor(
                self.model.qpos0, dtype=torch.float32, device=dev
            )
        return self._qpos0[dev]

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

    def _finish(self, state: EnvState, q2, qd2, reward, healthy, finite):
        """The step's outputs from the new state, its raw reward and health."""
        reward = _sanitize_reward(reward, finite)
        t = state.t + 1
        terminated = 1.0 - healthy.to(torch.float32)
        truncated = (t >= self.max_episode_steps).to(torch.float32) * (1.0 - terminated)
        obs = torch.nan_to_num(self._obs(q2, qd2), nan=0.0, posinf=0.0, neginf=0.0)
        physics = torch.cat([q2, qd2], dim=-1)
        return EnvState(physics=physics, t=t), obs, reward, terminated, truncated


class _PlanarLocomotion(_Locomotion):
    """Shared step machinery for the gym-v5-style planar tasks.

    Subclasses set the class attributes and override ``_is_healthy`` where
    semantics differ. Actions are the canonical (−1, 1) box (gym's
    ctrlrange for all three tasks), scaled by gear inside the engine.
    """

    forward_reward_weight = 1.0
    ctrl_cost_weight: float
    healthy_reward = 0.0         # hopper/walker alive bonus
    reset_noise_scale: float
    uniform_vel_noise: bool      # v5: cheetah = N(0,s), hopper/walker = U(±s)
    vel_clip = math.inf          # hopper/walker clip qvel in obs to ±10

    @property
    def nv(self) -> int:
        return self.nq

    def _obs(self, q: torch.Tensor, qd: torch.Tensor) -> torch.Tensor:
        # gym v5 default excludes the absolute x position (qpos[0])
        if self.vel_clip != math.inf:
            qd = qd.clamp(-self.vel_clip, self.vel_clip)
        return torch.cat([q[:, 1:], qd], dim=-1)

    def _is_healthy(self, q: torch.Tensor, qd: torch.Tensor) -> torch.Tensor:
        return torch.ones(q.shape[0], dtype=torch.bool, device=q.device)

    def _draw(self, n: int, generator: torch.Generator, device) -> torch.Tensor:
        """gym v5: init_qpos (the XML pose) + U(±s); q̇ ~ U(±s) or s·N(0, 1)."""
        s = self.reset_noise_scale
        q = self._init_qpos(device) + _uniform(n, self.nq, s, generator, device)
        if self.uniform_vel_noise:
            qd = _uniform(n, self.nq, s, generator, device)
        else:
            qd = s * torch.randn((n, self.nq), generator=generator, device=device)
        return torch.cat([q, qd], dim=-1)

    def step(self, state: EnvState, action: torch.Tensor):
        a = action.clamp(-1.0, 1.0)
        q, qd = self._split(state.physics)
        q2, qd2 = planar.step_physics(self.model, q, qd, a, self.n_substeps, self.substep_dt)
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
        return self._finish(state, q2, qd2, reward, healthy, finite)


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


class _SpatialLocomotion(_Locomotion):
    """Shared step machinery for the gym-v5-style 3D tasks over the
    spatial engine (free-joint root: qpos[0:2], the planar position, is
    left out of the observation; qpos[2], the height, drives the healthy
    check). Reward = healthy·bonus + w·ẋ − c·Σctrl², with ctrl =
    clip(a, −1, 1)·ctrl_hi; gym's contact-cost term is left out, as in the
    JAX package (the penalty contacts have no cfrc_ext)."""

    engine = spatial
    forward_reward_weight: float
    ctrl_cost_weight: float
    healthy_reward: float
    reset_noise_scale: float
    uniform_vel_noise = True  # humanoid: U(±s); ant: s·N(0, 1)
    healthy_z: tuple

    def __init__(self, max_episode_steps: Optional[int] = None):
        super().__init__(max_episode_steps)
        self.nq, self.nv = self.model.nq, self.model.nv
        self._consts: dict = {}

    def _const(self, device):
        """(ctrl_hi, body masses / total mass) on ``device``, made once."""
        dev = torch.device("cpu" if device is None else device)
        if dev not in self._consts:
            m = torch.as_tensor(self.model.mass, dtype=torch.float32, device=dev)
            self._consts[dev] = (
                torch.as_tensor(self.model.ctrl_hi, dtype=torch.float32, device=dev),
                m / m.sum(),
            )
        return self._consts[dev]

    def _obs(self, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return torch.cat([q[:, 2:], v], dim=-1)

    def _forward_x(self, q: torch.Tensor) -> torch.Tensor:
        """x whose finite difference is the forward velocity: the
        mass-weighted COM of the whole model (Humanoid-v5); Ant overrides
        it with the torso's."""
        coms, _ = spatial.body_coms(self.model, q)
        return (self._const(q.device)[1] * coms[..., 0]).sum(-1)

    def _draw(self, n: int, generator: torch.Generator, device) -> torch.Tensor:
        """qpos0 + U(±s) over all of q, the root quaternion renormalised;
        v ~ U(±s) or s·N(0, 1)."""
        s = self.reset_noise_scale
        q = self._init_qpos(device) + _uniform(n, self.nq, s, generator, device)
        quat = q[:, 3:7]
        q = torch.cat([q[:, :3], quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True),
                       q[:, 7:]], dim=-1)
        if self.uniform_vel_noise:
            v = _uniform(n, self.nv, s, generator, device)
        else:
            v = s * torch.randn((n, self.nv), generator=generator, device=device)
        return torch.cat([q, v], dim=-1)

    def step(self, state: EnvState, action: torch.Tensor):
        ctrl = action.clamp(-1.0, 1.0) * self._const(action.device)[0]
        q, v = self._split(state.physics)
        q2, v2 = spatial.step_physics(self.model, q, v, ctrl, self.n_substeps, self.substep_dt)
        x = self._forward_x(torch.cat([q, q2], 0))
        n = q.shape[0]
        x_velocity = (x[n:] - x[:n]) / self.control_dt
        # a blow-up (one in ~3M steps in the JAX package's runs) terminates
        # and writes nothing non-finite into the ring: a NaN height fails
        # both comparisons, the finiteness guard catches the rest
        finite = _state_finite(q2, v2)
        z = q2[:, 2]
        healthy = (z > self.healthy_z[0]) & (z < self.healthy_z[1]) & finite
        reward = (
            self.forward_reward_weight * x_velocity
            - self.ctrl_cost_weight * ctrl.square().sum(-1)
            + self.healthy_reward * healthy.to(torch.float32)
        )
        return self._finish(state, q2, v2, reward, healthy, finite)


class Humanoid(_SpatialLocomotion):
    """Humanoid-v5 semantics over the 3D engine. State (qpos[24],
    qvel[23]); obs[45] = qpos[2:] (z, root quaternion, 17 hinge angles) ++
    qvel, the proprioceptive core of gym's 348-dim observation. Reward =
    5.0·healthy + 1.25·ẋ_com − 0.1·Σctrl² (ctrl = 0.4·action, the MJCF
    ctrlrange). Terminates when the torso z leaves (1.0, 2.0). Reset noise
    U(±0.01) on qpos and qvel. Control dt 0.015 (MuJoCo dt 0.003 × frame
    skip 5) as 10 substeps of 1.5 ms."""

    asset = "humanoid.xml"
    observation_dim = 45
    action_dim = 17
    mj_timestep = 0.003
    frame_skip = 5
    substeps_per_frame = 2   # 1.5 ms substeps keep the penalty feet stable
    forward_reward_weight = 1.25
    ctrl_cost_weight = 0.1
    healthy_reward = 5.0
    reset_noise_scale = 1e-2
    uniform_vel_noise = True
    healthy_z = (1.0, 2.0)


class Ant(_SpatialLocomotion):
    """Ant-v5 semantics over the same engine: obs[27] = qpos[2:] ++ qvel.
    Reward = 1.0·healthy + ẋ_torso − 0.5·Σctrl² (Ant-v5 tracks the torso
    body's x, not the whole-model COM); terminates when the torso z leaves
    (0.2, 1.0). Reset noise: qpos U(±0.1), qvel 0.1·N(0, 1). Control dt
    0.05 as 20 substeps of 2.5 ms."""

    asset = "ant.xml"
    observation_dim = 27
    action_dim = 8
    mj_timestep = 0.01
    frame_skip = 5
    substeps_per_frame = 4   # 2.5 ms substeps
    forward_reward_weight = 1.0
    ctrl_cost_weight = 0.5
    healthy_reward = 1.0
    reset_noise_scale = 0.1
    uniform_vel_noise = False
    healthy_z = (0.2, 1.0)

    def _forward_x(self, q: torch.Tensor) -> torch.Tensor:
        # body 0 is the free-joint root (the torso); its COM is the sphere
        # centre, the frame origin gymnasium's get_body_com("torso") reads
        coms, _ = spatial.body_coms(self.model, q)
        return coms[:, 0, 0]
