"""Batched torch environments on the device: Pendulum and its pixel
variant, the goal point mass, the planar locomotion tasks and Humanoid
and Ant on the 3D engine (ROADMAP A5 (d) lists the host envs still to
come)."""

from typing import Optional

from d4pg_tpu_torch.envs.api import Env, EnvState
from d4pg_tpu_torch.envs.locomotion import Ant, HalfCheetah, Hopper, Humanoid, Walker2d
from d4pg_tpu_torch.envs.pendulum import Pendulum
from d4pg_tpu_torch.envs.pixel_pendulum import PixelPendulum
from d4pg_tpu_torch.envs.pointmass_goal import PointMassGoal

ENVS = {
    "pendulum": Pendulum,
    "pixel_pendulum": PixelPendulum,
    "pointmass_goal": PointMassGoal,
    "halfcheetah": HalfCheetah,
    "hopper": Hopper,
    "walker2d": Walker2d,
    "humanoid": Humanoid,
    "ant": Ant,
}


def _reject_action_repeat(name: str, action_repeat: int) -> None:
    # the locomotion envs already bake frame_skip into their substep counts,
    # and the presets' value ranges assume per-step reward scale
    if action_repeat != 1:
        raise ValueError(
            f"--action-repeat is only supported for dmc:/dmc_pixels: envs "
            f"(got {name!r})"
        )


def make_env(name: str, max_episode_steps: Optional[int] = None, action_repeat: int = 1):
    """Build a batched env by short name; ``max_episode_steps`` overrides
    its episode limit. ``action_repeat`` must be 1, as the JAX package
    requires for these envs."""
    if name not in ENVS:
        raise NotImplementedError(
            f"env {name!r} is not ported to d4pg_tpu_torch yet (ROADMAP A9: "
            f"on-device envs; A5 (d): gym ids through the host env adapters); "
            f"available: {sorted(ENVS)}"
        )
    _reject_action_repeat(name, action_repeat)
    env = ENVS[name]()
    if max_episode_steps is not None:
        env.max_episode_steps = max_episode_steps
    return env


__all__ = [
    "ENVS", "Ant", "Env", "EnvState", "HalfCheetah", "Hopper", "Humanoid", "Pendulum",
    "PixelPendulum", "PointMassGoal", "Walker2d", "make_env",
]
