"""Environments: batched torch envs on the device (Pendulum and its pixel
variant, the goal point mass, the planar locomotion tasks, Humanoid and
Ant on the 3D engine) and the host env adapters (gymnasium ids,
dm_control ``dmc:`` ids and ``pixel_pendulum_host``) that the host actor
pool steps in worker processes.

Exports resolve lazily (PEP 562, :mod:`d4pg_tpu_torch._lazy`), and
:func:`make_env` imports the env it builds when it builds it, so a pool
worker that imports only :mod:`d4pg_tpu_torch.envs.gym_adapter` never
loads torch or the torch envs.
"""

from typing import Optional

# short name -> (module, class) of the batched torch envs
ENVS = {
    "pendulum": ("d4pg_tpu_torch.envs.pendulum", "Pendulum"),
    "pixel_pendulum": ("d4pg_tpu_torch.envs.pixel_pendulum", "PixelPendulum"),
    "pointmass_goal": ("d4pg_tpu_torch.envs.pointmass_goal", "PointMassGoal"),
    "halfcheetah": ("d4pg_tpu_torch.envs.locomotion", "HalfCheetah"),
    "hopper": ("d4pg_tpu_torch.envs.locomotion", "Hopper"),
    "walker2d": ("d4pg_tpu_torch.envs.locomotion", "Walker2d"),
    "humanoid": ("d4pg_tpu_torch.envs.locomotion", "Humanoid"),
    "ant": ("d4pg_tpu_torch.envs.locomotion", "Ant"),
}

_EXPORTS = {
    "Env": "d4pg_tpu_torch.envs.api",
    "EnvState": "d4pg_tpu_torch.envs.api",
    **{cls: module for module, cls in ENVS.values()},
    "DMControlAdapter": "d4pg_tpu_torch.envs.dmc_adapter",
    "GymAdapter": "d4pg_tpu_torch.envs.gym_adapter",
    "NormalizeAction": "d4pg_tpu_torch.envs.gym_adapter",
    "make_host_env": "d4pg_tpu_torch.envs.gym_adapter",
}


def _reject_action_repeat(name: str, action_repeat: int) -> None:
    # Gym MuJoCo envs already bake frame_skip into their control dt (and the
    # torch locomotion envs into their substep counts); the presets' value
    # ranges assume per-step reward scale. Repeat is a dm_control
    # (DrQ-convention) knob only.
    if action_repeat != 1:
        raise ValueError(
            f"--action-repeat is only supported for dmc:/dmc_pixels: envs "
            f"(got {name!r})"
        )


def make_env(name: str, max_episode_steps: Optional[int] = None, action_repeat: int = 1):
    """Build a batched torch env by short name (``max_episode_steps``
    overrides its episode limit; ``action_repeat`` must be 1, as the JAX
    package requires for these envs), or, for any other name, a host env
    through :func:`~d4pg_tpu_torch.envs.gym_adapter.make_host_env`, as the
    JAX ``make_env`` falls through to it."""
    import importlib

    if name not in ENVS:
        # gymnasium, dm_control and the host pixel env load only here
        from d4pg_tpu_torch.envs.gym_adapter import make_host_env

        return make_host_env(name, max_episode_steps, action_repeat=action_repeat)
    _reject_action_repeat(name, action_repeat)
    module, cls = ENVS[name]
    env = getattr(importlib.import_module(module), cls)()
    if max_episode_steps is not None:
        env.max_episode_steps = max_episode_steps
    return env


__all__ = ["ENVS", "make_env", *_EXPORTS]

from d4pg_tpu_torch._lazy import lazy_exports as _lazy_exports  # noqa: E402

__getattr__, __dir__ = _lazy_exports(__name__, _EXPORTS)
