"""Host-side gymnasium adapter with the reference's env conventions (the
port's own copy of ``d4pg_tpu/envs/gym_adapter.py``).

Covers reference ``normalize_env.py`` (affine (−1,1)→[low,high] action map),
the ``TimeLimit`` unwrap + ``_max_episode_steps`` override (``main.py:68-69``)
and goal-dict flattening (``main.py:73-79,144``). gymnasium is optional: the
adapter import-gates it so the torch envs work without it (the H100's
machine has neither gymnasium nor dm_control; ``pixel_pendulum_host`` needs
neither).

This module imports numpy only (and gymnasium, dm_control or the pixel env
when :func:`make_host_env` builds one): it is what a host actor-pool worker
imports, and it must not load torch.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from d4pg_tpu_torch.envs import _reject_action_repeat

try:
    import gymnasium as _gym
except ImportError:  # pragma: no cover
    _gym = None


class NormalizeAction:
    """Affine map of canonical (−1, 1) actions onto the env's Box bounds and
    back (reference ``normalize_env.py:4-14``)."""

    def __init__(self, low: np.ndarray, high: np.ndarray):
        self.low = np.asarray(low, np.float32)
        self.high = np.asarray(high, np.float32)

    def to_env(self, action: np.ndarray) -> np.ndarray:
        action = np.clip(action, -1.0, 1.0)
        return self.low + (action + 1.0) * 0.5 * (self.high - self.low)

    def to_canonical(self, action: np.ndarray) -> np.ndarray:
        scaled = 2.0 * (action - self.low) / (self.high - self.low) - 1.0
        return np.clip(scaled, -1.0, 1.0)


class GymAdapter:
    """Flat functional-ish interface over a gymnasium env.

    ``reset(seed) -> obs`` and ``step(action) -> (obs, reward, terminated,
    truncated, info)`` with canonical (−1,1) actions and goal-dict obs
    flattened to ``concat(observation, desired_goal)`` (reference
    ``main.py:73-79``). Goal components stay available via
    ``last_goal_obs`` for HER relabeling.
    """

    def __init__(self, env_id: str, max_episode_steps: Optional[int] = None):
        if _gym is None:
            raise ImportError(
                "gymnasium is not installed; use the torch envs in d4pg_tpu_torch.envs"
            )
        try:
            env = _gym.make(env_id)
        except _gym.error.NameNotFound as not_found:
            # The goal-dict robotics family (FetchReach/FetchPush/…) the
            # reference's loop is built around (main.py:144-148,161-184)
            # ships in gymnasium_robotics, which registers its ids only on
            # import. Register lazily and retry — only on miss, so the
            # common path pays nothing; if the package isn't installed the
            # original NameNotFound (with gymnasium's did-you-mean hint)
            # propagates, not a misleading missing-package error.
            try:
                import gymnasium_robotics
            except ImportError:
                raise not_found
            _gym.register_envs(gymnasium_robotics)
            env = _gym.make(env_id)
        if max_episode_steps is not None:
            # reference overrides _max_episode_steps (main.py:69)
            env = _gym.wrappers.TimeLimit(env.unwrapped, max_episode_steps)
        self.env = env
        # Effective episode limit (explicit override, else the registry's),
        # surfaced so trainers don't guess-rewrap with a different limit.
        self.max_episode_steps = (
            max_episode_steps
            if max_episode_steps is not None
            else getattr(getattr(env, "spec", None), "max_episode_steps", None)
        )
        space = env.action_space
        if not hasattr(space, "high"):
            raise ValueError(
                f"{env_id} has a discrete action space; DDPG needs a Box "
                "(reference exits likewise, main.py:70-72)"
            )
        self._normalize = NormalizeAction(space.low, space.high)
        obs_space = env.observation_space
        self.is_goal_env = hasattr(obs_space, "spaces") and "desired_goal" in getattr(
            obs_space, "spaces", {}
        )
        if self.is_goal_env:
            sp = obs_space.spaces
            self.observation_dim = int(
                np.prod(sp["observation"].shape) + np.prod(sp["desired_goal"].shape)
            )
        else:
            self.observation_dim = int(np.prod(obs_space.shape))
        self.action_dim = int(np.prod(space.shape))
        self.last_goal_obs: Any = None
        # Categorical-support hint consumed by reconcile_config's
        # getattr(env, "v_min"/"v_max") fallback, so gym ids outside
        # ENV_PRESETS do not train on the Pendulum default support. An
        # explicit --v-min/--v-max still wins.
        if env_id in ENV_VALUE_RANGES:
            self.v_min, self.v_max = ENV_VALUE_RANGES[env_id]

    def _flatten(self, obs) -> np.ndarray:
        if self.is_goal_env:
            self.last_goal_obs = obs
            return np.concatenate(
                [np.ravel(obs["observation"]), np.ravel(obs["desired_goal"])]
            ).astype(np.float32)
        return np.ravel(obs).astype(np.float32)

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        obs, _ = self.env.reset(seed=seed)
        return self._flatten(obs)

    def step(self, action: np.ndarray):
        obs, reward, terminated, truncated, info = self.env.step(
            self._normalize.to_env(np.asarray(action))
        )
        if self.is_goal_env and not terminated:
            # The reference takes done from info['is_success'] for goal envs
            # (main.py:144-148): success TERMINATES the episode. This is
            # load-bearing for the sparse -1/0 value structure — the Fetch
            # envs themselves never terminate, and without success-cuts the
            # infinite-horizon value of "stuck far from goal" is
            # -1/(1-gamma) = -100, outside the [-horizon, 0] support the
            # bounded-episode convention implies. It also matches the HER
            # writer's done_on_success=True relabel convention
            # (replay/her.py), which the original trajectory must share.
            terminated = bool(info.get("is_success", False))
        return self._flatten(obs), float(reward), bool(terminated), bool(truncated), info

    def to_canonical_action(self, action: np.ndarray) -> np.ndarray:
        """Env-scale → canonical (−1, 1): the inverse of the map ``step``
        applies. The flywheel sim client needs it because the SERVE wire
        speaks env-scale (the bundle's action bounds) while the env
        adapter, the replay buffer, and the NumPy bundle policy all
        speak canonical."""
        return self._normalize.to_canonical(np.asarray(action))

    def compute_reward(self, achieved_goal, desired_goal) -> float:
        return float(
            self.env.unwrapped.compute_reward(achieved_goal, desired_goal, {})
        )

    def close(self):
        self.env.close()


# Value-range presets per env (replaces the reference's configure_env_params,
# main.py:84-99, which hardcodes Pendulum and comments the rest out).
ENV_VALUE_RANGES = {
    # ONLY ids absent from config.ENV_PRESETS belong here:
    # reconcile_config checks ENV_PRESETS first, so an entry duplicated
    # in both tables would silently not take effect. Pendulum-v1,
    # HalfCheetah-v4/v5 and Humanoid-v4/v5 live in ENV_PRESETS.
    "Hopper-v4": (0.0, 500.0),
    "Hopper-v5": (0.0, 500.0),
    "Walker2d-v4": (0.0, 500.0),
    "Walker2d-v5": (0.0, 500.0),
    # Sparse goal-dict robotics: reward is −1 per non-success step over a
    # 50-step limit, so returns live in [−50, 0] (same shape as the
    # pointmass_goal preset the HER path was built against).
    "FetchReach-v4": (-50.0, 0.0),
    "FetchPush-v4": (-50.0, 0.0),
    "FetchSlide-v4": (-50.0, 0.0),
    "FetchPickAndPlace-v4": (-50.0, 0.0),
}


def make_host_env(
    name: str,
    max_episode_steps: Optional[int] = None,
    action_repeat: int = 1,
):
    """Build a HOST env (gymnasium id, dm_control ``dmc:``/``dmc_pixels:``
    or ``pixel_pendulum_host``) without importing torch or any torch env:
    the single dispatch point shared by
    :func:`d4pg_tpu_torch.envs.make_env` and the actor-pool workers."""
    if name.startswith(("dmc:", "dmc_pixels:")):
        from d4pg_tpu_torch.envs.dmc_adapter import make_dmc

        return make_dmc(name, max_episode_steps, action_repeat=action_repeat)
    _reject_action_repeat(name, action_repeat)
    if name == "pixel_pendulum_host":
        # The NumPy twin of the batched pixel_pendulum: what a host actor
        # process runs when the learner trains the pixel env (the same
        # MDP, its render and physics parity-tested).
        from d4pg_tpu_torch.envs.pixel_pendulum_host import PixelPendulumHost

        return PixelPendulumHost(
            max_episode_steps=max_episode_steps or 200
        )
    return GymAdapter(name, max_episode_steps)

