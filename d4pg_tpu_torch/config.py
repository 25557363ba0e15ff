"""Run configuration of the port (counterpart of ``d4pg_tpu/config.py``).

``TrainConfig`` keeps the JAX package's field names and defaults for the
knobs this slice honours, and has no field for an option it does not
carry: the CLI refuses those by name (``train.UNPORTED_FLAGS``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

from d4pg_tpu_torch.agent.state import D4PGConfig


@dataclass(frozen=True)
class TrainConfig:
    env: str = "pendulum"
    max_episode_steps: Optional[int] = None  # None → env default
    num_envs: int = 16
    total_steps: int = 100_000         # learner grad steps
    warmup_steps: int = 1_000          # env steps before learning
    env_steps_per_train_step: float = 1.0
    batch_size: int = 256
    replay_capacity: Optional[int] = None  # None → 1M
    prioritized: bool = True
    n_step: int = 3
    eval_interval: int = 2_000         # grad steps between evals
    eval_episodes: int = 10
    ewma_alpha: float = 0.05
    log_dir: str = "runs/default"
    agent: D4PGConfig = field(default_factory=D4PGConfig)
    seed: int = 0


DEFAULT_REPLAY_CAPACITY = 1_000_000

# Per-env presets: categorical support and episode limit.
ENV_PRESETS = {
    "pendulum": dict(v_min=-300.0, v_max=0.0, obs_dim=3, action_dim=1, max_episode_steps=200),
}


def apply_env_preset(config: TrainConfig) -> TrainConfig:
    """Fill obs/action dims, the episode limit and the replay capacity from
    the env preset, and the categorical support too unless the caller moved
    it off the ``DistConfig`` defaults (as ``_reconcile_config`` of the JAX
    trainer does: an explicit support is never clobbered)."""
    preset = ENV_PRESETS.get(config.env)
    if preset is None:
        raise NotImplementedError(
            f"env {config.env!r} is not ported to d4pg_tpu_torch yet (ROADMAP "
            f"A9); available: {sorted(ENV_PRESETS)}"
        )
    dist = config.agent.dist
    defaults = type(dist)()
    if (dist.v_min, dist.v_max) == (defaults.v_min, defaults.v_max):
        dist = dataclasses.replace(dist, v_min=preset["v_min"], v_max=preset["v_max"])
    agent = dataclasses.replace(
        config.agent,
        obs_dim=preset["obs_dim"],
        action_dim=preset["action_dim"],
        dist=dist,
        n_step=config.n_step,
    )
    return dataclasses.replace(
        config,
        agent=agent,
        max_episode_steps=config.max_episode_steps or preset["max_episode_steps"],
        replay_capacity=config.replay_capacity or DEFAULT_REPLAY_CAPACITY,
    )
