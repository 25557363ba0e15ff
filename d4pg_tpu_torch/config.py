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
    checkpoint_interval: int = 10_000  # grad steps of a leg between saves
    resume: bool = False
    # Also snapshot the replay buffer (and, on the device placement with
    # PER, the device tree's priorities) with each checkpoint and restore
    # it on resume, so a resumed run does not repay its warmup.
    snapshot_replay: bool = False
    # When > 0, the trainer reads its own RSS at every eval crossing and,
    # past the limit, checkpoints and stops with ``preempted`` set; the CLI
    # then exits 75 so a supervisor reruns it with --resume.
    max_rss_gb: float = 0.0
    agent: D4PGConfig = field(default_factory=D4PGConfig)
    seed: int = 0
    # Where sampled batches live: "host" = host replay, one host-to-device
    # batch copy per grad step; "device" = the device ring + (with PER) the
    # device sum tree, K grad steps per megastep dispatch with no host
    # operand (runtime/megastep.py). "hybrid" waits for ROADMAP A6.
    replay_placement: str = "host"
    steps_per_dispatch: int = 1        # K grad steps per megastep dispatch
    # Fuse the next step's descent into each step's loss kernel (B4).
    fused_descent: bool = False
    # Run every megastep dispatch after the first under
    # torch.cuda.set_sync_debug_mode("error"): a host synchronisation in
    # the steady-state loop raises.
    debug_guards: bool = False


DEFAULT_REPLAY_CAPACITY = 1_000_000
PLACEMENTS = ("host", "device")

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


def check_placement(config: TrainConfig) -> None:
    """Refuse a replay placement, dispatch width or descent tier the port
    cannot run, as ``d4pg_tpu/replay/source.py`` refuses them: an unported
    feature raises ``NotImplementedError`` naming its ROADMAP item, an
    illegal combination ``ValueError`` naming every gap."""
    if config.replay_placement == "hybrid":
        raise NotImplementedError(
            "replay_placement='hybrid' (host-descended PER indices for the "
            "device ring, through the host sample_block) is not ported to "
            "d4pg_tpu_torch yet (ROADMAP A6)"
        )
    if config.replay_placement not in PLACEMENTS:
        raise ValueError(
            f"replay_placement must be one of {PLACEMENTS}, got {config.replay_placement!r}"
        )
    if config.steps_per_dispatch < 1:
        raise ValueError(f"steps_per_dispatch must be >= 1, got {config.steps_per_dispatch}")
    if config.replay_placement == "host" and config.steps_per_dispatch > 1:
        raise NotImplementedError(
            "steps_per_dispatch > 1 with replay_placement='host' needs the "
            "host replay's sample_block, which is not ported to d4pg_tpu_torch "
            "yet (ROADMAP A5); use replay_placement='device'"
        )
    if config.fused_descent:
        gaps = [
            (config.replay_placement != "device", "replay_placement='device'"),
            (not config.prioritized, "prioritized replay"),
            (config.agent.dist.kind != "categorical", "the categorical critic head"),
            (config.agent.projection_backend != "fused", "projection_backend='fused'"),
        ]
        missing = [what for gap, what in gaps if gap]
        if missing:
            raise ValueError(
                "fused_descent fuses the device PER tree descent into the fused "
                f"loss kernel; it requires {', '.join(missing)}"
            )
