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
from d4pg_tpu_torch.models.critic import DistConfig
from d4pg_tpu_torch.replay.per import TREE_BACKENDS


@dataclass(frozen=True)
class TrainConfig:
    env: str = "pendulum"
    max_episode_steps: Optional[int] = None  # None → env default
    action_repeat: int = 1             # must be 1 for the ported envs
    num_envs: int = 16
    # Hindsight relabeling ("future" strategy, her_k relabels a step) on a
    # goal env: whole single-env episodes through replay/her.py. Ignored by
    # --on-device, as in the JAX package.
    her: bool = False
    her_k: int = 4
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
    # Where sampled batches live: "host" = host replay, its [K, B] block
    # copied to the device once per dispatch of K grad steps; "device" =
    # the device ring + (with PER) the device sum tree, K grad steps per
    # megastep dispatch with no host operand (runtime/megastep.py);
    # "hybrid" = the host PER tree descends, only the [K, B] indices and IS
    # weights cross to the device, and the rows are gathered from the
    # device ring.
    replay_placement: str = "host"
    steps_per_dispatch: int = 1        # K grad steps per dispatch
    # Host PER tree backend: "auto" (native, else NumPy with a printed
    # line), "native" (the g++-built C++ trees; raises if they cannot be
    # built) or "numpy".
    tree_backend: str = "auto"
    # Fuse the next step's descent into each step's loss kernel (B4).
    fused_descent: bool = False
    # Host placement: sample dispatch N+1's batch and start its copy to the
    # device right after dispatch N is enqueued, so the copy overlaps the
    # dispatch in flight (the sample still runs on the loop thread). On an
    # H100 it moved grad steps/s by no more than the spread between runs
    # (PERF.md section 5). The batch sees replay one dispatch staler
    # (the staleness class of steps_per_dispatch > 1). Ignored, with a
    # printed line, on the device and hybrid placements.
    prefetch: bool = False
    # Device placement: right after each megastep dispatch, gather the next
    # flush's first chunk and start its copy (DeviceRingSync.stage), so the
    # copy overlaps the dispatch. Ignored, with a printed line, elsewhere.
    ingest_prefetch: bool = False
    # Run every host, megastep and hybrid dispatch after the first under
    # torch.cuda.set_sync_debug_mode("error"): a host synchronisation in
    # the steady-state loop raises.
    debug_guards: bool = False
    # Host and hybrid placements with PER: a background thread applies the
    # priority write-backs (drain and batch: each wake takes every dispatch
    # queued since the last one and waits once, for the newest copy), so
    # the loop never waits on the device for them. Measured on an H100 it
    # is no gain: it cost the K = 1 host loop 10-29 % of its grad steps/s
    # and left K = 8 and hybrid within the spread between runs; the cause
    # is open (PERF.md sections 5 and 7).
    async_priority_writeback: bool = False
    # Capture a torch.profiler trace of grad steps [10, max(60, 10 + K))
    # of the leg into this directory (a Chrome trace, *.pt.trace.json).
    profile_dir: Optional[str] = None
    # The large-batch recipe in one knob S (apply_batch_scale): batch x S,
    # both learning rates x S, the PER-beta anneal / S, warmup x S,
    # steps_per_dispatch / S. 1 = off.
    batch_scale: int = 1
    # --on-device ring row dtype for the observations: "bfloat16" stores
    # obs and next_obs at half the bytes and decodes them to float32 at
    # the gather. "auto" is float32. Ignored by the other placements, as
    # in the JAX package.
    ring_dtype: str = "auto"
    # Host placement: the observations' host-to-device wire format.
    # "bfloat16" casts obs and next_obs to bfloat16 on the host (round to
    # nearest even), copies half the bytes and casts them back to float32
    # on the device. "uint8" (pixel envs only) ships the replay's stored
    # bytes, a quarter of float32's, and divides them by 255 on the device
    # as the dispatch's first op.
    transfer_dtype: str = "float32"


DEFAULT_REPLAY_CAPACITY = 1_000_000
PLACEMENTS = ("host", "device", "hybrid")

# Per-env presets: categorical support and episode limit.
ENV_PRESETS = {
    "pendulum": dict(v_min=-300.0, v_max=0.0, obs_dim=3, action_dim=1, max_episode_steps=200),
    "pointmass_goal": dict(v_min=-50.0, v_max=0.0, obs_dim=6, action_dim=2, max_episode_steps=50),
    # the pixel env: a flattened 48x48x2 render. replay_capacity caps the
    # default 1M rows: at 4608 bytes an observation (uint8 storage) 100k
    # transitions hold ~0.92 GB of obs and next_obs; 1M would hold ~9 GB
    "pixel_pendulum": dict(
        v_min=-300.0, v_max=0.0, obs_dim=48 * 48 * 2, action_dim=1,
        max_episode_steps=200, pixel_shape=(48, 48, 2), replay_capacity=100_000,
    ),
    # the planar locomotion envs (envs/locomotion.py), trained fully on the
    # device with --on-device
    "halfcheetah": dict(v_min=0.0, v_max=1000.0, obs_dim=17, action_dim=6, max_episode_steps=1000),
    "hopper": dict(v_min=0.0, v_max=500.0, obs_dim=11, action_dim=3, max_episode_steps=1000),
    "walker2d": dict(v_min=0.0, v_max=500.0, obs_dim=17, action_dim=6, max_episode_steps=1000),
    # the 3D envs on the spatial engine (envs/spatial.py); humanoid's
    # support is the JAX package's widened [0, 1500]
    "humanoid": dict(v_min=0.0, v_max=1500.0, obs_dim=45, action_dim=17, max_episode_steps=1000),
    "ant": dict(v_min=0.0, v_max=1000.0, obs_dim=27, action_dim=8, max_episode_steps=1000),
}


def cli_support(env: str, v_min: Optional[float], v_max: Optional[float]) -> tuple:
    """The support the JAX CLI resolves (``train.py:config_from_args``):
    the env preset's pair first (the ``DistConfig`` defaults for an env
    without one), then each explicit ``--v-min`` / ``--v-max`` wins on its
    own."""
    preset = ENV_PRESETS.get(env)
    defaults = DistConfig()
    lo, hi = (preset["v_min"], preset["v_max"]) if preset else (defaults.v_min, defaults.v_max)
    return (lo if v_min is None else v_min), (hi if v_max is None else v_max)


def apply_env_preset(config: TrainConfig) -> TrainConfig:
    """Fill obs/action dims, the pixel shape, the episode limit and the
    replay capacity from the env preset (the preset's cap, e.g.
    ``pixel_pendulum``'s 100 000 rows, unless the config names one). The support follows the JAX trainer's
    ``_reconcile_config``: a support equal to the ``DistConfig`` defaults
    is swapped for the preset's, for the categorical head only; any other
    support (an explicit one, or the CLI's resolved one) is kept."""
    preset = ENV_PRESETS.get(config.env)
    if preset is None:
        raise NotImplementedError(
            f"env {config.env!r} is not ported to d4pg_tpu_torch yet (ROADMAP "
            f"A9: on-device envs; A5 (d): gym ids through the host env "
            f"adapters); available: {sorted(ENV_PRESETS)}"
        )
    dist = config.agent.dist
    defaults = DistConfig()
    if dist.kind == "categorical" and (dist.v_min, dist.v_max) == (defaults.v_min, defaults.v_max):
        dist = dataclasses.replace(dist, v_min=preset["v_min"], v_max=preset["v_max"])
    agent = dataclasses.replace(
        config.agent,
        obs_dim=preset["obs_dim"],
        action_dim=preset["action_dim"],
        dist=dist,
        n_step=config.n_step,
        pixel_shape=preset.get("pixel_shape", config.agent.pixel_shape),
    )
    return dataclasses.replace(
        config,
        agent=agent,
        max_episode_steps=config.max_episode_steps or preset["max_episode_steps"],
        replay_capacity=config.replay_capacity
        or preset.get("replay_capacity", DEFAULT_REPLAY_CAPACITY),
    )


def apply_batch_scale(config: TrainConfig) -> TrainConfig:
    """Derive the large-batch recipe from the baseline config (the JAX
    package's ``apply_batch_scale``): with S = ``batch_scale``,

    ==================  =============  ====================================
    knob                rule           why
    ==================  =============  ====================================
    batch_size          × S            the point
    lr_actor/lr_critic  × S            linear scaling (Goyal et al. 2017)
    per_beta_steps      ÷ S (floor 1)  the β anneal tracks data seen
    warmup_steps        × S            rows for the first wide batch
    steps_per_dispatch  ÷ S (floor 1)  a wide batch amortizes the dispatch
    ==================  =============  ====================================

    Applied after :func:`apply_env_preset`. ``S <= 1`` returns the config
    unchanged."""
    s = int(config.batch_scale)
    if s <= 1:
        return config
    agent = dataclasses.replace(
        config.agent,
        lr_actor=config.agent.lr_actor * s,
        lr_critic=config.agent.lr_critic * s,
        per_beta_steps=max(1, config.agent.per_beta_steps // s),
    )
    return dataclasses.replace(
        config,
        agent=agent,
        batch_size=config.batch_size * s,
        warmup_steps=config.warmup_steps * s,
        steps_per_dispatch=max(1, config.steps_per_dispatch // s),
    )


RING_DTYPES = ("auto", "float32", "bfloat16")
TRANSFER_DTYPES = ("float32", "bfloat16", "uint8")


def check_wire_dtypes(config: TrainConfig) -> None:
    """Refuse an unknown ring or transfer dtype, and the uint8 wire for a
    flat env (the JAX ``uint8_wire_requires_pixel`` gap, in its words).
    Call it after :func:`apply_env_preset`, which sets ``pixel_shape``."""
    if config.transfer_dtype == "uint8" and not config.agent.pixel_shape:
        raise ValueError(
            "uint8_wire_requires_pixel: --transfer-dtype uint8 requires a pixel env "
            "(uint8-quantized replay); use bfloat16 for flat observations"
        )
    if config.transfer_dtype not in TRANSFER_DTYPES:
        raise ValueError(
            f"transfer_dtype must be float32|bfloat16|uint8, got {config.transfer_dtype!r}"
        )
    if config.ring_dtype not in RING_DTYPES:
        raise ValueError(f"ring_dtype must be one of {RING_DTYPES}, got {config.ring_dtype!r}")


def apply_declared_actions(config: TrainConfig) -> TrainConfig:
    """The declared downgrades of ``d4pg_tpu/replay/source.py``
    (``prefetch_ignored``, ``ingest_prefetch_ignored``): an option that the
    placement makes moot is dropped with a printed line, never an error."""
    placement = config.replay_placement
    if config.prefetch and placement != "host":
        print(
            "[replay] --prefetch double-buffers the host batch "
            f"upload, which replay_placement={placement} removes; "
            "ignoring it",
            flush=True,
        )
        config = dataclasses.replace(config, prefetch=False)
    if config.ingest_prefetch and placement != "device":
        print(
            "[replay] --ingest-prefetch double-buffers the device ring "
            "ingest in front of each megastep dispatch of "
            f"replay_placement=device, not {placement}; ignoring it",
            flush=True,
        )
        config = dataclasses.replace(config, ingest_prefetch=False)
    return config


def check_placement(config: TrainConfig) -> None:
    """Refuse a replay placement, dispatch width, tree backend or descent
    tier the port cannot run, as ``d4pg_tpu/replay/source.py`` refuses
    them: an illegal combination raises ``ValueError`` naming every gap."""
    if config.replay_placement not in PLACEMENTS:
        raise ValueError(
            f"replay_placement must be one of {PLACEMENTS}, got {config.replay_placement!r}"
        )
    if config.steps_per_dispatch < 1:
        raise ValueError(f"steps_per_dispatch must be >= 1, got {config.steps_per_dispatch}")
    if config.replay_placement == "hybrid" and not config.prioritized:
        # the reference's hybrid_requires_per gap, in its words
        raise ValueError(
            "hybrid_requires_per: replay_placement=hybrid is the PER mode "
            "(host sum-tree indices + on-device gather); use "
            "replay_placement=device for uniform replay"
        )
    if config.replay_placement != "host" and config.agent.pixel_shape:
        # the reference's device_ring_f32_only gap, in its words, then the
        # ROADMAP item that carries pixels
        raise ValueError(
            "device_ring_f32_only: replay_placement=device/hybrid mirrors f32 rows "
            "into HBM; pixel (uint8-quantized) buffers are host-path only for now "
            "(refused as the JAX package refuses it; pixels are ROADMAP A10 (c): "
            "use the host placement or --on-device)"
        )
    if config.tree_backend not in TREE_BACKENDS:
        raise ValueError(
            f"tree_backend must be one of {TREE_BACKENDS}, got {config.tree_backend!r}"
        )
    if config.fused_descent and config.agent.dist.kind != "categorical":
        # the reference's fused_descent_categorical_only gap, in its words
        raise ValueError(
            "fused_descent_categorical_only: --fused-descent fuses into the "
            "CATEGORICAL projection kernel; quantile/IQN heads keep the "
            "separate-programs tier"
        )
    if config.fused_descent:
        gaps = [
            (config.replay_placement != "device", "replay_placement='device'"),
            (not config.prioritized, "prioritized replay"),
            (config.agent.projection_backend != "fused", "projection_backend='fused'"),
        ]
        missing = [what for gap, what in gaps if gap]
        if missing:
            raise ValueError(
                "fused_descent fuses the device PER tree descent into the fused "
                f"loss kernel; it requires {', '.join(missing)}"
            )


def check_on_device(config: TrainConfig) -> None:
    """Refuse what ``--on-device`` cannot honour, as
    ``d4pg_tpu/replay/source.py`` refuses it (its ``on_device_*`` gaps; the
    others concern flags the port refuses by name)."""
    if config.replay_placement != "host":
        raise ValueError(
            "on_device_placement: --replay-placement configures the HOST "
            "trainer's data plane; --on-device already keeps "
            "rollout+replay+learn in one XLA program (the flag would be "
            "silently ignored)"
        )
