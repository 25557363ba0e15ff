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
    # Running observation normalization at the data boundary
    # (ops/obs_norm.py): clip((x−μ)/σ, ±5) on sampled batches and on the
    # acting and eval forwards, its Welford statistics folded once per
    # OBSERVED env step at collection time (never per sampled batch).
    # Host state-feature envs (gymnasium, dmc:) on the host placement only.
    obs_norm: bool = False
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
    # Runtime guards (analysis/): on the card every host, megastep and
    # hybrid dispatch after the first runs under the zero-transfer budget
    # (a CPU tensor among its operands, checked on entry, or a host sync
    # inside it raises), and a staging ledger polices the
    # PER sample_block slots and the pool's reply slots. The CLI also arms
    # the lock witness and the flow ledger.
    debug_guards: bool = False
    # Chaos harness (chaos.py): a seeded deterministic fault plan, e.g.
    # "seed=3;env_raise@5#0;worker_kill@9#1;wb_stall@1:0.2". Faults fire
    # at per-site event counts, so a chaos run replays exactly.
    chaos: Optional[str] = None
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
    # Host envs (gymnasium ids, dmc: ids): collection through the host
    # actor pool (runtime/actor_pool.py) when num_envs > 1, in a background
    # thread against published actor copies with async_collect (a single
    # env then gets a pool of 1), the copy refreshed every
    # publish_interval grad steps.
    async_collect: bool = False
    publish_interval: int = 10
    # Pool worker start method: "spawn" children import numpy and the env
    # adapter only, never torch or CUDA; a "fork" child inherits the
    # parent's CUDA context and must never touch it (workers use numpy).
    pool_start_method: str = "spawn"
    # A worker that misses this monotonic per-step reply deadline is hung:
    # killed and restarted under jittered exponential backoff, and
    # quarantined (masked out for good) after pool_max_worker_failures
    # consecutive failures.
    pool_step_timeout_s: float = 60.0
    pool_max_worker_failures: int = 3
    # Where host-env collection and eval forwards run: "cpu" a CPU copy of
    # the actor refreshed at each publication, "default" the learner's
    # device, "auto" the CPU whenever the learner is on the card.
    actor_device: str = "auto"
    # Host-env evals on a thread of their own, scoring a copy of the
    # published params, so an eval crossing costs the learner no grad step.
    concurrent_eval: bool = True

    # Data parallelism (parallel/): dp lanes (None = one device), their
    # gradients combined by a fixed-order mean every grad step. Processes
    # of one run (torch.distributed) each own dp/num_processes contiguous
    # lanes and, on the device placement, a replay_capacity/num_processes
    # host buffer; secondary processes log under log_dir/workerN and read
    # and write the shared checkpoint files through run_root (None =
    # log_dir), where process 0 is the one writer.
    dp: Optional[int] = None
    num_processes: int = 1
    run_root: Optional[str] = None
    # Host placement: each lane runs the K steps of a dispatch on its own
    # copy of the state with no sync, then one fixed-order mean of every
    # float tensor resyncs the copies (staleness bounded by K).
    dp_hogwild: bool = False
    tp: int = 1

    # The collection fleet (fleet/): with fleet_listen set, the trainer
    # runs an experience-ingest server on that port (0 = ephemeral,
    # printed at startup; a process of several listens on port + its
    # index) and remote actor hosts (python -m d4pg_tpu_torch.fleet.actor)
    # stream complete n-step windows into replay, beside local collection
    # or, with num_envs == 0, instead of it (the learner then paces on the
    # ingested windows).
    fleet_listen: Optional[int] = None
    # The ingest's bind address: 0.0.0.0 so remote hosts reach it;
    # 127.0.0.1 for a fleet on one machine.
    fleet_host: str = "0.0.0.0"
    # Weight distribution: the trainer re-exports the acting bundle here
    # (params first, json last, each atomic) every fleet_publish_interval
    # grad steps and bumps its generation; the ingest drops windows older
    # than generation − fleet_max_gen_lag.
    fleet_bundle: Optional[str] = None
    fleet_publish_interval: int = 200
    fleet_max_gen_lag: int = 1
    # The wire of flat observation rows: "auto" = float32 (the local
    # path's bytes; pixel envs always stream the uint8 replay's bytes),
    # "bfloat16" halves them with a declared bf16 round. Negotiated with
    # each actor at HELLO (replay/source.py:negotiate_fleet).
    fleet_wire_dtype: str = "auto"
    # The ingest's bounded admission queue (frames): past it a frame is
    # answered OVERLOADED queue_full.
    fleet_queue_limit: int = 64
    # League identity (league/): which population member this learner is
    # and which league generation spawned or forked it; None = not a
    # league run. When set: stamped onto every metrics row, written into
    # trainer_meta.json (the controller's fork attestation: a clone that
    # checkpoints under its own variant_id resumed and progressed) and
    # declared in the fleet HELLO (actors assigned elsewhere are refused).
    variant_id: Optional[int] = None
    league_generation: int = 0


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
    # gymnasium ids, stepped on the host (envs/gym_adapter.py); their dims
    # come from the env itself (apply_env_preset with the built env)
    "Pendulum-v1": dict(v_min=-300.0, v_max=0.0, obs_dim=3, action_dim=1, max_episode_steps=200),
    "HalfCheetah-v4": dict(v_min=0.0, v_max=1000.0, obs_dim=17, action_dim=6, max_episode_steps=1000),
    "HalfCheetah-v5": dict(v_min=0.0, v_max=1000.0, obs_dim=17, action_dim=6, max_episode_steps=1000),
    "Humanoid-v4": dict(v_min=0.0, v_max=1500.0, obs_dim=376, action_dim=17, max_episode_steps=1000),
    "Humanoid-v5": dict(v_min=0.0, v_max=1500.0, obs_dim=348, action_dim=17, max_episode_steps=1000),
}
ACTOR_DEVICES = ("auto", "cpu", "default")


def cli_support(env: str, v_min: Optional[float], v_max: Optional[float]) -> tuple:
    """The support the JAX CLI resolves (``train.py:config_from_args``):
    the env preset's pair first (the ``DistConfig`` defaults for an env
    without one), then each explicit ``--v-min`` / ``--v-max`` wins on its
    own."""
    preset = ENV_PRESETS.get(env)
    defaults = DistConfig()
    lo, hi = (preset["v_min"], preset["v_max"]) if preset else (defaults.v_min, defaults.v_max)
    return (lo if v_min is None else v_min), (hi if v_max is None else v_max)


def apply_env_preset(config: TrainConfig, env=None) -> TrainConfig:
    """Fill obs/action dims, the pixel shape, the episode limit and the
    replay capacity, as the JAX trainer's ``_reconcile_config`` does.

    With ``env`` (a host env: a gymnasium or ``dmc:`` adapter) the dims
    and pixel shape come from the env, the episode limit from the config,
    else the env, else 1000 (pool workers must truncate for noise resets
    and HER flushes to fire). Without it they come from the env preset
    (a torch env's, or a gym id's), which must exist. The replay capacity
    is the config's, else the preset's cap (e.g. ``pixel_pendulum``'s
    100 000 rows), else 1M. The support: a support equal to the
    ``DistConfig`` defaults is swapped, for the categorical head only, for
    the preset's, else the env's ``v_min``/``v_max``, else kept; any other
    support (an explicit one, or the CLI's resolved one) is kept."""
    preset = ENV_PRESETS.get(config.env)
    if env is None:
        if preset is None:
            raise NotImplementedError(
                f"env {config.env!r} has no preset; a host env (gymnasium or "
                f"dmc: id) takes its dims from the built env "
                f"(apply_env_preset(config, env)); presets: {sorted(ENV_PRESETS)}"
            )
        obs_dim, action_dim = preset["obs_dim"], preset["action_dim"]
        pixel_shape = preset.get("pixel_shape", config.agent.pixel_shape)
        max_steps = config.max_episode_steps or preset["max_episode_steps"]
    else:
        obs_dim, action_dim = env.observation_dim, env.action_dim
        pixel_shape = (tuple(env.pixel_shape) if hasattr(env, "pixel_shape")
                       else config.agent.pixel_shape)
        max_steps = (config.max_episode_steps
                     or getattr(env, "max_episode_steps", None) or 1000)
    dist = config.agent.dist
    defaults = DistConfig()
    if dist.kind == "categorical" and (dist.v_min, dist.v_max) == (defaults.v_min, defaults.v_max):
        source = preset if preset else {"v_min": getattr(env, "v_min", defaults.v_min),
                                        "v_max": getattr(env, "v_max", defaults.v_max)}
        dist = dataclasses.replace(dist, v_min=source["v_min"], v_max=source["v_max"])
    agent = dataclasses.replace(
        config.agent,
        obs_dim=obs_dim,
        action_dim=action_dim,
        dist=dist,
        n_step=config.n_step,
        pixel_shape=pixel_shape,
    )
    return dataclasses.replace(
        config,
        agent=agent,
        max_episode_steps=max_steps,
        replay_capacity=config.replay_capacity
        or (preset or {}).get("replay_capacity", DEFAULT_REPLAY_CAPACITY),
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
    elif config.ingest_prefetch and config.dp:
        print(
            "[replay] --ingest-prefetch double-buffers the single-device ring "
            f"ingest; the --dp {config.dp} ring ships each lane's rows in its own "
            "flush; ignoring it",
            flush=True,
        )
        config = dataclasses.replace(config, ingest_prefetch=False)
    return config


def dp_gaps(config: TrainConfig) -> list:
    """The data-parallel and multi-process verdicts of
    ``d4pg_tpu/replay/source.py:negotiate``, as (code, message) pairs in
    its words and order."""
    gaps = []
    placement, dp = config.replay_placement, int(config.dp or 0)
    procs = int(config.num_processes or 1)
    capacity = config.replay_capacity
    if placement != "host" and dp:
        if placement == "hybrid":
            gaps.append(("hybrid_single_device",
                         "replay_placement=hybrid is single-device: the host sum-tree's "
                         "[K, B] index blocks are global, so shard-local gathers can't "
                         "serve them; use --replay-placement device for the sharded "
                         "(uniform) megastep"))
        if config.tp != 1:
            gaps.append(("sharded_megastep_dp_only",
                         "the sharded megastep mesh is dp-only (tp=1); tensor parallelism "
                         "composes via the host-path GSPMD step (--replay-placement host "
                         "--tp N)"))
        if config.dp_hogwild:
            gaps.append(("dp_hogwild_host_only",
                         "--dp-hogwild is a host-path DP mode; the sharded megastep syncs "
                         "gradients every step"))
        if config.batch_size % dp:
            gaps.append(("batch_not_divisible",
                         f"--batch-size {config.batch_size} must be divisible by --dp {dp} "
                         "(each shard draws batch/dp rows)"))
        if capacity and capacity % dp:
            gaps.append(("capacity_not_divisible",
                         f"replay capacity {capacity} must be divisible by --dp {dp} (each "
                         "shard owns capacity/dp ring rows)"))
    if procs > 1:
        if placement != "device":
            gaps.append(("multihost_device_placement_only",
                         "--num-processes > 1 requires --replay-placement device: per-host "
                         "replay shards ride the sharded ring's striped layout (host/hybrid "
                         "keep a single global host buffer no process owns)"))
        if not dp:
            gaps.append(("multihost_requires_dp",
                         "--num-processes > 1 requires --dp: the multi-host mesh IS the "
                         "dp-sharded megastep mesh spanning processes"))
        elif dp % procs:
            gaps.append(("multihost_dp_not_divisible",
                         f"--dp {dp} must be divisible by --num-processes {procs} (each "
                         "process owns dp/num_processes contiguous mesh shards)"))
        if capacity and capacity % procs:
            gaps.append(("multihost_capacity_not_divisible",
                         f"replay capacity {capacity} must be divisible by --num-processes "
                         f"{procs} (each process owns a capacity/num_processes local "
                         "shard)"))
    if config.fused_descent and dp:
        gaps.append(("fused_descent_single_device",
                     "--fused-descent is single-device: the sharded megastep keeps "
                     "separate per-shard descent programs (drop the flag or --dp)"))
    if config.dp_hogwild:
        if not dp:
            gaps.append(("dp_hogwild_requires_dp",
                         "--dp-hogwild is a DP mode: it requires --dp"))
        elif placement == "host" and config.steps_per_dispatch <= 1:
            gaps.append(("dp_hogwild_needs_fused_window",
                         "--dp-hogwild needs --steps-per-dispatch > 1: the dispatch window "
                         "IS the staleness bound (K local steps between param resyncs)"))
    return gaps


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
        # the reference's device_ring_f32_only gap, in its words
        raise ValueError(
            "device_ring_f32_only: replay_placement=device/hybrid mirrors f32 rows "
            "into HBM; pixel (uint8-quantized) buffers are host-path only for now "
            "(refused as the JAX package refuses it: use the host placement or "
            "--on-device)"
        )
    if config.obs_norm and config.replay_placement != "host":
        # the reference's obs_norm_host_sampling gap, in its words
        raise ValueError(
            "obs_norm_host_sampling: --obs-norm normalizes sampled batches on the host; "
            "it is incompatible with a device-resident ring "
            "(rows are gathered in-kernel)"
        )
    if config.actor_device not in ACTOR_DEVICES:
        raise ValueError(
            f"actor_device must be auto|cpu|default, got {config.actor_device!r}"
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
    gaps = dp_gaps(config)
    if gaps:
        raise ValueError("; ".join(f"{code}: {message}" for code, message in gaps))


def check_on_device(config: TrainConfig) -> None:
    """Refuse what ``--on-device`` cannot honour, as
    ``d4pg_tpu/replay/source.py`` refuses it (its ``on_device_*`` gaps; the
    others concern flags the port refuses by name)."""
    if config.obs_norm:
        raise ValueError(
            "on_device_obs_norm: --obs-norm is a host data-boundary feature; the on-device "
            "path keeps observations inside jit (the flag would be "
            "silently ignored)"
        )
    if config.replay_placement != "host":
        raise ValueError(
            "on_device_placement: --replay-placement configures the HOST "
            "trainer's data plane; --on-device already keeps "
            "rollout+replay+learn in one XLA program (the flag would be "
            "silently ignored)"
        )


def check_chaos(config: TrainConfig) -> None:
    """Parse the chaos plan: ``ValueError`` with the parser's words on a
    malformed spec. ``host_kill`` with several processes kills one process
    of the run; the supervisor that reaps the survivors and relaunches
    them all with ``--resume`` is ``tools/multihost_smoke.py``."""
    if not config.chaos:
        return
    from d4pg_tpu_torch.chaos import ChaosPlan

    ChaosPlan.parse(config.chaos)


def check_collection(config: TrainConfig, host_env: bool, env=None) -> None:
    """Refuse what the env's kind cannot collect, as the JAX package refuses
    it (``replay/source.py``'s ``obs_norm_flat_envs_only`` gap and the
    trainer's pool and async refusals, in their words). ``host_env``: the
    env is stepped on the host (a gymnasium or ``dmc:`` adapter), not a
    batched torch env. Call it after :func:`apply_env_preset`."""
    if config.obs_norm and (config.agent.pixel_shape or not host_env):
        raise ValueError(
            "obs_norm_flat_envs_only: --obs-norm supports host state-feature envs only "
            "(pure-JAX envs act inside jit; pixel obs are uint8 "
            "frames the conv encoder already scales)"
        )
    if config.async_collect and not host_env:
        raise ValueError(
            "async_collect needs the host actor pool (a gymnasium env id); "
            "pure-JAX envs collect on-device in the learner stream"
        )
    if host_env and getattr(env, "pixels", False) and (config.num_envs > 1 or config.async_collect):
        # pool workers each open an EGL context; concurrent cross-process
        # EGL rendering deadlocks on a software GL stack
        raise ValueError(
            "pixel dm_control envs cannot use pooled/async "
            "collection (concurrent EGL contexts deadlock): run "
            "with --num-envs 1 and without --async-collect"
        )


def check_fleet(config: TrainConfig, on_device: bool = False) -> None:
    """Refuse what the experience source cannot honour: the fleet's gaps
    and ``no_collection_source`` (``--num-envs 0`` with no
    ``--fleet-listen``), from ``replay/source.py`` where each code lives
    once."""
    from d4pg_tpu_torch.replay.source import from_train_config, negotiate_source

    verdict = negotiate_source(from_train_config(config, on_device=on_device))
    if not verdict.ok:
        raise ValueError("; ".join(f"{g.code}: {g.message}" for g in verdict.gaps))
