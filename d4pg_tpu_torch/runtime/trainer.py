"""The learner loop (counterpart of the pure-env sync path of
``d4pg_tpu/runtime/trainer.py``), with replay on the host or on the device.

One loop, on one device, in dispatches of K = ``steps_per_dispatch`` grad
steps. With ``replay_placement="host"``:

- warmup: collect at noise scale 3.0 until ``warmup_steps`` env steps are
  in replay and it can serve a batch;
- collection budgeted by ``env_steps_per_train_step``: each budgeted
  collect rolls every env one segment on the device and bulk-inserts the
  n-step-collapsed block into host replay;
- sample on the host (PER: one ``sample_block`` call for the [K, B]
  block, one C call on the native tree backend; uniform: K ``sample``
  calls, stacked) → pinned host tensors → ``non_blocking`` copies to the
  device; K = 1 keeps the flat [B] batch. With ``transfer_dtype=
  "bfloat16"`` the observations are cast to bfloat16 on the host (round to
  nearest even), cross at half the bytes and are cast back to float32 on
  the device before the step. A pixel env's observations are stored as
  uint8 (``clip(rint(x·255), 0, 255)``) and decoded (/255) at the sample,
  or with ``transfer_dtype="uint8"`` cross as those bytes and are divided
  by 255 on the device as the dispatch's first op;
- :func:`~d4pg_tpu_torch.agent.d4pg.train_step` (K = 1) or
  :func:`~d4pg_tpu_torch.agent.d4pg.fused_train_scan` (K > 1);
- the PER priority write-back with a one-dispatch lag: dispatch N's
  priorities start their device→host copy right after it is enqueued and
  are written back after dispatch N+1 is enqueued, so the host never waits
  on the dispatch it just launched;
- eval and a metrics row at every ``eval_interval`` crossing and at the end.

With ``replay_placement="device"`` (the JAX trainer's ``:427-563`` and
``_megastep_dispatch_once``) the host ``ReplayBuffer`` stays the
write-side source of truth, without host trees; each iteration budgets
collection for K = ``steps_per_dispatch`` grad steps, flushes the new
rows into the device ring (``ingest_chunk``; with PER the flush's
``tree_hook`` seeds the same slots into the device tree), then makes ONE
megastep dispatch of K grad steps (``megastep_dispatch``) whose draws,
IS weights and priority write-back stay on the device. ``total_steps`` is
rounded up to whole dispatches. Under ``debug_guards`` every dispatch
after the first runs under ``torch.cuda.set_sync_debug_mode("error")``.

With ``replay_placement="hybrid"`` (PER only; the JAX trainer's hybrid
branch of ``_megastep_dispatch_once``) the host
``PrioritizedReplayBuffer`` keeps its trees and the rows are mirrored
into the device ring with no tree hook. Each dispatch draws the [K, B]
indices and IS weights from the host tree (``sample_block_indices``)
BEFORE the ring flush, so every row that carries tree mass is mirrored by
the time it is gathered; copies those two blocks to the device (its only
host-to-device copy); runs the hybrid megastep (rows gathered from the
ring, K fused-loss steps) under the same guard; and writes the [K, B]
priorities back through the host placement's one-dispatch lag. Its seeded
index stream equals the host placement's.

The asynchronous host data plane (the JAX trainer's ``--prefetch``,
``--async-writeback`` and ``--ingest-prefetch``):

- ``prefetch`` (host placement): right after dispatch N is enqueued, the
  batch of dispatch N+1 is sampled and its copy to the device started; the
  next dispatch consumes it (the first one samples its own). The staged
  batch is copied on a copy stream of its own
  (:class:`~d4pg_tpu_torch.utils.h2d.H2DStream`), so the copy overlaps the
  dispatch in flight; the consumer's stream waits on its event. A batch
  read at once is copied on the compute stream, as without prefetch. A
  staged batch that no dispatch consumes (a preemption) is dropped.
- ``async_priority_writeback`` (host and hybrid placements with PER): a
  flusher thread applies the write-backs. Each wake takes every dispatch
  queued since the last one, waits once for the newest device→host copy
  (``Event.synchronize()``, which releases the interpreter lock and which
  ``set_sync_debug_mode`` does not count; ``chip_smoke.py`` checks that)
  and applies them in order. A checkpoint's replay snapshot drains it
  first; ``train()`` stops it however the loop ends, and a flusher that
  died fails the run.
- ``ingest_prefetch`` (device placement): right after each megastep
  dispatch, ``DeviceRingSync.stage`` gathers the next flush's first chunk
  and starts its copy (stage ``ingest_stage``). In this synchronous loop
  collection and the flush run before each dispatch, so nothing is
  pending then and no chunk is staged; a concurrent writer is what gives
  it rows.

Hindsight relabeling (``her``, the JAX trainer's ``_setup_her`` and
``_her_collect_episode_jax`` for a pure goal env, ``pointmass_goal``):
each collection is ONE episode of a single env on the device, stepped to
``max_episode_steps`` by :meth:`Trainer._her_collect_episode` with the
rollout's own generator (actions, noise, the ``random_eps`` mixture and the
reset), the trajectory fetched to the host once, cut to its live prefix
(:func:`live_prefix`) and written through a
:class:`~d4pg_tpu_torch.replay.her.HindsightWriter` (the original steps and
``her_k`` "future" relabels each, through an n-step writer) into the host
buffer, which the ring mirrors on the device and hybrid placements. The
warmup collects whole episodes at noise scale 3.0; the loop collects one
each time the collect budget reaches ``max_episode_steps``; ``env_steps``
counts the live steps. A host goal env (its own episodes, or the actor
pool's with ``num_envs > 1``) waits for ROADMAP A5 (d).

Each stage is also a ``host/<name>`` profiler range (and an NVTX range on
the card); ``profile_dir`` traces grad steps [10, max(60, 10 + K)) of a
leg (``utils/profiling.py``). Under ``debug_guards`` every host dispatch
after the first runs under the sync guard too.

Checkpoints (the JAX trainer's single-process contract,
``runtime/checkpoint.py``): at every ``checkpoint_interval`` crossing of
the leg's grad-step count and at the end of ``train()``, the state is
saved under the global step, then ``trainer_meta.json``, then (with
``snapshot_replay``) ``replay.npz`` (on the host and hybrid placements
with the host tree's priorities) and, on the device placement with PER,
the ``device_per.npz`` priority sidecar, and the manifest LAST. With
``resume`` the newest intact step is restored with all of it; a restored
replay skips the warmup. :meth:`Trainer.request_preemption` (the CLI's
SIGTERM/SIGINT handler) makes the loop checkpoint at its next iteration
and stop with ``preempted`` set, as does the RSS watchdog
(``max_rss_gb``); the CLI then exits 75. The champion actor of the evals
is kept in ``checkpoints/best_actor.npz`` (the JAX leaf layout) with
``best_eval.json``.
"""

from __future__ import annotations

import contextlib
import json
import os
import queue
import threading
import time
import zipfile
from typing import Optional

import numpy as np
import torch

from d4pg_tpu_torch import resolve_device
from d4pg_tpu_torch.agent import (
    act_deterministic,
    create_train_state,
    make_noise,
    noisy_explore,
    train_step,
)
from d4pg_tpu_torch.agent.d4pg import decode_obs, fused_train_scan
from d4pg_tpu_torch.agent.state import check_supported
from d4pg_tpu_torch.config import (
    TrainConfig,
    apply_batch_scale,
    apply_declared_actions,
    apply_env_preset,
    check_placement,
    check_wire_dtypes,
)
from d4pg_tpu_torch.envs import PointMassGoal, make_env
from d4pg_tpu_torch.replay import (
    PrioritizedReplayBuffer,
    ReplayBuffer,
    SampledIndices,
    Transition,
    noise_scale_schedule,
)
from d4pg_tpu_torch.replay.device_per import DevicePerSync
from d4pg_tpu_torch.replay.device_ring import DeviceRingSync, device_ring_init
from d4pg_tpu_torch.replay.her import HindsightWriter
from d4pg_tpu_torch.replay.nstep_writer import NStepWriter
from d4pg_tpu_torch.runtime import megastep
from d4pg_tpu_torch.runtime.checkpoint import (
    CheckpointManager,
    best_eval_path,
    load_trainer_meta,
    save_best_eval,
    save_trainer_meta,
    trainer_meta_path,
)
from d4pg_tpu_torch.runtime.collect import make_segment_collector
from d4pg_tpu_torch.runtime.evaluator import evaluate
from d4pg_tpu_torch.runtime.metrics import MetricsLogger, StageTimers, interval_crossed
from d4pg_tpu_torch.utils.h2d import H2DStream, to_device
from d4pg_tpu_torch.utils.profiling import annotate, profile_trace
from d4pg_tpu_torch.weights import best_actor_path, save_best_actor

SEGMENT_LEN = 32  # env steps per env per collect (the JAX sync trainer's)
WIRE_FIELDS = ("obs", "next_obs")  # what --transfer-dtype narrows on the wire
WB_JOIN_S = 60.0  # how long stopping or draining the write-back thread may take


# The fields of one HER rollout step, in the order they are fetched.
HER_FIELDS = ("observation", "achieved_goal", "desired_goal", "action", "reward",
              "next_observation", "next_achieved_goal", "terminated", "truncated")


def live_prefix(terminated: np.ndarray, truncated: np.ndarray) -> tuple[int, bool]:
    """(T, terminated) of an episode's live prefix: the steps up to and
    including the first terminated or truncated flag (all of them if none
    is set), and whether that last step terminated. What a batched env
    does after its episode ended belongs to no episode."""
    done = (terminated > 0.5) | (truncated > 0.5)
    T = int(done.argmax()) + 1 if done.any() else len(done)
    return T, bool(terminated[T - 1] > 0.5)


def _rss_gb() -> float:
    """This process's resident set size in GB (Linux's ``VmRSS``)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 1024 / 1024
    raise OSError("no VmRSS line in /proc/self/status")


class Trainer:
    def __init__(self, config: TrainConfig, device=None):
        """``config`` as the user gives it: the env preset and then
        ``batch_scale`` are applied here, so ``self.config`` holds the
        scaled values (and ``batch_scale`` itself, as the JAX trainer's
        config does)."""
        self.device = resolve_device(device)
        config = apply_batch_scale(apply_env_preset(config))
        check_wire_dtypes(config)
        check_supported(config.agent)
        check_placement(config)
        config = apply_declared_actions(config)
        self.config = config
        agent_cfg = config.agent
        self.env = make_env(config.env, config.max_episode_steps, config.action_repeat)

        obs_dim, act_dim = agent_cfg.obs_dim, agent_cfg.action_dim
        self.on_device = config.replay_placement == "device"
        self.hybrid = config.replay_placement == "hybrid"
        # pixel observations are stored as uint8 (a quarter of the host
        # memory); with the uint8 wire the sampled rows stay bytes until
        # the device divides them by 255
        storage = dict(
            obs_dtype=np.uint8 if agent_cfg.pixel_shape else np.float32,
            decode_on_sample=config.transfer_dtype != "uint8",
        )
        if self.on_device:
            # the write-side source of truth: a plain host ring, no host
            # trees (with PER the priorities live in the device tree)
            self.buffer = ReplayBuffer(config.replay_capacity, obs_dim, act_dim, **storage)
        elif config.prioritized:
            self.buffer = PrioritizedReplayBuffer(
                config.replay_capacity, obs_dim, act_dim,
                alpha=agent_cfg.per_alpha, beta0=agent_cfg.per_beta0,
                beta_steps=agent_cfg.per_beta_steps, eps=agent_cfg.per_eps,
                tree_backend=config.tree_backend, **storage,
            )
        else:
            self.buffer = ReplayBuffer(config.replay_capacity, obs_dim, act_dim, **storage)

        self.state = create_train_state(agent_cfg, config.seed, self.device)
        # Host sampling draws from numpy; acting, resets and eval from
        # torch generators on the device. Each stream has its own seed.
        self._rng = np.random.default_rng(config.seed)
        self._collect_gen = torch.Generator(self.device).manual_seed(config.seed + 1)
        self._eval_gen = torch.Generator(self.device).manual_seed(config.seed + 2)

        noise_fns = make_noise(agent_cfg, (config.num_envs,), self.device)
        self._collect = make_segment_collector(
            agent_cfg, self.env, config.num_envs, SEGMENT_LEN, noise_fns
        )
        self.env_states, self.obs = self.env.reset(
            config.num_envs, self._collect_gen, self.device
        )
        self.noise_states = noise_fns[0]()
        self.her_writer = None
        if config.her:
            self._setup_her()

        self._ring = self._ring_sync = self._dev_per = self._megastep = None
        self._dispatches = 0
        # host-to-device batch copies, on a stream of their own on the card
        self._h2d = H2DStream(self.device)
        # --prefetch: (indices, device batch, copy-done event) sampled after
        # the previous dispatch, for the next one
        self._staged = None
        # PER: (indices, priority fetch) of the previous dispatch, written
        # back after the next one is enqueued
        self._pending = None
        # --async-writeback: the flusher thread and its queue. _wb_idle is
        # set iff every queued write-back has been applied; _wb_idle_lock
        # orders a producer's clear + put against the flusher's empty check
        # + set, so the flusher never sets it over a queued item.
        self._wb_queue: Optional[queue.Queue] = None
        self._wb_thread: Optional[threading.Thread] = None
        self._wb_error: Optional[BaseException] = None
        self._wb_idle = threading.Event()
        self._wb_idle.set()
        self._wb_idle_lock = threading.Lock()
        self.writebacks_applied = 0  # dispatches whose priorities reached the tree
        if self.on_device or self.hybrid:
            self._ring = device_ring_init(config.replay_capacity, obs_dim, act_dim, self.device)
            self._ring_sync = DeviceRingSync(self.buffer)
        if self.hybrid:
            self._megastep = megastep.make_megastep_hybrid(agent_cfg)
        elif self.on_device:
            K, B = config.steps_per_dispatch, config.batch_size
            if config.prioritized:
                self._dev_per = DevicePerSync(
                    config.replay_capacity, agent_cfg.per_alpha, device=self.device
                )
                self._ring_sync.tree_hook = self._dev_per.on_chunk
                if config.fused_descent:
                    self._megastep = megastep.make_megastep_device_per_fused(agent_cfg, K, B)
                else:
                    self._megastep = megastep.make_megastep_device_per(agent_cfg, K, B)
            else:
                self._megastep = megastep.make_megastep_uniform(agent_cfg, K, B)
            # the megastep's draws come from their own device generator
            self._megastep_gen = torch.Generator(self.device).manual_seed(config.seed + 3)

        self.env_steps = 0
        self.grad_steps = 0
        self.ewma_return: Optional[float] = None
        self._best_eval: Optional[float] = None
        self.timers = StageTimers()
        for name in StageTimers.STAGES:  # every row carries every stage
            self.timers.ensure(name)
        self.metrics = MetricsLogger(config.log_dir)
        self.ckpt = CheckpointManager(os.path.join(config.log_dir, "checkpoints"))
        self.preempted = False
        # Signal handlers only set this event (signal- and thread-safe);
        # the train and warmup loops act on it at their next iteration.
        self._preempt_requested = threading.Event()
        self._replay_restored = False
        self._ckpt_fallbacks = 0
        if config.resume and self.ckpt.latest_step() is not None:
            with self.timers.stage("checkpoint_restore"):
                self._resume()

    # ------------------------------------------------------------ checkpoints
    def _replay_snapshot_path(self) -> str:
        return os.path.join(self.config.log_dir, "checkpoints", "replay.npz")

    def _device_per_snapshot_path(self) -> str:
        return os.path.join(self.config.log_dir, "checkpoints", "device_per.npz")

    def _resume(self) -> None:
        """Restore the newest intact checkpoint in place, with the trainer
        meta, the keep-best score and (``snapshot_replay``) the replay and
        the device-PER priorities."""
        cfg = self.config
        _, restored_step, fallbacks = self.ckpt.restore_verified(self.state)
        self._ckpt_fallbacks = len(fallbacks)
        for fb in fallbacks:
            print(f"[checkpoint] fallback: {fb}")
        print(f"[checkpoint] resumed from step {restored_step}", flush=True)
        self.grad_steps = self.state.step
        meta = load_trainer_meta(cfg.log_dir)
        # env_steps drives the noise schedule: without it a resumed run
        # would re-explore at full scale
        self.env_steps = int(meta.get("env_steps", 0))
        self.ewma_return = meta.get("ewma_return")
        best_json = best_eval_path(cfg.log_dir)
        if os.path.exists(best_actor_path(cfg.log_dir)) and os.path.exists(best_json):
            try:
                with open(best_json) as f:
                    self._best_eval = float(json.load(f)["eval_return_mean"])
            except (OSError, ValueError, KeyError):
                pass  # a corrupt best file: start fresh, never crash
        snap = self._replay_snapshot_path()
        if cfg.snapshot_replay and os.path.exists(snap):
            try:
                n = self.buffer.restore(snap)
                self._replay_restored = True
                print(f"restored replay snapshot: {n} transitions")
            except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
                # a torn snapshot degrades (the warmup is repaid), never
                # kills the resume
                print(
                    f"[checkpoint] replay snapshot {snap} unreadable ({e}); "
                    "resuming with an empty buffer (warmup will be repaid)"
                )
        if self._replay_restored and self._ring_sync is not None:
            # Mirror the restored rows NOW, before the first gather (setup,
            # not loop). On the device placement the tree hook seeds every
            # leaf at max priority; the sidecar's priorities overwrite the
            # seeds when it loads. The hybrid placement's priorities came
            # back with replay.npz, in the host tree.
            with self.timers.stage("ingest_chunk"):
                self._ring_sync.flush(self._ring)
        if self._replay_restored and self._dev_per is not None:
            dp_snap = self._device_per_snapshot_path()
            if os.path.exists(dp_snap):
                try:
                    with np.load(dp_snap) as z:
                        self._dev_per.restore_host(
                            z["priorities_alpha"], float(z["max_priority"])
                        )
                    print("restored device-PER priorities")
                except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
                    print(
                        f"[checkpoint] device-PER snapshot {dp_snap} unreadable "
                        f"({e}); priorities re-seeded at max"
                    )

    def _save_checkpoint(self) -> None:
        """The state, the trainer meta, the replay snapshot and the
        device-PER sidecar, then the manifest that names them LAST (the
        commit record): a crash anywhere before it leaves the step
        unattested. Reads device values, so it runs outside
        :meth:`_dispatch_guard`."""
        cfg = self.config
        with self.timers.stage("checkpoint_save"):
            self.ckpt.save(self.grad_steps, self.state)
            save_trainer_meta(cfg.log_dir, self.env_steps, self.ewma_return)
            side = [trainer_meta_path(cfg.log_dir)]
            if cfg.snapshot_replay:
                # in-flight async write-backs land first, or the snapshot
                # freezes priorities the flusher was about to overwrite
                self._drain_writeback()
                self.buffer.snapshot(self._replay_snapshot_path())
                side.append(self._replay_snapshot_path())
                if self._dev_per is not None:
                    # Rows the ring has not mirrored yet (all of them after
                    # a preemption during the warmup) have no leaves in the
                    # tree; flush them first so the sidecar names every row
                    # of replay.npz, as the JAX multi-process save does.
                    with self.timers.stage("ingest_chunk"):
                        self._ring_sync.flush(self._ring)
                    pa, mp = self._dev_per.snapshot_host()
                    dp_path = self._device_per_snapshot_path()
                    tmp = dp_path + ".tmp"
                    with open(tmp, "wb") as f:  # a file object: savez appends no suffix
                        np.savez(f, priorities_alpha=pa, max_priority=mp)
                    os.replace(tmp, dp_path)
                    side.append(dp_path)
            self.ckpt.write_manifest(self.grad_steps, side_files=side)

    def request_preemption(self) -> None:
        """Ask the trainer to checkpoint and stop at the next loop boundary
        (signal-handler-safe: only sets an event)."""
        self._preempt_requested.set()

    def _preempt_now(self, where: str) -> None:
        self._save_checkpoint()
        print(
            f"[preempt] stop requested ({where}): checkpointed at grad step "
            f"{self.grad_steps}; exiting for a --resume restart",
            flush=True,
        )
        self.preempted = True

    def _effective_warmup(self) -> int:
        """Warmup env steps still owed: none once a replay snapshot was
        restored (that experience already paid its warmup)."""
        return 0 if self._replay_restored else self.config.warmup_steps

    def _noise_scale(self) -> float:
        agent = self.config.agent
        return noise_scale_schedule(
            self.env_steps, agent.noise_decay_steps, agent.noise_scale_final
        )

    # -------------------------------------------------------------------- HER
    def _make_her_writer(self, reward_fn) -> HindsightWriter:
        cfg = self.config
        return HindsightWriter(
            writer_factory=lambda: NStepWriter(self.buffer, cfg.n_step, cfg.agent.gamma),
            compute_reward=reward_fn,
            k_future=cfg.her_k,
            rng=self._rng,
        )

    def _setup_her(self) -> None:
        """The hindsight writer and the single-env rollout of a pure goal
        env. A host goal env (``is_goal_env``: the gymnasium adapters)
        waits for the host env adapters and the actor pool."""
        cfg = self.config
        env = self.env
        if getattr(env, "is_goal_env", False):
            what = (
                f"--her with num_envs={cfg.num_envs} collects through the host actor "
                "pool's goal views" if cfg.num_envs > 1
                else "--her on a host goal env collects its episodes on the host"
            )
            raise NotImplementedError(
                f"{what}; the host env adapters and the actor pool (ROADMAP A5 (d)) "
                "are not ported to d4pg_tpu_torch yet"
            )
        if not isinstance(env, PointMassGoal):
            raise ValueError(f"--her needs a goal env, got {cfg.env}")

        def reward_fn(ag, dg):
            return float(env.compute_reward(torch.from_numpy(ag), torch.from_numpy(dg)))

        self.her_writer = self._make_her_writer(reward_fn)
        init, self._her_noise_sample, self._her_noise_reset = make_noise(
            cfg.agent, (), self.device
        )
        self._her_noise = init()
        # the rollout's own stream: resets, actions' noise and the mixture
        self._her_gen = torch.Generator(self.device).manual_seed(cfg.seed + 4)
        self.her_episodes = 0

    @torch.no_grad()
    def _her_rollout(self, scale: float) -> dict:
        """One episode of one env on the device, stepped to
        ``max_episode_steps`` whatever its flags say (the JAX ``lax.scan``
        as a loop); the trajectory comes to the host in ONE copy. Returns
        the HER_FIELDS as [T_max, ...] numpy arrays."""
        env, agent, gen = self.env, self.config.agent, self._her_gen
        state, obs = env.reset(1, gen, self.device)
        nstate = self._her_noise
        rows = []
        for _ in range(env.max_episode_steps):
            a = act_deterministic(agent, self.state.actor, obs)
            a, nstate = noisy_explore(agent, self._her_noise_sample, a, gen, nstate, scale)
            g0 = env.goal_obs(state)
            state, obs, r, term, trunc = env.step(state, a)
            g1 = env.goal_obs(state)
            rows.append(torch.cat([
                g0.observation, g0.achieved_goal, g0.desired_goal, a, r[:, None],
                g1.observation, g1.achieved_goal, term[:, None], trunc[:, None],
            ], dim=-1))
        self._her_noise = self._her_noise_reset(nstate)
        traj = torch.cat(rows).cpu().numpy()        # [T_max, F], the one fetch
        widths = (env.observation_dim, env.goal_dim, env.goal_dim, agent.action_dim, 1,
                  env.observation_dim, env.goal_dim, 1, 1)
        cols = np.split(traj, np.cumsum(widths)[:-1], axis=1)
        out = dict(zip(HER_FIELDS, cols))
        for k in ("reward", "terminated", "truncated"):
            out[k] = out[k][:, 0]
        return out

    def _her_collect_episode(self, noise_scale: Optional[float] = None) -> float:
        """One exploratory episode through the hindsight writer; returns its
        reward sum. Only the live prefix is written and counted."""
        scale = self._noise_scale() if noise_scale is None else noise_scale
        with self.timers.stage("env_step"):
            traj = self._her_rollout(scale)
        T, terminated = live_prefix(traj["terminated"], traj["truncated"])
        with self.timers.stage("replay_insert"):
            for t in range(T):
                self.her_writer.add(
                    observation=traj["observation"][t],
                    achieved_goal=traj["achieved_goal"][t],
                    desired_goal=traj["desired_goal"][t],
                    action=traj["action"][t],
                    reward=float(traj["reward"][t]),
                    next_observation=traj["next_observation"][t],
                    next_achieved_goal=traj["next_achieved_goal"][t],
                    terminated=terminated and t == T - 1,
                )
            self.her_writer.end_episode(truncated=not terminated)
        self.env_steps += T
        self.her_episodes += 1
        return float(traj["reward"][:T].sum())

    # ------------------------------------------------------------ collection
    def _collect_once(self, noise_scale: Optional[float] = None) -> None:
        """One collection: a segment of every env into replay, or with HER
        one episode through the hindsight writer."""
        if self.her_writer is not None:
            self._her_collect_episode(noise_scale)
            return
        scale = self._noise_scale() if noise_scale is None else noise_scale
        with self.timers.stage("env_step"):
            self.env_states, self.obs, self.noise_states, flat, _ = self._collect(
                self.state.actor, self.env_states, self.obs, self.noise_states,
                self._collect_gen, scale,
            )
            flat = {k: v.cpu().numpy() for k, v in flat.items()}
        with self.timers.stage("replay_insert"):
            self.buffer.add_batch(Transition(**flat))
        self.env_steps += self.config.num_envs * SEGMENT_LEN

    def warmup(self) -> None:
        """Pre-fill replay with high-noise exploration."""
        cfg = self.config
        while self.env_steps < self._effective_warmup() or len(self.buffer) < cfg.batch_size:
            if self._preempt_requested.is_set():
                return  # the train loop's first check checkpoints
            self._collect_once(noise_scale=3.0)

    # ---------------------------------------------------------------- batches
    def _sample_staged(self, k: int, ahead: bool = False):
        """Sample one dispatch's K batches on the host and start their copy
        to the device: on the compute stream for a dispatch that reads them
        at once, or with ``ahead`` (``--prefetch``) on the copy stream.
        Returns (indices for the write-back or None, device batch, copy-done
        event or None): [K, B, ...] fields, or the flat [B] batch when K = 1.
        The batch may be read only after ``self._h2d.consume``.

        PER: one ``sample_block`` call (on the native tree backend one C
        call for the descents, the IS weights, the generation capture and
        the gather of every row); K = 1 draws the same stream as ``sample``.
        Uniform: K ``sample`` calls, stacked (no ``weights`` key: uniform IS
        weights are identically 1)."""
        cfg = self.config
        with self.timers.stage("sample"):
            if cfg.prioritized:
                block = self.buffer.sample_block(cfg.batch_size, k, self._rng, step=self.grad_steps)
                indices = block.pop("indices")
                if k == 1:
                    indices = SampledIndices(indices.idx[0], indices.gen[0])
                    block = {key: v[0] for key, v in block.items()}
            elif k == 1:
                block = dict(self.buffer.sample(cfg.batch_size, self._rng))
                indices = None
            else:
                samples = [self.buffer.sample(cfg.batch_size, self._rng) for _ in range(k)]
                block = {key: np.stack([s[key] for s in samples]) for key in samples[0]}
                indices = None
        if cfg.transfer_dtype == "bfloat16":
            block = {
                key: torch.from_numpy(v).to(torch.bfloat16) if key in WIRE_FIELDS else v
                for key, v in block.items()
            }
        with self.timers.stage("h2d_stage"):
            # sample_block's fields are views of a staging slot that is
            # rewritten STAGING_SLOTS - 1 calls later. That is safe because
            # on the card both copies pin each view into a fresh block
            # before they return, and on the CPU the dispatch that reads the
            # views runs before the slot comes round again: with --prefetch
            # one batch is in flight, sampled after one dispatch and read by
            # the next. Pinning the slots themselves would have to honour
            # the rotation.
            if ahead:
                dev_batch, ready = self._h2d.put(block)
            else:
                dev_batch, ready = to_device(block, self.device), None
        return indices, dev_batch, ready

    def _start_fetch(self, priorities: torch.Tensor):
        """Start the device→host copy of one step's priorities."""
        if self.device.type != "cuda":
            return priorities, None
        host = torch.empty(priorities.shape, dtype=priorities.dtype, pin_memory=True)
        host.copy_(priorities, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _write_back(self, pending) -> None:
        indices, (host, done) = pending
        with self.timers.stage("priority_writeback"):
            if done is not None:
                done.synchronize()
            self.buffer.update_priorities(indices, host.numpy())
        self.writebacks_applied += 1

    def _lagged_write_back(self, indices, priorities: torch.Tensor) -> None:
        """Write back the previous dispatch's priorities, then start this
        one's device→host copy: the host never waits on the dispatch it
        just enqueued."""
        if self._pending is not None:
            self._write_back(self._pending)
        self._pending = (indices, self._start_fetch(priorities))

    def _flush_write_back(self) -> None:
        """Apply the last dispatch's lagged priority write-back, if any."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            self._write_back(pending)

    def _hand_off(self, indices, priorities: torch.Tensor) -> None:
        """One dispatch's priorities to the write-back thread when it runs,
        else to the one-dispatch-lagged write-back."""
        if self._wb_thread is not None:
            self._queue_writeback(indices, priorities)
        else:
            self._lagged_write_back(indices, priorities)

    # ------------------------------------------------------ async write-back
    def _wants_writeback(self) -> bool:
        """--async-writeback on a placement whose priorities come back to
        the host (the device placement's never leave the device)."""
        cfg = self.config
        return cfg.async_priority_writeback and cfg.prioritized and not self.on_device

    def _check_writeback(self) -> None:
        if self._wb_error is not None:
            raise RuntimeError("priority write-back thread died") from self._wb_error

    def _writeback_loop(self) -> None:
        """Drain-and-batch priority flusher. Each wake takes every item
        queued since the last one, waits once, for the newest item's
        copy-done event (the copies run in stream order, so every older one
        is done too), then applies the items in FIFO order."""
        try:
            while True:
                # sentinel-terminated: _stop_writeback always puts None
                item = self._wb_queue.get()
                stop = item is None
                items = [] if stop else [item]
                while True:
                    try:
                        nxt = self._wb_queue.get_nowait()
                    except queue.Empty:
                        break
                    if nxt is None:
                        stop = True
                    else:
                        items.append(nxt)
                if items:
                    with self.timers.stage("priority_writeback"):
                        done = items[-1][1][1]
                        if done is not None:
                            # set_sync_debug_mode is process-wide and may be
                            # on in the loop thread's guarded dispatch; it
                            # does not count an event's synchronize
                            done.synchronize()
                        for indices, (host, _) in items:
                            self.buffer.update_priorities(indices, host.numpy())
                        self.writebacks_applied += len(items)
                with self._wb_idle_lock:
                    if self._wb_queue.empty():
                        # idle = drained AND applied; producers clear it
                        # under the same lock before every put
                        self._wb_idle.set()
                if stop:
                    return
        except BaseException as e:
            self._wb_error = e
            self._wb_idle.set()  # never leave a drain waiting
            raise

    def _start_writeback(self) -> None:
        if self._wb_thread is not None and self._wb_thread.is_alive():
            raise RuntimeError("a priority write-back thread is already running")
        self._flush_write_back()  # a lagged write-back lands first, in order
        self._wb_queue = queue.Queue()
        self._wb_idle.set()
        self._wb_error = None
        self._wb_thread = threading.Thread(
            target=self._writeback_loop, name="priority-writeback", daemon=True
        )
        self._wb_thread.start()

    def _stop_writeback(self) -> None:
        """Apply everything queued, stop the thread, and raise if it died."""
        if self._wb_thread is not None:
            self._wb_queue.put(None)
            self._wb_thread.join(timeout=WB_JOIN_S)
            if self._wb_thread.is_alive():
                # keep the references: a later _start_writeback must refuse
                raise RuntimeError(
                    f"priority write-back thread failed to drain within {WB_JOIN_S:.0f} s; "
                    "queued priority updates were not applied"
                )
            self._wb_thread = None
        self._wb_queue = None
        self._check_writeback()

    def _queue_writeback(self, indices, priorities: torch.Tensor) -> None:
        """Hand one dispatch's (indices, priorities) to the flusher, with
        its device→host copy already started."""
        self._check_writeback()
        with self.timers.stage("priority_writeback"):
            fetch = self._start_fetch(priorities)
            with self._wb_idle_lock:
                self._wb_idle.clear()
                self._wb_queue.put((indices, fetch))  # unbounded: never blocks

    def _drain_writeback(self) -> None:
        """Wait until the flusher has applied everything queued so far
        (before a replay snapshot, so that it holds no stale priority)."""
        if self._wb_thread is None:
            return
        if not self._wb_idle.wait(WB_JOIN_S):
            raise RuntimeError(
                f"priority write-back queue not drained within {WB_JOIN_S:.0f} s"
            )
        self._check_writeback()

    @contextlib.contextmanager
    def _async_writeback(self):
        """The flusher thread for the block, when configured. It is stopped
        however the block ends; a failure to stop never masks an error
        already propagating out of the block."""
        if not self._wants_writeback():
            yield
            return
        self._start_writeback()
        try:
            yield
        except BaseException:
            try:
                self._stop_writeback()
            except RuntimeError as e:
                print(f"[priority-writeback] {e} (original error propagating)", flush=True)
            raise
        self._stop_writeback()

    # ------------------------------------------------------------------ train
    def _dispatch_guard(self):
        """``set_sync_debug_mode("error")`` around a steady-state host,
        megastep or hybrid dispatch under ``debug_guards`` (the first
        dispatch builds and loads the kernels, which may synchronise). The
        operands must already be on the device."""
        if not (self.config.debug_guards and self.device.type == "cuda" and self._dispatches):
            return contextlib.nullcontext()
        return _sync_debug_error()

    def _megastep_dispatch_once(self) -> dict:
        """Flush new rows into the device ring (and tree), then one megastep
        dispatch of K grad steps; returns its K-step mean metrics. With
        ``ingest_prefetch`` the next flush's first chunk is staged right
        after the dispatch, outside the guard (explicit staging)."""
        with self.timers.stage("ingest_chunk"):
            self._ring_sync.flush(self._ring)
        tree = self._dev_per.tree if self._dev_per is not None else None
        with self.timers.stage("megastep_dispatch"), self._dispatch_guard():
            metrics = self._megastep(self.state, self._ring, tree, self._megastep_gen)
        self._dispatches += 1
        if self.config.ingest_prefetch:
            with self.timers.stage("ingest_stage"):
                self._ring_sync.stage(self._ring)
        return metrics

    def _hybrid_dispatch_once(self) -> dict:
        """One hybrid dispatch of K grad steps, in the JAX trainer's order:
        the host tree's [K, B] draw, the ring flush, the indices' and
        weights' copy to the device, the megastep, then the write-back of
        its [K, B] priorities. Returns its K-step mean metrics."""
        cfg = self.config
        with self.timers.stage("sample"):
            # BEFORE the flush: every row that carries tree mass now is
            # mirrored by the time the megastep gathers it
            idx, weights, gen = self.buffer.sample_block_indices(
                cfg.batch_size, cfg.steps_per_dispatch, self._rng, step=self.grad_steps
            )
        with self.timers.stage("ingest_chunk"):
            self._ring_sync.flush(self._ring)
        with self.timers.stage("h2d_stage"):
            # the dispatch's only host-to-device copy, explicit staging
            # outside the guard
            dev = to_device({"idx": idx.astype(np.int32), "weights": weights}, self.device)
        with self.timers.stage("megastep_dispatch"), self._dispatch_guard():
            metrics, priorities = self._megastep(self.state, self._ring, dev["idx"], dev["weights"])
        self._dispatches += 1
        self._hand_off(SampledIndices(idx, gen), priorities)
        return metrics

    def _host_dispatch_once(self, prefetch_next: bool) -> dict:
        """One ``train_step`` (K = 1) or ``fused_train_scan`` (K > 1) on
        host-sampled batches, then the PER write-back; returns the K-step
        mean metrics. The batch is the one staged after the previous
        dispatch when there is one (``--prefetch``), else sampled now; with
        ``prefetch_next`` the next dispatch's batch is sampled and its copy
        started right after this dispatch is enqueued. Its generation
        stamps are taken at that sample, so a write-back to a slot recycled
        since is dropped."""
        cfg = self.config
        k = cfg.steps_per_dispatch
        if self._staged is not None:
            (indices, dev_batch, ready), self._staged = self._staged, None
        else:
            indices, dev_batch, ready = self._sample_staged(k)
        self._h2d.consume(dev_batch, ready)
        with self.timers.stage("train_dispatch"), self._dispatch_guard():
            # the bfloat16 or uint8 wire's observations back to float32, on
            # the device
            dev_batch = {key: decode_obs(v) if key in WIRE_FIELDS else v
                         for key, v in dev_batch.items()}
            if k == 1:
                _, metrics, priorities = train_step(cfg.agent, self.state, dev_batch)
            else:
                _, metrics_k, priorities = fused_train_scan(cfg.agent, self.state, dev_batch)
                metrics = {key: v.mean() for key, v in metrics_k.items()}
        self._dispatches += 1
        if prefetch_next:
            with annotate("host/prefetch"):
                self._staged = self._sample_staged(k, ahead=True)
        if cfg.prioritized:
            self._hand_off(indices, priorities)
        return metrics

    def _dispatch_once(self, prefetch_next: bool = False) -> dict:
        """One dispatch of K grad steps on this trainer's placement;
        ``prefetch_next`` (a later dispatch follows) arms ``--prefetch``."""
        if self.on_device:
            return self._megastep_dispatch_once()
        if self.hybrid:
            return self._hybrid_dispatch_once()
        return self._host_dispatch_once(prefetch_next and self.config.prefetch)

    def train(self, total_steps: Optional[int] = None) -> dict:
        """Warm up, then run ``total_steps`` grad steps in this leg (rounded
        up to whole dispatches of K); returns the last metrics row (``{}``
        when preempted before the first step). The write-back thread and a
        profiler trace are stopped however the loop ends."""
        cfg = self.config
        total = total_steps or cfg.total_steps
        K = cfg.steps_per_dispatch
        if total % K:
            total = -(-total // K) * K
            print(f"total_steps rounded up to {total} (multiple of steps_per_dispatch={K})",
                  flush=True)
        self.warmup()
        t_start = time.monotonic()
        env_steps_start = self.env_steps
        # HER: one episode a collection, budgeted at its full length
        per_collect = cfg.max_episode_steps if cfg.her else cfg.num_envs * SEGMENT_LEN
        collect_budget = 0.0
        last: dict = {}
        done = 0
        trace = contextlib.ExitStack()
        tracing = profiled = False
        try:
            with self._async_writeback(), trace:
                while done < total:
                    if self._preempt_requested.is_set():
                        # before any sampling: a preemption that cut the
                        # warmup short never samples a buffer that cannot
                        # serve a batch
                        self._preempt_now("train loop")
                        break
                    if cfg.profile_dir and not (profiled or tracing) and done >= 10:
                        trace.enter_context(profile_trace(cfg.profile_dir))
                        tracing = True
                    if tracing and done >= max(60, 10 + K):
                        trace.close()
                        tracing, profiled = False, True
                    collect_budget += cfg.env_steps_per_train_step * K
                    while collect_budget >= per_collect:
                        self._collect_once()
                        collect_budget -= per_collect
                    metrics = self._dispatch_once(prefetch_next=done + K < total)
                    done += K
                    self.grad_steps += K
                    eval_crossed = interval_crossed(done - K, done, cfg.eval_interval)
                    if eval_crossed or done >= total:
                        last = self._periodic(metrics, t_start, done, env_steps_start)
                    # crossings of the LEG's count, saved under the global step
                    saved = interval_crossed(done - K, done, cfg.checkpoint_interval) or done >= total
                    if saved:
                        self._save_checkpoint()
                    if cfg.max_rss_gb > 0 and done < total and eval_crossed:
                        rss = _rss_gb()
                        if rss > cfg.max_rss_gb:
                            if not saved:
                                self._save_checkpoint()
                            print(
                                f"[rss-watchdog] RSS {rss:.1f} GB > --max-rss-gb "
                                f"{cfg.max_rss_gb}: checkpointed at step {self.grad_steps}; "
                                "exiting for a --resume restart",
                                flush=True,
                            )
                            self.preempted = True
                            break
        finally:
            # a batch staged for a dispatch that never ran (a preemption,
            # an error) is dropped; its rows got no write-back
            self._staged = None
        # The host tree's lagged write-back lands after the loop, so after a
        # preemption checkpoint too (as in the JAX trainer).
        self._flush_write_back()
        return last

    def _periodic(self, metrics, t_start, grad_steps_done, env_steps_start) -> dict:
        cfg = self.config
        scalars = {k: float(v) for k, v in metrics.items()}
        scalars["noise_scale"] = self._noise_scale()
        dt = time.monotonic() - t_start
        scalars.update(
            {
                "grad_steps_per_sec": grad_steps_done / dt,
                "env_steps_per_sec": (self.env_steps - env_steps_start) / dt,
                "replay_size": len(self.buffer),
                "env_steps": self.env_steps,
            }
        )
        ev = evaluate(
            cfg.agent, self.env, self.state.actor, self._eval_gen, cfg.eval_episodes
        )
        if self.ewma_return is None:
            self.ewma_return = ev["eval_return_mean"]
        else:
            self.ewma_return = (
                (1 - cfg.ewma_alpha) * self.ewma_return
                + cfg.ewma_alpha * ev["eval_return_mean"]
            )
        if self._best_eval is None or ev["eval_return_mean"] > self._best_eval:
            self._best_eval = ev["eval_return_mean"]
            self._save_best(self.grad_steps, self._best_eval)
        if self._ckpt_fallbacks:
            scalars["checkpoint_fallbacks"] = float(self._ckpt_fallbacks)
        scalars.update(ev)
        scalars["best_eval_return"] = self._best_eval
        scalars["avg_test_reward_ewma"] = self.ewma_return
        self.metrics.log(self.grad_steps, scalars, timers=self.timers)
        print(
            f"[step {self.grad_steps}] "
            + " ".join(f"{k}={v:.3f}" for k, v in scalars.items() if k != "replay_size"),
            flush=True,
        )
        return scalars

    def _save_best(self, step: int, score: float) -> None:
        """The champion actor, then its score: params first, JSON second,
        so the JSON never claims params that were not saved."""
        save_best_actor(self.config.log_dir, self.state.actor)
        save_best_eval(self.config.log_dir, step, score, self.env_steps)

    def close(self) -> None:
        self.metrics.close()


@contextlib.contextmanager
def _sync_debug_error():
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)
