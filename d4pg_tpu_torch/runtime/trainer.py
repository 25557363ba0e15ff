"""The learner loop (counterpart of ``d4pg_tpu/runtime/trainer.py``),
with replay on the host or on the device, on one device or over
data-parallel lanes and processes.

One loop in dispatches of K = ``steps_per_dispatch`` grad
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
after the first runs under ``torch.cuda.set_sync_debug_mode("error")``
and the zero-transfer budget (see Guards below).

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
counts the live steps. A host goal env collects its own episodes step by
step through its goal view (``_her_collect_episode_host``), or, with
``num_envs > 1`` or ``async_collect``, through the actor pool's goal views
with one hindsight writer an actor (a dropped actor's writer is rebuilt).

Host envs (gymnasium ids, ``dmc:`` ids; the JAX trainer's host and pool
modes): the env is built first and gives the config its dims and support
(``config.apply_env_preset(config, env)``). With ``num_envs == 1`` the
loop steps it itself through an n-step writer; otherwise the host actor
pool (``runtime/actor_pool.py``) steps N worker processes and a
:class:`~d4pg_tpu_torch.runtime.collect.PoolCollector` makes each pool step
(one batched act, the supervised step, the dropped windows, one N-wide
writer call, the per-row noise reset). Acting runs on ``actor_device``
("auto": the CPU whenever the learner is on the card, on a CPU copy of
the actor refreshed at most once a grad step). ``async_collect`` moves the
pool's collection onto a collector thread (a single env gets a pool of
1), paced from both sides at ``env_steps_per_train_step`` with per-process
counters, acting on a publication of the actor (a real copy, refreshed
every ``publish_interval`` grad steps; on the card cloned on the
learner's stream and read after its event), with its own generator. Evals
run greedy episodes on the host: through an eval pool (seed + 977 777)
when the trainer has a pool and ``eval_episodes > 1``, else on a dedicated
eval env; with ``concurrent_eval`` (the default) on an evaluator thread
that scores a publication, so an eval crossing costs no grad step.
``obs_norm`` folds the observations the policy acts on into a
:class:`~d4pg_tpu_torch.ops.obs_norm.RunningObsNorm` once per env step,
normalizes sampled batches on the host and the acting and eval forwards,
and is saved in the trainer meta and beside ``best_actor.npz``
(``best_obs_norm.json``).

The collection fleet (``fleet_listen``, the JAX trainer's fleet wiring):
after the resume, an
:class:`~d4pg_tpu_torch.fleet.ingest.IngestServer` runs in front of
``self.buffer`` (on ``fleet_listen`` + the process's index) and remote
actor hosts (``python -m d4pg_tpu_torch.fleet.actor``) stream complete
n-step windows into it, its writer thread calling ``add_batch`` as local
collection does (the device and hybrid rings mirror those rows as any
others). Beside local collection, or with ``num_envs == 0`` instead of
it: the warmup and the loop then pace on the ingested windows, which are
the run's ``env_steps``, with the ingest's ``check_alive`` and a
heartbeat line after 30 s without a window. With ``fleet_bundle`` the
acting bundle is exported there (``serve/bundle.export_bundle``) at the
start and at every ``fleet_publish_interval`` crossing, each time with
the next generation, which the ingest's stale drop follows;
``fleet_generation`` is saved in the trainer meta and restored by a
resume. Every metrics row carries the ingest's counters as ``fleet_*``,
and ``close()`` drains it.

Data parallelism (``dp``; the JAX trainer's dp wiring): ``dp`` lanes laid
out by ``parallel.mesh.make_mesh``, one process's lanes on one device.
On the host placement each dispatch splits the sampled rows over the
lanes (``parallel/dp.py``: the gradients combined by a fixed-order mean
every step, or with ``dp_hogwild`` every float tensor of each lane's own
copy once a dispatch). With ``tp`` > 1 there (``--dp D --tp N``) the
state is sharded over each dp lane's ``tp`` lanes
(``parallel/partition.py:shard_train_state``) and the same steps run the
Megatron forward of ``parallel/tp.py`` over them, the gradients combined
per tp index; without ``dp``, ``tp`` has no effect, as in the JAX
trainer, and the device placement refuses it
(``sharded_megastep_dp_only``). On the device placement the ring is striped over
the lanes, each with its PER subtree and generator, and one sharded
megastep (``runtime/megastep.py``) runs them. A process of several
(``num_processes``, after ``parallel.initialize_distributed``) owns
``replay_capacity / P`` host rows and its contiguous lanes, salts its
collection seeds with ``1_000_003 · process_index``, and agrees the fill
count at each flush; the checkpoint files live under ``run_root`` (else
``log_dir``), written by process 0 alone after every process has joined
the save's gathers (the replay snapshot and the PER sidecar in global
slot order, so any topology restores them; a process of several deals
itself its rows). The state is replicated, so process 0 saves its copy.

Compiled programs (``utils/graphs.py``, the JAX trainer's jits): every
dispatch is a program, ``train_step`` (host, K = 1), ``fused_step``
(host, K > 1) or ``megastep`` (device and hybrid), and so are the ring's
``ring_ingest`` and the device tree's ``tree_ingest``, on one device and
over the ``dp`` lanes of one process alike (the lanes' steps, hogwild
with its replicas, ``--dp D --tp N`` over the sharded state, the sharded
megastep and the lanes' ingests). On the card each is a CUDA graph
captured after one eager call and replayed; on the CPU the same bodies
run eagerly on the programs' static buffers. The host step count
advances by K around each call (:meth:`Trainer._run_program`), the PER
tiers take β as an input, and a lane program counts its combines
outside its body (``parallel/dp.py:LaneProgram``). The one eager branch,
chosen when the trainer is built: a process of several keeps its lanes'
entries eager, since their combines (gloo) are host round trips that no
CUDA graph can hold.

Each stage is also a ``host/<name>`` profiler range (and an NVTX range on
the card); ``profile_dir`` traces grad steps [10, max(60, 10 + K)) of a
leg (``utils/profiling.py``).

Guards (``debug_guards``, the JAX trainer's; ``analysis/``): on the card
every dispatch after the first runs under the zero-transfer budget
``no_transfers``: its operands (state, batch, ring, trees) are checked
once on entry, none on the host, and it runs under
``torch.cuda.set_sync_debug_mode("error")``. A
:class:`~d4pg_tpu_torch.analysis.ledger.StagingLedger` polices PER ``sample_block``'s staging slots and the
actor pool's reply slots, the recompile sentinel
(:attr:`Trainer.sentinel`, ``analysis/recompile.py``) holds the programs
to their budgets (the dispatch's count after its first call of a leg,
the ingests 1) at every eval crossing and at the end of ``train()``, and
``close()`` checks the lock witness's observed nesting against the port's
committed graph last (a no-op unless the CLI armed it). Chaos
(``chaos``, :mod:`d4pg_tpu_torch.chaos`): the flusher ticks ``wb_stall``
at each wake, a checkpoint ``ckpt_truncate`` after its manifest, a megastep or hybrid dispatch ``host_kill``, the pool
``worker_kill`` and its workers ``env_raise`` / ``env_hang``; every
metrics row carries ``chaos_injections``.

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
from collections import deque
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
from d4pg_tpu_torch.analysis import lockwitness
from d4pg_tpu_torch.analysis.ledger import StagingLedger
from d4pg_tpu_torch.analysis.recompile import RecompileSentinel
from d4pg_tpu_torch.analysis.transfer import no_transfers, sync_debug_error
from d4pg_tpu_torch.chaos import ChaosInjector, ChaosPlan, truncate_checkpoint_step
from d4pg_tpu_torch.config import (
    TrainConfig,
    apply_declared_actions,
    apply_env_preset,
    check_chaos,
    check_collection,
    check_fleet,
    check_placement,
    check_wire_dtypes,
)
from d4pg_tpu_torch.envs import ENVS, make_env
from d4pg_tpu_torch.envs.pointmass_goal import PointMassGoal
from d4pg_tpu_torch.ops.obs_norm import RunningObsNorm
from d4pg_tpu_torch.parallel.distributed import process_count, process_index
from d4pg_tpu_torch.parallel.dp import (
    lane_program,
    make_dp_fused_train_step,
    make_dp_train_step,
    make_hogwild_dp_train_step,
)
from d4pg_tpu_torch.parallel.mesh import check_one_device, make_mesh
from d4pg_tpu_torch.parallel.partition import shard_train_state, stack_axes_for
from d4pg_tpu_torch.replay import (
    PrioritizedReplayBuffer,
    ReplayBuffer,
    SampledIndices,
    Transition,
    noise_scale_schedule,
)
from d4pg_tpu_torch.replay import device_per as dper
from d4pg_tpu_torch.replay.device_per import DevicePerSync
from d4pg_tpu_torch.replay.device_ring import (
    DeviceRingSync,
    MultihostRingSync,
    ShardedDeviceRingSync,
    device_ring_init,
    lane_rings_init,
)
from d4pg_tpu_torch.replay.her import HindsightWriter
from d4pg_tpu_torch.replay.nstep_writer import BatchedNStepWriter, NStepWriter
from d4pg_tpu_torch.runtime import megastep
from d4pg_tpu_torch.runtime.actor_pool import HostActorPool
from d4pg_tpu_torch.runtime.checkpoint import (
    CheckpointManager,
    best_eval_path,
    load_trainer_meta,
    save_best_eval,
    save_trainer_meta,
    trainer_meta_path,
)
from d4pg_tpu_torch.runtime.collect import (
    ActorCopy,
    HostActing,
    PoolCollector,
    make_segment_collector,
    publish_actor,
)
from d4pg_tpu_torch.runtime.evaluator import evaluate
from d4pg_tpu_torch.runtime.metrics import MetricsLogger, StageTimers, interval_crossed
from d4pg_tpu_torch.utils import graphs
from d4pg_tpu_torch.utils.h2d import H2DStream, to_device
from d4pg_tpu_torch.utils.profiling import annotate, profile_trace
from d4pg_tpu_torch.weights import best_actor_path, save_best_actor

SEGMENT_LEN = 32  # env steps per env per collect (the JAX sync trainer's)
WIRE_FIELDS = ("obs", "next_obs")  # what --transfer-dtype narrows on the wire
WB_JOIN_S = 60.0  # how long stopping or draining the write-back thread may take
COLLECTOR_JOIN_S = 30.0  # how long stopping the async collector may take
EVAL_POOL_SEED = 977_777  # the eval pool's seed offset (the JAX trainer's)
PROCESS_SEED = 1_000_003  # a process's collection-seed offset (the JAX trainer's)


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


def _widened(batch: dict) -> dict:
    """The bfloat16 or uint8 wire's observations back to float32, on the
    device (the dispatch's first op)."""
    return {key: decode_obs(v) if key in WIRE_FIELDS else v for key, v in batch.items()}


def _rss_gb() -> float:
    """This process's resident set size in GB (Linux's ``VmRSS``)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 1024 / 1024
    raise OSError("no VmRSS line in /proc/self/status")


class Trainer:
    def __init__(self, config: TrainConfig, device=None, actor_env: Optional[str] = None):
        """``config`` as the user gives it: the env preset is applied
        here; ``batch_scale`` is not (the CLI applies it, as the JAX CLI
        does: ``config.apply_batch_scale``), so the batch is the config's.

        ``actor_env`` names a host env that the host collection (one env,
        or the actor pool) and the host evaluation step in place of
        ``config.env``, whose preset stays the learner's: the JAX fleet's
        pairing of a ``pixel_pendulum`` learner with actors that run its
        twin ``pixel_pendulum_host``. Its dims must be the preset's."""
        self.device = resolve_device(device)
        if config.env == "pixel_pendulum_host":
            raise ValueError(
                "pixel_pendulum_host is a host actor env (a pool worker's twin of "
                "pixel_pendulum, with no preset and no goal views); the JAX Trainer "
                "does not train on it either: train --env pixel_pendulum"
            )
        # a host env (gymnasium id, dmc: id) is stepped on the host: built
        # first, it gives the config its dims (the JAX _reconcile_config)
        self.host_env = config.env not in ENVS or actor_env is not None
        self.actor_env = actor_env or config.env
        if actor_env is not None:
            config = apply_env_preset(config)
            self.env = make_env(actor_env, config.max_episode_steps, config.action_repeat)
            dims = (self.env.observation_dim, self.env.action_dim)
            if dims != (config.agent.obs_dim, config.agent.action_dim):
                raise ValueError(
                    f"actor_env {actor_env!r} has (obs_dim, action_dim) {dims}; "
                    f"{config.env!r}'s preset has "
                    f"{(config.agent.obs_dim, config.agent.action_dim)}"
                )
        elif self.host_env:
            self.env = make_env(config.env, config.max_episode_steps, config.action_repeat)
            config = apply_env_preset(config, self.env)
        else:
            config = apply_env_preset(config)
            self.env = make_env(config.env, config.max_episode_steps, config.action_repeat)
        check_wire_dtypes(config)
        check_supported(config.agent)
        check_placement(config)
        check_collection(config, self.host_env, self.env)
        check_chaos(config)
        check_fleet(config)
        config = apply_declared_actions(config)
        self.config = config
        # --fleet-listen with --num-envs 0: the fleet is the only collector
        self._fleet_only = config.fleet_listen is not None and config.num_envs == 0
        agent_cfg = config.agent
        # The chaos plan (seeded, deterministic): the trainer owns wb_stall,
        # ckpt_truncate and host_kill; the pool owns worker_kill and ships
        # env_raise / env_hang into its workers.
        self._chaos = ChaosInjector(ChaosPlan.parse(config.chaos)) if config.chaos else None
        # The staging ledger (debug_guards) on PER sample_block's slots and
        # the pool's reply slots; FIFO holds, one a sampled PER block.
        self._ledger = StagingLedger("trainer") if config.debug_guards else None
        self._staging_holds: deque = deque()

        # Data parallelism: the lane layout and this process's place in it
        # (parallel/). Each process owns capacity/P rows of the replay and
        # salts its collection seeds with its index; the train state and
        # the lanes' draws are seeded alike everywhere.
        self._procs, self._proc_idx = process_count(), process_index()
        if config.num_processes != self._procs:
            raise ValueError(
                f"num_processes={config.num_processes}, but the process group has "
                f"{self._procs}: call parallel.initialize_distributed before the Trainer"
            )
        self.mesh = None
        if config.dp:
            self.mesh = make_mesh(config.dp, config.tp, device=self.device)
            self.device = check_one_device(self.mesh)
        self._shared_dir = config.run_root or config.log_dir
        self._collect_seed = config.seed + PROCESS_SEED * self._proc_idx
        host_capacity = config.replay_capacity // self._procs

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
            self.buffer = ReplayBuffer(host_capacity, obs_dim, act_dim, **storage)
        elif config.prioritized:
            self.buffer = PrioritizedReplayBuffer(
                config.replay_capacity, obs_dim, act_dim,
                alpha=agent_cfg.per_alpha, beta0=agent_cfg.per_beta0,
                beta_steps=agent_cfg.per_beta_steps, eps=agent_cfg.per_eps,
                tree_backend=config.tree_backend, **storage,
            )
            self.buffer.set_ledger(self._ledger)
        else:
            self.buffer = ReplayBuffer(config.replay_capacity, obs_dim, act_dim, **storage)

        self.state = create_train_state(agent_cfg, config.seed, self.device)
        if self.mesh is not None and config.tp > 1:
            # --tp N with --dp on the host placement: the state sharded
            # over each dp lane's tp lanes, stepped by the TP step
            self.state = shard_train_state(self.state, self.mesh,
                                           stack_axes=stack_axes_for(agent_cfg))
        # Host sampling draws from numpy; acting, resets and eval from
        # torch generators on the device. Each stream has its own seed.
        self._rng = np.random.default_rng(self._collect_seed)
        self._collect_gen = torch.Generator(self.device).manual_seed(self._collect_seed + 1)
        self._eval_gen = torch.Generator(self.device).manual_seed(config.seed + 2)

        self.her_writer = None
        self.her_writers = None
        if not self.host_env and not self._fleet_only:
            noise_fns = make_noise(agent_cfg, (config.num_envs,), self.device)
            self._collect = make_segment_collector(
                agent_cfg, self.env, config.num_envs, SEGMENT_LEN, noise_fns
            )
            self.env_states, self.obs = self.env.reset(
                config.num_envs, self._collect_gen, self.device
            )
            self.noise_states = noise_fns[0]()
            if config.her:
                self._setup_her()
        self._init_host_state()

        self._ring = self._ring_sync = self._dev_per = self._megastep = None
        # the dispatches as compiled programs (utils/graphs.py: a CUDA graph
        # captured after one eager dispatch on the card), on one device and
        # over the lanes of one process; the lanes of several processes
        # stay eager (their combines cross the processes on the host)
        self._train_step_prog = self._fused_step_prog = self._megastep_prog = None
        self._compiled = self._procs == 1
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
        self._wb_idle_lock = lockwitness.named_lock("Trainer._wb_idle_lock")
        self.writebacks_applied = 0  # dispatches whose priorities reached the tree
        # the host placement's --dp steps: the batch's rows split over the
        # lanes, gradients combined every step (or every K with hogwild)
        self._dp_step = self._dp_fused = None
        if self.mesh is not None and config.replay_placement == "host":
            self._dp_step = make_dp_train_step(agent_cfg, self.mesh)
            if config.steps_per_dispatch > 1:
                fused = (make_hogwild_dp_train_step if config.dp_hogwild
                         else make_dp_fused_train_step)
                self._dp_fused = fused(agent_cfg, self.mesh)
        if self.mesh is not None and self.on_device:
            self._init_sharded_megastep()
        elif self.on_device or self.hybrid:
            self._ring = device_ring_init(config.replay_capacity, obs_dim, act_dim, self.device)
            self._ring_sync = DeviceRingSync(self.buffer)
            if self.hybrid:
                self._megastep = megastep.make_megastep_hybrid(agent_cfg)
                if self.mesh is None:
                    self._megastep_prog = megastep.hybrid_program(agent_cfg, self.state,
                                                                  self._ring)
            else:
                self._init_megastep()
        if self._compiled:
            self._init_host_programs()
        self._init_sentinel()

        self.env_steps = 0
        self.grad_steps = 0
        self.ewma_return: Optional[float] = None
        self._best_eval: Optional[float] = None
        self.timers = StageTimers()
        for name in StageTimers.STAGES:  # every row carries every stage
            self.timers.ensure(name)
        # a league learner's identity on every row (absent outside leagues)
        self.metrics = MetricsLogger(
            config.log_dir,
            static=None if config.variant_id is None else {
                "variant_id": float(config.variant_id),
                "league_generation": float(config.league_generation),
            },
        )
        # the shared files (checkpoints, trainer meta, replay snapshot, PER
        # sidecar) live under run_root; process 0 alone writes them
        self.ckpt = CheckpointManager(os.path.join(self._shared_dir, "checkpoints"))
        self.preempted = False
        # Signal handlers only set this event (signal- and thread-safe);
        # the train and warmup loops act on it at their next iteration.
        self._preempt_requested = threading.Event()
        self._replay_restored = False
        self._ckpt_fallbacks = 0
        # the fleet's bundle generation, restored with the trainer meta
        self._fleet_gen = 0
        if config.resume and self.ckpt.latest_step() is not None:
            with self.timers.stage("checkpoint_restore"):
                self._resume()
        # Per-process counters for async pacing: the checkpoint-restored
        # global ones would make a resumed learner wait for ratio x (all
        # past steps) of fresh collection, or its collector collect nothing.
        self._learner_steps = 0
        self._env_steps_origin = self.env_steps
        self._fleet = None
        if config.fleet_listen is not None:
            self._start_fleet()
        if self.host_env and not self._fleet_only:
            # after the resume, as in the JAX trainer
            if config.her:
                self._setup_her()
            elif config.num_envs > 1 or config.async_collect:
                self._setup_pool_collect()
            else:
                self._setup_host_collect()

    def _init_megastep(self) -> None:
        """The single-device megastep of the device placement, its device
        PER tree and its generator."""
        cfg, agent_cfg = self.config, self.config.agent
        K, B = cfg.steps_per_dispatch, cfg.batch_size
        if cfg.prioritized:
            self._dev_per = DevicePerSync(cfg.replay_capacity, agent_cfg.per_alpha,
                                          device=self.device)
            self._ring_sync.tree_hook = self._dev_per.on_chunk
            if cfg.fused_descent:
                mega = megastep.make_megastep_device_per_fused(agent_cfg, K, B)
            else:
                mega = megastep.make_megastep_device_per(agent_cfg, K, B)
            # the one lane's tree (the sharded megasteps take every lane's)
            self._megastep = lambda state, ring, trees, gen: mega(state, ring, trees[0], gen)
        else:
            self._megastep = megastep.make_megastep_uniform(agent_cfg, K, B)
        # the megastep's draws come from their own device generator
        self._megastep_gen = torch.Generator(self.device).manual_seed(cfg.seed + 3)
        self._megastep_prog = megastep.megastep_program(
            agent_cfg, K, B, self.state, self._ring,
            None if self._dev_per is None else self._dev_per.tree, self._megastep_gen,
            fused=cfg.prioritized and cfg.fused_descent)

    def _init_host_programs(self) -> None:
        """The host placement's dispatches as compiled programs: ``train_step``
        (K = 1) and, with K > 1, ``fused_step`` (``fused_train_scan``). On
        one device both exist on every placement, as the JAX trainer's
        jits do; only the host placement calls them. With ``dp`` (one
        process, the host placement) they run the lanes' steps
        (``parallel/dp.py``), each a :class:`~d4pg_tpu_torch.parallel.dp.
        LaneProgram` that counts its combines outside the body; with
        ``tp`` over the sharded state, with ``dp_hogwild`` over the state
        and its replicas, made here. Input: the device batch (the wire's
        bfloat16 or uint8 observations are widened inside); outputs: the
        K-step mean metrics and the priorities."""
        k = self.config.steps_per_dispatch
        if self.mesh is None:
            state = lambda: megastep.learner_tensors(self.state)  # noqa: E731
            gens = megastep.learner_generators(self.state)
            self._train_step_prog = graphs.Program("train_step", self._host_step_body,
                                                   self.device, state=state, generators=gens)
            if k > 1:
                self._fused_step_prog = graphs.Program("fused_step", self._host_scan_body,
                                                       self.device, state=state, generators=gens)
            return
        if self._dp_step is None:
            return  # the sharded megastep's placement: no host dispatch
        states = lambda: [self.state]  # noqa: E731
        self._train_step_prog = lane_program("train_step", self._host_step_body, states,
                                             [self._dp_step.sync], self.device)
        if k > 1:
            if self.config.dp_hogwild:
                replicas = self._dp_fused.bind(self.state)
                states = lambda: [self.state, *replicas]  # noqa: E731
            self._fused_step_prog = lane_program("fused_step", self._host_scan_body, states,
                                                 [self._dp_fused.sync], self.device)

    def _host_step_body(self, batch: dict):
        if self._dp_step is None:
            _, metrics, priorities = train_step(self.config.agent, self.state, _widened(batch))
        else:
            _, metrics, priorities = self._dp_step(self.state, _widened(batch))
        return metrics, priorities

    def _host_scan_body(self, batch: dict):
        if self._dp_fused is None:
            _, metrics_k, priorities = fused_train_scan(self.config.agent, self.state,
                                                        _widened(batch))
        else:
            _, metrics_k, priorities = self._dp_fused(self.state, _widened(batch))
        return {key: v.mean() for key, v in metrics_k.items()}, priorities

    def _init_sentinel(self) -> None:
        """The recompile sentinel under ``debug_guards`` (the JAX trainer's
        entries): ``train_step``, ``fused_step`` (K > 1) and, on the device
        and hybrid placements, ``megastep`` and ``ring_ingest`` (budget 1:
        one fixed chunk shape), with device PER ``tree_ingest`` (budget 1),
        on one device and over the lanes of one process alike. The
        dispatch's budget is pinned after the first dispatch of each
        ``train()`` leg and checked at every eval crossing and at its end.
        The eager entries of several processes count 0, where the JAX
        multi-process jits count 1 (ROADMAP, "Not mirrored, on purpose")."""
        self.sentinel = None
        if not self.config.debug_guards:
            return
        self.sentinel = RecompileSentinel().start()
        self.sentinel.track("train_step", self._train_step_prog or self._dp_step)
        fused = self._fused_step_prog or self._dp_fused
        if fused is not None:  # K > 1 off the sharded megastep's placement
            self.sentinel.track("fused_step", fused)
        if self._megastep is not None:
            self.sentinel.track("megastep", self._megastep_prog or self._megastep)
            self.sentinel.track("ring_ingest", getattr(self._ring_sync, "ingest_program", None),
                                budget=1)
            if self._dev_per is not None:
                self.sentinel.track("tree_ingest", self._dev_per.ingest_program, budget=1)

    def _run_program(self, prog, *args):
        """One call of a learner program. The host step count advances by K
        here, whatever the call ran: an eager call (which advances it in
        the body), a capture (whose Python ran once), or a replay (no
        Python)."""
        step = self.state.step
        out = prog(*args)
        self.state.step = step + self.config.steps_per_dispatch
        return out

    def _init_sharded_megastep(self) -> None:
        """The sharded megastep of ``--dp`` on the device placement: this
        process's lanes, each with its striped ring, (PER) its subtree and
        its generator; the ring sync of a single process or of one of
        several."""
        cfg, agent_cfg = self.config, self.config.agent
        K, B = cfg.steps_per_dispatch, cfg.batch_size
        self._ring = lane_rings_init(cfg.replay_capacity, agent_cfg.obs_dim, agent_cfg.action_dim,
                                     self.mesh)
        sync_cls = MultihostRingSync if self._procs > 1 else ShardedDeviceRingSync
        self._ring_sync = sync_cls(self.buffer, self.mesh)
        if cfg.prioritized:
            self._dev_per = DevicePerSync(cfg.replay_capacity, agent_cfg.per_alpha, mesh=self.mesh)
            self._ring_sync.tree_hook = self._dev_per.on_lane_chunk
            self._megastep = megastep.make_megastep_device_per_sharded(agent_cfg, K, B, self.mesh)
        else:
            self._megastep = megastep.make_megastep_uniform_sharded(agent_cfg, K, B, self.mesh)
        self._megastep_gen = megastep.lane_generators(cfg.seed + 3, self.mesh)
        if self._compiled:
            self._megastep_prog = megastep.sharded_megastep_program(
                agent_cfg, K, B, self.mesh, self.state, self._ring,
                None if self._dev_per is None else self._dev_per.trees, self._megastep_gen)

    def _init_host_state(self) -> None:
        """The host-env collection, publication and evaluation state (inert
        for a torch env)."""
        cfg = self.config
        self.obs_norm = RunningObsNorm(cfg.agent.obs_dim) if cfg.obs_norm else None
        # Where host-env collection and eval forwards run: "auto" is the CPU
        # whenever the learner is on the card.
        cpu = torch.device("cpu")
        if cfg.actor_device == "cpu" or (cfg.actor_device == "auto" and self.device.type == "cuda"):
            self._act_device = cpu
        else:
            self._act_device = self.device
        # the collection's own stream: a background collector never races
        # the learner thread on a generator
        self._act_gen = torch.Generator(self._act_device).manual_seed(self._collect_seed + 5)
        # sync acting on the CPU while the learner is on the card: a CPU
        # copy refreshed at most once a grad step (made at first use)
        self._sync_copy: Optional[ActorCopy] = None
        self.pool: Optional[HostActorPool] = None
        self.collector: Optional[PoolCollector] = None
        self.batched_writer = None
        self._eval_pool: Optional[HostActorPool] = None
        self._eval_env = None
        self._eval_acting: Optional[HostActing] = None
        # --async-collect: the published actor copy, the collector thread
        self._actor_pub = None
        self._pub_version = 0
        self._collector_copy: Optional[ActorCopy] = None
        self._stop_collect = threading.Event()
        self._collector: Optional[threading.Thread] = None
        self._collector_error: Optional[BaseException] = None
        # --concurrent-eval: the evaluator thread scores published copies
        self._eval_copy: Optional[ActorCopy] = None
        self._eval_thread: Optional[threading.Thread] = None
        self._eval_req = None  # latest pending (publication, step, scalars, env_steps, norm)
        self._eval_req_lock = lockwitness.named_lock("Trainer._eval_req_lock")
        self._eval_pending = threading.Event()
        self._eval_idle = threading.Event()
        self._eval_idle.set()
        self._eval_stop = threading.Event()
        self._eval_error: Optional[BaseException] = None
        # set when the evaluator outlived its shutdown join: close() then
        # leaves the eval pool, env and metrics to it rather than closing
        # them under a worker still stepping them
        self._eval_leaked = False
        self._last_eval_row: dict = {}
        self._last_eval_ev: dict = {}

    @property
    def has_pool(self) -> bool:
        return self.pool is not None

    # ------------------------------------------------------------ checkpoints
    def _replay_snapshot_path(self) -> str:
        return os.path.join(self._shared_dir, "checkpoints", "replay.npz")

    def _device_per_snapshot_path(self) -> str:
        return os.path.join(self._shared_dir, "checkpoints", "device_per.npz")

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
        if getattr(self._dp_fused, "replicas", None):
            # the hogwild program's replicas take the restored state by copy_
            self._dp_fused.reload()
        self.grad_steps = self.state.step
        meta = load_trainer_meta(self._shared_dir)
        # env_steps drives the noise schedule: without it a resumed run
        # would re-explore at full scale
        self.env_steps = int(meta.get("env_steps", 0))
        self.ewma_return = meta.get("ewma_return")
        # restarting at 0 would fall below the generations connected actors
        # hold and disarm the ingest's stale drop until it caught up
        self._fleet_gen = int(meta.get("fleet_generation", 0))
        # a flag/meta mismatch is an error both ways: a net trained on
        # normalized observations sees inputs far off its trained scale
        if self.obs_norm is not None:
            if "obs_norm" not in meta:
                raise ValueError(
                    "--obs-norm resume: checkpoint has no saved "
                    "normalizer statistics (was the run trained "
                    "without --obs-norm?)"
                )
            self.obs_norm.load_state_dict(meta["obs_norm"])
        elif "obs_norm" in meta:
            raise ValueError(
                "checkpoint was trained WITH --obs-norm; resuming "
                "without it would feed the nets un-normalized inputs"
            )
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
                if self._procs > 1:
                    # the snapshot holds the GLOBAL ring in global slot
                    # order: this process takes the rows of its lanes
                    with np.load(snap, allow_pickle=False) as z:
                        n = self._ring_sync.deal_snapshot(z)
                else:
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
            ring_snap = per_snap = None
            if self._procs > 1:
                # every collective of the save first, on every process in
                # one order (the flush, the ring's and the tree's gathers);
                # then process 0 alone writes
                if cfg.snapshot_replay:
                    with self.timers.stage("ingest_chunk"):
                        self._ring_sync.flush(self._ring)
                    ring_snap = self._ring_sync.gather_snapshot(self._ring)
                    if self._dev_per is not None:
                        per_snap = self._dev_per.snapshot_host()
                if self._proc_idx != 0:
                    return
            self.ckpt.save(self.grad_steps, self.state)
            extra = {"obs_norm": self.obs_norm.state_dict()} if self.obs_norm is not None else {}
            if self._fleet is not None:
                extra["fleet_generation"] = self._fleet_gen
            if cfg.variant_id is not None:
                # the league controller's fork attestation: a clone that
                # saves under its own id restored the fork and progressed
                extra["variant_id"] = int(cfg.variant_id)
                extra["league_generation"] = int(cfg.league_generation)
            save_trainer_meta(self._shared_dir, self.env_steps, self.ewma_return, extra=extra)
            side = [trainer_meta_path(self._shared_dir)]
            if cfg.snapshot_replay:
                # in-flight async write-backs land first, or the snapshot
                # freezes priorities the flusher was about to overwrite
                self._drain_writeback()
                if ring_snap is not None:
                    path = self._replay_snapshot_path()
                    with open(path + ".tmp", "wb") as f:
                        np.savez(f, **ring_snap)
                    os.replace(path + ".tmp", path)
                else:
                    self.buffer.snapshot(self._replay_snapshot_path())
                side.append(self._replay_snapshot_path())
                if self._dev_per is not None:
                    if per_snap is None:
                        # Rows the ring has not mirrored yet (all of them
                        # after a preemption during the warmup) have no
                        # leaves in the tree; flush them first so the
                        # sidecar names every row of replay.npz, as the JAX
                        # multi-process save does.
                        with self.timers.stage("ingest_chunk"):
                            self._ring_sync.flush(self._ring)
                        per_snap = self._dev_per.snapshot_host()
                    pa, mp = per_snap
                    dp_path = self._device_per_snapshot_path()
                    tmp = dp_path + ".tmp"
                    with open(tmp, "wb") as f:  # a file object: savez appends no suffix
                        np.savez(f, priorities_alpha=pa, max_priority=mp)
                    os.replace(tmp, dp_path)
                    side.append(dp_path)
            self.ckpt.write_manifest(self.grad_steps, side_files=side)
            if self._chaos is not None and self._chaos.tick("ckpt_truncate") is not None:
                # corrupt the COMMITTED step: a resume's verify-on-restore
                # must catch what the manifest attests against
                step_dir = self.ckpt.step_dir(self.grad_steps)
                if step_dir is not None:
                    truncate_checkpoint_step(step_dir)

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
        """The hindsight writer(s). A pure goal env (``pointmass_goal``)
        rolls its single-env episodes on the device; a host goal env
        (``is_goal_env``: a goal-dict gymnasium adapter) collects through
        the host actor pool's goal views with one hindsight writer an actor
        when ``num_envs > 1`` or ``async_collect``, else its own episodes
        on the host."""
        cfg = self.config
        env = self.env
        if self.host_env:
            if not (hasattr(env, "compute_reward") and getattr(env, "is_goal_env", False)):
                raise ValueError(f"--her needs a goal env, got {cfg.env}")
            self._her_reward_fn = env.compute_reward
            if cfg.num_envs > 1 or cfg.async_collect:
                self.her_writers = [self._make_her_writer(env.compute_reward)
                                    for _ in range(cfg.num_envs)]
                self._setup_pool_collect()
                return
            self.her_writer = self._make_her_writer(env.compute_reward)
            self._her_acting = HostActing(cfg.agent, 1, self._act_device, self._act_gen)
            self.her_episodes = 0
            return
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
        self._her_gen = torch.Generator(self.device).manual_seed(self._collect_seed + 4)
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
        if self.host_env:
            return self._her_collect_episode_host(noise_scale)
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

    def _her_collect_episode_host(self, noise_scale: Optional[float] = None) -> float:
        """One exploratory episode of a host goal env through the hindsight
        writer, step by step with the adapter's goal view
        (``last_goal_obs``); returns its reward sum."""
        env = self.env
        scale = self._noise_scale() if noise_scale is None else noise_scale
        obs = env.reset()
        ep_return, term = 0.0, False
        actor, wait = self._acting_actor()
        for _ in range(self.config.max_episode_steps):
            with self.timers.stage("env_step"):
                g0 = env.last_goal_obs
                a = self._her_acting.explore(actor, self._ingest_obs(obs)[None], scale, wait)[0]
                obs2, r, term, trunc, _ = env.step(a)
                g1 = env.last_goal_obs
            with self.timers.stage("replay_insert"):
                self.her_writer.add(
                    observation=np.ravel(g0["observation"]),
                    achieved_goal=np.ravel(g0["achieved_goal"]),
                    desired_goal=np.ravel(g0["desired_goal"]),
                    action=a,
                    reward=float(r),
                    next_observation=np.ravel(g1["observation"]),
                    next_achieved_goal=np.ravel(g1["achieved_goal"]),
                    terminated=bool(term),
                )
            ep_return += float(r)
            self.env_steps += 1
            obs = obs2
            if term or trunc:
                break
        with self.timers.stage("replay_insert"):
            self.her_writer.end_episode(truncated=not term)
        self._her_acting.reset_noise(np.ones(1, bool))
        self.her_episodes += 1
        return ep_return

    # ------------------------------------------------------ host collection
    def _ingest_obs(self, x: np.ndarray) -> np.ndarray:
        """The collection-side view: fold the observed observations into the
        running statistics (once per env step, the distribution the stats
        should track), then return the normalized copy the policy acts on.
        Identity without ``obs_norm``."""
        if self.obs_norm is None:
            return x
        self.obs_norm.update(x)
        return self.obs_norm.normalize(x)

    def _norm_obs(self, x: np.ndarray) -> np.ndarray:
        """The read-only normalizer view for eval forwards."""
        return x if self.obs_norm is None else self.obs_norm.normalize(x)

    def _acting_actor(self):
        """(actor, wait_caller) that sync host collection and inline eval act
        with: the live actor on the learner's device (the acting stream
        waits for the learner's enqueued work), or a CPU copy of it
        refreshed at most once a grad step."""
        if self._act_device == self.device:
            return self.state.actor, True
        if self._sync_copy is None:
            self._sync_copy = ActorCopy(self.state.actor, self._act_device)
        if self._sync_copy.version != self.grad_steps:
            self._sync_copy.load(publish_actor(self.state.actor, self._act_device, self.grad_steps))
        return self._sync_copy.module, False

    def _setup_host_collect(self) -> None:
        """One host env stepped by the loop itself, through an n-step
        writer (the JAX trainer's single-env host path)."""
        cfg = self.config
        self.writers = [NStepWriter(self.buffer, cfg.n_step, cfg.agent.gamma)]
        self._host_obs = self.env.reset(seed=self._collect_seed)
        self._host_acting = HostActing(cfg.agent, 1, self._act_device, self._act_gen)

    def _host_collect_steps(self, num_steps: int, noise_scale: Optional[float] = None) -> None:
        w = self.writers[0]
        scale = self._noise_scale() if noise_scale is None else noise_scale
        actor, wait = self._acting_actor()
        for _ in range(num_steps):
            with self.timers.stage("env_step"):
                a = self._host_acting.explore(
                    actor, self._ingest_obs(self._host_obs)[None], scale, wait)[0]
                obs2, r, term, trunc, _ = self.env.step(a)
            with self.timers.stage("replay_insert"):
                w.add(self._host_obs, a, r, obs2, terminated=term, truncated=trunc)
            if term or trunc:
                self._host_obs = self.env.reset()
                self._host_acting.reset_noise(np.ones(1, bool))
            else:
                self._host_obs = obs2
            self.env_steps += 1

    def _setup_pool_collect(self) -> None:
        """The host actor pool: N env worker processes, one batched act per
        pool step (:class:`~d4pg_tpu_torch.runtime.collect.PoolCollector`),
        one N-wide n-step writer (or one hindsight writer an actor); the
        pool reset at the seed."""
        cfg = self.config
        self.pool = HostActorPool(
            self.actor_env, cfg.num_envs, cfg.max_episode_steps, seed=self._collect_seed,
            start_method=cfg.pool_start_method, action_repeat=cfg.action_repeat,
            step_timeout_s=cfg.pool_step_timeout_s,
            max_worker_failures=cfg.pool_max_worker_failures,
            ledger=self._ledger, chaos=self._chaos,
        )
        if self.her_writers is None:
            self.batched_writer = BatchedNStepWriter(
                self.buffer, cfg.num_envs, cfg.n_step, cfg.agent.gamma)
        self.collector = PoolCollector(
            cfg.agent, self.pool, HostActing(cfg.agent, cfg.num_envs, self._act_device, self._act_gen),
            writer=self.batched_writer, her_writers=self.her_writers,
            make_her_writer=lambda: self._make_her_writer(self._her_reward_fn),
            ingest=self._ingest_obs, timers=self.timers,
        )
        self.collector.reset(seed=self._collect_seed)

    def _pool_collect_steps(self, num_steps: int, noise_scale: Optional[float] = None) -> None:
        """Collect about ``num_steps`` env steps across the pool (rounded up
        to whole pool steps of N envs), with the published copy under
        ``async_collect``, else the acting actor."""
        scale = self._noise_scale() if noise_scale is None else noise_scale
        N = self.config.num_envs
        if self._actor_pub is not None:
            actor = self._collector_copy.load(self._actor_pub, self.collector.acting.stream)
            wait = False
        else:
            actor, wait = self._acting_actor()
        for _ in range(max(1, -(-num_steps // N))):
            self.env_steps += self.collector.step(actor, scale, wait)

    # ------------------------------------------------------- async collection
    def _publish_params(self) -> None:
        """A real copy of the actor for the collector thread: Adam updates
        the live actor in place, so the collector never reads it."""
        self._pub_version += 1
        self._actor_pub = publish_actor(self.state.actor, self._act_device, self._pub_version)

    # ----------------------------------------------------------------- fleet
    def _start_fleet(self) -> None:
        """The experience-ingest server in front of ``self.buffer`` (after
        the resume, so the first bundle published carries the restored
        params): on ``fleet_listen`` + this process's index (an explicit
        0 stays 0, ephemeral on every process), its capabilities the
        replay's, its obs-norm fold the run's normalizer."""
        from d4pg_tpu_torch.fleet.ingest import IngestServer
        from d4pg_tpu_torch.replay.source import from_train_config, learner_fleet_caps

        cfg = self.config
        agent_cfg = cfg.agent
        self._fleet = IngestServer(
            self.buffer,
            obs_dim=agent_cfg.obs_dim,
            action_dim=agent_cfg.action_dim,
            n_step=cfg.n_step,
            gamma=agent_cfg.gamma,
            host=cfg.fleet_host,
            port=cfg.fleet_listen + self._proc_idx if cfg.fleet_listen else cfg.fleet_listen,
            queue_limit=cfg.fleet_queue_limit,
            max_gen_lag=cfg.fleet_max_gen_lag,
            caps=learner_fleet_caps(from_train_config(cfg)),
            obs_norm=self.obs_norm,
            ledger=self._ledger,
            chaos=self._chaos,
        ).start()
        print(f"[fleet] ingest listening on :{self._fleet.port}", flush=True)
        self._fleet_stall_mark = -1  # the first check records the baseline
        self._fleet_stall_t = time.monotonic()
        if cfg.fleet_bundle:
            self._fleet_publish()

    def _fleet_publish(self) -> None:
        """Export the acting bundle for the fleet's actors and move the
        ingest to the current generation: the fleet's weight distribution.
        The export (params first, json last, each atomic) is the sync:
        actors poll ``bundle.json``'s mtime and swap, and windows made
        under bundles older than ``generation − fleet_max_gen_lag`` are
        dropped at the ingest."""
        from d4pg_tpu_torch.serve.bundle import export_bundle

        cfg = self.config
        norm = getattr(self.env, "_normalize", None)
        export_bundle(
            cfg.fleet_bundle,
            cfg.agent,
            self.state.actor,
            action_low=None if norm is None else norm.low,
            action_high=None if norm is None else norm.high,
            # the statistics ride the bundle, tagged by meta.stats_generation
            obs_norm_state=None if self.obs_norm is None else self.obs_norm.state_dict(),
            meta={
                "generation": self._fleet_gen,
                "stats_generation": self._fleet_gen,
                "env": cfg.env,
                "grad_steps": self.grad_steps,
                "log_dir": os.path.abspath(cfg.log_dir),
                "source": "fleet_publish",
            },
            prioritized=cfg.prioritized,
        )
        if self._fleet is not None:
            self._fleet.set_generation(self._fleet_gen)
        print(f"[fleet] published bundle generation {self._fleet_gen} -> {cfg.fleet_bundle}",
              flush=True)

    def _fleet_env_steps(self) -> int:
        """Fleet-only: the ingested windows are the env-step count (one a
        step in steady state, a burst at each episode's tail; close enough
        for the pacing and the noise schedule)."""
        self.env_steps = self._env_steps_origin + self._fleet.counters()["windows_ingested"]
        return self.env_steps

    def _fleet_stall_check(self) -> None:
        """A heartbeat while the fleet-only learner waits: it outlives actor
        churn, so a starved wait never raises, but when no window arrived
        for 30 s it says so, with the live connection count."""
        c = self._fleet.counters()
        now = time.monotonic()
        if c["windows_ingested"] != self._fleet_stall_mark:
            self._fleet_stall_mark = c["windows_ingested"]
            self._fleet_stall_t = now
        elif now - self._fleet_stall_t >= 30.0:
            print(
                "[fleet] WARNING: no windows ingested for "
                f"{now - self._fleet_stall_t:.0f}s "
                f"({c['connections']} live actor connections) — the "
                "learner is paced by remote actors and will wait",
                flush=True,
            )
            self._fleet_stall_t = now  # once an interval

    def _wait_for_fleet(self) -> bool:
        """Fleet-only pacing, as ``_wait_for_collector`` paces on the
        collector: until the ingested windows hold the env:train ratio and
        the buffer can serve a batch. A dead ingest thread raises; False
        when a preemption interrupted the wait."""
        cfg = self.config
        while (
            self._fleet_env_steps() - self._env_steps_origin
            < self._effective_warmup() + cfg.env_steps_per_train_step * self._learner_steps
        ) or len(self.buffer) < cfg.batch_size:
            self._fleet.check_alive()
            self._fleet_stall_check()
            if self._preempt_requested.is_set():
                return False
            time.sleep(0.002)
        return True

    def _collector_loop(self) -> None:
        cfg = self.config
        ratio = cfg.env_steps_per_train_step
        slack = max(cfg.num_envs * 4, 64)
        try:
            while not self._stop_collect.is_set():
                target = self._effective_warmup() + ratio * self._learner_steps + slack
                fresh = self.env_steps - self._env_steps_origin
                if fresh >= target and len(self.buffer) >= cfg.batch_size:
                    time.sleep(0.002)
                    continue
                noise = 3.0 if self.env_steps < self._effective_warmup() else None
                self._pool_collect_steps(cfg.num_envs, noise_scale=noise)
        except BaseException as e:  # surfaced by the learner's pacing loop
            self._collector_error = e
            raise

    def _check_collector_alive(self) -> None:
        if self._collector is not None and not self._collector.is_alive():
            raise RuntimeError(
                "async collector thread died; training cannot make progress"
            ) from self._collector_error

    def _start_collector(self) -> None:
        if not self.has_pool:
            raise ValueError(
                "async_collect needs the host actor pool (a gymnasium env id); "
                "pure-JAX envs collect on-device in the learner stream"
            )
        if self._collector is not None and self._collector.is_alive():
            raise RuntimeError(
                "a collector thread is already running; call _stop_collector() "
                "(train() does this even on error) before starting another"
            )
        self._stop_collect.clear()
        self._collector_error = None
        if self._collector_copy is None:
            self._collector_copy = ActorCopy(self.state.actor, self._act_device)
        self._publish_params()
        self._collector = threading.Thread(
            target=self._collector_loop, name="collector", daemon=True
        )
        self._collector.start()

    def _stop_collector(self) -> None:
        self._stop_collect.set()
        if self._collector is not None:
            self._collector.join(timeout=COLLECTOR_JOIN_S)
            self._collector = None

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
        """Pre-fill replay with high-noise exploration. The env-step count
        alone is not enough: hindsight writers flush only at episode ends,
        so collection goes on until the buffer can serve a batch."""
        cfg = self.config
        while self.env_steps < self._effective_warmup() or len(self.buffer) < cfg.batch_size:
            if self._preempt_requested.is_set():
                return  # the train loop's first check checkpoints
            if self._fleet_only:
                # the remote hosts pay the warmup
                self._fleet.check_alive()
                self._fleet_env_steps()
                self._fleet_stall_check()
                time.sleep(0.01)
            elif self.has_pool:  # the pool handles HER itself
                self._pool_collect_steps(cfg.num_envs * 8, noise_scale=3.0)
            elif self.host_env and not cfg.her:
                self._host_collect_steps(64, noise_scale=3.0)
            else:
                self._collect_once(noise_scale=3.0)

    def _collect_budgeted(self, budget: float) -> float:
        """Synchronous collection for ``budget`` env steps' worth in whole
        units (a pool step of N envs, a HER episode, a device segment, or
        single host env steps); returns the budget left."""
        cfg = self.config
        if self.has_pool:
            while budget >= cfg.num_envs:
                self._pool_collect_steps(cfg.num_envs)
                budget -= cfg.num_envs
        elif self.host_env and not cfg.her:
            n = int(budget)
            if n > 0:
                self._host_collect_steps(n)
                budget -= n
        else:
            # HER: one episode a collection, budgeted at its full length
            per_collect = cfg.max_episode_steps if cfg.her else cfg.num_envs * SEGMENT_LEN
            while budget >= per_collect:
                self._collect_once()
                budget -= per_collect
        return budget

    def _wait_for_collector(self) -> bool:
        """``async_collect`` pacing: wait until the collector has held the
        env:train ratio (against the per-process counters, so chunked and
        resumed legs keep collecting) and the buffer can serve a batch.
        False when a preemption interrupted the wait."""
        cfg = self.config
        while (
            self.env_steps - self._env_steps_origin
            < self._effective_warmup() + cfg.env_steps_per_train_step * self._learner_steps
        ) or len(self.buffer) < cfg.batch_size:
            self._check_collector_alive()
            if self._preempt_requested.is_set():
                return False
            time.sleep(0.001)
        return True

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
                hold = block.pop("_staging_hold", None)
                if hold is not None:
                    # released once the dispatch that reads this block has
                    # run (_release_staging_holds)
                    self._staging_holds.append(hold)
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
            if self.obs_norm is not None:
                # normalize ONLY: the statistics fold at collection time
                # (_ingest_obs), once per observed env step; normalize
                # returns fresh arrays, so staging slots stay untouched
                block = dict(block)
                block["obs"] = self.obs_norm.normalize(block["obs"])
                block["next_obs"] = self.obs_norm.normalize(block["next_obs"])
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
            # the next. The indices are fresh copies, so the lagged and the
            # flusher's write-backs never read the slot. Pinning the slots
            # themselves would have to honour the rotation. Under
            # debug_guards the ledger holds the slot until the dispatch
            # that reads the block has run: the last reader on the CPU, and
            # later than pin_memory, the last one on the card.
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

    def _release_staging_holds(self, n: int = 1) -> None:
        """Release the oldest ``n`` staging-ledger holds (FIFO: blocks are
        sampled and dispatched in one order). No-op with guards off."""
        for _ in range(min(n, len(self._staging_holds))):
            self._staging_holds.popleft().release()

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
                if self._chaos is not None:
                    # chaos wb_stall: a slow flusher must only slow the
                    # write-backs, never trip a guard or drop an update
                    e = self._chaos.tick("wb_stall")
                    if e is not None:
                        time.sleep(e.arg if e.arg is not None else 0.5)
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
    def _dispatch_guard(self, *operands):
        """The guards of a steady-state dispatch under ``debug_guards`` on
        the card (the first dispatch builds and loads the kernels, which may
        synchronise): the zero-transfer budget ``no_transfers``, which
        checks the dispatch's operands once on entry (none may lie on the
        host) and runs it under ``set_sync_debug_mode("error")``."""
        if not (self.config.debug_guards and self.device.type == "cuda" and self._dispatches):
            return contextlib.nullcontext()
        return no_transfers(*operands)

    def _tick_host_kill(self) -> None:
        """Chaos ``host_kill@N[:victim]``: SIGKILL this process at its Nth
        megastep or hybrid dispatch when it is the victim (default 0). The
        survivors block or fail on their next collective; the supervisor
        (``tools/multihost_smoke.py``) reaps them and relaunches the run."""
        if self._chaos is None:
            return
        e = self._chaos.tick("host_kill")
        if e is not None and self._proc_idx == int(e.arg or 0):
            import signal

            print(f"[chaos] host_kill: SIGKILL process {self._proc_idx} "
                  f"at grad step {self.grad_steps}", flush=True)
            os.kill(os.getpid(), signal.SIGKILL)

    def _megastep_dispatch_once(self) -> dict:
        """Flush new rows into the device ring (and tree), then one megastep
        dispatch of K grad steps; returns its K-step mean metrics. With
        ``ingest_prefetch`` the next flush's first chunk is staged right
        after the dispatch, outside the guard (explicit staging)."""
        self._tick_host_kill()
        with self.timers.stage("ingest_chunk"):
            self._ring_sync.flush(self._ring)
        trees = None if self._dev_per is None else self._dev_per.trees
        with self.timers.stage("megastep_dispatch"), \
                self._dispatch_guard(self.state, self._ring, trees):
            if self._megastep_prog is None:
                metrics = self._megastep(self.state, self._ring, trees, self._megastep_gen)
            elif self._dev_per is None:
                metrics = self._run_program(self._megastep_prog)
            else:
                agent = self.config.agent
                metrics = self._run_program(self._megastep_prog, dper.beta_tensor(
                    self.state.step, agent.per_beta0, agent.per_beta_steps, self.device))
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
        self._tick_host_kill()
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
        with self.timers.stage("megastep_dispatch"), \
                self._dispatch_guard(self.state, self._ring, dev):
            if self._megastep_prog is None:
                metrics, priorities = self._megastep(self.state, self._ring, dev["idx"],
                                                     dev["weights"])
            else:
                metrics, priorities = self._run_program(self._megastep_prog, dev["idx"],
                                                        dev["weights"])
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
        with self.timers.stage("train_dispatch"), self._dispatch_guard(self.state, dev_batch):
            prog = self._train_step_prog if k == 1 else self._fused_step_prog
            if prog is not None:
                metrics, priorities = self._run_program(prog, dev_batch)
            else:  # the lanes of several processes
                body = self._host_step_body if k == 1 else self._host_scan_body
                metrics, priorities = body(dev_batch)
        self._dispatches += 1
        self._release_staging_holds(1)  # the dispatch has read its block
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
        if cfg.async_collect:
            self._start_collector()  # the collector pays the warmup
        else:
            self.warmup()
        t_start = time.monotonic()
        env_steps_start = self.env_steps
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
                    if cfg.async_collect:
                        if not self._wait_for_collector():
                            continue  # the loop top checkpoints and stops
                    elif self._fleet_only:
                        if not self._wait_for_fleet():
                            continue
                    else:
                        collect_budget = self._collect_budgeted(
                            collect_budget + cfg.env_steps_per_train_step * K)
                    metrics = self._dispatch_once(prefetch_next=done + K < total)
                    if self.sentinel is not None and done == 0:
                        # the first dispatch built the leg's program: its
                        # count IS the budget (one a config); the ingests
                        # keep their track-time budget of 1
                        name = ("megastep" if self._megastep is not None
                                else "train_step" if K == 1 else "fused_step")
                        self.sentinel.set_budget(name, self.sentinel.count(name))
                    done += K
                    self.grad_steps += K
                    self._learner_steps += K
                    if cfg.async_collect and interval_crossed(done - K, done, cfg.publish_interval):
                        self._publish_params()
                    if (self._fleet is not None and cfg.fleet_bundle
                            and interval_crossed(done - K, done, cfg.fleet_publish_interval)):
                        # the fleet's weights: re-export and bump the
                        # generation, so stale windows age out at the ingest
                        self._fleet_gen += 1
                        self._fleet_publish()
                    eval_crossed = interval_crossed(done - K, done, cfg.eval_interval)
                    if self.sentinel is not None and eval_crossed:
                        self.sentinel.check(f"eval crossing @ step {self.grad_steps}")
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
            # an error) is dropped; its rows got no write-back, and nothing
            # reads its slot any more
            self._staged = None
            self._release_staging_holds(len(self._staging_holds))
            self._stop_collector()
        # The host tree's lagged write-back lands after the loop, so after a
        # preemption checkpoint too (as in the JAX trainer).
        self._flush_write_back()
        if self.sentinel is not None:
            self.sentinel.check("end of train()")
        if self.host_env and cfg.concurrent_eval:
            # the final crossing's eval may still be in flight; its row must
            # exist before train() returns
            self._drain_eval()
            if self._last_eval_row:
                last = self._last_eval_row
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
        if self.has_pool:
            # the supervisor's counters ride every row
            scalars["pool_worker_failures"] = float(self.pool.failures_total)
            scalars["pool_worker_restarts"] = float(self.pool.restarts_total)
            scalars["pool_workers_quarantined"] = float(self.pool.num_quarantined())
        if self._ckpt_fallbacks:
            scalars["checkpoint_fallbacks"] = float(self._ckpt_fallbacks)
        if self._chaos is not None:
            scalars["chaos_injections"] = float(self._chaos.injections_total)
        if self._fleet is not None:
            # the fleet's books in every row; fleet-only, env_steps is the
            # ingested windows. check_alive here covers the mixed mode,
            # where no pacing loop asks the ingest
            self._fleet.check_alive()
            counters = self._fleet.counters()  # one snapshot for the row
            if self._fleet_only:
                self.env_steps = self._env_steps_origin + counters["windows_ingested"]
                scalars["env_steps"] = float(self.env_steps)
            for k, v in counters.items():
                scalars[f"fleet_{k}"] = float(v)
        if not self.host_env:
            ev = evaluate(
                cfg.agent, self.env, self.state.actor, self._eval_gen, cfg.eval_episodes
            )
            return self._apply_eval(self.grad_steps, scalars, ev, actor=self.state.actor)
        if cfg.concurrent_eval:
            # the evaluator thread logs the row when its eval completes;
            # return the latest finished eval's scalars meanwhile
            self._request_eval(scalars)
            return {**scalars, **self._last_eval_ev}
        actor, _ = self._acting_actor()
        return self._apply_eval(self.grad_steps, scalars, self._host_eval(), actor=actor)

    def _apply_eval(self, step: int, scalars: dict, ev: dict, actor=None,
                    env_steps: Optional[int] = None, norm_state=None) -> dict:
        """EWMA, keep-best, the metrics row and the console line for one
        completed eval, at the step it was requested. ``actor`` is the
        module the eval scored (the live actor inline, the evaluator
        thread's copy under ``concurrent_eval``), what keep-best saves;
        ``env_steps`` and ``norm_state`` were captured at the request."""
        cfg = self.config
        if self.ewma_return is None:
            self.ewma_return = ev["eval_return_mean"]
        else:
            self.ewma_return = (
                (1 - cfg.ewma_alpha) * self.ewma_return
                + cfg.ewma_alpha * ev["eval_return_mean"]
            )
        if actor is not None and (self._best_eval is None or ev["eval_return_mean"] > self._best_eval):
            self._best_eval = ev["eval_return_mean"]
            if norm_state is None and self.obs_norm is not None:
                # inline: the statistics now are those of the scored actor
                norm_state = self.obs_norm.state_dict()
            self._save_best(step, self._best_eval, actor,
                            self.env_steps if env_steps is None else env_steps, norm_state)
        scalars = dict(scalars)
        scalars.update(ev)
        if self._best_eval is not None:
            scalars["best_eval_return"] = self._best_eval
        scalars["avg_test_reward_ewma"] = self.ewma_return
        self.metrics.log(step, scalars, timers=self.timers)
        print(
            f"[step {step}] "
            + " ".join(f"{k}={v:.3f}" for k, v in scalars.items() if k != "replay_size"),
            flush=True,
        )
        self._last_eval_ev = {**ev, "avg_test_reward_ewma": self.ewma_return}
        self._last_eval_row = scalars
        return scalars

    def _save_best(self, step: int, score: float, actor, env_steps: int, norm_state=None) -> None:
        """The champion actor, its normalizer statistics (as of the scored
        copy, ``best_obs_norm.json``), then its score: params first, JSON
        last, so the JSON never claims params that were not saved."""
        save_best_actor(self.config.log_dir, actor)
        if norm_state is not None:
            path = os.path.join(self.config.log_dir, "checkpoints", "best_obs_norm.json")
            with open(path + ".tmp", "w") as f:
                json.dump(norm_state, f)
            os.replace(path + ".tmp", path)
        save_best_eval(self.config.log_dir, step, score, env_steps)

    # ------------------------------------------------------------- host eval
    def _eval_forwards(self) -> HostActing:
        """The eval's greedy forwards (on a stream of their own on the card)."""
        if self._eval_acting is None:
            self._eval_acting = HostActing(self.config.agent, 1, self._act_device)
        return self._eval_acting

    def _host_eval(self, pub=None) -> dict:
        """Greedy eval episodes of a host env: through the eval pool (all
        episodes in parallel) when the trainer has a pool and
        ``eval_episodes > 1`` (never for a pixel ``dmc_pixels:`` env),
        else one by one on a dedicated eval env. ``pub`` (the evaluator
        thread's request) is a publication it scores with its own copy;
        without it the acting actor is scored."""
        cfg = self.config
        if pub is None:
            actor, wait = self._acting_actor()
        else:
            actor, wait = self._eval_copy.load(pub, self._eval_forwards().stream), False
        if self.has_pool and cfg.eval_episodes > 1 and not getattr(self.env, "pixels", False):
            return self._pool_eval(actor, wait)
        if self._eval_env is None:
            self._eval_env = make_env(self.actor_env, cfg.max_episode_steps, cfg.action_repeat)
        env, acting = self._eval_env, self._eval_forwards()
        rets, succ, any_reported = [], 0, False
        info = {}
        for _ in range(cfg.eval_episodes):
            obs = env.reset()
            ep_ret = 0.0
            for _ in range(cfg.max_episode_steps):
                a = acting.greedy(actor, self._norm_obs(obs)[None], wait)[0]
                obs, r, term, trunc, info = env.step(a)
                ep_ret += r
                if term or trunc:
                    break
            # success only where the env reports is_success
            if isinstance(info, dict) and "is_success" in info:
                any_reported = True
                succ += int(bool(info["is_success"]))
            rets.append(ep_ret)
        out = {"eval_return_mean": float(np.mean(rets)), "eval_return_std": float(np.std(rets))}
        if any_reported:
            out["success_rate"] = succ / cfg.eval_episodes
        return out

    def _pool_eval(self, actor, wait: bool = False) -> dict:
        """Every eval episode in parallel through a dedicated eval pool
        (seed + 977 777), one batched greedy act an env step. A worker that
        fails mid-episode is restarted by the pool's supervisor, but its
        episode is torn: it is excluded from the stats."""
        cfg = self.config
        n = cfg.eval_episodes
        if self._eval_pool is None:
            self._eval_pool = HostActorPool(
                self.actor_env, n, cfg.max_episode_steps, seed=cfg.seed + EVAL_POOL_SEED,
                start_method=cfg.pool_start_method, action_repeat=cfg.action_repeat,
            )
        acting = self._eval_forwards()
        obs = self._eval_pool.reset_all()
        alive = np.ones(n, bool)
        valid = np.ones(n, bool)
        rets = np.zeros(n, np.float64)
        ep_success = np.zeros(n, bool)
        any_reported = False
        for _ in range(cfg.max_episode_steps):
            a = acting.greedy(actor, self._norm_obs(obs), wait)
            _, r, term, trunc, pol_obs, s, s_rep = self._eval_pool.step(a)
            self._eval_pool.take_dropped()  # no writers here; keep it drained
            failed_now = alive & ~self._eval_pool.stepped_mask
            if failed_now.any():
                valid &= ~failed_now
                alive &= ~failed_now
                print(
                    f"[eval] dropped {int(failed_now.sum())} episode(s): "
                    "eval worker failed mid-episode (restarted; torn "
                    "returns excluded from the stats)", flush=True,
                )
                if not alive.any():
                    break
            rets += r * alive
            # final-step semantics: an episode's success is is_success at
            # its last step, only where the env reports it
            done_now = (term | trunc) & alive
            ep_success = np.where(done_now, s & s_rep, ep_success)
            any_reported |= bool((done_now & s_rep & valid).any())
            alive &= ~(term | trunc)
            obs = pol_obs
            if not alive.any():
                break
        if not valid.any():
            raise RuntimeError(
                "every eval episode was lost to eval-pool worker failures; "
                "no return to report"
            )
        out = {"eval_return_mean": float(rets[valid].mean()),
               "eval_return_std": float(rets[valid].std())}
        if any_reported:
            out["success_rate"] = float(ep_success[valid].mean())
        return out

    # ------------------------------------------------------ concurrent eval
    def _eval_worker(self) -> None:
        try:
            while True:
                # bounded wait: a stop that forgets the wake parks this
                # thread one tick, not forever
                while not self._eval_pending.wait(0.5):
                    if self._eval_stop.is_set():
                        return
                if self._eval_stop.is_set():
                    return
                with self._eval_req_lock:
                    req, self._eval_req = self._eval_req, None
                    self._eval_pending.clear()
                if req is None:
                    continue
                pub, step, scalars, env_steps, norm_state = req
                ev = self._host_eval(pub)
                # the copy scored is what keep-best saves; the normalizer
                # snapshot is the one taken with it
                self._apply_eval(step, scalars, ev, actor=self._eval_copy.module,
                                 env_steps=env_steps, norm_state=norm_state)
                with self._eval_req_lock:
                    if self._eval_req is None:
                        self._eval_idle.set()
        except BaseException as e:
            self._eval_error = e
            self._eval_idle.set()  # never leave the end-of-train drain hanging
            raise

    def _request_eval(self, scalars: dict) -> None:
        """Hand the evaluator thread a copy of the actor and this crossing's
        train scalars. A request still waiting is REPLACED (latest params
        win); the replaced crossing still logs its train-scalars row."""
        if self._eval_error is not None:
            raise RuntimeError("evaluator thread died") from self._eval_error
        if self._eval_copy is None:
            self._eval_copy = ActorCopy(self.state.actor, self._act_device)
        if self._eval_thread is None or not self._eval_thread.is_alive():
            self._eval_stop.clear()
            self._eval_thread = threading.Thread(
                target=self._eval_worker, name="evaluator", daemon=True
            )
            self._eval_thread.start()
        self._pub_version += 1
        pub = publish_actor(self.state.actor, self._act_device, self._pub_version)
        norm_state = self.obs_norm.state_dict() if self.obs_norm is not None else None
        with self._eval_req_lock:
            replaced = self._eval_req
            self._eval_idle.clear()
            # env_steps and the statistics captured HERE, on the learner
            # thread, with the copy
            self._eval_req = (pub, self.grad_steps, scalars, self.env_steps, norm_state)
            self._eval_pending.set()
        if replaced is not None:
            _, r_step, r_scalars, _, _ = replaced
            self.metrics.log(r_step, r_scalars, timers=self.timers)

    def _drain_eval(self, timeout: float = 600.0) -> None:
        """Wait for the evals in flight and pending (end of ``train()``)."""
        # the error first: a worker that died on the final request leaves a
        # dead thread, which the early return below would swallow
        if self._eval_error is not None:
            raise RuntimeError("evaluator thread died") from self._eval_error
        if self._eval_thread is None or not self._eval_thread.is_alive():
            return
        if not self._eval_idle.wait(timeout):
            print(f"[evaluator] eval still running after {timeout:.0f} s", flush=True)
        if self._eval_error is not None:
            raise RuntimeError("evaluator thread died") from self._eval_error

    def _stop_eval_thread(self) -> None:
        if self._eval_thread is not None:
            self._eval_stop.set()
            self._eval_pending.set()  # wake the wait()
            self._eval_thread.join(timeout=60)
            if self._eval_thread.is_alive():
                # closing the eval pool or env under a worker still stepping
                # them would crash it: leave them to it
                self._eval_leaked = True
                print(
                    "[evaluator] still running after 60 s shutdown join; "
                    "leaking eval pool/env rather than closing them mid-step",
                    flush=True,
                )
            self._eval_thread = None

    def close(self) -> None:
        """Stop the collector and the evaluator, then close the metrics, the
        pools (no worker outlives it) and the envs. Under ``debug_guards``
        the lock witness is checked LAST: a contradiction fails the close
        loudly without leaking the teardown above (pool workers, metrics,
        envs)."""
        self._stop_collector()
        self._stop_eval_thread()
        if self._fleet is not None:
            # the drain: frames admitted to the queue land in replay (and
            # release their ledger holds) before the teardown
            self._fleet.close()
            self._fleet = None
        if not self._eval_leaked:
            self.metrics.close()
        if self.pool is not None:
            self.pool.close()
        if not self._eval_leaked:
            if self._eval_pool is not None:
                self._eval_pool.close()
            if self._eval_env is not None and hasattr(self._eval_env, "close"):
                self._eval_env.close()
        if self.host_env and hasattr(self.env, "close"):
            self.env.close()
        if self.sentinel is not None:
            self.sentinel.stop()
        if self.config.debug_guards:
            lockwitness.check_against_committed(where="trainer close")
