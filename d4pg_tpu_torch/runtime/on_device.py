"""Fully on-device training: rollout, replay and learning all on the card
(counterpart of ``d4pg_tpu/runtime/on_device.py``, ``train --on-device``).

One train iteration:

  1. rolls a [num_envs, segment_len] exploration segment of the batched
     envs (auto-reset, noise state threaded through) and collapses it to
     n-step transitions (:func:`~d4pg_tpu_torch.runtime.collect.
     make_segment_collector`);
  2. appends them to a columnar ring of device tensors (:class:`DeviceReplay`;
     with ``ring_dtype="bfloat16"`` the observations are stored as
     bfloat16, half the bytes, and a pixel env's as uint8
     (``clip(round(x·255), 0, 255)``), a quarter; both are decoded to
     float32 at the gather);
  3. draws [K, B] indices (uniform, or proportional to the ring's
     priorities by ``cumsum`` + ``searchsorted`` with IS weights) and runs
     K grad steps (:func:`~d4pg_tpu_torch.agent.d4pg.fused_train_scan`,
     through kernels B1f and B1b on the card);
  4. with PER, writes the [K, B] priorities back in step order (later
     steps win) and raises ``max_priority``.

The JAX package jits the warmup and the iteration into one XLA program
each. Here, on one device, :class:`OnDeviceLoop` cuts them into five
bodies that work in place on the carry (one control step, the n-step
collapse and ring append, the [K, B] draw, a block of grad steps, the
write-back) and :class:`OnDevicePrograms` makes each a compiled program
(``utils/graphs.py``; a CUDA graph on the card), replayed 32 times a
segment and K/b times an iteration. The ring's ``pos`` and ``size`` are
0-d device tensors, advanced inside the programs; the host keeps mirrors
that advance by exactly ``num_envs·segment_len`` a segment, so no
iteration reads anything back from the device. :func:`run_on_device`
reads the metrics only at an eval, which is a compiled program too
(``runtime/evaluator.py:GreedyEval``).

With a ``mesh`` (``--dp D``; the JAX package's ``shard_map`` over "dp")
``num_envs``, ``replay_capacity`` and ``batch_size`` are global and each
dp lane owns ``1/D`` of each: its envs, its ring (PER draws from the
lane's own priorities, the distributed-PER approximation) and its batch
shard, with its own generators seeded from ``(seed, stream, lane)``
(the JAX ``fold_in`` of the lane index). The K grad steps run over the
lanes (:func:`~d4pg_tpu_torch.agent.d4pg.fused_train_scan` with
``parallel/dp.py:LaneSync``: one fixed-order gradient mean a step),
``max_priority`` is the exact max over the lanes after the write-back,
and the proxy metric their fixed-order mean. The lanes of one process
run one after another; over several ranks the same sync gathers across
them. The carry then holds one env state, observation block, noise
state, ring, generator pair and scratch a local lane, in lists.
:class:`LanesLoop` cuts the lanes' loop into the same five bodies, each
over every local lane, and :class:`OnDevicePrograms` compiles them as it
does one device's. Several processes keep the eager loop of
:func:`make_on_device_trainer`: their combines are host round trips.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from functools import partial
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from d4pg_tpu_torch import resolve_device
from d4pg_tpu_torch.agent import create_train_state
from d4pg_tpu_torch.agent.d4pg import (
    encode_obs,
    fused_train_scan,
    gather_batches,
    make_noise,
    step_metric_keys,
)
from d4pg_tpu_torch.agent.state import D4PGConfig, TrainState, check_supported
from d4pg_tpu_torch.analysis.transfer import sync_debug_error
from d4pg_tpu_torch.config import (
    TrainConfig,
    apply_env_preset,
    check_on_device,
    check_placement,
    check_wire_dtypes,
)
from d4pg_tpu_torch.envs import make_env
from d4pg_tpu_torch.envs.api import EnvState
from d4pg_tpu_torch.envs.rollouts import Trajectory
from d4pg_tpu_torch.parallel.dp import LaneProgram, LaneSync
from d4pg_tpu_torch.parallel.mesh import check_one_device, make_mesh
from d4pg_tpu_torch.replay import device_per as dper
from d4pg_tpu_torch.replay import noise_scale_schedule
from d4pg_tpu_torch.runtime import megastep
from d4pg_tpu_torch.runtime.checkpoint import (
    CheckpointManager,
    best_eval_path,
    invalidate_best_eval,
    load_trainer_meta,
    save_best_eval,
    save_trainer_meta,
    trainer_meta_path,
)
from d4pg_tpu_torch.runtime.collect import SegmentCollector, make_segment_collector
from d4pg_tpu_torch.runtime.evaluator import GreedyEval
from d4pg_tpu_torch.runtime.metrics import MetricsLogger, interval_crossed
from d4pg_tpu_torch.runtime.trainer import SEGMENT_LEN, _rss_gb
from d4pg_tpu_torch.utils import graphs

TRAIN_BLOCK = 8  # grad steps of one train_block program call, at most


@dataclasses.dataclass
class DeviceReplay:
    """Device-resident ring buffer (columnar, fixed shapes), updated in
    place. ``priority`` holds α-exponentiated priorities (0 = empty slot;
    read only with PER); ``max_priority`` is the running max of raw
    priorities, a 0-d float32 tensor. ``pos`` and ``size`` are 0-d int64
    tensors on the ring's device, as the JAX ring's are: a compiled
    program reads and advances them there (the host keeps mirrors of its
    own, :class:`OnDeviceRun`)."""

    obs: torch.Tensor        # [C, O] float32, or bfloat16 (ring_dtype), or uint8 (pixels)
    action: torch.Tensor     # [C, A]
    reward: torch.Tensor     # [C]
    next_obs: torch.Tensor   # [C, O] as obs
    discount: torch.Tensor   # [C]
    priority: torch.Tensor   # [C] p_i^α, 0 where empty
    max_priority: torch.Tensor  # 0-d float32
    pos: torch.Tensor        # 0-d int64: next write slot
    size: torch.Tensor       # 0-d int64: filled entries


RING_FIELDS = ("obs", "action", "reward", "next_obs", "discount", "priority", "max_priority",
               "pos", "size")


def ring_tensors(replay: DeviceReplay) -> list:
    """Every tensor of the ring, in ``RING_FIELDS`` order."""
    return [getattr(replay, f) for f in RING_FIELDS]


def device_replay_init(
    capacity: int, obs_dim: int, action_dim: int, device=None,
    obs_dtype: torch.dtype = torch.float32,
) -> DeviceReplay:
    """An empty ring. ``obs_dtype`` bfloat16 stores the observations at
    half the bytes (the JAX ``_encode_obs``): ``_append``'s copy rounds
    them to nearest even. uint8 stores a pixel env's [0, 1] observations
    as bytes, quantized by :func:`~d4pg_tpu_torch.agent.d4pg.encode_obs`.
    :func:`~d4pg_tpu_torch.agent.d4pg.gather_batches` decodes both to
    float32."""
    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return DeviceReplay(
        obs=z(capacity, obs_dim, dtype=obs_dtype), action=z(capacity, action_dim),
        reward=z(capacity), next_obs=z(capacity, obs_dim, dtype=obs_dtype),
        discount=z(capacity), priority=z(capacity),
        max_priority=torch.ones((), dtype=torch.float32, device=device),
        pos=z(dtype=torch.int64), size=z(dtype=torch.int64),
    )


def _append(replay: DeviceReplay, batch: dict, count: int, alpha: float) -> DeviceReplay:
    """Write ``count`` rows at the ring position, in place: an
    ``index_copy_`` at ``pos + arange(count)`` (the JAX
    ``lax.dynamic_update_slice``), then ``pos`` and ``size`` advance on
    the device. Requires capacity % count == 0 so a write never wraps
    mid-block (enforced by :func:`make_on_device_trainer`). New rows enter
    at max_priority^α."""
    cap = replay.obs.shape[0]
    rows = replay.pos + torch.arange(count, device=replay.pos.device)
    for k in ("obs", "action", "reward", "next_obs", "discount"):
        dst = getattr(replay, k)
        src = encode_obs(batch[k]) if dst.dtype == torch.uint8 else batch[k].to(dst.dtype)
        dst.index_copy_(0, rows, src)
    replay.priority.index_copy_(0, rows, (replay.max_priority**alpha).expand(count).contiguous())
    replay.pos.copy_((replay.pos + count) % cap)
    replay.size.copy_(torch.clamp(replay.size + count, max=cap))
    return replay


SCAN_WIDTH = 1024  # the row length of ordered_cumsum's two-level scan


def ordered_cumsum(x: torch.Tensor) -> torch.Tensor:
    """The inclusive cumsum of a 1-D tensor, its float adds in an order
    fixed by the length alone: each ``SCAN_WIDTH``-row (the tail padded
    with zeros) scanned by ATen's per-row kernel, then the rows'
    exclusive offsets, the same scan one level up, added. On the card a
    1-D ``torch.cumsum`` runs CUB's device-wide scan, whose decoupled
    look-back sums a tile's predecessors in an order the timing decides,
    so two calls on one float input may differ in the last bits (and a
    ``searchsorted`` in it in the index it finds: on an H100, two eager
    draws from one state over a 2^20-row ring did). A
    lone row would take that scan too, so a short input is scanned as one
    row of two."""
    n = x.shape[0]
    if n <= SCAN_WIDTH:
        return torch.stack([x, x]).cumsum(1)[0]
    rows = torch.nn.functional.pad(x, (0, (-n) % SCAN_WIDTH)).view(-1, SCAN_WIDTH).cumsum(1)
    ends = ordered_cumsum(rows[:, -1])
    offsets = torch.cat([ends.new_zeros(1), ends[:-1]])
    return (rows + offsets[:, None]).view(-1)[:n]


def per_draw(config: D4PGConfig, priority: torch.Tensor, size, u: torch.Tensor, step=0,
             beta: Optional[torch.Tensor] = None):
    """Proportional [K, B] draw from the ring's α-priorities at uniform
    numbers ``u`` in [0, 1): ``searchsorted`` (left side) of ``u·total`` in
    the priorities' ``cumsum`` (on the card :func:`ordered_cumsum`, so a
    replay draws what the eager body draws), clamped to the ``size`` filled rows (a 0-d
    int tensor, or an int), and the β-annealed IS weights normalised by
    the min-priority row's weight. β is ``beta`` (a 0-d float32 tensor,
    :func:`~d4pg_tpu_torch.replay.device_per.beta_tensor`), else that of
    the learner step ``step``: ``linear_schedule(step, per_beta_steps,
    β0, 1)`` in float32, as the JAX iterate computes it from
    ``state.step``. Returns (idx [K, B] int64, weights [K, B])."""
    dev = priority.device
    if beta is None:
        beta = dper.beta_tensor(step, config.per_beta0, config.per_beta_steps, dev)
    if not isinstance(size, torch.Tensor):
        size = torch.full((), size, dtype=torch.int64, device=dev)
    cums = ordered_cumsum(priority) if priority.is_cuda else torch.cumsum(priority, 0)
    total = cums[-1]
    idx = torch.minimum(torch.searchsorted(cums, u * total), size - 1).clamp_(min=0)
    p = priority[idx] / total
    n = size.to(torch.float32)
    weights = (p * n) ** (-beta)
    min_p = torch.where(priority > 0, priority, float("inf")).min() / total
    return idx, weights / (min_p * n) ** (-beta)


def per_write_back(
    config: D4PGConfig, replay: DeviceReplay, idx: torch.Tensor, new_pri: torch.Tensor
) -> None:
    """Write (|δ| + ε)^α of the [K, B] priorities into the ring in step
    order, in place: a row drawn by several steps keeps the value of the
    latest (within one step, of the last draw), as the JAX package's
    sequential ``fori_loop`` gives. One scatter of the winning values, so
    duplicate indices all write the same number. Raises ``max_priority``
    (in place)."""
    raw = new_pri.abs() + config.per_eps
    pa = (raw**config.per_alpha).reshape(-1)
    flat = idx.reshape(-1)
    order = torch.arange(flat.numel(), device=flat.device)
    last = torch.full(replay.priority.shape, -1, dtype=order.dtype, device=flat.device)
    last.scatter_reduce_(0, flat, order, reduce="amax")
    replay.priority.index_put_((flat,), pa[last[flat]])
    replay.max_priority.copy_(torch.maximum(replay.max_priority, raw.max()))


class IterationBuffers(NamedTuple):
    """A single-device carry's scratch, overwritten every iteration: the
    segment's [N, T] trajectory, the iteration's [K, B] draws (indices
    and, with PER, IS weights), the K steps' priorities and each step
    metric's [K] values."""

    traj: Trajectory
    idx: torch.Tensor
    weights: Optional[torch.Tensor]
    priorities: torch.Tensor
    metrics: dict


class Carry(NamedTuple):
    """Everything one iteration reads and updates: the learner state, the
    envs, their observations and noise states, the ring and the two device
    generators (collection, train draws), and the iteration's scratch
    (``buffers``). With a mesh every field but ``state`` is a list, one
    entry a local lane (the eager loop of :func:`make_on_device_trainer`
    has no scratch: ``buffers`` None). The five bodies update every
    tensor IN PLACE."""

    state: TrainState
    env_states: EnvState
    obs: torch.Tensor
    noise_states: object
    replay: DeviceReplay
    collect_gen: torch.Generator
    train_gen: torch.Generator
    buffers: Optional[IterationBuffers] = None


def leg_seed(*parts: int) -> int:
    """A generator seed from integers (the run's seed, the leg's grad step,
    a stream number): the JAX package's ``fold_in`` of each part."""
    return int(np.random.SeedSequence([int(p) for p in parts]).generate_state(1)[0])


def train_block_size(k: int) -> int:
    """Grad steps of one ``train_block`` call: the largest divisor of K
    that is at most ``TRAIN_BLOCK``."""
    return max(d for d in range(1, min(TRAIN_BLOCK, k) + 1) if k % d == 0)


def _proxy(traj) -> torch.Tensor:
    # A TRAIN-time diagnostic, not an evaluation return: the segment's
    # exploration reward over the episode boundaries it saw (at least 1)
    return traj.reward.sum() / torch.clamp_min(
        torch.maximum(traj.terminated, traj.truncated).sum(), 1.0)


def _lanes(x) -> list:
    """A lanes carry's field as it is (a list, one entry a lane), a
    single-device carry's as a list of one."""
    return x if isinstance(x, list) else [x]


def carry_tensors(carry: Carry) -> list:
    """Every tensor of a carry: the learner's (networks and Adam), the
    envs', observations' and noise states', the ring's and the scratch's
    (with lanes, every lane's)."""
    out = megastep.learner_tensors(carry.state)
    out += pytree.tree_leaves((carry.env_states, carry.obs, carry.noise_states))
    for replay, buf in zip(_lanes(carry.replay), _lanes(carry.buffers)):
        out += ring_tensors(replay) + list(buf.traj) + [buf.idx, buf.priorities]
        out += ([buf.weights] if buf.weights is not None else []) + list(buf.metrics.values())
    return out


def carry_generators(carry: Carry) -> list:
    """The device generators an iteration draws from: collection, train
    draws (one each a lane), and the state's REDQ subsets and DrQ shifts
    where used."""
    return [g for g in (*_lanes(carry.collect_gen), *_lanes(carry.train_gen),
                        carry.state.subset_gen, carry.state.augment_gen) if g is not None]


class OnDeviceLoop:
    """The single-device loop of :func:`make_on_device_trainer` as five
    bodies, each IN PLACE on a :class:`Carry` (the JAX ``warmup_body`` and
    ``iterate_body`` cut where a compiled program of a few thousand
    kernels ends):

    - :meth:`collect_step` ``(carry, t, noise_scale)``: one control step of
      every env under the noisy actor, written at slot ``t`` of the
      segment buffer (a segment is ``segment_len`` of them);
    - :meth:`append`: the n-step collapse of the segment and its ring
      append;
    - :meth:`draw` ``(carry, beta)``: the iteration's [K, B] indices (and
      with PER the IS weights at β), all from the priorities as they stand
      after the append;
    - :meth:`train_block` ``(carry, j)``: grad steps ``j·b .. j·b + b − 1``
      (b = :func:`train_block_size`) on rows gathered from the ring by
      the drawn indices, their priorities and metrics into the scratch;
    - :meth:`finish`: with PER the ordered write-back of the K steps'
      priorities and ``max_priority``; returns the K-step mean metrics and
      ``train_reward_per_episode_boundary``.

    ``noise_scale``, ``t``, ``j`` and β are 0-d device tensors. The eager
    :meth:`warmup` and :meth:`iterate` call the bodies in order;
    :meth:`programs` makes each body a compiled program over one carry
    (:class:`OnDevicePrograms`)."""

    def __init__(self, config: D4PGConfig, env, num_envs: int, segment_len: int,
                 replay_capacity: int, batch_size: int, k: int, prioritized: bool, device,
                 obs_dtype: torch.dtype, noise_fns=None):
        self.config, self.env = config, env
        self.num_envs, self.segment_len = num_envs, segment_len
        self.capacity, self.B, self.K = replay_capacity, batch_size, k
        self.prioritized = prioritized
        self.device = device
        self.obs_dtype = obs_dtype
        self.n_new = num_envs * segment_len
        noise_fns = noise_fns or make_noise(config, (num_envs,), device)
        self.noise_init = noise_fns[0]
        self.collector = SegmentCollector(config, env, num_envs, segment_len, noise_fns)
        self.block = train_block_size(k)
        self.steps = torch.arange(segment_len, device=device)      # the slots t
        self.blocks = torch.arange(k // self.block, device=device)  # the blocks j
        self._block_rows = torch.arange(self.block, device=device)

    # ------------------------------------------------------------- carry
    def init(self, state: TrainState, seed: int) -> Carry:
        """``num_envs`` envs reset, an empty ring and the scratch on the
        state's device; the generators seeded from ``seed``."""
        dev, cfg, K, B = self.device, self.config, self.K, self.B

        def gen(stream):
            return torch.Generator(dev).manual_seed(leg_seed(seed, stream))

        env_states, obs = self.env.reset(self.num_envs, gen(0), dev)
        replay = device_replay_init(self.capacity, cfg.obs_dim, cfg.action_dim, dev,
                                    obs_dtype=self.obs_dtype)
        buffers = IterationBuffers(
            traj=self.collector.trajectory_buffers(cfg.obs_dim, cfg.action_dim, dev),
            idx=torch.zeros((K, B), dtype=torch.int64, device=dev),
            weights=torch.zeros((K, B), device=dev) if self.prioritized else None,
            priorities=torch.zeros((K, B), device=dev),
            metrics={key: torch.zeros(K, device=dev) for key in step_metric_keys(cfg)})
        return Carry(state, env_states, obs, self.noise_init(), replay, gen(1), gen(2), buffers)

    def scale_tensor(self, noise_scale: float) -> torch.Tensor:
        """A noise scale as the 0-d float32 input of the collection (a
        fill on the device: no copy from the host)."""
        return torch.full((), float(noise_scale), dtype=torch.float32, device=self.device)

    def beta(self, step: int) -> Optional[torch.Tensor]:
        """The draw's β input at host learner step ``step`` (None
        without PER)."""
        if not self.prioritized:
            return None
        cfg = self.config
        return dper.beta_tensor(step, cfg.per_beta0, cfg.per_beta_steps, self.device)

    # ------------------------------------------------------------ bodies
    def collect_step(self, carry: Carry, t: torch.Tensor, noise_scale: torch.Tensor) -> None:
        self.collector.step(carry.state.actor, carry.env_states, carry.obs, carry.noise_states,
                            carry.collect_gen, noise_scale, carry.buffers.traj, t)

    def append(self, carry: Carry) -> None:
        flat = self.collector.collapse(carry.buffers.traj)
        _append(carry.replay, flat, self.n_new, self.config.per_alpha)

    def draw(self, carry: Carry, beta: Optional[torch.Tensor] = None,
             draws: Optional[torch.Tensor] = None) -> None:
        """``draws`` replaces the train generator's: [K, B] uniform numbers
        in [0, 1) with PER, [K, B] indices without."""
        replay, buf = carry.replay, carry.buffers
        if self.prioritized:
            u = draws if draws is not None else torch.rand(
                (self.K, self.B), generator=carry.train_gen, device=self.device)
            idx, weights = per_draw(self.config, replay.priority, replay.size, u, beta=beta)
            buf.weights.copy_(weights)
        else:
            idx = draws if draws is not None else megastep.draw_uniform_indices(
                carry.train_gen, self.K, self.B, replay.size)
        buf.idx.copy_(idx)

    def train_block(self, carry: Carry, j: torch.Tensor) -> None:
        buf = carry.buffers
        rows = j * self.block + self._block_rows
        # a pixel ring's rows stay uint8 until their step decodes them
        batches = gather_batches(carry.replay, buf.idx.index_select(0, rows), decode=False)
        if self.prioritized:
            batches["weights"] = buf.weights.index_select(0, rows)
        _, metrics, priorities = fused_train_scan(self.config, carry.state, batches)
        buf.priorities.index_copy_(0, rows, priorities)
        for key, v in metrics.items():
            buf.metrics[key].index_copy_(0, rows, v)

    def finish(self, carry: Carry) -> dict:
        buf = carry.buffers
        if self.prioritized:
            per_write_back(self.config, carry.replay, buf.idx, buf.priorities)
        metrics = {key: v.mean() for key, v in buf.metrics.items()}
        metrics["train_reward_per_episode_boundary"] = _proxy(buf.traj)
        return metrics

    # ------------------------------------------------------------- eager
    def warmup(self, carry: Carry, noise_scale: float) -> Carry:
        """One segment into the ring, no training (the replay pre-fill)."""
        scale = self.scale_tensor(noise_scale)
        for t in self.steps:
            self.collect_step(carry, t, scale)
        self.append(carry)
        return carry

    def iterate(self, carry: Carry, noise_scale: float, draws=None):
        """One segment, then K grad steps; ``(carry, metrics)``."""
        beta = self.beta(carry.state.step)
        self.warmup(carry, noise_scale)
        self.draw(carry, beta, draws)
        for j in self.blocks:
            self.train_block(carry, j)
        return carry, self.finish(carry)

    def programs(self, carry: Carry) -> "OnDevicePrograms":
        return OnDevicePrograms(self, carry)


class LanesLoop:
    """The loop of :func:`make_on_device_trainer` with a mesh (this
    process's dp lanes) as :class:`OnDeviceLoop`'s five bodies, each IN
    PLACE on a lanes :class:`Carry` (every field but ``state`` a list, one
    entry a local lane; ``buffers`` one :class:`IterationBuffers` a lane,
    the lanes' combined metrics in lane 0's):

    - :meth:`collect_step` and :meth:`append`: every lane's control step,
      its n-step collapse and its ring append;
    - :meth:`draw`: every lane's [K, B/D] draw from its own ring and
      generator (``draws``: one block a lane);
    - :meth:`train_block`: grad steps over the lanes, the gradients and
      metrics combined by :class:`~d4pg_tpu_torch.parallel.dp.LaneSync`'s
      fixed-order mean each step (``fused_train_scan(sync_fn=)``);
    - :meth:`finish`: every lane's write-back, then the exact max of the
      lanes' ``max_priority`` into each, and the proxy metric's mean over
      the lanes.

    The bodies compute what the eager mesh loop of
    :func:`make_on_device_trainer` computes, in the same order, so the two
    agree bit for bit; :meth:`programs` makes each body a compiled program
    (:class:`OnDevicePrograms`), which several processes cannot have
    (their combines cross the processes on the host)."""

    def __init__(self, config: D4PGConfig, env, mesh, num_envs: int, segment_len: int,
                 replay_capacity: int, batch_size: int, k: int, prioritized: bool, device,
                 obs_dtype: torch.dtype, noise_fns: list):
        self.config, self.env, self.mesh = config, env, mesh
        self.num_envs, self.segment_len = num_envs, segment_len
        self.capacity, self.B, self.K = replay_capacity, batch_size, k
        self.prioritized = prioritized
        self.device = device
        self.obs_dtype = obs_dtype
        self.n_new = num_envs * segment_len
        self.lanes = list(mesh.local_lanes)
        self.noise_inits = [fns[0] for fns in noise_fns]
        self.collectors = [SegmentCollector(config, env, num_envs, segment_len, fns)
                           for fns in noise_fns]
        self.sync = LaneSync(mesh)
        self.block = train_block_size(k)
        self.steps = torch.arange(segment_len, device=device)
        self.blocks = torch.arange(k // self.block, device=device)
        self._block_rows = torch.arange(self.block, device=device)

    def init(self, state: TrainState, seed: int) -> Carry:
        """Every local lane's envs reset, empty ring, scratch and
        generators, seeded from ``(seed, stream, lane)`` as the eager mesh
        loop seeds them."""
        dev, cfg, K, B = self.device, self.config, self.K, self.B

        def gen(stream, lane):
            return torch.Generator(dev).manual_seed(leg_seed(seed, stream, lane))

        per_lane = []
        for j, lane in enumerate(self.lanes):
            env_states, obs = self.env.reset(self.num_envs, gen(0, lane), dev)
            replay = device_replay_init(self.capacity, cfg.obs_dim, cfg.action_dim, dev,
                                        obs_dtype=self.obs_dtype)
            buffers = IterationBuffers(
                traj=self.collectors[j].trajectory_buffers(cfg.obs_dim, cfg.action_dim, dev),
                idx=torch.zeros((K, B), dtype=torch.int64, device=dev),
                weights=torch.zeros((K, B), device=dev) if self.prioritized else None,
                priorities=torch.zeros((K, B), device=dev),
                metrics={key: torch.zeros(K, device=dev) for key in step_metric_keys(cfg)}
                if j == 0 else {})
            per_lane.append((env_states, obs, self.noise_inits[j](), replay, gen(1, lane),
                             gen(2, lane), buffers))
        return Carry(state, *(list(f) for f in zip(*per_lane)))

    scale_tensor = OnDeviceLoop.scale_tensor
    beta = OnDeviceLoop.beta

    # ------------------------------------------------------------ bodies
    def collect_step(self, carry: Carry, t: torch.Tensor, noise_scale: torch.Tensor) -> None:
        for j, collector in enumerate(self.collectors):
            collector.step(carry.state.actor, carry.env_states[j], carry.obs[j],
                           carry.noise_states[j], carry.collect_gen[j], noise_scale,
                           carry.buffers[j].traj, t)

    def append(self, carry: Carry) -> None:
        for collector, replay, buf in zip(self.collectors, carry.replay, carry.buffers):
            _append(replay, collector.collapse(buf.traj), self.n_new, self.config.per_alpha)

    def draw(self, carry: Carry, beta: Optional[torch.Tensor] = None,
             draws: Optional[list] = None) -> None:
        """``draws`` replaces the lanes' train generators: one [K, B/D]
        block a lane, uniform numbers in [0, 1) with PER, indices
        without."""
        for j, (replay, buf, gen) in enumerate(zip(carry.replay, carry.buffers,
                                                   carry.train_gen)):
            fed = None if draws is None else draws[j]
            if self.prioritized:
                u = fed if fed is not None else torch.rand((self.K, self.B), generator=gen,
                                                           device=self.device)
                idx, weights = per_draw(self.config, replay.priority, replay.size, u, beta=beta)
                buf.weights.copy_(weights)
            else:
                idx = fed if fed is not None else megastep.draw_uniform_indices(
                    gen, self.K, self.B, replay.size)
            buf.idx.copy_(idx)

    def train_block(self, carry: Carry, j: torch.Tensor) -> None:
        rows = j * self.block + self._block_rows
        lanes = []
        for replay, buf in zip(carry.replay, carry.buffers):
            # a pixel ring's rows stay uint8 until their step decodes them
            batches = gather_batches(replay, buf.idx.index_select(0, rows), decode=False)
            if self.prioritized:
                batches["weights"] = buf.weights.index_select(0, rows)
            lanes.append(batches)
        _, metrics, priorities = fused_train_scan(self.config, carry.state, lanes,
                                                  sync_fn=self.sync)
        for buf, pri in zip(carry.buffers, priorities.split(self.B, dim=1)):
            buf.priorities.index_copy_(0, rows, pri)
        for key, v in metrics.items():
            carry.buffers[0].metrics[key].index_copy_(0, rows, v)

    def finish(self, carry: Carry) -> dict:
        if self.prioritized:
            for replay, buf in zip(carry.replay, carry.buffers):
                per_write_back(self.config, replay, buf.idx, buf.priorities)
            top = self.sync.max(torch.stack([r.max_priority for r in carry.replay]))
            for replay in carry.replay:
                replay.max_priority.copy_(top)
        metrics = {key: v.mean() for key, v in carry.buffers[0].metrics.items()}
        proxies = torch.stack([_proxy(buf.traj) for buf in carry.buffers])
        metrics["train_reward_per_episode_boundary"] = self.sync(proxies[:, None])[0]
        return metrics

    warmup = OnDeviceLoop.warmup
    iterate = OnDeviceLoop.iterate

    def programs(self, carry: Carry) -> "OnDevicePrograms":
        if self.mesh.num_processes > 1:
            raise ValueError("the on-device lanes of several processes stay eager: their "
                             "combines cross the processes on the host")
        return OnDevicePrograms(self, carry)


class OnDevicePrograms:
    """:class:`OnDeviceLoop`'s five bodies as compiled programs
    (``utils/graphs.py``) over one carry, the counterpart of the JAX
    package's ``jax.jit(warmup_body)`` and ``jax.jit(iterate_body)``:
    ``collect_step`` (replayed ``segment_len`` times a segment),
    ``ring_append``, ``train_draw``, ``train_block`` (replayed K/b times an
    iteration) and ``train_finish``. A HalfCheetah segment as one graph
    would hold ~72 000 kernels; a control step holds ~2 240, a block of 8
    grad steps ~1 600. Inputs are 0-d device tensors (the step's slot, the
    noise scale, β, the block's index), so warmup (noise 3.0) and the
    iterations share each program's one specialization. The ring, its
    priorities, the envs and the scratch are the programs' ``state``,
    read by address, never copied in or out; the only output is
    ``train_finish``'s metrics. Each program registers the generators it
    draws from. A replay runs no Python, so :meth:`iterate` advances the
    host step count by K itself. Over a :class:`LanesLoop` the same five
    programs run every local lane (state: every lane's envs, ring and
    scratch; generators: every lane's), ``train_block`` and
    ``train_finish`` counting their combines outside the body
    (:class:`~d4pg_tpu_torch.parallel.dp.LaneProgram`); one block of 8
    grad steps over two lanes holds about twice the kernels of one
    device's."""

    def __init__(self, loop, carry: Carry):
        self.loop, self.carry = loop, carry
        c, bufs, dev = carry, _lanes(carry.buffers), loop.device
        traj = [t for buf in bufs for t in buf.traj]
        drawn = [t for buf in bufs
                 for t in [buf.idx] + ([buf.weights] if buf.weights is not None else [])]
        trained = drawn + [t for buf in bufs for t in [buf.priorities, *buf.metrics.values()]]

        def actor():
            return graphs.module_tensors(c.state.actor)

        def lane():
            return pytree.tree_leaves((c.env_states, c.obs, c.noise_states))

        def ring():
            return [t for replay in _lanes(c.replay) for t in ring_tensors(replay)]

        self.collect_step = graphs.Program(
            "collect_step", partial(loop.collect_step, c), dev,
            state=lambda: actor() + lane() + traj, generators=_lanes(c.collect_gen))
        self.ring_append = graphs.Program("ring_append", partial(loop.append, c), dev,
                                          state=lambda: traj + ring())
        self.train_draw = graphs.Program("train_draw", partial(loop.draw, c), dev,
                                         state=lambda: ring() + drawn,
                                         generators=_lanes(c.train_gen))
        self.train_block = graphs.Program(
            "train_block", partial(loop.train_block, c), dev,
            state=lambda: megastep.learner_tensors(c.state) + ring() + trained,
            generators=megastep.learner_generators(c.state))
        self.train_finish = graphs.Program("train_finish", partial(loop.finish, c), dev,
                                           state=lambda: ring() + traj + trained)
        sync = getattr(loop, "sync", None)
        if sync is not None:  # the lanes' combines, counted outside the bodies
            self.train_block = LaneProgram(self.train_block, sync)
            self.train_finish = LaneProgram(self.train_finish, sync)

    def all(self) -> list:
        return [self.collect_step, self.ring_append, self.train_draw, self.train_block,
                self.train_finish]

    def warmup(self, noise_scale: float) -> None:
        """One segment into the ring: ``collect_step`` ``segment_len``
        times, then ``ring_append``."""
        scale = self.loop.scale_tensor(noise_scale)
        for t in self.loop.steps:
            self.collect_step(t, scale)
        self.ring_append()

    def iterate(self, noise_scale: float) -> dict:
        """One segment, the draw, the K grad steps and the write-back;
        returns the metrics (0-d device tensors)."""
        state = self.carry.state
        step = state.step
        beta = self.loop.beta(step)
        self.warmup(noise_scale)
        self.train_draw(*(() if beta is None else (beta,)))
        for j in self.loop.blocks:
            self.train_block(j)
        metrics = self.train_finish()
        state.step = step + self.loop.K
        return metrics


def _check_sizes(num_envs: int, replay_capacity: int, segment_len: int, D: int) -> int:
    """The rows a segment writes, refusing a ring they do not divide."""
    n_new = num_envs * segment_len
    if replay_capacity % n_new != 0:
        raise ValueError(
            f"replay_capacity ({replay_capacity * D}) must be a multiple of "
            f"num_envs*segment_len ({n_new * D}"
            + (f" — both are per-device ÷{D})" if D > 1 else ")")
        )
    return n_new


def make_on_device_loop(
    config: D4PGConfig,
    env,
    num_envs: int = 64,
    segment_len: int = SEGMENT_LEN,
    replay_capacity: int = 131_072,
    batch_size: int = 256,
    train_steps_per_iter: int = 32,
    prioritized: bool = True,
    device=None,
    obs_uint8: bool = False,
    obs_bf16: bool = False,
    noise_fns=None,
) -> OnDeviceLoop:
    """The single-device loop (:class:`OnDeviceLoop`); the arguments are
    :func:`make_on_device_trainer`'s without a mesh."""
    if obs_uint8 and obs_bf16:
        raise ValueError("obs_uint8 and obs_bf16 are mutually exclusive")
    _check_sizes(num_envs, replay_capacity, segment_len, 1)
    obs_dtype = torch.uint8 if obs_uint8 else torch.bfloat16 if obs_bf16 else torch.float32
    return OnDeviceLoop(config, env, num_envs, segment_len, replay_capacity, batch_size,
                        train_steps_per_iter, prioritized, resolve_device(device), obs_dtype,
                        noise_fns)


def _lane_shapes(config, mesh, num_envs, segment_len, replay_capacity, batch_size, obs_uint8,
                 obs_bf16, noise_fns):
    """A mesh loop's lane sizes from the global ones (refusing what the
    lanes do not divide), its device, ring dtype and noise processes (one
    a local lane)."""
    D = mesh.dp
    for name, val in (("num_envs", num_envs), ("replay_capacity", replay_capacity),
                      ("batch_size", batch_size)):
        if val % D != 0:
            raise ValueError(f"{name} ({val}) must be divisible by mesh axis 'dp' size {D}")
    num_envs //= D
    replay_capacity //= D
    batch_size //= D
    device = check_one_device(mesh)
    if obs_uint8 and obs_bf16:
        raise ValueError("obs_uint8 and obs_bf16 are mutually exclusive")
    n_new = _check_sizes(num_envs, replay_capacity, segment_len, D)
    device = resolve_device(device)
    if not isinstance(noise_fns, list):
        noise_fns = [noise_fns or make_noise(config, (num_envs,), device)] * len(mesh.local_lanes)
    obs_dtype = torch.uint8 if obs_uint8 else torch.bfloat16 if obs_bf16 else torch.float32
    return num_envs, replay_capacity, batch_size, n_new, device, obs_dtype, noise_fns


def make_lanes_loop(
    config: D4PGConfig,
    env,
    mesh,
    num_envs: int = 64,
    segment_len: int = SEGMENT_LEN,
    replay_capacity: int = 131_072,
    batch_size: int = 256,
    train_steps_per_iter: int = 32,
    prioritized: bool = True,
    obs_uint8: bool = False,
    obs_bf16: bool = False,
    noise_fns=None,
) -> LanesLoop:
    """The lanes' loop (:class:`LanesLoop`); the arguments are
    :func:`make_on_device_trainer`'s with a mesh (``num_envs``,
    ``replay_capacity`` and ``batch_size`` global)."""
    num_envs, replay_capacity, batch_size, _, device, obs_dtype, noise_fns = _lane_shapes(
        config, mesh, num_envs, segment_len, replay_capacity, batch_size, obs_uint8, obs_bf16,
        noise_fns)
    return LanesLoop(config, env, mesh, num_envs, segment_len, replay_capacity, batch_size,
                     train_steps_per_iter, prioritized, device, obs_dtype, noise_fns)


def make_on_device_trainer(
    config: D4PGConfig,
    env,
    num_envs: int = 64,
    segment_len: int = SEGMENT_LEN,
    replay_capacity: int = 131_072,
    batch_size: int = 256,
    train_steps_per_iter: int = 32,
    prioritized: bool = True,
    device=None,
    mesh=None,
    obs_uint8: bool = False,
    obs_bf16: bool = False,
    noise_fns=None,
):
    """Build ``(init_fn, warmup_fn, iterate_fn)`` for the on-device loop.

    - ``init_fn(state, seed) -> carry``: resets ``num_envs`` envs and an
      empty ring on the state's device, generators seeded from ``seed``;
    - ``warmup_fn(carry, noise_scale) -> carry`` collects one
      num_envs×segment_len segment into the ring WITHOUT training (the
      replay pre-fill);
    - ``iterate_fn(carry, noise_scale, draws=None) -> (carry, metrics)``:
      one segment, then ``train_steps_per_iter`` grad steps; ``metrics``
      holds 0-d device tensors (their K-step means and
      ``train_reward_per_episode_boundary``). ``draws`` replaces the train
      generator's draws: [K, B] uniform numbers in [0, 1) with PER, [K, B]
      indices without (with a mesh, one such block a local lane, of the
      lane's B/D rows).

    Without a mesh these are :class:`OnDeviceLoop`'s eager ``init``,
    ``warmup`` and ``iterate``, which update the carry IN PLACE (and
    return it); :class:`OnDevicePrograms` runs the same bodies as
    compiled programs. ``noise_fns`` replaces the exploration noise
    process (init, sample, reset) of :func:`~d4pg_tpu_torch.agent.d4pg.
    make_noise` (with a mesh, a list of one a local lane). ``obs_bf16``
    stores the ring's observations as bfloat16 (``--ring-dtype
    bfloat16``), ``obs_uint8`` as uint8 bytes (a pixel env's [0, 1]
    frames); the two are exclusive. ``mesh`` (``parallel/mesh.py``) splits
    the loop over its dp lanes (see the module docstring); ``num_envs``,
    ``replay_capacity`` and ``batch_size`` are then global and must
    divide by ``mesh.dp``. The mesh's functions here are the eager loop,
    whole segments and all K grad steps at once, which a run of several
    processes uses and against which the tests hold :class:`LanesLoop`
    (:func:`make_lanes_loop`), whose bodies :class:`OnDevicePrograms`
    compiles.
    """
    if mesh is None:
        loop = make_on_device_loop(
            config, env, num_envs, segment_len, replay_capacity, batch_size,
            train_steps_per_iter, prioritized, device, obs_uint8, obs_bf16, noise_fns)
        return loop.init, loop.warmup, loop.iterate
    num_envs, replay_capacity, batch_size, n_new, device, obs_dtype, noise_fns = _lane_shapes(
        config, mesh, num_envs, segment_len, replay_capacity, batch_size, obs_uint8, obs_bf16,
        noise_fns)
    lanes = list(mesh.local_lanes)
    collects = [make_segment_collector(config, env, num_envs, segment_len, fns)
                for fns in noise_fns]
    sync = LaneSync(mesh)
    K, B = train_steps_per_iter, batch_size

    def _gen(seed, stream, lane):
        return torch.Generator(device).manual_seed(leg_seed(seed, stream, lane))

    def init_fn(state: TrainState, seed: int) -> Carry:
        per_lane = []
        for j, lane in enumerate(lanes):
            env_states, obs = env.reset(num_envs, _gen(seed, 0, lane), device)
            replay = device_replay_init(replay_capacity, config.obs_dim, config.action_dim,
                                        device, obs_dtype=obs_dtype)
            per_lane.append((env_states, obs, noise_fns[j][0](), replay,
                             _gen(seed, 1, lane), _gen(seed, 2, lane)))
        return Carry(state, *(list(f) for f in zip(*per_lane)))

    def _lane_items(carry: Carry) -> list:
        return list(zip(*carry[1:7]))

    def _pack(carry: Carry, items: list) -> Carry:
        return Carry(carry.state, *(list(f) for f in zip(*items)))

    def _collect(carry: Carry, noise_scale: float):
        items, trajs = [], []
        for j, (env_states, obs, noise_states, replay, cgen, tgen) in enumerate(
                _lane_items(carry)):
            env_states, obs, noise_states, flat, traj = collects[j](
                carry.state.actor, env_states, obs, noise_states, cgen, noise_scale)
            _append(replay, flat, n_new, config.per_alpha)
            items.append((env_states, obs, noise_states, replay, cgen, tgen))
            trajs.append(traj)
        return _pack(carry, items), trajs

    def warmup_fn(carry: Carry, noise_scale: float) -> Carry:
        return _collect(carry, noise_scale)[0]

    def _draw(state, replay: DeviceReplay, gen, lane_draws):
        if prioritized:
            u = lane_draws if lane_draws is not None else torch.rand(
                (K, B), generator=gen, device=device)
            idx, weights = per_draw(config, replay.priority, replay.size, u, state.step)
            # a pixel ring's rows stay uint8 until their step decodes them
            batches = gather_batches(replay, idx, decode=False)
            batches["weights"] = weights
        else:
            idx = lane_draws if lane_draws is not None else megastep.draw_uniform_indices(
                gen, K, B, replay.size)
            batches = gather_batches(replay, idx, decode=False)
        return idx, batches

    def iterate_fn(carry: Carry, noise_scale: float, draws=None):
        carry, trajs = _collect(carry, noise_scale)
        state = carry.state
        items = _lane_items(carry)
        replays = [it[3] for it in items]
        drawn = [_draw(state, it[3], it[5], None if draws is None else draws[j])
                 for j, it in enumerate(items)]
        _, metrics, new_pri = fused_train_scan(config, state, [b for _, b in drawn],
                                               sync_fn=sync)
        new_pri = new_pri.split(B, dim=1)  # the lanes' columns, in lane order
        if prioritized:
            for replay, (idx, _), pri in zip(replays, drawn, new_pri):
                per_write_back(config, replay, idx, pri)
            top = sync.max(torch.stack([r.max_priority for r in replays]))
            for replay in replays:
                replay.max_priority.copy_(top)
        metrics = {k: v.mean() for k, v in metrics.items()}
        proxies = torch.stack([_proxy(t) for t in trajs])
        metrics["train_reward_per_episode_boundary"] = sync(proxies[:, None])[0]
        return carry, metrics

    return init_fn, warmup_fn, iterate_fn


class OnDeviceRun:
    """The ``--on-device`` loop (the JAX package's ``run_on_device``):
    the loop of :func:`make_on_device_trainer` with greedy eval on the eval
    cadence, the EWMA return, ``metrics.jsonl``, checkpoints, the
    best-eval snapshot, ``--resume``, preemption and the RSS watchdog.

    One iteration = ``num_envs × 32`` env steps and ``K = round(num_envs ×
    32 / env_steps_per_train_step)`` grad steps. The warmup
    segments and the iterations run as :class:`OnDevicePrograms` (CUDA
    graphs on the card), and the evals as a compiled
    :class:`~d4pg_tpu_torch.runtime.evaluator.GreedyEval`; the programs
    are built after any ``--resume`` restore, which copies into the
    tensors they capture. The host keeps its own mirrors of the ring's
    ``pos`` and ``size`` (``ring_pos``, ``ring_size``), which
    ``replay_size`` reads. The ring is not checkpointed: a resumed run
    rebuilds it and warms it up again. Its generators are seeded from
    ``(seed, grad_steps)`` on every start, so a resumed leg draws a stream
    of its own. With ``debug_guards`` on the card every iteration after
    the first runs under ``torch.cuda.set_sync_debug_mode("error")``. With
    ``dp`` the same programs run the ``dp`` lanes of this process
    (:class:`LanesLoop`; ``replay_size`` is the global fill, a lane's
    times ``dp``); several processes are refused as the JAX CLI refuses
    them (``multihost_device_placement_only``).
    """

    def __init__(self, config: TrainConfig, device=None, preempt_event=None):
        if getattr(config, "obs_norm", False):
            raise ValueError(
                "obs_norm is a host data-boundary feature; the on-device path "
                "does not support it"
            )
        self.device = resolve_device(device)
        config = apply_env_preset(config)
        check_wire_dtypes(config)
        check_supported(config.agent)
        check_placement(config)
        check_on_device(config)
        self.config = config
        self.preempt_event = preempt_event
        self.env = make_env(config.env, config.max_episode_steps, config.action_repeat)
        agent = config.agent
        self.n_new = config.num_envs * SEGMENT_LEN
        self.K = max(1, round(self.n_new / max(config.env_steps_per_train_step, 1e-9)))
        capacity = max(self.n_new, (config.replay_capacity // self.n_new) * self.n_new)
        if capacity != config.replay_capacity:
            print(
                f"replay capacity {config.replay_capacity} adjusted to {capacity} "
                f"(device ring must be a multiple of num_envs×segment_len = {self.n_new})",
                flush=True,
            )
        self.capacity = capacity
        # --dp: the loop's dp lanes (tp is ignored here, as in the JAX
        # run_on_device, which builds make_mesh(dp, tp=1))
        self.mesh = None
        if config.dp:
            self.mesh = make_mesh(config.dp, 1, device=self.device)
            self.device = check_one_device(self.mesh)
        loop_kw = dict(
            num_envs=config.num_envs, segment_len=SEGMENT_LEN, replay_capacity=capacity,
            batch_size=config.batch_size, train_steps_per_iter=self.K,
            prioritized=config.prioritized, device=self.device,
            # a pixel env's ring stores uint8 whatever --ring-dtype says,
            # as the JAX package's run_on_device does
            obs_uint8=bool(agent.pixel_shape),
            obs_bf16=config.ring_dtype == "bfloat16" and not agent.pixel_shape,
        )
        if self.mesh is None:
            self.loop = make_on_device_loop(agent, self.env, **loop_kw)
        else:
            loop_kw.pop("device")
            self.loop = make_lanes_loop(agent, self.env, self.mesh, **loop_kw)
        self.init_fn, self.warmup_fn, self.iterate_fn = (
            self.loop.init, self.loop.warmup, self.loop.iterate)
        state = create_train_state(agent, config.seed, self.device)
        self.ckpt = CheckpointManager(os.path.join(config.log_dir, "checkpoints"))
        # the champion of the evals, kept apart from the rolling checkpoints
        self.best_ckpt = CheckpointManager(
            os.path.join(config.log_dir, "checkpoints_best"), max_to_keep=1
        )
        self.env_steps = 0
        self.ewma: Optional[float] = None
        self.best_eval: Optional[float] = None
        if config.resume and self.ckpt.latest_step() is not None:
            _, step, fallbacks = self.ckpt.restore_verified(state)
            for fb in fallbacks:
                print(f"[checkpoint] fallback: {fb}")
            print(f"[checkpoint] resumed from step {step}", flush=True)
            meta = load_trainer_meta(config.log_dir)
            self.env_steps = int(meta.get("env_steps", 0))
            self.ewma = meta.get("ewma_return")
            # only a score that a checkpoints_best snapshot backs is kept
            best_json = best_eval_path(config.log_dir)
            if self.best_ckpt.latest_step() is not None and os.path.exists(best_json):
                try:
                    with open(best_json) as f:
                        self.best_eval = float(json.load(f)["eval_return_mean"])
                except (OSError, ValueError, KeyError):
                    pass
        self.grad_steps = state.step
        # a stream of its own for each leg, as the JAX package folds
        # grad_steps into its key
        self.leg_seed = leg_seed(config.seed, self.grad_steps)
        self.carry = self.init_fn(state, self.leg_seed)
        self.eval_gen = torch.Generator(self.device).manual_seed(leg_seed(config.seed, self.grad_steps, 3))
        # built after the restore above: a program reads the state by address
        self.programs = self.loop.programs(self.carry)
        self.evaluator = GreedyEval(agent, self.env, state.actor, self.eval_gen,
                                    config.eval_episodes, compiled=True)
        self.ring_pos = self.ring_size = 0  # host mirrors of a lane ring's pos and size
        self.logger = MetricsLogger(config.log_dir)
        self.iterations = 0          # train iterations run by this leg
        self.guarded_iterations = 0  # of which under the sync guard
        self.rows_appended = 0       # rows written into the ring
        self.warmup_s = 0.0          # host seconds in the warmup segments
        self.eval_s = 0.0            # host seconds in the evals
        self.last: dict = {}

    def replay_size(self) -> int:
        """The global fill: a lane's ring size (every lane's is the same,
        read off the host mirror) times the dp lanes, as the JAX
        ``run_on_device`` reports it."""
        return self.ring_size * (1 if self.mesh is None else self.mesh.dp)

    def _advance_mirrors(self) -> None:
        """The ring's ``pos`` and ``size`` after one segment, on the host:
        they advance by exactly ``n_new`` rows a lane, so nothing is read
        back from the device."""
        n = self.n_new // (1 if self.mesh is None else self.mesh.dp)
        cap = self.capacity // (1 if self.mesh is None else self.mesh.dp)
        self.ring_pos = (self.ring_pos + n) % cap
        self.ring_size = min(self.ring_size + n, cap)
        self.rows_appended += self.n_new

    def segment(self, noise_scale: float) -> None:
        """One warmup segment into the ring (the ``collect_step`` and
        ``ring_append`` programs)."""
        self.programs.warmup(noise_scale)
        self._advance_mirrors()

    def iteration(self, noise_scale: float) -> dict:
        """One train iteration (every program); returns the metrics, 0-d
        device tensors."""
        metrics = self.programs.iterate(noise_scale)
        self._advance_mirrors()
        return metrics

    def _noise_scale(self) -> float:
        agent = self.config.agent
        return noise_scale_schedule(self.env_steps, agent.noise_decay_steps, agent.noise_scale_final)

    def _guard(self):
        if self.config.debug_guards and self.device.type == "cuda" and self.iterations:
            self.guarded_iterations += 1
            return sync_debug_error()
        return contextlib.nullcontext()

    def _save(self) -> None:
        """The state, the trainer meta, then the manifest naming both."""
        cfg = self.config
        self.ckpt.save(self.grad_steps, self.carry.state)
        save_trainer_meta(cfg.log_dir, self.env_steps, self.ewma)
        self.ckpt.write_manifest(self.grad_steps, side_files=[trainer_meta_path(cfg.log_dir)])

    def _save_best(self) -> None:
        """Replace the best-eval snapshot. The JSON is invalidated before
        the old snapshot goes, and rewritten after the new one landed, so
        it never attests params that do not exist."""
        prev = self.best_ckpt.latest_step()
        if prev is not None:
            invalidate_best_eval(self.config.log_dir)
            if prev >= self.grad_steps:
                self.best_ckpt.delete(prev)
        self.best_ckpt.save(self.grad_steps, self.carry.state)
        save_best_eval(self.config.log_dir, self.grad_steps, self.best_eval, self.env_steps)

    def _eval_and_log(self, metrics, t0: float, grad_steps_done: int, env_steps_done: int) -> dict:
        cfg = self.config
        scalars = {k: float(v) for k, v in metrics.items()} if metrics else {}
        e0 = time.monotonic()
        scalars.update(self.evaluator.run())
        self.eval_s += time.monotonic() - e0
        ret = scalars["eval_return_mean"]
        self.ewma = ret if self.ewma is None else (
            (1 - cfg.ewma_alpha) * self.ewma + cfg.ewma_alpha * ret
        )
        if self.best_eval is None or ret > self.best_eval:
            self.best_eval = ret
            self._save_best()
        dt = time.monotonic() - t0
        scalars.update(
            best_eval_return=self.best_eval,
            avg_test_reward_ewma=self.ewma,
            noise_scale=self._noise_scale(),
            grad_steps_per_sec=grad_steps_done / dt,
            env_steps_per_sec=env_steps_done / dt,
            replay_size=self.replay_size(),
            env_steps=self.env_steps,
        )
        self.logger.log(self.grad_steps, scalars)
        print(
            f"[step {self.grad_steps}] "
            + " ".join(f"{k}={v:.3f}" for k, v in scalars.items() if k != "replay_size"),
            flush=True,
        )
        self.last = scalars
        return scalars

    def run(self) -> dict:
        """Warm up, then run ``total_steps`` more grad steps (a budget per
        invocation: a resumed leg adds them to the restored step). Returns
        the last metrics row, with ``_preempted`` set when the run stopped
        for a ``--resume`` restart."""
        cfg = self.config
        total = self.grad_steps + cfg.total_steps
        t0 = time.monotonic()
        grad_steps_done = env_steps_done = 0
        try:
            # replay pre-fill at 3x noise, after a resume too (the ring
            # starts empty); skipped when the budget is already spent
            w0 = time.monotonic()
            while self.grad_steps < total and env_steps_done < max(cfg.warmup_steps, cfg.batch_size):
                self.segment(3.0)
                env_steps_done += self.n_new
                self.env_steps += self.n_new
            self.warmup_s = time.monotonic() - w0
            if self.grad_steps >= total:
                print(
                    f"--total-steps {cfg.total_steps} leaves no budget at "
                    f"step {self.grad_steps}; running final eval only",
                    flush=True,
                )
                return self._eval_and_log(None, t0, 0, 0)
            while self.grad_steps < total:
                if self.preempt_event is not None and self.preempt_event.is_set():
                    self._save()
                    print(
                        f"[preempt] stop requested: checkpointed at step "
                        f"{self.grad_steps}; exiting for a --resume restart",
                        flush=True,
                    )
                    self.last = dict(self.last, _preempted=True)
                    break
                with self._guard():
                    m = self.iteration(self._noise_scale())
                self.iterations += 1
                prev = self.grad_steps
                self.grad_steps += self.K
                grad_steps_done += self.K
                self.env_steps += self.n_new
                env_steps_done += self.n_new
                evaluated = interval_crossed(prev, self.grad_steps, cfg.eval_interval)
                if evaluated or self.grad_steps >= total:
                    self._eval_and_log(m, t0, grad_steps_done, env_steps_done)
                saved = interval_crossed(prev, self.grad_steps, cfg.checkpoint_interval) or (
                    self.grad_steps >= total
                )
                if saved:
                    self._save()
                if cfg.max_rss_gb > 0 and self.grad_steps < total and evaluated:
                    rss = _rss_gb()
                    if rss > cfg.max_rss_gb:
                        if not saved:
                            self._save()
                        print(
                            f"[rss-watchdog] RSS {rss:.1f} GB > --max-rss-gb "
                            f"{cfg.max_rss_gb}: checkpointed at step {self.grad_steps}; "
                            "exiting for a --resume restart",
                            flush=True,
                        )
                        self.last = dict(self.last, _preempted=True)
                        break
        finally:
            self.logger.close()
        return self.last


def run_on_device(config: TrainConfig, preempt_event=None, device=None) -> dict:
    """CLI entry of the on-device loop: :meth:`OnDeviceRun.run` on
    ``device`` (default: the CUDA card)."""
    return OnDeviceRun(config, device, preempt_event).run()
