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

The JAX package compiles this into one XLA program. Here it is eager
PyTorch, and the host keeps ``pos`` and ``size`` of the ring as integers:
they advance by exactly ``num_envs·segment_len`` a segment, so no
iteration reads anything back from the device. :func:`run_on_device`
reads the metrics only at an eval.

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
state, ring and generator pair a local lane, in lists.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from d4pg_tpu_torch import resolve_device
from d4pg_tpu_torch.agent import create_train_state
from d4pg_tpu_torch.agent.d4pg import encode_obs, fused_train_scan, gather_batches, make_noise
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
from d4pg_tpu_torch.parallel.dp import LaneSync
from d4pg_tpu_torch.parallel.mesh import check_one_device, make_mesh
from d4pg_tpu_torch.replay import noise_scale_schedule
from d4pg_tpu_torch.runtime.checkpoint import (
    CheckpointManager,
    best_eval_path,
    invalidate_best_eval,
    load_trainer_meta,
    save_best_eval,
    save_trainer_meta,
    trainer_meta_path,
)
from d4pg_tpu_torch.runtime.collect import make_segment_collector
from d4pg_tpu_torch.runtime.evaluator import evaluate
from d4pg_tpu_torch.runtime.metrics import MetricsLogger, interval_crossed
from d4pg_tpu_torch.runtime.trainer import SEGMENT_LEN, _rss_gb


@dataclasses.dataclass
class DeviceReplay:
    """Device-resident ring buffer (columnar, fixed shapes), updated in
    place. ``priority`` holds α-exponentiated priorities (0 = empty slot;
    read only with PER); ``max_priority`` is the running max of raw
    priorities, a 0-d device tensor. ``pos`` and ``size`` are host ints."""

    obs: torch.Tensor        # [C, O] float32, or bfloat16 (ring_dtype), or uint8 (pixels)
    action: torch.Tensor     # [C, A]
    reward: torch.Tensor     # [C]
    next_obs: torch.Tensor   # [C, O] as obs
    discount: torch.Tensor   # [C]
    priority: torch.Tensor   # [C] p_i^α, 0 where empty
    max_priority: torch.Tensor  # 0-d float32
    pos: int = 0             # next write slot
    size: int = 0            # filled entries


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
    )


def _append(replay: DeviceReplay, batch: dict, count: int, alpha: float) -> DeviceReplay:
    """Write ``count`` rows at the ring position, in place. Requires
    capacity % count == 0 so a write never wraps mid-block (enforced by
    :func:`make_on_device_trainer`). New rows enter at max_priority^α."""
    p = replay.pos
    cap = replay.obs.shape[0]
    for k in ("obs", "action", "reward", "next_obs", "discount"):
        dst = getattr(replay, k)[p:p + count]
        dst.copy_(encode_obs(batch[k]) if dst.dtype == torch.uint8 else batch[k])
    replay.priority[p:p + count].copy_((replay.max_priority**alpha).expand(count))
    replay.pos = (p + count) % cap
    replay.size = min(replay.size + count, cap)
    return replay


def per_draw(config: D4PGConfig, priority: torch.Tensor, size: int, u: torch.Tensor, step: int):
    """Proportional [K, B] draw from the ring's α-priorities at uniform
    numbers ``u`` in [0, 1): ``searchsorted`` (left side) of ``u·total`` in
    the priorities' ``cumsum``, clamped to the filled rows, and the
    β-annealed IS weights normalised by the min-priority row's weight.
    Returns (idx [K, B] int64, weights [K, B])."""
    cums = torch.cumsum(priority, 0)
    total = cums[-1]
    idx = torch.searchsorted(cums, u * total).clamp_(0, size - 1)
    p = priority[idx] / total
    frac = min(max(float(step) / max(config.per_beta_steps, 1), 0.0), 1.0)
    beta = config.per_beta0 + frac * (1.0 - config.per_beta0)
    weights = (p * size) ** (-beta)
    min_p = torch.where(priority > 0, priority, float("inf")).min() / total
    return idx, weights / (min_p * size) ** (-beta)


def per_write_back(
    config: D4PGConfig, replay: DeviceReplay, idx: torch.Tensor, new_pri: torch.Tensor
) -> None:
    """Write (|δ| + ε)^α of the [K, B] priorities into the ring in step
    order, in place: a row drawn by several steps keeps the value of the
    latest (within one step, of the last draw), as the JAX package's
    sequential ``fori_loop`` gives. One scatter of the winning values, so
    duplicate indices all write the same number. Raises ``max_priority``."""
    raw = new_pri.abs() + config.per_eps
    pa = (raw**config.per_alpha).reshape(-1)
    flat = idx.reshape(-1)
    order = torch.arange(flat.numel(), device=flat.device)
    last = torch.full(replay.priority.shape, -1, dtype=order.dtype, device=flat.device)
    last.scatter_reduce_(0, flat, order, reduce="amax")
    replay.priority.index_put_((flat,), pa[last[flat]])
    replay.max_priority = torch.maximum(replay.max_priority, raw.max())


class Carry(NamedTuple):
    """Everything one iteration reads and updates: the learner state, the
    envs, their observations and noise states, the ring and the two device
    generators (collection, train draws). With a mesh every field but
    ``state`` is a list, one entry a local lane."""

    state: TrainState
    env_states: EnvState
    obs: torch.Tensor
    noise_states: object
    replay: DeviceReplay
    collect_gen: torch.Generator
    train_gen: torch.Generator


def leg_seed(*parts: int) -> int:
    """A generator seed from integers (the run's seed, the leg's grad step,
    a stream number): the JAX package's ``fold_in`` of each part."""
    return int(np.random.SeedSequence([int(p) for p in parts]).generate_state(1)[0])


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

    ``noise_fns`` replaces the exploration noise process (init, sample,
    reset) of :func:`~d4pg_tpu_torch.agent.d4pg.make_noise` (with a mesh,
    a list of one a local lane). ``obs_bf16`` stores the ring's
    observations as bfloat16 (``--ring-dtype bfloat16``), ``obs_uint8``
    as uint8 bytes (a pixel env's [0, 1] frames); the two are exclusive.
    ``mesh`` (``parallel/mesh.py``) splits the loop over its dp lanes (see
    the module docstring); ``num_envs``, ``replay_capacity`` and
    ``batch_size`` are then global and must divide by ``mesh.dp``.
    """
    D = 1
    if mesh is not None:
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
    n_new = num_envs * segment_len
    if replay_capacity % n_new != 0:
        raise ValueError(
            f"replay_capacity ({replay_capacity * D}) must be a multiple of "
            f"num_envs*segment_len ({n_new * D}"
            + (f" — both are per-device ÷{D})" if D > 1 else ")")
        )
    device = resolve_device(device)
    lanes = list(mesh.local_lanes) if mesh is not None else [None]
    if not isinstance(noise_fns, list):
        noise_fns = [noise_fns or make_noise(config, (num_envs,), device)] * len(lanes)
    collects = [make_segment_collector(config, env, num_envs, segment_len, fns)
                for fns in noise_fns]
    sync = LaneSync(mesh) if mesh is not None else None
    K, B = train_steps_per_iter, batch_size
    obs_dtype = torch.uint8 if obs_uint8 else torch.bfloat16 if obs_bf16 else torch.float32

    def _seed(seed: int, stream: int, lane) -> int:
        return leg_seed(seed, stream) if lane is None else leg_seed(seed, stream, lane)

    def _gen(seed, stream, lane):
        return torch.Generator(device).manual_seed(_seed(seed, stream, lane))

    def init_fn(state: TrainState, seed: int) -> Carry:
        per_lane = []
        for j, lane in enumerate(lanes):
            env_states, obs = env.reset(num_envs, _gen(seed, 0, lane), device)
            replay = device_replay_init(replay_capacity, config.obs_dim, config.action_dim,
                                        device, obs_dtype=obs_dtype)
            per_lane.append((env_states, obs, noise_fns[j][0](), replay,
                             _gen(seed, 1, lane), _gen(seed, 2, lane)))
        if mesh is None:
            return Carry(state, *per_lane[0])
        return Carry(state, *(list(f) for f in zip(*per_lane)))

    def _lane_items(carry: Carry) -> list:
        items = carry[1:]
        return [items] if mesh is None else list(zip(*items))

    def _pack(carry: Carry, items: list) -> Carry:
        if mesh is None:
            return Carry(carry.state, *items[0])
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
            idx = lane_draws if lane_draws is not None else torch.randint(
                0, replay.size, (K, B), generator=gen, device=device)
            batches = gather_batches(replay, idx, decode=False)
        return idx, batches

    def _proxy(traj) -> torch.Tensor:
        # A TRAIN-time diagnostic, not an evaluation return: the segment's
        # exploration reward over the episode boundaries it saw (at least 1)
        return traj.reward.sum() / torch.clamp_min(
            torch.maximum(traj.terminated, traj.truncated).sum(), 1.0)

    def iterate_fn(carry: Carry, noise_scale: float, draws=None):
        carry, trajs = _collect(carry, noise_scale)
        state = carry.state
        items = _lane_items(carry)
        replays = [it[3] for it in items]
        if draws is not None and mesh is None:
            draws = [draws]
        drawn = [_draw(state, it[3], it[5], None if draws is None else draws[j])
                 for j, it in enumerate(items)]
        if mesh is None:
            _, metrics, new_pri = fused_train_scan(config, state, drawn[0][1])
            new_pri = [new_pri]
        else:
            _, metrics, new_pri = fused_train_scan(config, state, [b for _, b in drawn],
                                                   sync_fn=sync)
            new_pri = new_pri.split(B, dim=1)  # the lanes' columns, in lane order
        if prioritized:
            for replay, (idx, _), pri in zip(replays, drawn, new_pri):
                per_write_back(config, replay, idx, pri)
            if mesh is not None:
                top = sync.max(torch.stack([r.max_priority for r in replays]))
                for replay in replays:
                    replay.max_priority = top
        metrics = {k: v.mean() for k, v in metrics.items()}
        proxies = torch.stack([_proxy(t) for t in trajs])
        metrics["train_reward_per_episode_boundary"] = (
            proxies[0] if mesh is None else sync(proxies[:, None])[0])
        return carry, metrics

    return init_fn, warmup_fn, iterate_fn


class OnDeviceRun:
    """The ``--on-device`` loop (the JAX package's ``run_on_device``):
    the loop of :func:`make_on_device_trainer` with greedy eval on the eval
    cadence, the EWMA return, ``metrics.jsonl``, checkpoints, the
    best-eval snapshot, ``--resume``, preemption and the RSS watchdog.

    One iteration = ``num_envs × 32`` env steps and ``K = round(num_envs ×
    32 / env_steps_per_train_step)`` grad steps. The ring is not
    checkpointed: a resumed run rebuilds it and warms it up again. Its
    generators are seeded from ``(seed, grad_steps)`` on every start, so a
    resumed leg draws a stream of its own. With ``debug_guards`` on the
    card every iteration after the first runs under
    ``torch.cuda.set_sync_debug_mode("error")``. With ``dp`` the loop runs
    on ``dp`` lanes of this process (``replay_size`` is the global fill,
    a lane's times ``dp``); several processes are refused as the JAX CLI
    refuses them (``multihost_device_placement_only``).
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
        self.init_fn, self.warmup_fn, self.iterate_fn = make_on_device_trainer(
            agent, self.env, num_envs=config.num_envs, segment_len=SEGMENT_LEN,
            replay_capacity=capacity, batch_size=config.batch_size,
            train_steps_per_iter=self.K, prioritized=config.prioritized, device=self.device,
            mesh=self.mesh,
            # a pixel env's ring stores uint8 whatever --ring-dtype says,
            # as the JAX package's run_on_device does
            obs_uint8=bool(agent.pixel_shape),
            obs_bf16=config.ring_dtype == "bfloat16" and not agent.pixel_shape,
        )
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
        self.logger = MetricsLogger(config.log_dir)
        self.iterations = 0          # train iterations run by this leg
        self.guarded_iterations = 0  # of which under the sync guard
        self.rows_appended = 0       # rows written into the ring
        self.warmup_s = 0.0          # host seconds in the warmup segments
        self.eval_s = 0.0            # host seconds in the evals
        self.last: dict = {}

    def replay_size(self) -> int:
        """The global fill: a lane's ring size (every lane's is the same)
        times the dp lanes, as the JAX ``run_on_device`` reports it."""
        if self.mesh is None:
            return self.carry.replay.size
        return self.carry.replay[0].size * self.mesh.dp

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
        scalars.update(
            evaluate(cfg.agent, self.env, self.carry.state.actor, self.eval_gen, cfg.eval_episodes)
        )
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
                self.carry = self.warmup_fn(self.carry, 3.0)
                self.rows_appended += self.n_new
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
                    self.carry, m = self.iterate_fn(self.carry, self._noise_scale())
                self.iterations += 1
                self.rows_appended += self.n_new
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
