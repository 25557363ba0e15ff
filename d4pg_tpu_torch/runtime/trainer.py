"""The learner loop (counterpart of the pure-env sync path of
``d4pg_tpu/runtime/trainer.py``), with replay on the host or on the device.

One loop, on one device. With ``replay_placement="host"``:

- warmup: collect at noise scale 3.0 until ``warmup_steps`` env steps are
  in replay and it can serve a batch;
- collection budgeted by ``env_steps_per_train_step``: each budgeted
  collect rolls every env one segment on the device and bulk-inserts the
  n-step-collapsed block into host replay;
- sample (PER or uniform) on the host → pinned host tensors →
  ``non_blocking`` copies to the device;
- :func:`~d4pg_tpu_torch.agent.d4pg.train_step`;
- the PER priority write-back with a one-step lag: step N's priorities
  start their device→host copy right after step N is enqueued and are
  written back after step N+1 is enqueued, so the host never waits on the
  step it just launched;
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

Checkpoint, resume and preemption wait for ROADMAP A5.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import numpy as np
import torch

from d4pg_tpu_torch import resolve_device
from d4pg_tpu_torch.agent import create_train_state, make_noise, train_step
from d4pg_tpu_torch.agent.state import check_supported
from d4pg_tpu_torch.config import TrainConfig, apply_env_preset, check_placement
from d4pg_tpu_torch.envs import make_env
from d4pg_tpu_torch.replay import (
    PrioritizedReplayBuffer,
    ReplayBuffer,
    Transition,
    noise_scale_schedule,
)
from d4pg_tpu_torch.replay.device_per import DevicePerSync
from d4pg_tpu_torch.replay.device_ring import DeviceRingSync, device_ring_init
from d4pg_tpu_torch.runtime import megastep
from d4pg_tpu_torch.runtime.collect import make_segment_collector
from d4pg_tpu_torch.runtime.evaluator import evaluate
from d4pg_tpu_torch.runtime.metrics import MetricsLogger, StageTimers, interval_crossed

SEGMENT_LEN = 32  # env steps per env per collect (the JAX sync trainer's)


class Trainer:
    def __init__(self, config: TrainConfig, device=None):
        self.device = resolve_device(device)
        config = apply_env_preset(config)
        check_supported(config.agent)
        check_placement(config)
        self.config = config
        agent_cfg = config.agent
        self.env = make_env(config.env)
        self.env.max_episode_steps = config.max_episode_steps

        obs_dim, act_dim = agent_cfg.obs_dim, agent_cfg.action_dim
        self.on_device = config.replay_placement == "device"
        if self.on_device:
            # the write-side source of truth: a plain host ring, no host
            # trees (with PER the priorities live in the device tree)
            self.buffer = ReplayBuffer(config.replay_capacity, obs_dim, act_dim)
        elif config.prioritized:
            self.buffer = PrioritizedReplayBuffer(
                config.replay_capacity, obs_dim, act_dim,
                alpha=agent_cfg.per_alpha, beta0=agent_cfg.per_beta0,
                beta_steps=agent_cfg.per_beta_steps, eps=agent_cfg.per_eps,
            )
        else:
            self.buffer = ReplayBuffer(config.replay_capacity, obs_dim, act_dim)

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

        self._ring = self._ring_sync = self._dev_per = self._megastep = None
        self._dispatches = 0
        if self.on_device:
            self._ring = device_ring_init(config.replay_capacity, obs_dim, act_dim, self.device)
            self._ring_sync = DeviceRingSync(self.buffer)
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
        self.metrics = MetricsLogger(config.log_dir)

    def _noise_scale(self) -> float:
        agent = self.config.agent
        return noise_scale_schedule(
            self.env_steps, agent.noise_decay_steps, agent.noise_scale_final
        )

    # ------------------------------------------------------------ collection
    def _collect_once(self, noise_scale: Optional[float] = None) -> None:
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
        while self.env_steps < cfg.warmup_steps or len(self.buffer) < cfg.batch_size:
            self._collect_once(noise_scale=3.0)

    # ---------------------------------------------------------------- batches
    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            # pinned staging, so the copy is asynchronous; PyTorch's host
            # allocator keeps the pinned block until the copy has run
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _sample_staged(self):
        """Sample one batch on the host and start its copy to the device.
        Returns (indices for the write-back or None, device batch)."""
        cfg = self.config
        with self.timers.stage("sample"):
            if cfg.prioritized:
                batch = self.buffer.sample(cfg.batch_size, self._rng, step=self.grad_steps)
                indices = batch.pop("indices")
            else:
                # no "weights" key: uniform IS weights are identically 1
                batch = dict(self.buffer.sample(cfg.batch_size, self._rng))
                indices = None
        with self.timers.stage("h2d_stage"):
            dev_batch = {k: self._to_device(v) for k, v in batch.items()}
        return indices, dev_batch

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

    # ------------------------------------------------------------------ train
    def _dispatch_guard(self):
        """``set_sync_debug_mode("error")`` around a steady-state megastep
        dispatch under ``debug_guards`` (the first dispatch builds and loads
        the kernels, which may synchronise)."""
        if not (self.config.debug_guards and self.device.type == "cuda" and self._dispatches):
            return contextlib.nullcontext()
        return _sync_debug_error()

    def _megastep_dispatch_once(self) -> dict:
        """Flush new rows into the device ring (and tree), then one megastep
        dispatch of K grad steps; returns its K-step mean metrics."""
        with self.timers.stage("ingest_chunk"):
            self._ring_sync.flush(self._ring)
        tree = self._dev_per.tree if self._dev_per is not None else None
        with self.timers.stage("megastep_dispatch"), self._dispatch_guard():
            metrics = self._megastep(self.state, self._ring, tree, self._megastep_gen)
        self._dispatches += 1
        return metrics

    def _host_step(self, pending):
        """Sample on the host, one ``train_step``, and the one-step-lag PER
        write-back; returns (metrics, the new pending write-back)."""
        cfg = self.config
        indices, dev_batch = self._sample_staged()
        with self.timers.stage("train_dispatch"):
            _, metrics, priorities = train_step(cfg.agent, self.state, dev_batch)
        if cfg.prioritized:
            if pending is not None:
                self._write_back(pending)
            pending = (indices, self._start_fetch(priorities))
        return metrics, pending

    def train(self, total_steps: Optional[int] = None) -> dict:
        """Warm up, then run ``total_steps`` grad steps (rounded up to whole
        dispatches of K); returns the last metrics row."""
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
        per_collect = cfg.num_envs * SEGMENT_LEN
        collect_budget = 0.0
        pending = None  # host PER: (indices, priority fetch) of the previous step
        last: dict = {}
        done = 0
        while done < total:
            collect_budget += cfg.env_steps_per_train_step * K
            while collect_budget >= per_collect:
                self._collect_once()
                collect_budget -= per_collect
            if self.on_device:
                metrics = self._megastep_dispatch_once()
            else:
                metrics, pending = self._host_step(pending)
            done += K
            self.grad_steps += K
            if interval_crossed(done - K, done, cfg.eval_interval) or done >= total:
                last = self._periodic(metrics, t_start, done, env_steps_start)
        if pending is not None:
            self._write_back(pending)
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
