"""Exploration collection (counterpart of ``d4pg_tpu/runtime/collect.py``
and of the JAX trainer's host and pool collection).

Batched torch envs: one call rolls every env one segment under the noisy
actor (auto-reset, noise state threaded through) and collapses the
segment into n-step transitions, all as tensor ops on the env's device.
The host trainer then copies the flat block to the host and inserts it
into replay in one call. Windows never span segment boundaries: the last
up-to-(n−1) steps of a segment bootstrap early with the exact ``γ^m`` of
their shortened window, a valid m-step Bellman target, the same
convention as episode truncation (:func:`d4pg_tpu_torch.ops.nstep_returns`
with ``truncations``).

Host envs (gymnasium, ``dmc:``, ``pixel_pendulum_host``), stepped on the
host:

- :class:`HostActing` computes N rows of actions in one actor forward on
  the acting device (the CPU, or the card), with the noise state of N
  rows, its own ``torch.Generator`` and, on the card, its own stream: the
  observations cross with a non-blocking copy, the actions come back into
  a pinned buffer and the host waits on an event recorded after that
  copy (``Event.synchronize``, which ``set_sync_debug_mode`` does not
  count), so acting from a thread never trips the learner's sync guard;
- :func:`publish_actor` makes a publication, a real copy of the actor's
  parameters (on the card: fresh tensors cloned on the learner's stream
  and an event recorded after the clone; on the CPU: ``.cpu()`` copies),
  and :class:`ActorCopy`, a reader's own actor module, loads one after
  waiting on its event, so no thread reads a parameter that a dispatch
  in flight is writing;
- :class:`PoolCollector` is one pool step of the host actor pool: the
  batched act over N rows, the supervised step (``step`` or
  ``step_goal``), the dropped actors' windows dropped whole, the writers
  (a :class:`~d4pg_tpu_torch.replay.nstep_writer.BatchedNStepWriter` or
  one hindsight writer an actor), and the per-row noise reset on
  ``done | dropped``. The trainer and ``chip_smoke.py`` drive the same
  object.
"""

from __future__ import annotations

import contextlib
import copy
import time
from collections import deque
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from d4pg_tpu_torch.agent.d4pg import act_deterministic, make_noise, noisy_explore
from d4pg_tpu_torch.agent.state import D4PGConfig
from d4pg_tpu_torch.envs.rollouts import Trajectory, rollout
from d4pg_tpu_torch.ops.nstep import nstep_returns


def collapse_nstep(traj: Trajectory, gamma: float, n: int) -> dict[str, torch.Tensor]:
    """n-step-collapse an [N, T] segment into N·T flat transitions:
    obs, action, reward = R^(m), next_obs = s_{t+m}, discount =
    γ^m·(1−terminal)."""
    N, T = traj.reward.shape
    rets, boots, offs = nstep_returns(
        traj.reward, traj.terminated, gamma, n, truncations=traj.truncated
    )
    # the bootstrap state s_{t+m} is next_obs[t + m - 1]
    idx = (torch.arange(T, device=offs.device) + offs - 1).clamp(0, T - 1).long()
    next_obs = torch.gather(
        traj.next_obs, 1, idx[..., None].expand(-1, -1, traj.next_obs.shape[-1])
    )
    flat = {
        "obs": traj.obs,
        "action": traj.action,
        "reward": rets,
        "next_obs": next_obs,
        "discount": boots,
    }
    return {k: v.reshape((N * T,) + v.shape[2:]) for k, v in flat.items()}


def make_segment_collector(
    config: D4PGConfig, env, num_envs: int, segment_len: int, noise_fns=None
):
    """Build ``collect(actor, env_states, obs, noise_states, generator,
    noise_scale) -> (env_states, obs, noise_states, flat, traj)`` where
    ``flat`` is :func:`collapse_nstep` of the segment and ``traj`` the raw
    [N, T] segment."""
    _, noise_sample, noise_reset = noise_fns or make_noise(config, (num_envs,))

    @torch.no_grad()
    def collect(actor, env_states, obs, noise_states, generator, noise_scale):
        def policy(o, gen, nstate):
            return noisy_explore(config, noise_sample, actor(o), gen, nstate, noise_scale)

        env_states, obs, noise_states, traj = rollout(
            env, policy, generator, segment_len,
            init_state=env_states, init_obs=obs,
            policy_state=noise_states, policy_state_reset=noise_reset,
        )
        flat = collapse_nstep(traj, config.gamma, config.n_step)
        return env_states, obs, noise_states, flat, traj

    return collect


# ---------------------------------------------------------------- host envs
class Publication(NamedTuple):
    """A real copy of the actor's parameters and buffers (``state_dict``
    keys), the event recorded after the copy on the card (None on the
    CPU), and a version that grows with every publication."""

    params: dict
    event: Optional[torch.cuda.Event]
    version: int


def publish_actor(actor: torch.nn.Module, device: torch.device, version: int) -> Publication:
    """Copy ``actor``'s parameters for readers on other threads: onto the
    CPU (a blocking copy), or on ``device`` = the actor's own card as fresh
    tensors cloned on the caller's (the learner's) stream, with an event
    recorded after the clones. The live actor is updated in place by the
    next dispatch; the copy is not."""
    src = actor.state_dict()
    if device.type == "cpu":
        return Publication({k: v.detach().to("cpu", copy=True) for k, v in src.items()},
                           None, version)
    params = {k: v.detach().clone() for k, v in src.items()}
    event = torch.cuda.Event()
    event.record()
    return Publication(params, event, version)


class ActorCopy:
    """One reader's own actor module on the acting device, loaded from
    publications. A reader owns its copy: the collector and the evaluator
    each hold one, so neither ever reads the other's or the learner's
    parameters."""

    def __init__(self, template: torch.nn.Module, device: torch.device):
        module = copy.deepcopy(template).to(device)
        for p in module.parameters():
            p.grad = None
            p.requires_grad_(False)
        self.module = module
        self.device = device
        self.version = -1

    def load(self, pub: Publication, stream=None) -> torch.nn.Module:
        """Load ``pub`` (once per version), on ``stream`` on the card after
        waiting on its event; returns the module."""
        if pub.version == self.version:
            return self.module
        if self.device.type == "cuda":
            stream = stream or torch.cuda.current_stream(self.device)
            with torch.cuda.stream(stream):
                if pub.event is not None:
                    stream.wait_event(pub.event)
                self.module.load_state_dict(pub.params)
                for v in pub.params.values():
                    if v.is_cuda:
                        # the allocator must not hand this memory to the
                        # learner's stream before the copy above has run
                        v.record_stream(stream)
        else:
            self.module.load_state_dict(pub.params)
        self.version = pub.version
        return self.module


class HostActing:
    """Actions for N host envs from one actor forward on ``device`` (see the
    module docstring). ``explore`` adds the config's noise at a scale and
    keeps its N-row noise state; ``greedy`` is the eval forward."""

    def __init__(self, config: D4PGConfig, n: int, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        self.config = config
        self.device = device
        self.generator = generator
        init, self._noise_sample, self._noise_reset = make_noise(config, (n,), device)
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        # every noise tensor is made, read and replaced on the acting stream
        with self._on_stream():
            self.noise = init()
        self._host = None  # pinned [n, action_dim] for the card's actions
        self._done = torch.cuda.Event() if self.stream is not None else None

    def _on_stream(self):
        return torch.cuda.stream(self.stream) if self.stream is not None else contextlib.nullcontext()

    def _forward(self, actor, obs: np.ndarray, scale: Optional[float], wait_caller: bool):
        if self.stream is None:
            with torch.no_grad():
                a = act_deterministic(self.config, actor, torch.from_numpy(obs))
                if scale is not None:
                    a, self.noise = noisy_explore(self.config, self._noise_sample, a,
                                                  self.generator, self.noise, scale)
            return a.numpy().copy()
        if wait_caller:
            # acting with the live actor: run after the caller's enqueued
            # dispatches have written it
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream), torch.no_grad():
            x = torch.from_numpy(np.ascontiguousarray(obs)).to(self.device, non_blocking=True)
            a = act_deterministic(self.config, actor, x)
            if scale is not None:
                a, self.noise = noisy_explore(self.config, self._noise_sample, a,
                                              self.generator, self.noise, scale)
            if self._host is None or self._host.shape != a.shape:
                self._host = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
            self._host.copy_(a, non_blocking=True)
            self._done.record(self.stream)
        self._done.synchronize()
        return self._host.numpy().copy()

    def explore(self, actor, obs: np.ndarray, scale: float, wait_caller: bool = False) -> np.ndarray:
        """Noisy actions [n, action_dim] for observations [n, obs_dim]."""
        return self._forward(actor, obs, scale, wait_caller)

    def greedy(self, actor, obs: np.ndarray, wait_caller: bool = False) -> np.ndarray:
        """Greedy actions for observations [m, obs_dim] (any m)."""
        return self._forward(actor, obs, None, wait_caller)

    def reset_noise(self, done: np.ndarray) -> None:
        """Fresh noise state (the config's per-episode reset) on the rows
        of ``done`` [n] bool."""
        with self._on_stream():
            fresh = self._noise_reset(self.noise)
            mask = torch.from_numpy(np.asarray(done, bool)).to(self.device, non_blocking=True)
            self.noise = type(self.noise)(*(
                torch.where(mask.view((-1,) + (1,) * (f.ndim - 1)), r, f)
                for r, f in zip(fresh, self.noise)
            ))


class PoolCollector:
    """One pool step of the host actor pool (see the module docstring).

    ``writer`` is the N-wide n-step writer, or None with ``her_writers``
    (one hindsight writer an actor, rebuilt by ``make_her_writer`` when its
    actor is dropped). ``ingest`` maps the policy observations to what the
    actor reads (the trainer's obs-norm fold and normalize; identity
    otherwise). ``timers`` gets the ``env_step`` and ``replay_insert``
    stages. Per pool step it keeps the act and the pipe round trip apart:
    ``step_times`` holds the (act, pipe) seconds of the latest 4096 pool
    steps. ``on_step``, when set, is called after each pool step's insert
    with a dict of what the step saw: ``obs`` (what the actions were
    taken on), ``actions``, ``rewards``, ``next_obs`` (before any
    auto-reset), ``terminated``, ``truncated``, ``stepped`` (the pool's
    mask) and ``dropped`` (the actors whose windows were dropped); the
    arrays are the pool's, valid until its next step."""

    def __init__(self, config: D4PGConfig, pool, acting: HostActing, writer=None,
                 her_writers: Optional[list] = None,
                 make_her_writer: Optional[Callable] = None,
                 ingest: Optional[Callable] = None, timers=None):
        self.config = config
        self.pool = pool
        self.acting = acting
        self.writer = writer
        self.her_writers = her_writers
        self.make_her_writer = make_her_writer
        self.ingest = ingest or (lambda x: x)
        self.timers = timers
        self.obs: Optional[np.ndarray] = None
        self.step_times: deque = deque(maxlen=4096)
        self.on_step: Optional[Callable] = None

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        self.obs = self.pool.reset_all(seed=seed)
        return self.obs

    def _stage(self, name: str):
        return self.timers.stage(name) if self.timers is not None else contextlib.nullcontext()

    def step(self, actor, scale: float, wait_caller: bool = False) -> int:
        """One synchronized pool step of N envs under ``actor`` at noise
        ``scale``; returns the env steps actually stepped (the rows of the
        pool's ``stepped_mask``)."""
        pool, her = self.pool, self.her_writers is not None
        with self._stage("env_step"):
            t0 = time.perf_counter()
            actions = self.acting.explore(actor, self.ingest(self.obs), scale, wait_caller)
            t1 = time.perf_counter()
            if her:
                (obs2, rews, terms, truncs, pol_obs, _succ, _rep,
                 g_prev, g_next) = pool.step_goal(actions)
            else:
                obs2, rews, terms, truncs, pol_obs, _succ, _rep = pool.step(actions)
            t2 = time.perf_counter()
        self.step_times.append((t1 - t0, t2 - t1))
        # Supervision aftermath: masked rows did not step; an actor that
        # failed mid-window has its in-flight n-step state dropped WHOLE so
        # no torn transition reaches replay.
        stepped = pool.stepped_mask
        all_stepped = bool(stepped.all())
        dropped = pool.take_dropped()
        for i in dropped:
            if her:
                # its episode buffer holds a torn episode that must never
                # relabel or flush
                self.her_writers[i] = self.make_her_writer()
            else:
                self.writer.drop_actor(i)
        with self._stage("replay_insert"):
            if her:
                for i in range(len(stepped)):
                    if not stepped[i]:
                        continue
                    w = self.her_writers[i]
                    w.add(
                        observation=g_prev[i][0], achieved_goal=g_prev[i][1],
                        desired_goal=g_prev[i][2], action=actions[i],
                        reward=float(rews[i]), next_observation=g_next[i][0],
                        next_achieved_goal=g_next[i][1], terminated=bool(terms[i]),
                    )
                    if terms[i] or truncs[i]:
                        w.end_episode(truncated=not bool(terms[i]))
            else:
                self.writer.add_batch(self.obs, actions, rews, obs2, terms, truncs,
                                      active=None if all_stepped else stepped)
        if self.on_step is not None:
            self.on_step(dict(obs=self.obs, actions=actions, rewards=rews, next_obs=obs2,
                              terminated=terms, truncated=truncs, stepped=stepped,
                              dropped=dropped))
        done = terms | truncs
        if dropped:
            # restarted actors start a fresh episode: fresh noise too
            done = done.copy()
            done[dropped] = True
        if done.any():
            self.acting.reset_noise(done)
        self.obs = pol_obs
        return len(stepped) if all_stepped else int(stepped.sum())
