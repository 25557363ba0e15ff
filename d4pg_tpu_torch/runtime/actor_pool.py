"""Parallel host actor pool: N host envs in SUPERVISED worker processes
(the port's own copy of ``d4pg_tpu/runtime/actor_pool.py``).

N lightweight processes each own one host env (a gymnasium id, a ``dmc:``
id or ``pixel_pendulum_host``) and only step it, while a single learner
consumes the shared replay. One batched actor forward computes all N
actions per pool step (``runtime/collect.py:PoolCollector``).

Workers deliberately import nothing heavy: no torch. A worker imports this
module (``d4pg_tpu_torch/__init__`` loads no torch), numpy and the host
env adapter (:func:`~d4pg_tpu_torch.envs.gym_adapter.make_host_env`). With
the default ``spawn`` start method each child interpreter loads only
those, and never touches CUDA; a ``fork`` child inherits the parent's
CUDA context and must never touch it, which holds because a worker uses
numpy only. :func:`probe_child` starts a child the same way and reports
what it loaded.

**Supervision**: the parent never trusts a pipe. All pipe I/O is
deadline-bounded on ``time.monotonic``; a worker that misses the step
deadline (hang) or whose process is dead (crash, SIGKILL, OOM) is killed
and restarted under a per-worker jittered exponential
:class:`~d4pg_tpu_torch.utils.retry.Backoff`, and quarantined (masked out
of the batch for good) after ``max_worker_failures`` CONSECUTIVE failures.
The batch keeps its N rows: failed rows are masked instead,
:attr:`HostActorPool.stepped_mask` says which rows are real env steps this
call, and callers skip replay ingestion for the rest. A failed worker's
in-flight n-step window is torn mid-episode, so the caller drains
:meth:`take_dropped` and drops those windows whole. An orphaned worker
polls its pipe with a timeout and exits when the parent is gone, so a
crashed learner never strands N env processes.

**Guards and faults** (the JAX pool's): with a
:class:`~d4pg_tpu_torch.analysis.ledger.StagingLedger` (``debug_guards``)
each reply slot handed out is held for the one step the caller retains
it, and a rewrite while held raises; with a
:class:`~d4pg_tpu_torch.chaos.ChaosInjector` the plan's ``env_raise`` /
``env_hang`` entries ship into their workers at spawn and ``worker_kill``
ticks here once per pool step.

Protocol (pipe messages, parent → child):
    ("reset", seed)      → child replies flat obs [obs_dim]
    ("step", action)     → child replies (next_obs, reward, terminated,
                           truncated, obs_after_autoreset, is_success)
    ("step_goal", action)→ same plus the pre/post-step goal views
                           (observation, achieved_goal, desired_goal) for
                           HER relabeling — goal-dict envs only
    ("close",)           → child exits
``next_obs`` is the true successor state (what replay must store);
``obs_after_autoreset`` is what the policy sees next (== next_obs unless the
episode ended, in which case the child has already reset).
"""

from __future__ import annotations

import multiprocessing as mp
import random
import time
from collections import deque
from multiprocessing.connection import wait as _conn_wait
from typing import Optional

import numpy as np

from d4pg_tpu_torch.analysis.ledger import NULL_LEDGER
from d4pg_tpu_torch.utils.retry import Backoff

# Per-worker supervision states.
_ACTIVE = "active"            # in the batch: sent actions, owes replies
_PENDING_RESET = "pending"    # respawned, waiting for its reset obs
_REJOINING = "rejoining"      # reset obs arrived; enters the batch NEXT step
_BACKOFF = "backoff"          # dead; respawn scheduled at _restart_at
_QUARANTINED = "quarantined"  # K consecutive failures: permanently masked


def _worker(
    conn,
    env_id: str,
    max_episode_steps: Optional[int],
    base_seed: int,
    action_repeat: int = 1,
    chaos_steps: tuple = (),
):
    # Child-process entry: owns exactly one host env. Import here so the
    # parent's module import stays light; make_host_env is the shared
    # torch-free dispatcher (gymnasium ids, dm_control prefixes,
    # pixel_pendulum_host) — the pool is never built for torch envs.
    from d4pg_tpu_torch.envs.gym_adapter import make_host_env

    env = make_host_env(env_id, max_episode_steps, action_repeat=action_repeat)
    episode = 0
    steps = 0
    # Orphan detection: if the parent dies (kill -9, OOM) this child must
    # exit instead of blocking in conn.recv() forever and leaking the env.
    parent = mp.parent_process()

    def goal_view():
        g = env.last_goal_obs
        return (
            np.ravel(g["observation"]).astype(np.float32),
            np.ravel(g["achieved_goal"]).astype(np.float32),
            np.ravel(g["desired_goal"]).astype(np.float32),
        )

    try:
        while True:
            # Deadline-bounded wait instead of a bare recv: wake once a
            # second to check the parent is still alive.
            if not conn.poll(1.0):
                if parent is not None and not parent.is_alive():
                    break  # orphaned: exit, closing the env, not leaking it
                continue
            try:
                msg = conn.recv()
            except EOFError:
                break  # parent closed the pipe (supervisor kill/close race)
            cmd = msg[0]
            if cmd == "reset":
                seed = msg[1] if msg[1] is not None else base_seed + episode
                episode += 1
                conn.send(env.reset(seed=seed))
            elif cmd in ("step", "step_goal"):
                steps += 1
                # Chaos faults scheduled for THIS worker (plain tuples from
                # ChaosPlan.worker_entries), counted in its own steps:
                # env_raise proves crash recovery, env_hang the parent's
                # step deadline.
                for site, at, arg in chaos_steps:
                    if at == steps:
                        if site == "env_raise":
                            raise RuntimeError(f"[chaos] env_raise at worker step {steps}")
                        if site == "env_hang":
                            time.sleep(arg if arg is not None else 3600.0)
                with_goals = cmd == "step_goal"
                g0 = goal_view() if with_goals else None
                obs2, r, term, trunc, info = env.step(msg[1])
                g1 = goal_view() if with_goals else None  # before any autoreset
                # tri-state: None = env doesn't report is_success (callers
                # fall back to terminal termination, reference main.py:327)
                success = (
                    bool(info["is_success"])
                    if isinstance(info, dict) and "is_success" in info
                    else None
                )
                if term or trunc:
                    episode += 1
                    obs_next = env.reset(seed=base_seed + episode)
                else:
                    obs_next = obs2
                if with_goals:
                    conn.send((obs2, r, term, trunc, obs_next, success, g0, g1))
                else:
                    conn.send((obs2, r, term, trunc, obs_next, success))
            elif cmd == "close":
                break
    finally:
        env.close()
        conn.close()


def _probe(conn) -> None:
    # A probe child: import what a worker imports, then report the heavy
    # modules loaded and the resident set size.
    import sys

    from d4pg_tpu_torch.envs import gym_adapter  # noqa: F401  (the worker's import)

    heavy = sorted(m for m in sys.modules
                   if m.split(".")[0] in ("torch", "jax") or m.startswith("d4pg_tpu_torch.envs."))
    rss_kb = 0
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                rss_kb = int(line.split()[1])
    conn.send((heavy, rss_kb))
    conn.close()


TRAIN_MAIN_PROBE = (
    # a parent whose __main__ is d4pg_tpu_torch.train, as under
    # ``python -m d4pg_tpu_torch.train``: a spawned child re-imports it as
    # __mp_main__ before it runs the worker
    "import importlib, json, sys\n"
    "sys.modules['__main__'] = importlib.import_module('d4pg_tpu_torch.train')\n"
    "from d4pg_tpu_torch.runtime.actor_pool import probe_child\n"
    "print(json.dumps(probe_child('spawn')))\n"
)


def probe_child(start_method: str = "spawn", timeout_s: float = 120.0) -> dict:
    """Start one child the way the pool starts a worker (same start method,
    same module) and report ``start_s`` (from ``Process.start`` to its
    reply, interpreter start and imports included), ``modules`` (every
    ``torch*``/``jax*`` module and every ``d4pg_tpu_torch.envs.*`` module but
    the adapter it has loaded: empty for a lean worker) and ``rss_mb``."""
    ctx = mp.get_context(start_method)
    parent, child = ctx.Pipe()
    t0 = time.monotonic()
    p = ctx.Process(target=_probe, args=(child,), daemon=True, name="pool-probe")
    p.start()
    child.close()
    try:
        if not parent.poll(timeout_s):
            raise RuntimeError(f"probe child did not answer within {timeout_s:.0f} s")
        heavy, rss_kb = parent.recv()
        start_s = time.monotonic() - t0
    finally:
        parent.close()
        p.join(timeout=10)
        if p.is_alive():
            p.kill()
    modules = [m for m in heavy if m != "d4pg_tpu_torch.envs.gym_adapter"]
    return {"start_method": start_method, "start_s": start_s, "modules": modules,
            "rss_mb": rss_kb / 1024}


class HostActorPool:
    """N parallel host envs behind a synchronized, supervised batch-step
    interface. See the module docstring for the failure semantics."""

    def __init__(
        self,
        env_id: str,
        num_actors: int,
        max_episode_steps: Optional[int] = None,
        seed: int = 0,
        start_method: str = "spawn",
        action_repeat: int = 1,
        step_timeout_s: float = 60.0,
        max_worker_failures: int = 3,
        ledger=None,
        chaos=None,
    ):
        assert num_actors >= 1
        self.num_actors = num_actors
        self.env_id = env_id
        self.max_episode_steps = max_episode_steps
        self.seed = seed
        self.action_repeat = action_repeat
        self.step_timeout_s = step_timeout_s
        # Env construction (dm_control especially) can dwarf a step; give
        # restarts their own, more generous deadline.
        self.restart_timeout_s = max(step_timeout_s, 30.0)
        self.max_worker_failures = max_worker_failures
        self._ctx = mp.get_context(start_method)
        self._chaos = chaos  # ChaosInjector or None
        if chaos is not None:
            chaos.plan = chaos.plan.resolve_actors(num_actors)
            # re-key the injector's site tables on the resolved plan
            chaos.__post_init__()
        self._conns: list = [None] * num_actors
        self._procs: list = [None] * num_actors
        self._state = [_ACTIVE] * num_actors
        self._failures = [0] * num_actors
        self._restart_at = [0.0] * num_actors
        self._restart_count = [0] * num_actors
        self._reset_deadline = [0.0] * num_actors
        # Seeded per-worker backoff: jitter decorrelates mass restarts but
        # stays deterministic under a fixed pool seed (the chaos contract).
        self._backoffs = [
            Backoff(
                base_s=0.05,
                factor=2.0,
                max_s=5.0,
                max_attempts=max(max_worker_failures, 1),
                rng=random.Random(seed ^ (0x9E3779B9 * (i + 1))),
            )
            for i in range(num_actors)
        ]
        for i in range(num_actors):
            self._spawn(i, fresh=True)
        self._closed = False
        # Supervision surface the caller reads after each step()/step_goal():
        # stepped_mask[i] ⇔ row i is a REAL env transition this call (valid
        # until the next step call — consume immediately); take_dropped()
        # drains the actors whose in-flight n-step windows must be dropped
        # whole (their episode tore mid-window).
        self._stepped = np.ones(num_actors, bool)
        self._dropped: list = []
        # Observability: events read by the trainer/tests (deque with a
        # bound so an unobserved pool can't grow it; appends from the
        # stepping thread are atomic).
        self.events: deque = deque(maxlen=256)
        self.failures_total = 0
        self.restarts_total = 0
        # Per-actor last policy obs: fills masked rows so the caller's next
        # batched act call sees stable, self-consistent inputs, and carries
        # a restarted worker's reset obs into the batch before its first
        # real step (the rejoin handshake). Allocated at reset_all.
        self._fallback_obs = None
        self._obs_dim: Optional[int] = None
        self._replies: list = [None] * num_actors
        # Zero-alloc reply staging: the stacked per-step output arrays are
        # preallocated once (dims from the first step's replies) and
        # DOUBLE-buffered — callers retain pol_obs across exactly one step
        # (act on it, then step again), so alternating two buffer sets
        # keeps the retained arrays stable with no np.stack allocation per
        # pool step. Retention beyond one step would need a copy.
        self._reply_slots = None
        self._reply_next = 0
        # Staging ledger (debug_guards): each handed-out reply slot is held
        # for the one step the caller retains it. The caller's last read of
        # step n's slot is step n+1's writer call (it inserts the
        # observations it acted on, step n's pol_obs, after step n+1's
        # replies landed), so the hold from two steps ago, whose slot this
        # step rewrites, is released at entry: the caller handing over new
        # actions has finished with it. Single-buffering the replies trips
        # the ledger at the overwrite. NULL_LEDGER when guards are off.
        self._ledger = ledger if ledger is not None else NULL_LEDGER
        self._reply_holds: deque = deque()

    # --------------------------------------------------------- worker spawn
    def _worker_seed(self, i: int) -> int:
        # Disjoint per-actor seed streams (akin to the reference seeding
        # each worker's env independently at fork); restarts shift the
        # stream so the fresh env doesn't replay the crashed episode.
        return (
            self.seed
            + 1_000_003 * (i + 1)
            + 7_919 * self._restart_count[i]
        )

    def _spawn(self, i: int, fresh: bool) -> None:
        parent, child = self._ctx.Pipe()
        # Chaos env faults ship only with the ORIGINAL spawn: a restarted
        # worker's step counter restarts at 0 and must not re-fire the
        # same entry forever.
        chaos_steps = ()
        if fresh and self._chaos is not None:
            chaos_steps = self._chaos.plan.worker_entries(i)
        p = self._ctx.Process(
            target=_worker,
            args=(
                child,
                self.env_id,
                self.max_episode_steps,
                self._worker_seed(i),
                self.action_repeat,
                chaos_steps,
            ),
            daemon=True,
            name=f"pool-worker-{i}",
        )
        p.start()
        child.close()
        self._conns[i] = parent
        self._procs[i] = p

    # --------------------------------------------------------- supervision
    def _emit(self, kind: str, worker: int, detail: str) -> None:
        self.events.append({"event": kind, "worker": worker, "detail": detail})
        print(f"[pool] {kind}: worker {worker} ({detail})", flush=True)

    def _fail_worker(self, i: int, reason: str) -> None:
        """Kill + deregister a misbehaving worker and schedule its restart
        (or quarantine it after max_worker_failures consecutive failures).
        The actor's in-flight n-step window is torn — queue it for
        take_dropped so no torn transition reaches replay."""
        self.failures_total += 1
        self._failures[i] += 1
        p = self._procs[i]
        if p is not None:
            try:
                p.kill()  # SIGKILL: a hung env ignores terminate()
                p.join(timeout=5)
            except (OSError, ValueError):
                pass  # already reaped / interpreter teardown
        c = self._conns[i]
        if c is not None:
            try:
                c.close()
            except OSError:
                pass
        self._procs[i] = None
        self._conns[i] = None
        self._dropped.append(i)
        delay = (
            None
            if self._failures[i] >= self.max_worker_failures
            else self._backoffs[i].next_delay()
        )
        if delay is None:
            self._state[i] = _QUARANTINED
            self._emit(
                "worker_quarantine", i,
                f"{self._failures[i]} consecutive failures; last: {reason}",
            )
        else:
            self._state[i] = _BACKOFF
            self._restart_at[i] = time.monotonic() + delay
            self._emit(
                "worker_failed", i,
                f"{reason}; restart in {delay * 1e3:.0f} ms "
                f"(failure {self._failures[i]}/{self.max_worker_failures})",
            )

    def _maintain(self) -> None:
        """Once per pool step: fire scheduled chaos kills, respawn workers
        whose backoff expired, and harvest restart reset handshakes."""
        if self._chaos is not None:
            e = self._chaos.tick("worker_kill")
            if e is not None:
                p = self._procs[e.actor]
                if p is not None and p.is_alive():
                    p.kill()  # detection and restart are the supervisor's job
        now = time.monotonic()
        for i in range(self.num_actors):
            st = self._state[i]
            if st == _BACKOFF and now >= self._restart_at[i]:
                self._restart_count[i] += 1
                self.restarts_total += 1
                self._spawn(i, fresh=False)
                try:
                    self._conns[i].send(("reset", None))
                except OSError:
                    self._fail_worker(i, "restart send failed")
                    continue
                self._state[i] = _PENDING_RESET
                self._reset_deadline[i] = now + self.restart_timeout_s
                self._emit(
                    "worker_restart", i, f"respawn #{self._restart_count[i]}"
                )
            elif st == _PENDING_RESET:
                conn, proc = self._conns[i], self._procs[i]
                try:
                    ready = conn.poll(0)
                except OSError:
                    ready = False
                if ready:
                    try:
                        obs = conn.recv()
                    except (EOFError, OSError):
                        self._fail_worker(i, "restart reset EOF")
                        continue
                    if self._fallback_obs is not None:
                        self._fallback_obs[i] = np.ravel(obs)[: self._obs_dim]
                    # One step as REJOINING: the caller must first SEE the
                    # reset obs (via this step's pol_obs row) before its
                    # next actions include a valid one for this actor —
                    # stepping it immediately would apply an action
                    # computed from the pre-crash observation.
                    self._state[i] = _REJOINING
                elif proc is not None and not proc.is_alive():
                    self._fail_worker(i, "died during restart reset")
                elif now >= self._reset_deadline[i]:
                    self._fail_worker(i, "restart reset timed out")

    def num_quarantined(self) -> int:
        return sum(1 for s in self._state if s == _QUARANTINED)

    def take_dropped(self) -> list:
        """Actors that failed since the last call: their in-flight n-step
        windows are torn mid-episode and must be dropped WHOLE (the caller
        resets the matching writer) so no torn transition reaches replay."""
        out, self._dropped = self._dropped, []
        return out

    @property
    def stepped_mask(self) -> np.ndarray:
        """Bool [N]: which rows of the last step()/step_goal() are real env
        transitions (ingest these; skip the rest). Valid until the next
        step call — the array is reused."""
        return self._stepped

    @property
    def pids(self) -> list:
        """Each worker's process id (None for a slot with no process)."""
        return [None if p is None else p.pid for p in self._procs]

    # ------------------------------------------------------------- stepping
    def reset_all(self, seed: Optional[int] = None) -> np.ndarray:
        """Reset every env; returns stacked obs [N, obs_dim]. Deadline-
        bounded like stepping, but construction-time failure here is a
        configuration error, not steady-state — it raises."""
        for i, c in enumerate(self._conns):
            if self._state[i] == _ACTIVE:
                c.send(("reset", None if seed is None else seed + i))
        deadline = time.monotonic() + self.restart_timeout_s
        rows = []
        for i, c in enumerate(self._conns):
            if self._state[i] != _ACTIVE:
                rows.append(self._fallback_obs[i])
                continue
            if not c.poll(max(0.0, deadline - time.monotonic())):
                raise RuntimeError(
                    f"pool worker {i} did not answer reset within "
                    f"{self.restart_timeout_s:.0f} s"
                )
            rows.append(np.ravel(c.recv()))
        out = np.stack(rows).astype(np.float32)
        # Fallback staging: masked rows of later steps read these; a
        # restarted worker's reset obs lands here during its rejoin.
        self._fallback_obs = out.copy()
        self._obs_dim = out.shape[1]
        return out

    def step(self, actions: np.ndarray):
        """Step all envs with canonical (−1,1) actions [N, act_dim].

        Returns ``(next_obs, rewards, terminated, truncated, policy_obs,
        success, success_reported)`` — all stacked over the actor axis.
        ``next_obs`` is the transition's successor (store this);
        ``policy_obs`` already reflects any auto-reset (act on this);
        ``success`` is only meaningful where ``success_reported`` (the env
        actually emitted ``is_success``) is True. Rows where
        :attr:`stepped_mask` is False did NOT step (worker down/rejoining/
        quarantined): their values are the fallback obs with zero reward —
        do not ingest them.
        """
        return self._step_cmd(actions, "step")

    def step_goal(self, actions: np.ndarray):
        """Like :meth:`step`, but additionally returns each actor's pre- and
        post-step goal views ``(observation, achieved_goal, desired_goal)``
        for HER relabeling. Goal-dict envs only.

        Returns ``(next_obs, rewards, terminated, truncated, policy_obs,
        success, success_reported, goals_prev, goals_next)`` where the goal
        lists hold per-actor triples of flat float32 arrays (``None`` for
        rows the :attr:`stepped_mask` excludes).
        """
        return self._step_cmd(actions, "step_goal")

    def _reply_slot(self, obs_dim: int):
        if self._reply_slots is None:
            N = self.num_actors

            def mk():
                return (
                    np.empty((N, obs_dim), np.float32),  # obs2
                    np.empty(N, np.float32),             # rewards
                    np.empty(N, bool),                   # terminated
                    np.empty(N, bool),                   # truncated
                    np.empty((N, obs_dim), np.float32),  # policy obs
                    np.empty(N, bool),                   # success
                    np.empty(N, bool),                   # success reported
                )

            self._reply_slots = (mk(), mk())
        pos = self._reply_next
        self._ledger.write("pool.reply", pos)
        slot = self._reply_slots[pos]
        self._reply_next ^= 1
        return slot, pos

    def _recv_replies(self) -> None:
        """Deadline-bounded gather of this step's replies from every ACTIVE
        worker into ``self._replies``. A worker that misses the monotonic
        deadline (env hang) or whose process died (crash/SIGKILL) fails —
        the batch shrinks via the stepped mask instead of the old behavior
        (parent wedged forever in ``conn.recv``)."""
        pending = {}
        for i in range(self.num_actors):
            self._replies[i] = None
            if self._state[i] == _ACTIVE and self._conns[i] is not None:
                pending[self._conns[i]] = i
        deadline = time.monotonic() + self.step_timeout_s
        while pending:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                for conn, i in list(pending.items()):
                    self._fail_worker(i, f"step timeout {self.step_timeout_s:.1f} s")
                return
            # Bounded multiplexed wait; a dead worker's pipe reports ready
            # (EOF) so crashes surface immediately, not at the deadline.
            ready = _conn_wait(list(pending), timeout=min(remaining, 1.0))
            if not ready:
                for conn, i in list(pending.items()):
                    p = self._procs[i]
                    if p is None or not p.is_alive():
                        del pending[conn]
                        self._fail_worker(i, "process died mid-step")
                continue
            for conn in ready:
                i = pending.pop(conn)
                try:
                    self._replies[i] = conn.recv()
                except (EOFError, OSError):
                    self._fail_worker(i, "pipe EOF mid-step (worker crashed)")

    def _step_cmd(self, actions: np.ndarray, cmd: str):
        with_goals = cmd == "step_goal"
        actions = np.asarray(actions)
        self._maintain()
        if all(s == _QUARANTINED for s in self._state):
            raise RuntimeError(
                f"all {self.num_actors} pool workers quarantined "
                f"(>= {self.max_worker_failures} consecutive failures each); "
                "collection cannot make progress"
            )
        # New actions mean the caller is done with the slot of two steps
        # ago: release its hold before _reply_slot rewrites it.
        while len(self._reply_holds) >= 2:
            self._reply_holds.popleft().release()
        for i in range(self.num_actors):
            if self._state[i] != _ACTIVE:
                continue
            try:
                self._conns[i].send((cmd, actions[i]))
            except (BrokenPipeError, OSError):
                self._fail_worker(i, "pipe broken at send")
        self._recv_replies()
        (obs2, rews, terms, truncs, pol_obs, succ, succ_rep), slot_pos = (
            self._reply_slot(self._obs_dim))
        g_prev: list = [None] * self.num_actors if with_goals else []
        g_next: list = [None] * self.num_actors if with_goals else []
        stepped = self._stepped
        for i in range(self.num_actors):
            reply = self._replies[i]
            if reply is None:
                # Masked row: stable fallback values so the caller's next
                # batched act stays numerically sane; stepped_mask tells it
                # to ignore this transition. A REJOINING worker's fallback
                # row is its fresh reset obs — next step it goes active.
                stepped[i] = False
                obs2[i] = self._fallback_obs[i]
                rews[i] = 0.0
                terms[i] = False
                truncs[i] = False
                pol_obs[i] = self._fallback_obs[i]
                succ[i] = False
                succ_rep[i] = False
                continue
            stepped[i] = True
            o2, r, te, tr, on, s = reply[:6]
            obs2[i] = o2
            rews[i] = r
            terms[i] = te
            truncs[i] = tr
            pol_obs[i] = on
            succ[i] = bool(s) if s is not None else False
            succ_rep[i] = s is not None
            # A successful full step proves the worker healthy again:
            # quarantine counts CONSECUTIVE failures.
            if self._failures[i]:
                self._failures[i] = 0
                self._backoffs[i].reset()
            if with_goals:
                g_prev[i] = reply[6]
                g_next[i] = reply[7]
        # Fallback staging tracks the latest policy obs for every actor so
        # masked rows stay self-consistent (vectorized copy, no alloc).
        self._fallback_obs[:] = pol_obs
        for i in range(self.num_actors):
            if self._state[i] == _REJOINING:
                # The caller has now seen this actor's reset obs (pol_obs
                # row above); its next actions include a valid one for it.
                self._state[i] = _ACTIVE
        out = (obs2, rews, terms, truncs, pol_obs, succ, succ_rep)
        self._reply_holds.append(self._ledger.hold("pool.reply", slot_pos, holder=cmd))
        return out + (g_prev, g_next) if with_goals else out

    # -------------------------------------------------------------- teardown
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        # Nothing reads the reply slots once the pool is down: release the
        # (up to two) holds in flight, so a guarded run ends with none.
        while self._reply_holds:
            self._reply_holds.popleft().release()
        for c in self._conns:
            if c is None:
                continue
            try:
                c.send(("close",))
            except (BrokenPipeError, OSError):
                pass
        for p in self._procs:
            if p is None:
                continue
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
        for c in self._conns:
            if c is None:
                continue
            try:
                c.close()
            except OSError:
                pass

    def __del__(self):  # best-effort cleanup
        try:
            self.close()
        except Exception:  # interpreter teardown: pipes/children may
            # already be gone and __del__ must never raise; close() is the
            # loud path for live callers
            pass
