"""Deterministic chaos harness: seeded fault plans injected at named sites
(the port's copy of ``d4pg_tpu/chaos.py``: the same grammar, the same
sites, the same injector, so a spec parses here exactly as it parses in
the JAX package).

D4PG's decomposition (acting, replay, learning and serving as separate
processes and threads) means each piece fails independently in
production, and nothing proves recovery except injecting the failures.
This module is the injection half: a **fault plan** is a seeded, fully
deterministic schedule of faults at named *sites*, parsed from a compact
spec string (``--chaos`` on ``python -m d4pg_tpu_torch.train`` and
``python -m d4pg_tpu_torch.serve``) so the exact same faults replay run
after run.

Where the port ticks them (the JAX package's sites):

- ``env_raise`` / ``env_hang``: inside a host actor pool worker, per env
  step of that worker (``runtime/actor_pool.py:_worker``);
- ``worker_kill``: the pool parent, per pool step (``_maintain``);
- ``wb_stall``: the priority flusher, per wake
  (``runtime/trainer.py:_writeback_loop``);
- ``ckpt_truncate``: the trainer, per checkpoint, after its manifest
  committed (``Trainer._save_checkpoint``);
- ``host_kill``: the trainer, per megastep or hybrid dispatch; with
  several processes the supervisor ``tools/multihost_smoke.py`` reaps the
  survivors and relaunches every process with ``--resume``;
- ``sock_reset``: the policy server, per received frame;
- ``slowloris`` / ``zero_window`` / ``fd_exhaust``: the policy server and
  the router, per accepted connection (``netio/attack.py``);
- ``replica_kill`` (per dispatch attempt, SIGKILL of the picked replica
  after the send), ``replica_slow``, ``tenant_flood`` and
  ``policy_skew`` (per request), ``canary_corrupt`` (per canary deploy)
  and ``gate_stall`` (per off-policy gate evaluation): the router
  (``serve/router.py``, ``--chaos`` on ``python -m
  d4pg_tpu_torch.serve.router``);
- ``scaledown_during_canary``: the autoscaler, per control tick
  (``serve/autoscaler.py:Autoscaler.tick``);
- ``partition``: the learner's fleet ingest, per frame of a connection
  (``fleet/ingest.py``);
- ``reconnect_flap`` (per connect), ``slow_link`` and ``pixel_truncate``
  (per frame sent), ``stale_bundle`` and ``stale_stats`` (per bundle
  swap) and ``her_actor_kill`` (per env step): a fleet actor host
  (``fleet/actor.py``, ``--chaos`` on ``python -m
  d4pg_tpu_torch.fleet.actor``);
- ``mirror_drop``: the flywheel's mirror tap, per window its sender
  flushes, before either sink (``flywheel/tap.py:MirrorTap._flush``,
  ``--chaos`` on the serve CLI with ``--mirror-fraction``);
- ``variant_kill`` and ``controller_kill`` (per control tick) and
  ``clone_corrupt`` (per checkpoint fork): the league controller
  (``league/controller.py``, ``--chaos`` on ``python -m
  d4pg_tpu_torch.league``).

The on-device loop has no site, in either package.

Spec syntax (entries separated by ``;`` or ``,``)::

    [seed=<int>;] <site>@<count>[:<arg>][#<actor>] ...

    env_raise@40#1        worker 1's env raises on ITS 40th step
    env_hang@60:30#0      worker 0's env hangs 30 s on its 60th step
    worker_kill@12#1      SIGKILL worker 1 at the pool's 12th step
    ckpt_truncate@2       truncate the 2nd checkpoint after it commits
    wb_stall@3:0.5        stall the priority flusher 0.5 s at wake 3
    sock_reset@5          force-reset the serve conn at its 5th frame
    partition@7           abortive-close the fleet ingest conn, frame 7
    reconnect_flap@2      fleet actor: drop its 2nd connection post-HELLO
    stale_bundle@1        fleet actor: skip its 1st bundle hot-swap
    slow_link@3:250       fleet actor: stall its 3rd frame send 250 ms
    replica_kill@25       router: SIGKILL the replica serving dispatch 25
    replica_slow@9:200    router: stall dispatch 9 for 200 ms
    canary_corrupt@1      router: truncate the params of its 1st canary
                          deploy (replica load fails, healthz degrades)
    tenant_flood@30:bulky router: at its 30th request, inject a synthetic
                          BULK burst from tenant "bulky" through the real
                          admission path (quota + class shed absorb it;
                          interactive p99 must hold)
    policy_skew@40        router: at its 40th request, inject a synthetic
                          burst 95% onto the default policy (cold
                          policies must still meet their deadlines)
    scaledown_during_canary@3  autoscaler: force a scale-down at its 3rd
                          control tick (mid-rollout it must abort or
                          complete cleanly, never strand a half-deployed
                          replica)
    stale_stats@2         fleet actor: at its 2nd bundle hot-swap, adopt
                          the new params but KEEP the old obs-norm stats
                          (windows advertise the stale stats generation;
                          ingest counts + drops them)
    pixel_truncate@4      fleet actor: truncate its 4th frame mid-send
                          and RST (the torn WINDOWS2 frame must die whole
                          server-side, its windows counted dropped)
    her_actor_kill@50     fleet actor: SIGKILL itself on its 50th env
                          step, mid-episode (the buffered HER episode
                          dies with the process; nothing torn ships)
    variant_kill@6        league controller: at its 6th control tick,
                          SIGKILL a live variant learner's whole process
                          group (deterministic victim; supervisor
                          restarts it under --resume + seeded Backoff)
    controller_kill@9     league controller: SIGKILL ITSELF at its 9th
                          control tick (a rerun must resume the SAME
                          generation from league.json and re-adopt the
                          still-live learners)
    clone_corrupt@1       league controller: truncate the newest step of
                          its 1st checkpoint fork after the copy (the
                          clone's verify-on-restore must fall back to
                          the older forked step, never train on torn
                          state)
    host_kill@8:1         multi-host learner: SIGKILL process 1 of the
                          process-spanning mesh at its 8th megastep
                          dispatch (dispatch counts are deterministic
                          and identical across processes, so every
                          process agrees on WHEN; survivors block on
                          the next collective until the supervisor
                          reaps them and relaunches the full mesh with
                          --resume — scripts/multihost_smoke.sh)
    mirror_drop@3         mirror tap: silently lose its 3rd built window
                          on the data path, before BOTH sinks (the
                          explicit windows_dropped_chaos counter must
                          keep the tap's accounting identity exact)
    gate_stall@1:30       router: the off-policy gate worker sleeps 30 s
                          inside its 1st evaluation (the rollout must
                          roll back at the observe deadline, never
                          promote on a missing verdict)
    slowloris@2:4         serve/router: at their 2nd accept, launch a
                          slowloris client trickling a frame header at
                          4 bytes/s (the read-progress deadline evicts)
    zero_window@3:1500    serve/router: at their 3rd accept, launch a
                          client that floods HEALTHZ and never reads for
                          1500 ms (write-progress deadline evicts)
    fd_exhaust@5:150      serve/router: at their 5th accept, hoard fds
                          to EMFILE for 150 ms (accepts shed OVERLOADED
                          fd_exhausted; the accept loop survives)

A ``:<arg>`` that does not parse as a number is kept as a string LABEL
(``tenant_flood``'s tenant name); numeric args stay floats.

``count`` is 1-based and counted *at the site* (a worker counts its own
env steps; the pool counts pool steps; the flusher counts wakes), which
is what makes the plan deterministic regardless of wall-clock timing.
``#actor`` omitted on a worker-targeted site resolves deterministically
from the seed and the entry's count once the pool size is known
(:meth:`ChaosPlan.resolve_actors`).

Deliberately stdlib-only (no numpy, no torch): the plan rides into spawned
actor-pool workers as plain tuples, and the serve CLI builds an injector
before any heavy import.

Site reference (who ticks, who reacts — docs/fault_tolerance.md):

====================  ==========================  =========================
site                  tick location               recovery proven
====================  ==========================  =========================
``env_raise``         pool worker, per env step   supervisor restart
``env_hang``          pool worker, per env step   step deadline + restart
``worker_kill``       pool parent, per pool step  is_alive detect + restart
``ckpt_truncate``     trainer, per checkpoint     verify-on-restore fallback
``wb_stall``          writeback flusher, per wake  hold pacing (guards green)
``sock_reset``        serve conn, per frame       reader survives, drop count
``partition``         ingest conn, per frame      actor Backoff reconnect,
                                                  unacked windows dropped
``reconnect_flap``    fleet actor, per connect    bounded Backoff, no dup
                                                  windows after the flap
``stale_bundle``      fleet actor, per hot-swap   stale-gen windows counted
                                                  + discarded at ingest
``slow_link``         fleet actor, per frame      flow control absorbs the
                                                  stall; read deadline
                                                  tolerates live-but-slow
``replica_kill``      router, per dispatch        in-flight request fails
                                                  over (bounded retry on a
                                                  different replica);
                                                  prober ejects, re-admits
                                                  the restarted process
``replica_slow``      router, per dispatch        p99 accounted; other
                                                  requests unaffected
``canary_corrupt``    router, per canary deploy   replica keeps old params
                                                  (degraded), router
                                                  auto-rolls-back
``tenant_flood``      router, per ACT frame       quota + bulk-first shed
                                                  absorb the burst;
                                                  interactive p99 holds,
                                                  identity exact per
                                                  tenant/class
``policy_skew``       router, per ACT frame       cold policies' batchers
                                                  unaffected; deadlines
                                                  still met
``scaledown_during_canary``  autoscaler, per      rollout aborts/completes
                      control tick                cleanly; removed
                                                  replica's bundle dir
                                                  restored (never
                                                  half-deployed)
``stale_stats``       fleet actor, per hot-swap   windows carry the stale
                                                  stats generation; ingest
                                                  counts + drops them
                                                  (windows_dropped_stale_
                                                  stats), actor recovers
                                                  at the next swap
``pixel_truncate``    fleet actor, per frame      torn frame whole-drops
                                                  server-side (read_frame
                                                  ProtocolError); windows
                                                  counted dropped client-
                                                  side, paced reconnect
``her_actor_kill``    fleet actor, per env step   buffered HER episode
                                                  dies with the process;
                                                  in-flight frames drop
                                                  whole; supervisor
                                                  restart reconnects
``variant_kill``      league controller, per      learner group SIGKILLed;
                      control tick                supervisor restarts it
                                                  under seeded Backoff
                                                  (--resume), quarantines
                                                  a crash-looper
``controller_kill``   league controller, per      controller SIGKILLs
                      control tick                ITSELF mid-generation;
                                                  a rerun resumes the
                                                  SAME generation from
                                                  league.json, re-adopts
                                                  live learners
``clone_corrupt``     league controller, per      newest forked step
                      checkpoint fork             truncated post-copy;
                                                  the clone's verified
                                                  restore falls back to
                                                  the older copied step,
                                                  logged — never trains
                                                  on torn state
``host_kill``         trainer, per megastep       victim process dies
                      dispatch                    mid-mesh; survivors
                                                  reaped by supervisor,
                                                  full-mesh relaunch
                                                  --resumes from the
                                                  last committed
                                                  coordinated checkpoint
``mirror_drop``       mirror tap sender, per      window lost before BOTH
                      built window                sinks; windows_dropped_
                                                  chaos keeps the tap
                                                  identity exact — the
                                                  learner just sees less
                                                  mirrored data, serving
                                                  is untouched
``gate_stall``        router gate worker, per     control thread rolls the
                      gate evaluation             rollout back at the
                                                  observe deadline
                                                  (gate_stalls counter);
                                                  later rollouts gate
                                                  normally — the stalled
                                                  worker's late verdict
                                                  is token-fenced out
``slowloris``         serve/router, per accept    attacker trickles a
                                                  frame header at :arg
                                                  bytes/s; read-progress
                                                  deadline evicts it
                                                  (evicted_read_stall);
                                                  no frame completes, so
                                                  the answered identity
                                                  is untouched
``zero_window``       serve/router, per accept    attacker floods HEALTHZ
                                                  and never reads for
                                                  :arg ms; write-progress
                                                  deadline / buffered-
                                                  bytes watermark evicts
                                                  (evicted_write_stall) —
                                                  no head-of-line block
``fd_exhaust``        serve/router, per accept    fds hoarded to EMFILE
                                                  for :arg ms; accepts
                                                  shed OVERLOADED
                                                  fd_exhausted through
                                                  the reserve fd
                                                  (accept_shed) — the
                                                  accept loop survives
====================  ==========================  =========================
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Optional

from d4pg_tpu_torch.analysis import lockwitness

# Sites whose faults run INSIDE a pool worker process (entries for them
# are shipped to the worker as plain tuples at spawn).
WORKER_SITES = ("env_raise", "env_hang")

KNOWN_SITES = WORKER_SITES + (
    "worker_kill",
    "ckpt_truncate",
    "wb_stall",
    "sock_reset",
    # fleet sites (fleet/): partition ticks in the learner's ingest
    # reader (server-side abortive close mid-stream); the other three
    # tick inside the fleet actor CLI's own injector (--chaos on
    # python -m d4pg_tpu_torch.fleet.actor).
    "partition",
    "reconnect_flap",
    "stale_bundle",
    "slow_link",
    # serving-fleet sites (d4pg_tpu/serve/router.py): all three tick in
    # the ROUTER process (--chaos on python -m d4pg_tpu.serve.router) —
    # replica_kill/replica_slow per dispatched request, canary_corrupt
    # per canary bundle deploy.
    "replica_kill",
    "replica_slow",
    "canary_corrupt",
    # multi-tenant sites: tenant_flood/policy_skew tick in the
    # router per received ACT-class frame and inject a synthetic burst
    # through the REAL admission + dispatch path (identity-accounted);
    # scaledown_during_canary ticks once per autoscaler control tick and
    # forces a scale-down (the rollout-abort proof).
    "tenant_flood",
    "policy_skew",
    "scaledown_during_canary",
    # one-data-plane sites: all three tick inside the fleet
    # actor CLI's injector — stale_stats per bundle hot-swap (adopt new
    # params, KEEP old obs-norm stats → ingest must age the windows out),
    # pixel_truncate per frame send (header promises bytes the body never
    # delivers, then RST — the torn WINDOWS2 frame must whole-drop),
    # her_actor_kill per env step (SIGKILL self mid-episode — the
    # relabeler's buffered episode dies with the process, nothing torn
    # reaches replay).
    "stale_stats",
    "pixel_truncate",
    "her_actor_kill",
    # league sites (d4pg_tpu_torch/league): variant_kill and
    # controller_kill tick once per controller supervision tick —
    # variant_kill SIGKILLs a deterministically-chosen live learner's
    # whole process group (supervisor restart under Backoff proves it),
    # controller_kill SIGKILLs the CONTROLLER itself (the journal-resume
    # proof: a rerun re-adopts learners and resumes the same generation);
    # clone_corrupt ticks per checkpoint fork and truncates the newest
    # forked step AFTER its manifest landed (the clone's
    # verify-on-restore must fall back, never train on torn state).
    "variant_kill",
    "controller_kill",
    "clone_corrupt",
    # multi-host site: ticks in the trainer once per megastep or hybrid
    # dispatch — deterministic and identical on every process of the
    # run — and SIGKILLs the process whose index matches the ``:<arg>``
    # victim (default 0); tools/multihost_smoke.py relaunches the run.
    "host_kill",
    # flywheel sites (d4pg_tpu_torch/flywheel): mirror_drop ticks in
    # the tap's sender once per built window, BEFORE either sink — the
    # window is lost on the data path but windows_dropped_chaos keeps
    # the tap's accounting identity exact (a drop the books can't see is
    # the one bug class the mirror plane must never have). gate_stall
    # ticks inside the router's off-policy gate worker and sleeps
    # ``:<arg>`` seconds (default: past any deadline) — the rollout must
    # roll back at the observe deadline, never promote on a missing
    # verdict or wedge the control loop.
    "mirror_drop",
    "gate_stall",
    # connection-attack sites (d4pg_tpu/netio/attack.py): all
    # three tick in the serve/router front-ends at every ACCEPT and
    # launch a self-targeted attacker driven by the victim's own event
    # loop — slowloris trickles a frame header at ``:<arg>`` bytes/sec
    # (read-progress deadline must evict; no frame ever completes, so
    # the answered identity is untouched by construction), zero_window
    # pipelines HEALTHZ and never reads for ``:<arg>`` ms (write-progress
    # deadline/watermark must evict; HEALTHZ is outside the identity),
    # fd_exhaust hoards descriptors to EMFILE for ``:<arg>`` ms (accepts
    # must shed ``OVERLOADED fd_exhausted`` via the reserve fd, never
    # kill the accept loop).
    "slowloris",
    "zero_window",
    "fd_exhaust",
)

# Sites whose ``:<arg>`` is a string label, not a number (the flood's
# tenant name). Everything else coerces to float as before.
LABEL_ARG_SITES = ("tenant_flood",)


@dataclass(frozen=True)
class ChaosEntry:
    site: str
    at: int                      # 1-based count at the site
    arg: Optional[float] = None  # site-specific (hang/stall seconds)
    actor: Optional[int] = None  # worker index for worker-targeted sites
    label: Optional[str] = None  # string arg (LABEL_ARG_SITES, e.g. tenant)

    def __str__(self) -> str:
        s = f"{self.site}@{self.at}"
        if self.label is not None:
            s += f":{self.label}"
        elif self.arg is not None:
            s += f":{self.arg:g}"
        if self.actor is not None:
            s += f"#{self.actor}"
        return s


@dataclass
class ChaosPlan:
    seed: int = 0
    entries: tuple = ()

    @classmethod
    def parse(cls, spec: str) -> "ChaosPlan":
        """Parse the ``--chaos`` spec string; raises ``ValueError`` with
        the offending token on any malformed entry."""
        seed = 0
        entries = []
        for raw in spec.replace(",", ";").split(";"):
            tok = raw.strip()
            if not tok:
                continue
            if tok.startswith("seed="):
                seed = int(tok[len("seed="):])
                continue
            try:
                head, _, actor_s = tok.partition("#")
                site, _, at_s = head.partition("@")
                at_s, _, arg_s = at_s.partition(":")
                if site not in KNOWN_SITES:
                    raise ValueError(
                        f"unknown site {site!r} (known: {', '.join(KNOWN_SITES)})"
                    )
                entry = ChaosEntry(
                    site=site,
                    at=int(at_s),
                    arg=(
                        float(arg_s)
                        if arg_s and site not in LABEL_ARG_SITES
                        else None
                    ),
                    actor=int(actor_s) if actor_s else None,
                    label=(
                        arg_s
                        if arg_s and site in LABEL_ARG_SITES
                        else None
                    ),
                )
            except ValueError as e:
                raise ValueError(f"bad chaos entry {tok!r}: {e}") from e
            if entry.at < 1:
                raise ValueError(f"bad chaos entry {tok!r}: count is 1-based")
            if any(
                e.site == entry.site and e.at == entry.at for e in entries
            ):
                # The injector keys on (site, count); a duplicate would
                # silently shadow one planned fault — refuse instead of
                # quietly weakening the plan.
                raise ValueError(
                    f"duplicate chaos entry {entry.site}@{entry.at}: only "
                    "one fault per (site, count) — use a different count"
                )
            entries.append(entry)
        return cls(seed=seed, entries=tuple(entries))

    def resolve_actors(self, num_actors: int) -> "ChaosPlan":
        """Pin every worker-targeted entry to a concrete worker index.
        Entries without an explicit ``#actor`` resolve deterministically
        from (seed, count) — no RNG state, so resolution is stable however
        many times it runs."""
        resolved = []
        for e in self.entries:
            if e.site in WORKER_SITES + ("worker_kill",) and e.actor is None:
                e = ChaosEntry(e.site, e.at, e.arg,
                               (self.seed + e.at) % num_actors, e.label)
            elif e.actor is not None and e.actor >= num_actors:
                raise ValueError(
                    f"chaos entry {e} targets actor {e.actor} but the pool "
                    f"has {num_actors}"
                )
            resolved.append(e)
        return ChaosPlan(seed=self.seed, entries=tuple(resolved))

    def worker_entries(self, actor: int) -> tuple:
        """The (site, at, arg) triples worker ``actor`` enforces itself —
        plain tuples so they cross the spawn boundary without importing
        this module in the child."""
        return tuple(
            (e.site, e.at, e.arg)
            for e in self.entries
            if e.site in WORKER_SITES and e.actor == actor
        )


@dataclass
class ChaosInjector:
    """Per-site counters over a :class:`ChaosPlan`; thread-safe.

    Each call to :meth:`tick` advances the named site's counter and
    returns the entry scheduled for that count (or ``None``). An entry
    fires exactly once. Fired entries accumulate in :attr:`fired` for
    observability (metrics rows, serve healthz).
    """

    plan: ChaosPlan
    fired: list = field(default_factory=list)

    def __post_init__(self):
        self._lock = lockwitness.named_lock("ChaosInjector._lock")
        self._counts: dict = {}
        self._by_site: dict = {}
        for e in self.plan.entries:
            self._by_site.setdefault(e.site, {})[e.at] = e

    def tick(self, site: str) -> Optional[ChaosEntry]:
        with self._lock:
            n = self._counts.get(site, 0) + 1
            self._counts[site] = n
            e = self._by_site.get(site, {}).pop(n, None)
            if e is not None:
                self.fired.append(e)
                print(f"[chaos] inject {e} (site count {n})", flush=True)
            return e

    @property
    def injections_total(self) -> int:
        with self._lock:
            return len(self.fired)

    def summary(self) -> dict:
        with self._lock:
            return {
                "chaos_injections": len(self.fired),
                "chaos_pending": sum(len(v) for v in self._by_site.values()),
            }


def truncate_checkpoint_step(step_dir: str) -> Optional[str]:
    """The ``ckpt_truncate`` fault: cut the largest file under a
    checkpoint step directory to half its size, whatever the directory
    holds (the port's steps hold ``state.pt``; deterministic victim
    choice, ties broken by path sort). Returns the truncated path, or
    ``None`` when the directory holds no non-empty file."""
    victim, vsize = None, -1
    for dirpath, _dirnames, filenames in os.walk(step_dir):
        for fn in sorted(filenames):
            p = os.path.join(dirpath, fn)
            try:
                size = os.path.getsize(p)
            except OSError:
                continue
            if size > vsize:
                victim, vsize = p, size
    if victim is None or vsize <= 0:
        return None
    with open(victim, "rb+") as f:
        f.truncate(vsize // 2)
    print(
        f"[chaos] truncated {victim} {vsize} -> {vsize // 2} bytes", flush=True
    )
    return victim
