"""Healthz-driven autoscaler: a control loop that spawns and DRAINS
capacity against the gauges the fleet already exports (the port's copy of
``d4pg_tpu/serve/autoscaler.py``: the same control rules, spawning the
port's CLIs).

Without it capacity is a hand-picked constant: M replicas chosen at
router startup, N actor hosts chosen at fleet launch. This module is the
control dimension: one generic hysteresis/cooldown loop
(:class:`Autoscaler`) over a normalized :class:`ScaleSignal`, with two
signal adapters and two pools:

- **Serving** — :class:`ServingSignalSource` reads the ROUTER's healthz
  (inflight vs the capacity model, interactive p99 vs its SLO, shed
  rate); :class:`RouterReplicaPool` scales by spawning
  ``python -m d4pg_tpu_torch.serve`` subprocesses (via
  :mod:`d4pg_tpu_torch.utils.spawnlib`, the shared CLI harness; they run
  on the card unless the pool's ``replica_args`` carry ``--device cpu``),
  registering them with
  :meth:`~d4pg_tpu_torch.serve.router.Router.add_backend`, and scaling DOWN by
  SIGTERM — the graceful-drain contract: the replica answers everything
  admitted and exits 0; only after the process exits is it
  ``remove_backend``-ed. Never SIGKILL on the happy path.

- **Training** — :class:`IngestSignalSource` reads the fleet-ingest
  counters (the learner paces against ingested windows: a starved ingest
  means too FEW actor hosts; sustained queue-full shedding means too
  many); :class:`ActorHostPool` spawns/drains
  ``python -m d4pg_tpu_torch.fleet.actor`` hosts — the same loop shape driving
  collection capacity against backpressure.

Control discipline:

- **never scale on one sample** — a decision needs ``samples``
  CONSECUTIVE breaching ticks; one GC pause or probe blip must not move
  the fleet;
- **hysteresis** — the scale-up threshold (``up_load``) sits well above
  the scale-down threshold (``down_load``); between them the loop holds,
  so load hovering at one threshold cannot flap capacity;
- **cooldown** — after ANY action the loop holds ``cooldown_s``: new
  capacity needs warmup + admission (K healthy probes) before its effect
  is measurable, and reacting to the pre-action gauges again would
  over-shoot;
- **drain, don't kill** — scale-down reuses the SIGTERM graceful-drain
  contract end to end.

Chaos: the ``scaledown_during_canary`` site ticks once per control tick
and forces a scale-down regardless of the gauges — the soak drives it
mid-rollout to prove the router's rollout machinery aborts or completes
cleanly (never a stranded half-deployed replica).

This is a HOST-ONLY module: it moves signals and processes, never
tensors — it must restart in milliseconds and run beside a torch-free
router.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from d4pg_tpu_torch.analysis import lockwitness
from d4pg_tpu_torch.utils import procs


@dataclass
class ScaleSignal:
    """One normalized control sample.

    ``load`` is utilization against CURRENT capacity: > ``up_load`` means
    underprovisioned, < ``down_load`` overprovisioned (the adapters map
    their domain gauges onto this axis). ``p99_ms``/``shed_rate`` are
    breach accelerants: an SLO violation or sustained shedding counts as
    an up-breach even at moderate load."""

    load: float
    p99_ms: Optional[float] = None
    shed_rate: float = 0.0
    replicas: int = 0


class Autoscaler:
    """The generic control loop. ``signal_fn() -> ScaleSignal`` samples
    the gauges; ``scale_up()`` / ``scale_down()`` are the pool's
    actuators (return True when they acted). ``close()`` joins the
    control thread (bounded)."""

    def __init__(
        self,
        signal_fn: Callable[[], ScaleSignal],
        scale_up: Callable[[], bool],
        scale_down: Callable[[], bool],
        *,
        min_replicas: int = 1,
        max_replicas: int = 4,
        interval_s: float = 2.0,
        up_load: float = 0.8,
        down_load: float = 0.3,
        p99_slo_ms: Optional[float] = None,
        shed_threshold: float = 0.05,
        samples: int = 3,
        cooldown_s: float = 30.0,
        chaos=None,
        on_event: Optional[Callable[..., None]] = None,
    ):
        if not (0.0 <= down_load < up_load):
            raise ValueError(
                f"need 0 <= down_load < up_load for hysteresis, got "
                f"down={down_load} up={up_load}"
            )
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{min_replicas}..{max_replicas}"
            )
        self._signal_fn = signal_fn
        self._scale_up = scale_up
        self._scale_down = scale_down
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self._interval_s = float(interval_s)
        self._up_load = float(up_load)
        self._down_load = float(down_load)
        self._p99_slo_ms = p99_slo_ms
        self._shed_threshold = float(shed_threshold)
        self._samples = int(samples)
        self._cooldown_s = float(cooldown_s)
        self._chaos = chaos
        self._on_event = on_event

        self._lock = lockwitness.named_lock("Autoscaler._lock")
        self._up_streak = 0
        self._down_streak = 0
        self._last_action_t: Optional[float] = None
        self.ticks = 0
        self.scale_ups = 0
        self.scale_downs = 0
        self.signal_errors = 0
        self.last_signal: Optional[ScaleSignal] = None

        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- lifecycle
    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("autoscaler already started")
        self._thread = threading.Thread(
            target=self._control_loop, name="autoscaler-control", daemon=True
        )
        self._thread.start()

    def close(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    def _event(self, kind: str, **fields) -> None:
        if self._on_event is not None:
            self._on_event(kind, **fields)
        else:
            import json

            print(f"[autoscaler] {json.dumps({'event': kind, **fields})}",
                  flush=True)

    # --------------------------------------------------------------- control
    def _control_loop(self) -> None:
        while not self._stop.wait(self._interval_s):
            try:
                self.tick()
            except Exception as e:
                # logged via _event (router event log or stdout): the
                # control loop must outlive probe and pool errors
                self._event("autoscaler_error", error=repr(e))

    def tick(self) -> Optional[str]:
        """One control step (public so tests drive it without the timer).
        Returns "up"/"down" when an action fired, else None."""
        with self._lock:
            self.ticks += 1
        if self._chaos is not None:
            e = self._chaos.tick("scaledown_during_canary")
            if e is not None:
                # forced scale-down (the chaos proof): bypasses streak +
                # cooldown but NEVER the floor — a chaos plan must not be
                # able to scale the fleet to zero
                sig = self._sample()
                if sig is not None and sig.replicas > self.min_replicas:
                    self._act("down", sig, forced=True)
                    return "down"
                self._event("scaledown_skipped_at_floor",
                            replicas=None if sig is None else sig.replicas)
                return None
        sig = self._sample()
        if sig is None:
            return None
        up_breach = sig.load > self._up_load or (
            self._p99_slo_ms is not None
            and sig.p99_ms is not None
            and sig.p99_ms > self._p99_slo_ms
        ) or sig.shed_rate > self._shed_threshold
        down_breach = not up_breach and sig.load < self._down_load and (
            self._p99_slo_ms is None
            or sig.p99_ms is None
            or sig.p99_ms <= self._p99_slo_ms
        )
        with self._lock:
            self._up_streak = self._up_streak + 1 if up_breach else 0
            self._down_streak = self._down_streak + 1 if down_breach else 0
            up_ready = self._up_streak >= self._samples
            down_ready = self._down_streak >= self._samples
            in_cooldown = (
                self._last_action_t is not None
                and time.monotonic() - self._last_action_t < self._cooldown_s
            )
        if in_cooldown:
            return None
        if up_ready and sig.replicas < self.max_replicas:
            return self._act("up", sig)
        if down_ready and sig.replicas > self.min_replicas:
            return self._act("down", sig)
        return None

    def _sample(self) -> Optional[ScaleSignal]:
        try:
            sig = self._signal_fn()
        except Exception as e:
            # counted in signal_errors and logged via _event: a flaky
            # probe is a no-op sample, not a dead autoscaler
            with self._lock:
                self.signal_errors += 1
            self._event("signal_error", error=repr(e))
            return None
        with self._lock:
            self.last_signal = sig
        return sig

    def _act(self, direction: str, sig: ScaleSignal,
             forced: bool = False) -> Optional[str]:
        acted = (self._scale_up if direction == "up" else self._scale_down)()
        with self._lock:
            self._up_streak = 0
            self._down_streak = 0
            # cooldown starts at the ATTEMPT, success or not: a failed
            # spawn (crash-looping replica) must be paced by the full
            # cooldown, not retried every `samples` ticks forever
            self._last_action_t = time.monotonic()
            if acted:
                if direction == "up":
                    self.scale_ups += 1
                else:
                    self.scale_downs += 1
        self._event(
            f"scale_{direction}" if acted else f"scale_{direction}_failed",
            load=round(sig.load, 4),
            p99_ms=sig.p99_ms,
            shed_rate=round(sig.shed_rate, 4),
            replicas=sig.replicas,
            forced=forced,
        )
        return direction if acted else None

    def snapshot(self) -> dict:
        with self._lock:
            sig = self.last_signal
            return {
                "ticks": self.ticks,
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "signal_errors": self.signal_errors,
                "min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas,
                "load": None if sig is None else round(sig.load, 4),
                "replicas": None if sig is None else sig.replicas,
            }


# ------------------------------------------------------- signal adapters
class ServingSignalSource:
    """Router healthz → :class:`ScaleSignal`. ``load`` = inflight over
    the capacity model (admitted × replica_capacity); ``p99_ms`` is the
    INTERACTIVE tier's p99 (the SLO the autoscaler defends — bulk p99 is
    allowed to suffer by design); ``shed_rate`` is overloaded-replies
    over requests SINCE THE LAST SAMPLE (a lifetime ratio would dilute a
    live overload under hours of healthy history)."""

    def __init__(self, healthz_fn: Callable[[], dict]):
        self._fn = healthz_fn
        self._prev = (0, 0)  # (requests_total, replies_overloaded)

    def __call__(self) -> ScaleSignal:
        h = self._fn()
        admitted = int(h.get("admitted") or 0)
        # the min/max clamp counts REGISTERED (non-removed) replicas, not
        # admitted ones: a transiently-ejected-but-alive replica still
        # owns its device/memory, and counting it out would let a load
        # breach push the fleet past --autoscale-max while it re-admits
        rows = h.get("replicas")
        registered = (
            sum(1 for r in rows if not r.get("removed"))
            if isinstance(rows, list) else admitted
        )
        cap = (h.get("capacity") or {}).get("total") or 0
        inflight = int(h.get("inflight") or 0)
        # no capacity model configured: fall back to inflight per replica
        # against an implicit 1.0 "busy" line per replica
        load = (inflight / cap) if cap else (
            float(inflight) / admitted if admitted else 0.0
        )
        req = int(h.get("requests_total") or 0)
        over = int(h.get("replies_overloaded") or 0)
        d_req = req - self._prev[0]
        d_over = over - self._prev[1]
        self._prev = (req, over)
        shed = (d_over / d_req) if d_req > 0 else 0.0
        inter = h.get("interactive") or {}
        p99 = inter.get("p99_ms")
        if p99 is None:
            p99 = h.get("p99_ms")
        return ScaleSignal(
            load=load, p99_ms=p99, shed_rate=shed, replicas=registered
        )


class IngestSignalSource:
    """Fleet-ingest counters → :class:`ScaleSignal` for ACTOR-HOST
    scaling. The learner paces against ingested windows, so demand is a
    TARGET windows/s: ``load = target / observed_rate`` — a starved
    ingest (too few actor hosts) reads load > 1 and scales UP; sustained
    queue-full shedding (too many hosts for the learner's write rate)
    zeroes the load and scales DOWN. ``replicas`` is the live connection
    count (one per actor host)."""

    def __init__(self, counters_fn: Callable[[], dict],
                 target_windows_per_s: float):
        if target_windows_per_s <= 0:
            raise ValueError("target_windows_per_s must be > 0")
        self._fn = counters_fn
        self._target = float(target_windows_per_s)
        self._prev: Optional[tuple] = None  # (t, ingested, shed)

    def __call__(self) -> ScaleSignal:
        c = self._fn()
        now = time.monotonic()
        ingested = int(c.get("windows_ingested") or 0)
        shed = int(c.get("windows_shed") or 0)
        conns = int(c.get("connections") or 0)
        if self._prev is None:
            self._prev = (now, ingested, shed)
            return ScaleSignal(load=1.0, replicas=conns)  # hold: no rate yet
        t0, i0, s0 = self._prev
        dt = max(now - t0, 1e-6)
        rate = (ingested - i0) / dt
        d_shed = shed - s0
        self._prev = (now, ingested, shed)
        total = (ingested - i0) + d_shed
        shed_frac = (d_shed / total) if total > 0 else 0.0
        if d_shed > 0 and shed_frac > 0.5:
            # the learner is the bottleneck: more actors only shed more
            return ScaleSignal(load=0.0, shed_rate=shed_frac,
                               replicas=conns)
        load = self._target / max(rate, 1e-6)
        return ScaleSignal(load=min(load, 10.0), shed_rate=shed_frac,
                           replicas=conns)


# ---------------------------------------------------------------- pools
class RouterReplicaPool:
    """Serving-side actuators over an in-process
    :class:`~d4pg_tpu_torch.serve.router.Router`.

    Scale-up: copy the source bundle into a FRESH per-replica dir (each
    replica serves its own dir — the rollout contract), spawn
    ``python -m d4pg_tpu_torch.serve`` via the injected ``spawn`` callable
    (``d4pg_tpu_torch/utils/spawnlib.py:spawn`` — tagged stdout pump +
    port scrape),
    then ``router.add_backend`` so admission flows through the normal
    probe path. Scale-down: drain the router's candidate (SIGTERM, wait
    for the rc-0 drain), then ``remove_backend``. ``close()`` drains
    everything this pool spawned."""

    def __init__(
        self,
        router,
        bundle_src: str,
        workdir: str,
        spawn: Callable,
        *,
        replica_args=(),
        spawn_timeout_s: float = 180.0,
        drain_timeout_s: float = 120.0,
    ):
        import sys

        self._router = router
        self._bundle_src = bundle_src
        self._workdir = workdir
        self._spawn = spawn
        self._replica_args = list(replica_args)
        self._spawn_timeout_s = float(spawn_timeout_s)
        self._drain_timeout_s = float(drain_timeout_s)
        self._python = sys.executable
        self._lock = lockwitness.named_lock("RouterReplicaPool._lock")
        self._spawned: dict = {}  # router index -> Spawned handle
        self._n = 0

    def scale_up(self) -> bool:
        import os
        import shutil

        with self._lock:
            self._n += 1
            n = self._n
        bundle_dir = os.path.join(self._workdir, f"autoscale_r{n}")
        if not os.path.isdir(bundle_dir):
            shutil.copytree(self._bundle_src, bundle_dir)
        handle = self._spawn(
            [self._python, "-m", "d4pg_tpu_torch.serve",
             "--bundle", bundle_dir, "--port", "0",
             "--replica-id", str(1000 + n)] + self._replica_args,
            f"autoscale-r{n}",
        )
        try:
            port = handle.wait_port(self._spawn_timeout_s)
        except AssertionError:
            # the replica never came up: reap it AND its bundle copy,
            # report failure — the autoscaler's cooldown (recorded at the
            # attempt, success or not) paces a crash-looping spawn storm,
            # and the rmtree keeps it from growing disk per retry
            import signal as _signal

            procs.drain_or_kill(
                handle.proc, pgid=getattr(handle, "pgid", 0),
                sig=_signal.SIGKILL, drain_timeout_s=10.0,
                label="failed-spawn replica",
            )
            shutil.rmtree(bundle_dir, ignore_errors=True)
            return False
        idx = self._router.add_backend("127.0.0.1", port, bundle_dir)
        with self._lock:
            self._spawned[idx] = handle
        return True

    def scale_down(self) -> bool:
        import signal as _signal

        cand = self._router.pick_scaledown_candidate()
        with self._lock:
            if not self._spawned:
                return False  # nothing THIS pool owns is drainable
            idx = cand if cand in self._spawned else max(self._spawned)
            handle = self._spawned.pop(idx)
        return self._drain_one(idx, handle, _signal)

    def _drain_one(self, idx: int, handle, _signal) -> bool:
        # Deregister from dispatch FIRST: remove_backend ejects the
        # replica (in-flight dispatches fail over via the bounded retry),
        # so no NEW request can land on it and shed OVERLOADED(draining)
        # during the window before a probe would have noticed. Only then
        # SIGTERM — drain, don't kill: the replica still answers
        # everything it had admitted and exits 0. The bounded
        # drain→group-kill escalation is procs.drain_or_kill.
        self._router.remove_backend(idx)
        rc = procs.drain_or_kill(
            handle.proc, pgid=getattr(handle, "pgid", 0),
            sig=_signal.SIGTERM, drain_timeout_s=self._drain_timeout_s,
            label=f"replica {idx}",
        )
        if rc not in (0, None):
            print(f"[autoscaler] replica {idx} drained rc={rc}", flush=True)
        return True

    def count(self) -> int:
        with self._lock:
            return len(self._spawned)

    def close(self) -> None:
        import signal as _signal

        with self._lock:
            spawned, self._spawned = dict(self._spawned), {}
        for idx, handle in sorted(spawned.items(), reverse=True):
            self._drain_one(idx, handle, _signal)


class ActorHostPool:
    """Training-side actuators: spawn/drain ``python -m
    d4pg_tpu_torch.fleet.actor`` hosts against a fleet-ingest endpoint. No
    registration step — actors dial the learner themselves (the HELLO
    handshake is the admission); scale-down SIGTERMs the newest host
    (its drain flushes the spool and prints the accounting line)."""

    def __init__(self, connect: str, bundle_dir: str, spawn: Callable,
                 *, actor_args=(), drain_timeout_s: float = 60.0):
        import sys

        self._connect = connect
        self._bundle_dir = bundle_dir
        self._spawn = spawn
        self._actor_args = list(actor_args)
        self._drain_timeout_s = float(drain_timeout_s)
        self._python = sys.executable
        self._lock = lockwitness.named_lock("ActorHostPool._lock")
        self._spawned: list = []
        self._n = 0

    def scale_up(self) -> bool:
        with self._lock:
            self._n += 1
            n = self._n
        handle = self._spawn(
            [self._python, "-m", "d4pg_tpu_torch.fleet.actor",
             "--connect", self._connect, "--bundle", self._bundle_dir,
             "--seed", str(1000 + n)] + self._actor_args,
            f"autoscale-actor{n}",
        )
        with self._lock:
            self._spawned.append(handle)
        return True

    def scale_down(self) -> bool:
        import signal as _signal

        with self._lock:
            if not self._spawned:
                return False
            handle = self._spawned.pop()
        procs.drain_or_kill(
            handle.proc, pgid=getattr(handle, "pgid", 0),
            sig=_signal.SIGTERM, drain_timeout_s=self._drain_timeout_s,
            label="actor host",
        )
        return True

    def count(self) -> int:
        with self._lock:
            return len(self._spawned)

    def close(self) -> None:
        while self.scale_down():
            pass
