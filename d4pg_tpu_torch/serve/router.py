"""Replicated serving front-end: least-loaded dispatch, health-driven
ejection, rolling canary rollout with auto-rollback (the port's copy of
``d4pg_tpu/serve/router.py``: the same dispatch, admission and rollout
rules, the same flags, healthz keys and ``[router-event]`` lines).

One ``serve/`` process saturates one device thread; production traffic
needs the tier above it. This module is that tier — the serving-side
mirror of the collection fleet (``d4pg_tpu_torch/fleet``): a stdlib
front-end speaking the SAME length-prefixed
frame protocol on both sides, dispatching each request to the least-loaded
of M backend replicas.

Three jobs:

- **Dispatch** — per-replica inflight accounting (the router's own gauge,
  not a healthz round-trip per request); least-loaded admitted replica
  wins, ties broken by index. A replica that sheds (``OVERLOADED``) or
  dies mid-stream (``ConnectionClosed`` — its pipelined dispatch link
  sweeps every in-flight future) triggers ONE bounded re-dispatch on a
  different replica under a seeded :class:`~d4pg_tpu_torch.utils.retry.Backoff`
  budget; only when every replica is ejected does the router itself
  answer ``OVERLOADED(no_replicas)``. The accounting identity the chaos
  soak pins: every request is answered ok, answered OVERLOADED, or
  failed-after-bounded-retry — never silently lost.

- **Health-driven ejection** — a prober thread polls each replica's
  healthz (``protocol.probe_healthz``, one-shot so a dead backend cannot
  wedge it). ``degraded`` / ``draining`` / timeout / connect-failure
  ejects the replica (its dispatch link is closed, failing its in-flight
  requests over to survivors); re-admission takes K CONSECUTIVE healthy
  probes (``readmit_after``) — one lucky probe must not flap a sick
  replica back in.

- **Rolling canary rollout** — ``--canary-bundle`` names a bundle
  directory the router watches (its ``bundle.json`` mtime is the version
  vector, exactly the attestation the exporter's params-first/json-second
  write ordering provides). A new version deploys onto a deterministic
  subset of replicas (the canaries), then ``--canary-fraction`` of
  requests (a deterministic counter fraction, not RNG) routes to them
  while the router compares canary vs baseline reply-error rate and p99
  over sliding windows. Better-or-equal → auto-promote (roll the
  remaining replicas forward one at a time, each attested via healthz
  ``bundle_mtime`` before the next). Worse — or a canary that fails to
  load / gets ejected — → auto-rollback: restore the saved old bundle
  and RE-EJECT the canaries until their healthz attests the old version
  again. Every decision is a structured ``[router-event]`` JSON line.

The multi-tenant tier adds three admission/routing axes on
top:

- **Policy-id routing** — an ``ACT2`` request names a resident policy;
  dispatch is restricted to replicas hosting it (learned from each
  replica's healthz ``policies`` rows), and the canary machinery runs
  ONE rollout state machine PER policy (``--canary-bundle policy=dir``,
  repeatable): a rollout for policy A never touches policy B's replicas,
  bundle dirs, or traffic split. v1 ``ACT`` requests negotiate down to
  the default policy.

- **QoS classes + per-tenant quotas** — every request carries a class
  (interactive | bulk) and a tenant id; admission runs BEFORE dispatch:
  first the tenant's token bucket (``--tenant-quota``/``--default-quota``,
  shed reason ``quota``), then the class-aware capacity check
  (``--replica-capacity`` × admitted replicas): bulk is admitted only
  up to ``--bulk-fraction`` of fleet capacity (shed reason
  ``bulk_capacity``) so under overload the bulk tier sheds FIRST and
  interactive p99 stays inside its SLO; interactive sheds only at full
  capacity (``capacity``). The accounting identity generalizes: answered
  == ok + overloaded + error, exact in aggregate AND per (tenant, class)
  on the healthz ``tenants`` rows.

- **Elastic capacity** — ``add_backend``/``remove_backend`` let the
  autoscaler (``serve/autoscaler.py``) grow and drain the fleet at
  runtime; a replica removed mid-rollout is handled by the rollout
  state machine (abort → restore every touched bundle dir), never left
  half-deployed.

The router is a HOST-ONLY module: it moves bytes and stats files, never
tensors — the one numpy touch is decoding the obs to re-encode it for the
backend link. Deliberately no torch import anywhere near it: M replicas
own the card; the router must restart in milliseconds.

Run it::

    python -m d4pg_tpu_torch.serve.router --backends 127.0.0.1:7431,127.0.0.1:7432 \\
        --backend-bundles runs/p1/bundle_a,runs/p1/bundle_b \\
        --canary-bundle runs/p1/canary --canary-fraction 0.25

``--autoscale`` runs :mod:`d4pg_tpu_torch.serve.autoscaler` in-process:
it spawns ``python -m d4pg_tpu_torch.serve`` replicas (on the card unless
``--replica-args`` asks for ``--device cpu``) and drains them again.
"""

from __future__ import annotations

import json
import os
import random
import shutil
import signal
import socket
import tempfile
import threading
import time
from collections import deque
from typing import Optional

import numpy as np

from d4pg_tpu_torch import netio
from d4pg_tpu_torch.netio import attack as netio_attack
from d4pg_tpu_torch.serve import protocol
from d4pg_tpu_torch.serve.client import ConnectionClosed, Overloaded, PolicyClient
from d4pg_tpu_torch.serve.protocol import ProtocolError
from d4pg_tpu_torch.serve.stats import LatencyReservoir
from d4pg_tpu_torch.utils.retry import Backoff
from d4pg_tpu_torch.analysis import flowledger, lockwitness

# Bundle file names, duplicated from serve/bundle.py ON PURPOSE: that
# module imports torch at module top, and the router is a host-only
# process that must never pay — or crash on — a torch import. The names
# are a stable on-disk contract, shared with the JAX package's bundles.
_PARAMS_FILE = "actor_params.npz"
_META_FILE = "bundle.json"


def _bundle_json_mtime(bundle_dir: str) -> Optional[float]:
    try:
        return os.stat(os.path.join(bundle_dir, _META_FILE)).st_mtime
    except (OSError, TypeError):
        return None


# Per-(tenant, class) accounting rows are bounded: past this many distinct
# tenants new ones aggregate into "__other__" (the identity stays exact —
# the overflow row is still a row) so a tenant-id flood cannot grow router
# memory without bound.
MAX_TENANT_ROWS = 512


class TokenBucket:
    """Per-tenant admission quota: ``rate`` tokens/s refill up to
    ``burst``. No lock of its own — every touch happens under the ROUTER
    lock on the admission path (one lock hop per request, same discipline
    as the dispatch bookkeeping), and no allocation per take (the quota
    check is in HOT_PATH_FUNCTIONS)."""

    __slots__ = ("rate", "burst", "tokens", "t_last")

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.t_last = now

    def take(self, now: float) -> bool:
        tokens = self.tokens + (now - self.t_last) * self.rate
        if tokens > self.burst:
            tokens = self.burst
        self.t_last = now
        if tokens < 1.0:
            self.tokens = tokens
            return False
        self.tokens = tokens - 1.0
        return True


class RouterStats:
    """Router-level counters + client-observed latency. One lock, O(1)
    per request; the identity surface is replies_ok + replies_overloaded
    + replies_error == answered requests — in aggregate, and per
    (tenant, QoS class) on the bounded ``tenants`` rows. Latency is also
    kept per class: the isolation claim ("a flooding bulk tenant cannot
    move interactive p99") needs the interactive reservoir separable."""

    def __init__(self):
        self._lock = lockwitness.named_lock("RouterStats._lock")
        self._t0 = time.monotonic()
        self.requests_total = 0
        self.replies_ok = 0
        self.replies_overloaded = 0
        self.replies_error = 0
        self.retries = 0
        self.ejections = 0
        self.admissions = 0
        self.dropped_replies = 0
        self.protocol_errors = 0
        self.canary_rollbacks = 0
        self.canary_promotions = 0
        # flywheel: reward echoes handled at the router tap,
        # and the off-policy promotion gate's verdict tallies
        # (evaluations == pass + block + stalls at quiesce)
        self.feedback_frames = 0
        self.gate_evaluations = 0
        self.gate_pass = 0
        self.gate_block = 0
        self.gate_stalls = 0
        # admission sheds (each also counted in replies_overloaded — they
        # ARE overloaded answers; these break the reason down)
        self.shed_quota = 0
        self.shed_bulk_capacity = 0
        self.shed_capacity = 0
        self.latency = LatencyReservoir()
        self.latency_interactive = LatencyReservoir()
        self.latency_bulk = LatencyReservoir()
        # (tenant, qos) -> [requests, ok, overloaded, error]
        self._tenants: dict = {}

    def inc(self, field: str, by: int = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + by)

    def _tenant_row(self, tenant: str, qos: int) -> list:
        """Caller holds ``self._lock``."""
        key = (tenant, qos)
        row = self._tenants.get(key)
        if row is None:
            if len(self._tenants) >= MAX_TENANT_ROWS:
                key = ("__other__", qos)
                row = self._tenants.get(key)
                if row is None:
                    row = self._tenants[key] = [0, 0, 0, 0]
            else:
                row = self._tenants[key] = [0, 0, 0, 0]
        return row

    def tenant_request(self, tenant: str, qos: int) -> None:
        with self._lock:
            self._tenant_row(tenant, qos)[0] += 1

    def tenant_outcome(self, tenant: str, qos: int, outcome: int) -> None:
        """``outcome``: 1 = ok, 2 = overloaded, 3 = error (row offsets)."""
        with self._lock:
            self._tenant_row(tenant, qos)[outcome] += 1

    def add_latency(self, seconds: float, qos: int) -> None:
        self.latency.add(seconds)
        (self.latency_bulk if qos else self.latency_interactive).add(seconds)

    def tenants_snapshot(self) -> dict:
        """``"tenant/class" -> {requests, ok, overloaded, error, answered}``
        rows; the per-row identity (requests == answered at quiesce) is
        the machine-checked multi-tenant accounting surface."""
        with self._lock:
            items = list(self._tenants.items())
        out = {}
        for (tenant, qos), row in sorted(items):
            out[f"{tenant}/{protocol.QOS_NAMES.get(qos, qos)}"] = {
                "requests": row[0],
                "ok": row[1],
                "overloaded": row[2],
                "error": row[3],
                "answered": row[1] + row[2] + row[3],
            }
        return out

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "uptime_s": round(time.monotonic() - self._t0, 3),
                "requests_total": self.requests_total,
                "replies_ok": self.replies_ok,
                "replies_overloaded": self.replies_overloaded,
                "replies_error": self.replies_error,
                "retries": self.retries,
                "ejections": self.ejections,
                "admissions": self.admissions,
                "dropped_replies": self.dropped_replies,
                "protocol_errors": self.protocol_errors,
                "canary_rollbacks": self.canary_rollbacks,
                "canary_promotions": self.canary_promotions,
                "feedback_frames": self.feedback_frames,
                "gate_evaluations": self.gate_evaluations,
                "gate_pass": self.gate_pass,
                "gate_block": self.gate_block,
                "gate_stalls": self.gate_stalls,
                "shed_quota": self.shed_quota,
                "shed_bulk_capacity": self.shed_bulk_capacity,
                "shed_capacity": self.shed_capacity,
            }
        out["answered_total"] = (
            out["replies_ok"] + out["replies_overloaded"] + out["replies_error"]
        )
        out.update(self.latency.percentiles_ms())
        out["interactive"] = self.latency_interactive.percentiles_ms()
        out["bulk"] = self.latency_bulk.percentiles_ms()
        return out


class Replica:
    """Router-side bookkeeping for one backend ``serve/`` process.

    No threads of its own and no locks: every mutable field is guarded by
    the ROUTER's lock — dispatch picks, inflight accounting, and ejection
    flips must be mutually consistent, and a per-replica lock would just
    invite ordering bugs between two.
    """

    def __init__(self, index: int, host: str, port: int,
                 bundle_dirs=None):
        self.index = index
        self.host = host
        self.port = port
        # policy id -> this replica's live bundle dir for that policy
        # ({} = canary rollouts cannot target it). A bare str means the
        # default policy (the single-policy calling convention).
        if bundle_dirs is None:
            self.bundle_dirs: dict = {}
        elif isinstance(bundle_dirs, str):
            self.bundle_dirs = {protocol.DEFAULT_POLICY: bundle_dirs}
        else:
            self.bundle_dirs = dict(bundle_dirs)
        self.client: Optional[PolicyClient] = None  # dispatch link
        self.inflight = 0                 # router-side, not healthz
        self.admitted = False
        self.ejected_reason: Optional[str] = "startup"
        self.healthy_streak = 0
        self.health: dict = {}            # last successful probe snapshot
        self.pid: Optional[int] = None
        self.bundle_mtime: Optional[float] = None   # default policy's vector
        # per-policy serving-version vectors from the healthz ``policies``
        # rows (an old single-policy replica reports only the top-level
        # bundle_mtime — mapped to the default policy)
        self.policy_mtimes: dict = {}
        # policies this replica HOSTS (healthz-learned); dispatch for a
        # policy only considers replicas hosting it
        self.policies: tuple = (protocol.DEFAULT_POLICY,)
        self.canary_for: set = set()      # policies it is canary for
        # Scale-down lifecycle: a removed replica stays in the list (index
        # stability — rollout state and events reference indices) but is
        # invisible to dispatch, probing, and capacity.
        self.removed = False
        self.ok = 0                       # lifetime final outcomes served
        self.errors = 0
        # Dispatch-progress watermark: refreshed when inflight leaves 0 at
        # a pick and on EVERY future resolution. While inflight > 0 a
        # stale watermark means nothing is coming back — the stuck-replica
        # signal healthz can't carry (a wedged device thread still answers
        # healthz "ok").
        self.last_progress = time.monotonic()

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"


class _Rollout:
    """Per-policy canary rollout state. The control thread is the only
    writer (the state machine runs there); ``state`` and the traffic
    counters are additionally written/read under the router lock because
    ``_pick`` routes on them. One instance per ``--canary-bundle``
    policy=dir spec — rollouts for different policies advance
    independently and never touch each other's replicas or traffic.

    The fields in ``_THREAD_SAFE`` are control-thread-only; readers take
    atomic snapshots and tolerate one-tick staleness."""

    _THREAD_SAFE = (
        "seen_mtime", "version", "deadline", "rollback_deadline",
        "deploys", "promote_done", "rollback_dir", "backed_up", "state",
        # off-policy gate handshake: gate_started/gate_token are
        # control-thread-only; gate_result is a single None→dict
        # transition by the gate worker, read by the control thread
        # (one-tick staleness tolerated, token-fenced against stragglers)
        "gate_started", "gate_result", "gate_token",
    )

    def __init__(self, policy: str, src_dir: str, window: int):
        self.policy = policy
        self.src_dir = src_dir
        self.state = "idle"  # idle|deploying|observing|promoting|rolling_back
        self.seen_mtime: Optional[float] = None
        self.version: Optional[float] = None
        self.deadline: Optional[float] = None
        self.rollback_deadline: Optional[float] = None
        self.deploys: dict = {}       # replica index -> awaited json mtime
        self.promote_done: set = set()
        self.rollback_dir: Optional[str] = None
        self.backed_up: set = set()
        # off-policy promotion gate: one evaluation per
        # observation phase, run off the control thread (the spool read +
        # policy load may block; a stalled gate must not freeze every
        # OTHER rollout's state machine). gate_token fences late writes
        # from a stalled worker of a PREVIOUS observation phase.
        self.gate_started = False
        self.gate_result: Optional[dict] = None
        self.gate_token = 0
        # per-rollout stripe counter (under the router lock): the
        # Bresenham fraction must be exact over THIS policy's requests,
        # not the global sequence mixed across policies
        self.seq = 0
        self.windows = {
            "baseline": deque(maxlen=int(window)),
            "canary": deque(maxlen=int(window)),
        }

    def snapshot_row(self, permille: int) -> dict:
        return {
            "policy": self.policy,
            "state": self.state,
            "fraction": permille / 1000.0,
            "version": self.version,
            "window_baseline": len(self.windows["baseline"]),
            "window_canary": len(self.windows["canary"]),
        }


class Router:
    """The replicated front-end. ``start()`` binds and spawns the accept /
    control threads; ``drain()`` is the graceful stop (answer in-flight,
    shed new with ``draining``)."""

    # Per-rollout cursor state lives on _Rollout (control thread only,
    # declared there); _obs_dim is written under _lock (prober) after the
    # first successful probe and only ever goes None -> int; _obs_dims
    # entries likewise.
    _THREAD_SAFE = ()
    # Detached on purpose: router-gate workers are bounded by the gate
    # evaluation itself (spool read + one NumPy policy forward); a
    # wedged one (gate_stall chaos, hung filesystem) is exactly the
    # fault the observe-deadline rollback covers, and its late verdict
    # is token-fenced out — joining would hand the control thread the
    # very stall the design isolates it from. (Client connections live
    # on the netio event loop — no per-connection threads to account.)
    _DETACHED_THREADS = ("router-gate",)

    def __init__(
        self,
        backends,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        bundle_dirs=None,
        probe_interval_s: float = 0.5,
        probe_timeout_s: float = 2.0,
        readmit_after: int = 2,
        dispatch_retries: int = 1,
        dispatch_timeout_s: float = 10.0,
        stuck_after_s: float = 30.0,
        retry_seed: int = 0,
        canary_bundle: Optional[str] = None,
        canary_fraction: float = 0.25,
        canary_window: int = 256,
        canary_min_samples: int = 40,
        canary_max_err_increase: float = 0.05,
        canary_p99_ratio: float = 3.0,
        canary_attest_timeout_s: float = 30.0,
        canary_observe_timeout_s: float = 600.0,
        mirror_tap=None,
        gate_spool: Optional[str] = None,
        gate_sigma: float = 0.3,
        gate_min_windows: int = 16,
        gate_min_ess: float = 4.0,
        gate_band: float = 1.0,
        gate_max_windows: int = 512,
        log_dir: Optional[str] = None,
        metrics_interval_s: float = 30.0,
        chaos=None,
        tenant_quotas=None,
        default_quota=None,
        replica_capacity: int = 0,
        bulk_fraction: float = 0.5,
        flood_burst: int = 200,
        io_read_stall_s: float = netio.loop.DEFAULT_READ_STALL_S,
        io_write_stall_s: float = netio.loop.DEFAULT_WRITE_STALL_S,
        io_write_buffer_limit: int = netio.loop.DEFAULT_WRITE_BUFFER_LIMIT,
    ):
        if not backends:
            raise ValueError("router needs at least one backend replica")
        bundle_dirs = list(bundle_dirs) if bundle_dirs else [None] * len(backends)
        if len(bundle_dirs) != len(backends):
            raise ValueError(
                f"{len(backends)} backends but {len(bundle_dirs)} bundle "
                "dirs — the canary controller needs a 1:1 mapping"
            )
        self._replicas = []
        for i, spec in enumerate(backends):
            if isinstance(spec, (tuple, list)):
                h, p = spec
            else:
                h, _, p = str(spec).rpartition(":")
            self._replicas.append(Replica(i, h or "127.0.0.1", int(p),
                                          bundle_dirs[i]))
        self.host = host
        self._requested_port = port
        self.port: Optional[int] = None
        self.stats = RouterStats()
        # Witnessed under --debug-guards (static node ids, see lockwitness)
        self._lock = lockwitness.named_lock("Router._lock")
        self._seq = 0
        self._obs_dim: Optional[int] = None
        # policy -> obs_dim learned from replica healthz ``policies`` rows
        # (the default policy also mirrors into _obs_dim for the v1 path)
        self._obs_dims: dict = {}

        self._probe_interval_s = float(probe_interval_s)
        self._probe_timeout_s = float(probe_timeout_s)
        self._readmit_after = int(readmit_after)
        self._dispatch_retries = int(dispatch_retries)
        self._dispatch_timeout_s = float(dispatch_timeout_s)
        self._stuck_after_s = float(stuck_after_s)
        # Seeded: the failover Backoff budget and its jitter replay
        # deterministically under --chaos, like every retry in this repo.
        self._retry_rng = random.Random(retry_seed)

        # ---- per-policy canary rollout state machines (control thread) ----
        # ``canary_bundle``: a bare dir (the single-policy convention — a rollout
        # for the DEFAULT policy) or a {policy: dir} mapping; one
        # _Rollout per entry, fully independent.
        self._canary_permille = int(round(float(canary_fraction) * 1000))
        if canary_bundle is not None and not (
            0 < self._canary_permille < 1000
        ):
            raise ValueError(
                "--canary-fraction must be strictly between 0 and 1: the "
                "verdict compares a canary window AGAINST a baseline "
                "window, so both groups must receive traffic (0 routes "
                "nothing to the canary, 1 starves the baseline — either "
                "way the rollout would observe forever)"
            )
        if canary_bundle is None:
            canary_specs = {}
        elif isinstance(canary_bundle, str):
            canary_specs = {protocol.DEFAULT_POLICY: canary_bundle}
        else:
            canary_specs = dict(canary_bundle)
        self._rollouts: dict = {
            pol: _Rollout(pol, src, canary_window)
            for pol, src in sorted(canary_specs.items())
        }
        for pol in self._rollouts:
            if not any(
                pol in r.bundle_dirs for r in self._replicas
            ):
                raise ValueError(
                    f"--canary-bundle for policy {pol!r} needs "
                    "--backend-bundles hosting that policy: the router "
                    "rolls a replica forward by writing into ITS bundle "
                    "directory for the policy"
                )
        self._attest_timeout_s = float(canary_attest_timeout_s)
        self._observe_timeout_s = float(canary_observe_timeout_s)
        self._min_samples = int(canary_min_samples)
        self._max_err_increase = float(canary_max_err_increase)
        self._p99_ratio = float(canary_p99_ratio)
        # (replica index, policy) -> bundle_mtime it must attest before
        # probes count as healthy again (the re-eject-until-old-bundle
        # rollback contract, per policy)
        self._readmit_gate: dict = {}

        # ---- flywheel: router-position mirror tap + IS gate ----
        # The tap is externally owned (main() builds/closes it); the gate
        # reads the mirror SPOOL — candidate return is estimated from
        # logged behavior traffic, never from live requests.
        self._tap = mirror_tap
        self._gate_spool = gate_spool
        self._gate_sigma = float(gate_sigma)
        self._gate_min_windows = int(gate_min_windows)
        self._gate_min_ess = float(gate_min_ess)
        self._gate_band = float(gate_band)
        self._gate_max_windows = int(gate_max_windows)

        # ---- QoS + per-tenant admission (the multi-tenant tier) ----
        # tenant -> TokenBucket, built from the configured quotas and
        # lazily for unknown tenants under the default quota; everything
        # guarded by self._lock (one hop per request on the hot path).
        now = time.monotonic()
        self._tenant_buckets: dict = {}
        self._tenant_quota_conf = {
            str(t): (float(r), float(b))
            for t, (r, b) in (tenant_quotas or {}).items()
        }
        for t, (rate, burst) in self._tenant_quota_conf.items():
            self._tenant_buckets[t] = TokenBucket(rate, burst, now)
        self._default_quota = (
            (float(default_quota[0]), float(default_quota[1]))
            if default_quota else None
        )
        # Class-aware capacity: fleet capacity = admitted replicas ×
        # replica_capacity; bulk is admitted only below bulk_fraction of
        # it, interactive up to all of it — so overload sheds bulk FIRST.
        # replica_capacity 0 disables the class-aware admission tier
        # (quotas still apply): the single-tier behavior.
        self._replica_capacity = int(replica_capacity)
        if not (0.0 < float(bulk_fraction) <= 1.0):
            raise ValueError(
                f"bulk_fraction must be in (0, 1], got {bulk_fraction}"
            )
        self._bulk_fraction = float(bulk_fraction)
        self._flood_burst = int(flood_burst)

        self._events: deque = deque(maxlen=1000)
        self._events_total = 0
        self._events_lock = lockwitness.named_lock("Router._events_lock")

        self._chaos = chaos
        self._log_dir = log_dir
        self._metrics_interval_s = metrics_interval_s
        self._metrics = None

        self._listen_sock: Optional[socket.socket] = None
        # ONE event-loop thread owns every client connection (reads,
        # frame reassembly, buffered writes, progress deadlines, bounded
        # accept) — the C10k front: thread count is O(1) in connections.
        self._loop = netio.FrameLoop(
            name="router-io",
            read_stall_s=io_read_stall_s,
            write_stall_s=io_write_stall_s,
            write_buffer_limit=io_write_buffer_limit,
        )
        self._control_thread: Optional[threading.Thread] = None
        self._metrics_thread: Optional[threading.Thread] = None
        self._shutdown = threading.Event()
        self._started = False

    # ------------------------------------------------------------- lifecycle
    def start(self) -> None:
        if self._started:
            raise RuntimeError("router already started")
        self._started = True
        self._listen_sock = socket.create_server(
            (self.host, self._requested_port)
        )
        self.port = self._listen_sock.getsockname()[1]
        self._loop.serve(
            self._listen_sock,
            on_frame=self._serve_conn,
            on_open=self._on_conn_open,
            on_close=self._on_conn_close,
            on_protocol_error=self._on_protocol_error,
        )
        self._loop.start()
        self._control_thread = threading.Thread(
            target=self._control_loop, name="router-control", daemon=True
        )
        self._control_thread.start()
        if self._log_dir:
            from d4pg_tpu_torch.runtime.metrics import MetricsLogger

            self._metrics = MetricsLogger(self._log_dir)
            self._metrics_thread = threading.Thread(
                target=self._metrics_loop, name="router-metrics", daemon=True
            )
            self._metrics_thread.start()

    def wait_for_replicas(self, n: int, timeout_s: float = 120.0) -> int:
        """Block until ``n`` replicas are admitted (bounded, monotonic).
        Returns the admitted count; raises ``TimeoutError`` when the fleet
        never materializes — a router fronting zero replicas should fail
        its orchestrator's readiness check loudly, not serve OVERLOADED."""
        deadline = time.monotonic() + timeout_s
        while True:
            with self._lock:
                admitted = sum(1 for r in self._replicas if r.admitted)
            if admitted >= n:
                return admitted
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"only {admitted}/{n} replicas admitted after {timeout_s}s"
                )
            time.sleep(0.05)

    def request_shutdown(self) -> None:
        """Signal-handler-safe: set the event; drain happens on the waiter."""
        self._shutdown.set()

    # ------------------------------------------------- elastic fleet (autoscaler)
    def add_backend(self, host: str, port: int, bundle_dirs=None) -> int:
        """Register a new replica at runtime (the autoscaler's scale-up
        seam). Returns its index. The replica starts un-admitted —
        admission flows through the normal K-consecutive-healthy-probes
        path, so a half-started process never takes traffic."""
        with self._lock:
            idx = len(self._replicas)
            r = Replica(idx, host, int(port), bundle_dirs)
            self._replicas.append(r)
        self._record_event("backend_added", replica=idx, addr=r.addr)
        return idx

    def remove_backend(self, index: int) -> None:
        """Deregister a replica (the autoscaler's scale-down seam, called
        BEFORE the SIGTERM so no new request lands on a draining process
        and sheds). Ejection closes the dispatch link — in-flight
        dispatches fail over via the bounded retry; the replica still
        answers what it had admitted. The replica keeps its index slot
        (rollout state and events reference indices) but becomes
        invisible to dispatch, probing, and capacity. If an active
        rollout touched it, the rollout's own control tick aborts via the
        normal rollback — which restores every touched bundle dir, so a
        scale-down can never strand a half-deployed replica."""
        with self._lock:
            r = self._replicas[index]
            if r.removed:
                return
            r.removed = True
            # a removed replica can never attest a restored bundle: any
            # readmit gate on it (a rollback that raced the drain) is
            # dead weight — drop it so no rollout waits on a ghost
            for key in [k for k in self._readmit_gate if k[0] == index]:
                del self._readmit_gate[key]
            to_close = self._eject_locked(r, "removed (scale-down)") \
                if r.admitted else None
        if to_close is not None:
            try:
                to_close.close()
            except OSError:
                pass
        self._record_event("backend_removed", replica=index, addr=r.addr)

    def pick_scaledown_candidate(self) -> Optional[int]:
        """The replica an autoscaler should drain next: prefer one no
        active rollout touched (draining a canary mid-rollout forces an
        abort — legal but wasteful), highest index first (LIFO — the
        autoscaler's own spawns go before the operator's seed fleet).
        None when nothing is admitted."""
        with self._lock:
            in_rollout = set()
            for ro in self._rollouts.values():
                if ro.state != "idle":
                    in_rollout |= set(ro.backed_up) | set(ro.deploys)
                    in_rollout |= {
                        r.index for r in self._replicas
                        if ro.policy in r.canary_for
                    }
            pool = [r for r in self._replicas if r.admitted and not r.removed]
            if not pool:
                return None
            clean = [r for r in pool if r.index not in in_rollout]
            return max(clean or pool, key=lambda r: r.index).index

    def serve_until_shutdown(self) -> None:
        # Park-until-signal is the design (same contract as PolicyServer).
        self._shutdown.wait()  # blocking forever is the serve loop
        self.drain()

    def drain(self, timeout: float = 30.0) -> None:
        """Graceful stop: no new connections, shed new requests with
        ``draining``, let every in-flight dispatch come back, tear down."""
        self._shutdown.set()
        # No new connections; the loop keeps running so in-flight
        # dispatch replies (and ``draining`` sheds for frames that race
        # the drain) still reach their clients.
        self._loop.stop_accepting()
        self._listen_sock = None
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                inflight = sum(r.inflight for r in self._replicas)
            if inflight == 0:
                break
            time.sleep(0.05)
        if self._control_thread is not None:
            self._control_thread.join(timeout=self._probe_interval_s + 10)
        with self._lock:
            clients = [r.client for r in self._replicas if r.client is not None]
            for r in self._replicas:
                r.client = None
                r.admitted = False
                r.ejected_reason = "router draining"
        for c in clients:
            try:
                c.close()
            except OSError:
                pass
        if self._metrics_thread is not None:
            self._metrics_thread.join(timeout=self._metrics_interval_s + 5)
        if self._metrics is not None:
            self._metrics.log(self.stats.requests_total, self._metrics_row())
            self._metrics.close()
            self._metrics = None
        # Flush every connection's queued replies (bounded by the write-
        # progress deadline), close them, join the one I/O thread.
        self._loop.close(flush_timeout_s=5.0)
        for ro in self._rollouts.values():  # the control thread is gone
            self._abandon_gate(ro)
        # --debug-guards: admission/terminal accounting, the promotion
        # gate's poll accounting, and every tenant row must balance now
        # that in-flight dispatches resolved and the readers are gone
        snap = self.stats.snapshot()
        flowledger.check("router", snap, where="router drain")
        flowledger.check("router-gate", snap, where="router drain")
        flowledger.check_rows(
            "router-tenant", self.stats.tenants_snapshot(),
            where="router drain",
        )
        # and the lock nesting against the port's committed graph (the
        # JAX router checks only the identities at its drain)
        lockwitness.check_against_committed(where="router drain")

    # ------------------------------------------------------------ event log
    def _record_event(self, kind: str, **fields) -> None:
        """Structured decision log: one JSON line per event on stdout
        (greppable by the soak) + a bounded in-memory tail for healthz."""
        event = {"event": kind, "t": round(time.monotonic(), 3), **fields}
        with self._events_lock:
            self._events.append(event)
            self._events_total += 1
        print(f"[router-event] {json.dumps(event, sort_keys=True)}", flush=True)

    # ------------------------------------------------------- control thread
    def _control_loop(self) -> None:
        """Probe → eject/re-admit → canary step, every probe interval.
        ONE control thread on purpose: ejection flips and rollout
        transitions observe each other, and two timers would race."""
        while not self._shutdown.is_set():
            try:
                self._probe_all()
                self._canary_step()
            except Exception as e:  # control must never die silently
                print(f"[router] control loop error: {e!r}", flush=True)
                self._record_event("control_error", error=repr(e))
            if self._shutdown.wait(self._probe_interval_s):
                return

    def _probe_all(self) -> None:
        # Probes run CONCURRENTLY: sequentially, every unreachable replica
        # would stall the whole control loop by its full connect timeout
        # per round (M-1 dead backends → the survivor's ejection and the
        # canary attestation deadlines slip by seconds while the
        # wall-parallel monotonic deadlines keep ticking). Each probe is a
        # self-contained one-shot socket, so a thread per replica per
        # round is safe; a wedged probe past the join bound is treated as
        # failed and its daemon thread dies with its socket timeout.
        with self._lock:
            live = [r for r in self._replicas if not r.removed]
        results: list = [None] * len(live)

        def probe_one(i: int, r: Replica) -> None:
            try:
                results[i] = (protocol.probe_healthz(
                    r.host, r.port, timeout_s=self._probe_timeout_s
                ), None)
            except (OSError, ProtocolError) as e:
                results[i] = (None, e)

        threads = [
            threading.Thread(
                target=probe_one, args=(i, r),
                name=f"router-probe-{r.index}", daemon=True,
            )
            for i, r in enumerate(live)
        ]
        for t in threads:
            t.start()
        deadline = time.monotonic() + self._probe_timeout_s + 2.0
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        for r, res in zip(live, results):
            if res is None:
                res = (None, TimeoutError("probe thread did not finish"))
            self._apply_probe(r, res[0], res[1])
        self._check_stuck()

    def _check_stuck(self) -> None:
        """Eject a replica whose dispatches stopped resolving. A backend
        with a wedged device thread still answers healthz ``ok`` (status
        only reflects drain/reload state), so the prober alone would keep
        it admitted while its unanswered futures break the accounting
        identity and its leaked inflight biases least-loaded dispatch.
        Closing the dispatch link fails every in-flight future with
        ``ConnectionClosed`` — the normal bounded-failover trigger — so
        stuck requests are rescued onto other replicas, not abandoned."""
        if not self._stuck_after_s:
            return
        now = time.monotonic()
        to_close, ejected = [], []
        with self._lock:
            for r in self._replicas:
                if (
                    r.admitted and r.inflight > 0
                    and now - r.last_progress > self._stuck_after_s
                ):
                    to_close.append(self._eject_locked(
                        r, f"stuck: no dispatch resolved in "
                           f"{self._stuck_after_s:g}s"
                    ))
                    ejected.append(r)
        for c in to_close:
            if c is not None:
                try:
                    c.close()
                except OSError:
                    pass
        for r in ejected:
            self._record_event("eject", replica=r.index, addr=r.addr,
                               reason="stuck")

    def _apply_probe(self, r: Replica, h: Optional[dict], err) -> None:
        to_close = None
        eject_reason = None
        dial = False
        with self._lock:
            if h is not None:
                r.health = h
                r.pid = h.get("pid")
                r.bundle_mtime = h.get("bundle_mtime")
                pol_rows = h.get("policies")
                if isinstance(pol_rows, dict) and pol_rows:
                    r.policies = tuple(sorted(pol_rows))
                    r.policy_mtimes = {
                        pid: row.get("bundle_mtime")
                        for pid, row in pol_rows.items()
                    }
                    for pid, row in pol_rows.items():
                        if pid not in self._obs_dims and row.get("obs_dim"):
                            self._obs_dims[pid] = int(row["obs_dim"])
                else:
                    # old single-policy replica: its one bundle IS the
                    # default policy's
                    r.policies = (protocol.DEFAULT_POLICY,)
                    r.policy_mtimes = {
                        protocol.DEFAULT_POLICY: h.get("bundle_mtime")
                    }
                if self._obs_dim is None and h.get("obs_dim"):
                    self._obs_dim = int(h["obs_dim"])
                    self._obs_dims.setdefault(
                        protocol.DEFAULT_POLICY, self._obs_dim
                    )
            if h is None or h.get("status") != "ok":
                r.healthy_streak = 0
                if r.admitted:
                    eject_reason = (
                        f"probe failed: {err!r}" if err is not None
                        else f"status: {h.get('status')}"
                    )
                    to_close = self._eject_locked(r, eject_reason)
            else:
                # rolled-back canary: healthy probes do not count until it
                # attests the RESTORED bundle version for EVERY gated
                # policy (gates are per (replica, policy) — a rollback of
                # policy A never gates on policy B's vector)
                gates = [
                    (key, mt) for key, mt in self._readmit_gate.items()
                    if key[0] == r.index
                ]
                unmet = [
                    key for key, mt in gates
                    if r.policy_mtimes.get(key[1]) != mt
                ]
                if unmet:
                    r.healthy_streak = 0
                else:
                    for key, _mt in gates:
                        del self._readmit_gate[key]
                    r.healthy_streak += 1
                    if (
                        not r.admitted and not r.removed
                        and r.healthy_streak >= self._readmit_after
                    ):
                        dial = True
        if to_close is not None:
            try:
                to_close.close()
            except OSError:
                pass
        if eject_reason is not None:
            self._record_event("eject", replica=r.index, addr=r.addr,
                               reason=eject_reason)
        if dial:
            self._admit(r)

    def _eject_locked(self, r: Replica, reason: str):
        """Caller holds ``self._lock``. Returns the dispatch link to close
        OUTSIDE the lock. Closing it fails every in-flight request on this
        replica with ``ConnectionClosed`` — which is exactly the bounded
        failover trigger, so ejection actively rescues in-flight work from
        a sick replica instead of letting it ride out a timeout."""
        r.admitted = False
        r.ejected_reason = reason
        r.healthy_streak = 0
        client, r.client = r.client, None
        self.stats.inc("ejections")
        return client

    def _admit(self, r: Replica) -> None:
        """Dial the dispatch link OUTSIDE the lock, then publish. The link
        is a pipelined PolicyClient at retries=0: the router's recovery is
        failover to a DIFFERENT replica, never a hammer on the same one."""
        try:
            client = PolicyClient(
                r.host, r.port, timeout=self._dispatch_timeout_s
            )
        except OSError as e:
            with self._lock:
                r.healthy_streak = 0
            self._record_event("admit_failed", replica=r.index, addr=r.addr,
                               error=str(e))
            return
        stale = None
        with self._lock:
            # r.removed: a probe round snapshotted before remove_backend
            # may still be applying — a removed replica must never
            # re-admit (its process is drained/gone)
            if r.admitted or r.removed or self._shutdown.is_set():
                stale = client
            else:
                r.client = client
                r.admitted = True
                r.ejected_reason = None
                r.last_progress = time.monotonic()
        if stale is not None:
            try:
                stale.close()
            except OSError:
                pass
            return
        self.stats.inc("admissions")
        self._record_event("admit", replica=r.index, addr=r.addr,
                           streak=r.healthy_streak)

    # -------------------------------------------------------------- dispatch
    def _pick(self, exclude, policy: str):
        """Least-loaded admitted replica HOSTING ``policy`` (ties →
        lowest index), honoring that policy's deterministic canary
        traffic split while ITS rollout is observing. Returns
        ``(replica, client)`` or ``(None, None)`` — the all-ejected case
        the router answers OVERLOADED itself."""
        with self._lock:
            self._seq += 1
            seq = self._seq
            pool = [
                r for r in self._replicas
                if r.admitted and r.client is not None
                and not r.removed
                and r.index not in exclude
                and policy in r.policies
            ]
            if not pool:
                return None, None
            ro = self._rollouts.get(policy)
            if (
                ro is not None and ro.state == "observing"
                and self._canary_permille
            ):
                # Bresenham-style striping on THIS policy's own request
                # counter: request i is canary iff (i·permille) mod 1000 <
                # permille — the fraction is exact over any 1000-request
                # window of this policy's traffic AND interleaved, so both
                # comparison windows fill together (seq%1000 < permille
                # would send a contiguous block of 1000·fraction requests
                # to the canary first, starving the baseline window).
                ro.seq += 1
                want_canary = (
                    ro.seq * self._canary_permille
                ) % 1000 < self._canary_permille
                group = [
                    r for r in pool if (policy in r.canary_for) == want_canary
                ] or pool
            else:
                group = [r for r in pool if policy not in r.canary_for] or pool
            # least-loaded wins; ties rotate with the dispatch counter so
            # sequential (inflight-0) traffic round-robins instead of
            # pinning the lowest index
            n = len(self._replicas)
            best = group[0]
            best_key = (best.inflight, (best.index - seq) % n)
            for r in group[1:]:
                key = (r.inflight, (r.index - seq) % n)
                if key < best_key:
                    best, best_key = r, key
            if best.inflight == 0:
                # arm the stuck watermark: from idle, the clock starts at
                # this dispatch (while inflight stays >0 only resolutions
                # refresh it — see _check_stuck)
                best.last_progress = time.monotonic()
            best.inflight += 1
            return best, best.client

    def _admit_tenant(self, tenant: str, qos: int) -> Optional[bytes]:
        """Admission control, BEFORE dispatch: the tenant's token bucket,
        then the class-aware capacity check. Returns the shed reason
        (wire bytes) or None when admitted. One lock hop, no allocation
        per request (HOT_PATH_FUNCTIONS) — the lazy bucket creation for a
        never-seen tenant is the one cold-path exception.

        The shed ORDERING contract: fleet capacity is
        admitted-replicas × replica_capacity; bulk is admitted only while
        total inflight is under bulk_fraction × capacity, interactive up
        to full capacity — so under overload the bulk tier sheds FIRST
        and the interactive tier keeps its p99 inside the SLO."""
        now = time.monotonic()
        with self._lock:
            bucket = self._tenant_buckets.get(tenant)
            if bucket is None and self._default_quota is not None:
                if len(self._tenant_buckets) >= MAX_TENANT_ROWS:
                    bucket = self._tenant_buckets.get("__other__")
                    if bucket is None:
                        bucket = self._tenant_buckets["__other__"] = (
                            TokenBucket(*self._default_quota, now)
                        )
                else:
                    bucket = self._tenant_buckets[tenant] = TokenBucket(
                        *self._default_quota, now
                    )
            if bucket is not None and not bucket.take(now):
                # stats.inc nests RouterStats._lock under Router._lock —
                # the same order _eject_locked already established
                self.stats.inc("shed_quota")
                return b"quota"
            if self._replica_capacity:
                admitted = 0
                inflight = 0
                for r in self._replicas:
                    if r.admitted and not r.removed:
                        admitted += 1
                        inflight += r.inflight
                capacity = admitted * self._replica_capacity
                if qos == protocol.QOS_BULK:
                    if inflight >= int(capacity * self._bulk_fraction):
                        self.stats.inc("shed_bulk_capacity")
                        return b"bulk_capacity"
                elif inflight >= capacity:
                    self.stats.inc("shed_capacity")
                    return b"capacity"
        return None

    def _route(
        self,
        obs,
        deadline_us: int,
        req_id: int,
        reply,
        policy: str = protocol.DEFAULT_POLICY,
        qos: int = protocol.QOS_INTERACTIVE,
        tenant: str = "",
    ) -> None:
        """Dispatch one decoded request; ``reply`` is the per-connection
        frame writer. Exactly one reply per request, on every path — the
        accounting identity (aggregate AND per tenant/class) depends on
        it."""
        t0 = time.perf_counter()
        deadline_ms = deadline_us / 1e3 if deadline_us else None
        state = {"backoff": None, "exclude": []}

        def answered(outcome: int) -> None:
            # one call per request, on exactly one path — outcome offsets:
            # 1 = ok, 2 = overloaded, 3 = error (RouterStats row layout)
            self.stats.tenant_outcome(tenant, qos, outcome)

        def attempt():
            remaining_ms = None
            if deadline_ms is not None:
                # the client's deadline is a budget for the whole request,
                # not per attempt: a failover re-dispatch gets what's LEFT
                # (a first replica that burned the budget before shedding
                # must yield an honest OVERLOADED, not a reply at 2x the
                # declared deadline)
                remaining_ms = (
                    deadline_ms - (time.perf_counter() - t0) * 1e3
                )
                if remaining_ms <= 0:
                    self.stats.inc("replies_overloaded")
                    answered(2)
                    reply(protocol.OVERLOADED, req_id, b"deadline")
                    return
            replica, client = self._pick(state["exclude"], policy)
            if replica is None:
                self.stats.inc("replies_overloaded")
                answered(2)
                reply(protocol.OVERLOADED, req_id, b"no_replicas")
                return
            kill_pid = None
            if self._chaos is not None:
                e = self._chaos.tick("replica_kill")
                if e is not None:
                    kill_pid = replica.pid
            # Forward at the lowest frame version the request needs: any
            # DEFAULT-policy request rides the v1 ACT frame — qos and
            # tenant are ROUTER-admission concerns the replica discards,
            # so forwarding them would only break old (v1-only) replicas
            # behind this router (a v2 frame tears down the shared
            # pipelined link with a version error, failing every request
            # in flight on it). Only a non-default policy needs ACT2.
            fut = client.act_async(
                obs, remaining_ms,
                policy_id=(
                    None if policy == protocol.DEFAULT_POLICY else policy
                ),
            )
            if kill_pid:
                # AFTER the send: the request is on the wire — this is the
                # mid-stream replica death the failover contract covers.
                try:
                    os.kill(int(kill_pid), signal.SIGKILL)
                except (OSError, ValueError) as e:
                    print(f"[router] chaos replica_kill failed: {e}",
                          flush=True)

            def done(f, replica=replica):
                with self._lock:
                    replica.inflight -= 1
                    replica.last_progress = time.monotonic()
                exc = f.exception()
                lat = time.perf_counter() - t0
                ro = self._rollouts.get(policy)
                if exc is None:
                    with self._lock:
                        replica.ok += 1
                        if ro is not None:
                            ro.windows[
                                "canary" if policy in replica.canary_for
                                else "baseline"
                            ].append((True, lat))
                    self.stats.inc("replies_ok")
                    self.stats.add_latency(lat, qos)
                    answered(1)
                    reply(protocol.ACT_OK, req_id,
                          # inside f's own done-callback: resolved by
                          # definition, result() cannot block
                          protocol.encode_action(f.result()))  # done-callback, future resolved
                    return
                if isinstance(exc, (Overloaded, ConnectionClosed)):
                    bo = state["backoff"]
                    if bo is None:
                        # base_s=0: with another replica available the
                        # failover is immediate; the Backoff's job here is
                        # the bounded ATTEMPT budget (and determinism under
                        # --chaos via the seeded rng).
                        bo = state["backoff"] = Backoff(
                            base_s=0.0, jitter=0.0,
                            max_attempts=self._dispatch_retries,
                            rng=self._retry_rng,
                        )
                    delay = bo.next_delay()
                    if delay is not None:
                        state["exclude"].append(replica.index)
                        self.stats.inc("retries")
                        if delay:
                            time.sleep(delay)
                        attempt()
                        return
                with self._lock:
                    replica.errors += 1
                    if ro is not None and not isinstance(exc, Overloaded):
                        ro.windows[
                            "canary" if policy in replica.canary_for
                            else "baseline"
                        ].append((False, lat))
                if isinstance(exc, Overloaded):
                    self.stats.inc("replies_overloaded")
                    answered(2)
                    reply(protocol.OVERLOADED, req_id,
                          str(exc).encode() or b"overloaded")
                else:
                    self.stats.inc("replies_error")
                    answered(3)
                    reply(protocol.ERROR, req_id,
                          f"failed after bounded retry: {exc}".encode())

            fut.add_done_callback(done)

        attempt()

    # -------------------------------------------------- synthetic chaos load
    @staticmethod
    def _sink(_msg_type, _req_id, _payload=b"") -> None:
        """Reply writer for synthetic chaos requests: the outcome counters
        tally through the normal _route path; there is no socket to
        answer."""

    def _inject_synthetic(self, policy: str, qos: int, tenant: str,
                          n: int) -> int:
        """Push ``n`` synthetic requests for ``policy`` through the REAL
        admission + dispatch path (counted in requests_total and every
        per-tenant/class identity row — the identity stays exact because
        synthetic traffic is accounted exactly like real traffic).
        Returns how many were injected (0 when the policy's obs_dim is
        still unknown)."""
        dim = self._obs_dims.get(policy)
        if dim is None and policy == protocol.DEFAULT_POLICY:
            dim = self._obs_dim
        if dim is None:
            return 0
        obs = np.zeros(dim, np.float32)
        for _ in range(n):
            self.stats.inc("requests_total")
            self.stats.tenant_request(tenant, qos)
            shed = self._admit_tenant(tenant, qos)
            if shed is not None:
                self.stats.inc("replies_overloaded")
                self.stats.tenant_outcome(tenant, qos, 2)
                continue
            self._route(obs, 0, 0, self._sink,
                        policy=policy, qos=qos, tenant=tenant)
        return n

    def _inject_flood(self, tenant: str, n: int) -> None:
        """The ``tenant_flood`` chaos site: a burst of BULK-class requests
        from one named tenant. Under the admission contracts most of it
        sheds at the tenant's quota / the bulk capacity line — which is
        the point: the soak asserts interactive p99 holds through it."""
        self._record_event("chaos_tenant_flood", tenant=tenant, n=n)
        self._inject_synthetic(
            protocol.DEFAULT_POLICY, protocol.QOS_BULK, tenant, n
        )

    def _inject_skew(self, n: int) -> None:
        """The ``policy_skew`` chaos site: 95% of a synthetic burst hits
        the default policy, 5% spreads over the other known policies —
        the cold policies' real traffic must still meet its deadlines
        (their batchers are independent; the shared resource is the
        host/device, which is what the soak measures)."""
        with self._lock:
            cold = sorted(
                p for p in self._obs_dims if p != protocol.DEFAULT_POLICY
            )
        self._record_event("chaos_policy_skew", n=n, cold_policies=cold)
        hot = int(n * 0.95) if cold else n
        self._inject_synthetic(
            protocol.DEFAULT_POLICY, protocol.QOS_BULK, "skew_tenant", hot
        )
        if cold:
            per = max(1, (n - hot) // len(cold))
            for p in cold:
                self._inject_synthetic(
                    p, protocol.QOS_BULK, "skew_tenant", per
                )

    # ------------------------------------------------------------ client side
    def _on_conn_open(self, conn) -> None:
        # Connection-level chaos sites fire at accept: each launches a
        # loop-timer-driven attacker against this router's own listener
        # (slowloris trickle / zero-window staller / fd hoard), proving
        # the eviction machinery on live traffic.
        if self._chaos is not None:
            netio_attack.tick_attacks(
                self._chaos, self._loop, self.host, self.port
            )

    def _on_conn_close(self, conn) -> None:
        if self._tap is not None:
            # vanished client: drop its half-built mirror window whole
            self._tap.on_disconnect(id(conn))

    def _on_protocol_error(self, conn, exc) -> None:
        # Framing is per-connection state: connection-fatal ERROR (req_id
        # 0), then the loop flush-closes. Other connections are untouched.
        self.stats.inc("protocol_errors")
        conn.send(protocol.ERROR, 0, str(exc).encode())

    def _reply(self, conn, msg_type: int, req_id: int,
               payload: bytes = b"") -> None:
        if not conn.send(msg_type, req_id, payload):
            # Client gone before its reply (disconnect-mid-request) or
            # evicted for stalling: count the computed-but-undeliverable
            # reply, same as the thread path's OSError branch did.
            self.stats.inc("dropped_replies")

    def _serve_conn(self, conn, msg_type: int, req_id: int,
                    payload: bytes) -> None:
        """One complete frame, on the loop thread. Must not block — the
        dispatch tier (``_route``) is already asynchronous (replica link
        done-callbacks), so the only stall the thread path tolerated
        here, the ``replica_slow`` chaos sleep, becomes a loop timer.
        Raising :class:`ProtocolError` routes to ``_on_protocol_error``
        (connection-fatal), like a framing error from the byte stream."""

        def reply(msg_type: int, req_id: int, payload: bytes = b"") -> None:
            self._reply(conn, msg_type, req_id, payload)

        if msg_type == protocol.HEALTHZ:
            reply(protocol.HEALTHZ_OK, req_id,
                  json.dumps(self.healthz()).encode())
            return
        if msg_type == protocol.ACT:
            # v1: default policy, interactive class, anonymous
            # tenant — old clients negotiate down implicitly
            policy = protocol.DEFAULT_POLICY
            qos = protocol.QOS_INTERACTIVE
            tenant = ""
            obs_dim = self._obs_dim
            if obs_dim is None:
                # no replica has ever answered a probe: obs_dim
                # (and the fleet) is unknown — shed honestly
                self.stats.inc("requests_total")
                self.stats.inc("replies_overloaded")
                reply(protocol.OVERLOADED, req_id, b"no_replicas")
                return
            obs, deadline_us = protocol.decode_act(payload, obs_dim)
        elif msg_type == protocol.ACT2:
            obs, deadline_us, policy, qos, tenant = (
                protocol.decode_act2(payload)
            )
            known = self._obs_dims.get(policy)
            if known is not None and obs.shape[0] != known:
                self.stats.inc("requests_total")
                self.stats.tenant_request(tenant, qos)
                self.stats.inc("replies_error")
                self.stats.tenant_outcome(tenant, qos, 3)
                reply(
                    protocol.ERROR, req_id,
                    f"obs is {obs.shape[0]}-dim, policy "
                    f"{policy!r} wants {known}".encode(),
                )
                return
        elif msg_type == protocol.FEEDBACK:
            # Reward echo for THIS connection's previous request —
            # handled LOCALLY (the router decoded the obs, so it
            # can pair the feedback itself; forwarding would need
            # replica-sticky feedback routing for no benefit).
            # Always acked: clients need not know whether a tap
            # rides this router.
            fb = protocol.decode_feedback(payload)
            self.stats.inc("feedback_frames")
            if (
                self._tap is not None
                and fb["policy_id"] == protocol.DEFAULT_POLICY
            ):
                self._tap.on_feedback(id(conn), fb)
            reply(protocol.FEEDBACK_OK, req_id)
            return
        else:
            raise ProtocolError(f"unexpected message type {msg_type}")
        if (
            self._tap is not None
            and policy == protocol.DEFAULT_POLICY
        ):
            # remember the obs this connection's next FEEDBACK
            # pairs with
            self._tap.on_request(id(conn), obs)
        self.stats.inc("requests_total")
        self.stats.tenant_request(tenant, qos)
        if self._shutdown.is_set():
            self.stats.inc("replies_overloaded")
            self.stats.tenant_outcome(tenant, qos, 2)
            reply(protocol.OVERLOADED, req_id, b"draining")
            return
        if self._chaos is not None:
            e = self._chaos.tick("replica_slow")
            if e is not None:
                # stall THIS request's dispatch (a slow replica as seen
                # by one request): p99 must account it, other connections
                # must not feel it — so the stall is a loop TIMER, never
                # a sleep on the loop thread
                self._loop.call_later(
                    (e.arg if e.arg is not None else 100.0) / 1e3,
                    self._admit_and_route,
                    conn, req_id, obs, deadline_us, policy, qos, tenant,
                )
                return
            e = self._chaos.tick("tenant_flood")
            if e is not None:
                # synthetic bulk flood from the named tenant: real
                # load through the real admission + dispatch path
                # (counted in every identity surface) — proves
                # interactive isolation under a misbehaving tenant
                self._inject_flood(
                    e.label or "flood_tenant", self._flood_burst
                )
            e = self._chaos.tick("policy_skew")
            if e is not None:
                # 95% of a synthetic burst hits the default
                # policy; the cold policies' requests ride along
                # and must still meet their deadlines
                self._inject_skew(self._flood_burst)
        self._admit_and_route(
            conn, req_id, obs, deadline_us, policy, qos, tenant
        )

    def _admit_and_route(self, conn, req_id, obs, deadline_us, policy,
                         qos, tenant) -> None:
        """Admission (quota first, then the class-aware capacity check —
        sheds here never reach a replica) and dispatch for one already-
        counted request. Split out of ``_serve_conn`` so a
        ``replica_slow`` stall can defer it on a loop timer."""

        def reply(msg_type: int, req_id: int, payload: bytes = b"") -> None:
            self._reply(conn, msg_type, req_id, payload)

        shed = self._admit_tenant(tenant, qos)
        if shed is not None:
            self.stats.inc("replies_overloaded")
            self.stats.tenant_outcome(tenant, qos, 2)
            reply(protocol.OVERLOADED, req_id, shed)
            return
        self._route(obs, deadline_us, req_id, reply,
                    policy=policy, qos=qos, tenant=tenant)

    # ------------------------------------------------------- canary rollout
    def _canary_step(self) -> None:
        """One control tick for EVERY per-policy rollout. The machines
        are independent: policy A deploying while policy B observes is
        normal, and no step of one ever touches another's replicas,
        bundle dirs, windows, or readmit gates."""
        for ro in self._rollouts.values():
            state = ro.state
            if state == "idle":
                self._canary_idle(ro)
            elif state == "deploying":
                self._canary_check_deploys(ro)
            elif state == "observing":
                self._canary_observe(ro)
            elif state == "promoting":
                self._canary_promote(ro)
            elif state == "rolling_back":
                self._canary_check_rollback(ro)

    def _set_canary_state(self, ro: _Rollout, state: str) -> None:
        with self._lock:
            ro.state = state

    def _clear_windows(self, ro: _Rollout) -> None:
        with self._lock:
            ro.windows["baseline"].clear()
            ro.windows["canary"].clear()

    def _removed_mid_rollout(self, ro: _Rollout) -> Optional[list]:
        """Replica indices the rollout touched that were REMOVED
        (scale-down) — an active rollout must abort rather than wait on a
        replica that no longer exists, and the abort's restore is what
        un-strands the removed replica's half-deployed bundle dir."""
        with self._lock:
            touched = (
                set(ro.backed_up)
                | set(ro.deploys)
                | {
                    r.index for r in self._replicas
                    if ro.policy in r.canary_for
                }
            )
            removed = sorted(
                i for i in touched if self._replicas[i].removed
            )
        return removed or None

    def _canary_idle(self, ro: _Rollout) -> None:
        m = _bundle_json_mtime(ro.src_dir)
        if m is None or m == ro.seen_mtime:
            return
        with self._lock:
            eligible = [
                r for r in self._replicas
                if r.admitted and not r.removed
                and ro.policy in r.bundle_dirs
            ]
            total = len([r for r in self._replicas if not r.removed])
        if len(eligible) < 2:
            # a canary needs at least one baseline to compare against;
            # keep waiting (the bookmark does NOT advance — the rollout
            # starts as soon as the fleet is healthy enough)
            return
        n_canary = min(max(1, round(self._canary_permille / 1000 * total)),
                       len(eligible) - 1)
        # deterministic choice: the highest-index eligible replicas
        canaries = sorted(eligible, key=lambda r: -r.index)[:n_canary]
        ro.seen_mtime = m
        ro.version = m
        ro.rollback_dir = tempfile.mkdtemp(
            prefix=f"d4pg-router-rollback-{ro.policy}-"
        )
        ro.backed_up = set()
        deploys = {}
        try:
            for r in canaries:
                self._backup_bundle(ro, r)
                corrupt = False
                if self._chaos is not None:
                    corrupt = self._chaos.tick("canary_corrupt") is not None
                deploys[r.index] = self._deploy_bundle(
                    ro.src_dir, r.bundle_dirs[ro.policy], corrupt=corrupt
                )
        except OSError as e:
            # Mid-deploy I/O failure (ENOSPC, unreadable canary source, a
            # missing replica bundle file): any canary ALREADY rolled
            # forward must not be left serving the new bundle as a phantom
            # baseline. Route through the normal rollback — it restores
            # every replica in backed_up and re-ejects until the old
            # version attests; the bookmark stays advanced so a broken
            # rollout is reported once, not retried every probe tick.
            self._canary_rollback(ro, f"deploy I/O error: {e!r}")
            return
        with self._lock:
            for r in canaries:
                r.canary_for.add(ro.policy)
            ro.state = "deploying"
        ro.deploys = deploys
        ro.deadline = time.monotonic() + self._attest_timeout_s
        self._clear_windows(ro)
        self._record_event(
            "canary_start", policy=ro.policy, version=m,
            canaries=[r.index for r in canaries],
            fraction=self._canary_permille / 1000.0,
        )

    def _canary_check_deploys(self, ro: _Rollout) -> None:
        removed = self._removed_mid_rollout(ro)
        if removed:
            self._canary_rollback(
                ro, f"replicas {removed} removed (scale-down) mid-deploy"
            )
            return
        with self._lock:
            canaries = [
                r for r in self._replicas if ro.policy in r.canary_for
            ]
            attested = all(
                r.policy_mtimes.get(ro.policy) == ro.deploys.get(r.index)
                and r.admitted
                for r in canaries
            )
            failed = [
                r.index for r in canaries
                if not r.admitted or r.health.get("status") == "degraded"
            ]
        if attested:
            self._set_canary_state(ro, "observing")
            # observing gets its own deadline: every other rollout state
            # is bounded, and a fleet with too little traffic to fill the
            # comparison windows must eventually roll back (frozen canary
            # traffic + a rollout that blocks every newer version forever
            # is worse than retrying later under real load)
            ro.deadline = time.monotonic() + self._observe_timeout_s
            self._clear_windows(ro)
            # fresh observation phase → fresh gate: the token fences any
            # still-running gate worker from a previous phase out of
            # writing into this one
            ro.gate_started = False
            ro.gate_result = None
            ro.gate_token += 1
            self._record_event("canary_observing", policy=ro.policy,
                               version=ro.version)
        elif failed or time.monotonic() > ro.deadline:
            self._canary_rollback(
                ro,
                f"deploy failed on replicas {failed}" if failed
                else "deploy attestation timed out"
            )

    def _canary_observe(self, ro: _Rollout) -> None:
        removed = self._removed_mid_rollout(ro)
        if removed:
            self._canary_rollback(
                ro,
                f"replicas {removed} removed (scale-down) mid-observation"
            )
            return
        with self._lock:
            dead = [r.index for r in self._replicas
                    if ro.policy in r.canary_for and not r.admitted]
            base = list(ro.windows["baseline"])
            can = list(ro.windows["canary"])
        if dead:
            self._canary_rollback(ro, f"canary replicas {dead} ejected "
                                  "mid-observation")
            return
        if len(base) < self._min_samples or len(can) < self._min_samples:
            if time.monotonic() > ro.deadline:
                self._canary_rollback(
                    ro,
                    f"observation starved: windows never filled "
                    f"({len(base)} baseline / {len(can)} canary of "
                    f"{self._min_samples} required)"
                )
            return
        base_err = 1.0 - sum(ok for ok, _ in base) / len(base)
        can_err = 1.0 - sum(ok for ok, _ in can) / len(can)
        base_p99 = _p99([lat for ok, lat in base if ok])
        can_p99 = _p99([lat for ok, lat in can if ok])
        verdict = {
            "baseline_error_rate": round(base_err, 4),
            "canary_error_rate": round(can_err, 4),
            "baseline_p99_ms": _ms(base_p99),
            "canary_p99_ms": _ms(can_p99),
            "samples": [len(base), len(can)],
        }
        if can_err > base_err + self._max_err_increase:
            self._canary_rollback(
                ro,
                f"error-rate regression {can_err:.4f} vs {base_err:.4f}",
                **verdict,
            )
        elif (
            base_p99 is not None and can_p99 is not None
            and can_p99 > base_p99 * self._p99_ratio + 0.010
        ):
            self._canary_rollback(
                ro,
                f"p99 regression {_ms(can_p99)} ms vs {_ms(base_p99)} ms",
                **verdict,
            )
        else:
            # The live verdict (errors + p99) passed. A bad-but-valid
            # bundle shows NEITHER signal — it serves cleanly while
            # steering the plant wrong — so when an off-policy gate is
            # configured, promotion additionally needs its IS-estimate
            # verdict over the MIRRORED windows (flywheel/gate.py).
            if self._gate_spool is not None:
                if not ro.gate_started:
                    # kick the evaluation off-thread (spool read + policy
                    # load may block; gate_stall chaos sleeps in there)
                    # and keep observing until it resolves
                    ro.gate_started = True
                    ro.gate_result = None
                    token = ro.gate_token
                    self.stats.inc("gate_evaluations")
                    self._record_event("gate_evaluating", policy=ro.policy,
                                       version=ro.version)
                    threading.Thread(
                        target=self._gate_worker, args=(ro, token),
                        name="router-gate", daemon=True,
                    ).start()
                    return
                gate = ro.gate_result
                if gate is None:
                    if time.monotonic() > ro.deadline:
                        # the observe deadline bounds the gate too: a
                        # wedged evaluation must not hold the rollout —
                        # and every newer version behind it — forever
                        # (the rollback books the stall)
                        self._canary_rollback(
                            ro,
                            "promotion gate stalled past observe deadline",
                            **verdict,
                        )
                    return
                if not gate.get("passed"):
                    self.stats.inc("gate_block")
                    self._canary_rollback(
                        ro,
                        f"off-policy gate: {gate.get('reason')}",
                        gate=gate, **verdict,
                    )
                    return
                self.stats.inc("gate_pass")
                verdict["gate"] = gate
            # canary_promotions ticks at COMPLETION (the canary_promoted
            # terminal in _canary_promote), not here at the verdict: a
            # promote that later fails (deploy I/O, attestation timeout)
            # ends in a rollback, and one rollout must never book both
            ro.promote_done = set()
            ro.deploys = {}
            self._set_canary_state(ro, "promoting")
            self._record_event("canary_promote", policy=ro.policy,
                               version=ro.version, **verdict)

    def _abandon_gate(self, ro: _Rollout) -> None:
        """An evaluation still running when its observation ends (a
        rollback for any reason, the observe deadline's included, or the
        router's drain) never books pass or block: book it stalled, once,
        so ``gate_evaluations == gate_pass + gate_block + gate_stalls``
        holds at every drain. The JAX router books a stall only at the
        observe deadline, and its identity breaks when a live verdict,
        an ejection or a drain ends the observation first."""
        if ro.gate_started and ro.gate_result is None:
            self.stats.inc("gate_stalls")
        ro.gate_started = False

    def _gate_worker(self, ro: _Rollout, token: int) -> None:
        """One off-policy gate evaluation (its own thread): estimate the
        CANDIDATE bundle's return on the mirror spool's logged behavior
        windows. Any failure becomes a refusing verdict — a gate that
        dies must block the promotion loudly, never wedge or wave it
        through."""
        try:
            if self._chaos is not None:
                e = self._chaos.tick("gate_stall")
                if e is not None:
                    # stall INSIDE the evaluation (a wedged spool read /
                    # slow shared filesystem): the control thread must
                    # roll back at the observe deadline, not wait forever
                    time.sleep(e.arg if e.arg is not None else 3600.0)
            from d4pg_tpu_torch.fleet.policy import load_numpy_policy
            from d4pg_tpu_torch.flywheel.gate import evaluate_is_gate
            from d4pg_tpu_torch.flywheel.spool import read_windows

            pol = load_numpy_policy(ro.src_dir)
            cols, _n = read_windows(
                self._gate_spool, pol.obs_dim, pol.action_dim,
                max_windows=self._gate_max_windows,
            )
            verdict = evaluate_is_gate(
                cols, pol,
                sigma=self._gate_sigma,
                min_windows=self._gate_min_windows,
                min_ess=self._gate_min_ess,
                band=self._gate_band,
            )
        except Exception as e:
            # every failure class (missing spool, unreadable bundle, bad
            # dims) becomes a REFUSING verdict carrying the repr, logged
            # through the canary_rollback event, never swallowed
            verdict = {
                "samples": 0, "passed": False,
                "reason": f"gate evaluation failed: {e!r}",
            }
        if ro.gate_token == token:
            ro.gate_result = verdict

    def _canary_promote(self, ro: _Rollout) -> None:
        """Roll the remaining baselines forward ONE at a time, each
        attested before the next — a bad surprise mid-promote strands one
        replica, not the fleet."""
        removed = self._removed_mid_rollout(ro)
        if removed:
            self._canary_rollback(
                ro, f"replicas {removed} removed (scale-down) mid-promote"
            )
            return
        with self._lock:
            baselines = [r for r in self._replicas
                         if ro.policy in r.bundle_dirs
                         and ro.policy not in r.canary_for
                         and not r.removed]
            pending = [r for r in baselines if r.index in ro.deploys]
            for r in pending:
                if (
                    r.policy_mtimes.get(ro.policy) == ro.deploys[r.index]
                    and r.admitted
                ):
                    ro.promote_done.add(r.index)
                    del ro.deploys[r.index]
        for r in pending:
            if r.index in ro.promote_done:
                self._record_event("promoted_replica", policy=ro.policy,
                                   replica=r.index)
        if ro.deploys:
            if time.monotonic() > ro.deadline:
                self._canary_rollback(
                    ro,
                    f"promote attestation timed out on "
                    f"{sorted(ro.deploys)}"
                )
            return
        nxt = next(
            (r for r in baselines if r.index not in ro.promote_done), None
        )
        if nxt is not None:
            try:
                self._backup_bundle(ro, nxt)
                mt = self._deploy_bundle(
                    ro.src_dir, nxt.bundle_dirs[ro.policy]
                )
            except OSError as e:
                # same contract as the idle-path deploy guard: a promote
                # whose source vanished or whose disk filled must roll the
                # whole rollout back, not spin in "promoting" re-raising
                # into the control loop's catch-all every tick
                self._canary_rollback(
                    ro, f"deploy I/O error during promote: {e!r}"
                )
                return
            ro.deploys = {nxt.index: mt}
            ro.deadline = time.monotonic() + self._attest_timeout_s
            self._record_event("promote_replica", policy=ro.policy,
                               replica=nxt.index)
            return
        # nxt is None: every baseline rolled forward — terminal event
        # BEFORE the state flip: a healthz reader that polls for
        # state=="idle" must find the terminal event already in
        # events_tail (the soak and tests do exactly that)
        self.stats.inc("canary_promotions")
        self._record_event("canary_promoted", policy=ro.policy,
                           version=ro.version)
        with self._lock:
            for r in self._replicas:
                r.canary_for.discard(ro.policy)
            ro.state = "idle"
        self._cleanup_rollback_dir(ro)

    def _canary_rollback(self, ro: _Rollout, reason: str, **verdict) -> None:
        """Restore every replica the rollout touched to the saved old
        bundle for THIS policy and RE-EJECT it until its healthz attests
        that old version (then the normal K-consecutive-probes
        re-admission applies). Baselines that were never deployed to —
        and every other policy's bundles — are never touched. A REMOVED
        replica still gets its bundle dir restored (nothing half-deployed
        may remain on disk) but is never gated or ejected: it has already
        left the fleet."""
        # State flips FIRST: once canary_rollbacks ticks (next line), a
        # healthz reader must never see the rollout still "idle"/
        # "observing" — a rollback entered from idle (deploy I/O error)
        # does file restores below before the gates land, and that window
        # read as a settled fleet.
        with self._lock:
            ro.state = "rolling_back"
        self._abandon_gate(ro)
        # deadline BEFORE the restores: if one raises below, the next
        # _canary_check_rollback tick must compare against a real deadline,
        # not a stale/None one (TypeError every control tick = a
        # permanently wedged rollout machine)
        ro.rollback_deadline = time.monotonic() + 4 * self._attest_timeout_s
        self.stats.inc("canary_rollbacks")
        self._record_event("canary_rollback", policy=ro.policy,
                           reason=reason, version=ro.version, **verdict)
        gates = {}
        restore_failed = []
        for i in sorted(ro.backed_up):
            r = self._replicas[i]
            try:
                gates[i] = self._deploy_bundle(
                    os.path.join(ro.rollback_dir, str(i)),
                    r.bundle_dirs[ro.policy],
                )
            except OSError as e:
                # the restore itself failed (ENOSPC again, backup dir
                # damaged): no version to gate re-admission on — eject the
                # replica below anyway (its probes decide re-admission) and
                # say so loudly; the rollback deadline bounds the wait
                restore_failed.append((i, e))
        to_close = []
        ejected = []
        with self._lock:
            for i in sorted(ro.backed_up):
                r = self._replicas[i]
                if r.removed:
                    continue  # restored above; no gate, no eject
                if i in gates:
                    self._readmit_gate[(i, ro.policy)] = gates[i]
                if r.admitted:
                    to_close.append(self._eject_locked(r, "rollback"))
                    ejected.append(i)
                else:
                    r.healthy_streak = 0
        ro.deploys = {}
        for c in to_close:
            if c is not None:
                try:
                    c.close()
                except OSError:
                    pass
        for i, e in restore_failed:
            self._record_event("rollback_restore_failed", policy=ro.policy,
                               replica=i, error=repr(e))
        for i in ejected:
            self._record_event("eject", replica=i,
                               addr=self._replicas[i].addr, reason="rollback")

    def _canary_check_rollback(self, ro: _Rollout) -> None:
        with self._lock:
            # every replica the rollout DEPLOYED to (canaries, plus any
            # baseline a failed promote already rolled forward) must attest
            # the restored bundle and re-admit before the rollback is done
            # — except removed replicas, which left the fleet (their dirs
            # were restored; there is no process to wait for)
            waiting = [
                r.index for r in self._replicas
                if r.index in ro.backed_up and not r.removed
                and ((r.index, ro.policy) in self._readmit_gate
                     or not r.admitted)
            ]
        if not waiting:
            # terminal event BEFORE the state flip (see _canary_promote)
            self._record_event("canary_rolled_back", policy=ro.policy,
                               version=ro.version)
            with self._lock:
                for r in self._replicas:
                    r.canary_for.discard(ro.policy)
                ro.state = "idle"
            self._cleanup_rollback_dir(ro)
            return
        if time.monotonic() > ro.rollback_deadline:
            # the replica never came back (killed and not restarted?) —
            # stop gating on it so a fresh process serving the restored
            # bundle can re-admit normally, and say so loudly
            self._record_event("canary_rollback_timeout", policy=ro.policy,
                               version=ro.version, waiting=waiting)
            with self._lock:
                for r in self._replicas:
                    r.canary_for.discard(ro.policy)
                for key in [
                    k for k in self._readmit_gate if k[1] == ro.policy
                ]:
                    del self._readmit_gate[key]
                ro.state = "idle"
            self._cleanup_rollback_dir(ro)

    def _backup_bundle(self, ro: _Rollout, r: Replica) -> None:
        if r.index in ro.backed_up:
            # never overwrite the pristine pre-rollout copy: a re-entered
            # promote step after a partial deploy would otherwise save the
            # half-deployed dir (new params + old json) AS the backup, and
            # a later rollback would restore that corrupt mixture
            return
        dst = os.path.join(ro.rollback_dir, str(r.index))
        os.makedirs(dst, exist_ok=True)
        for fname in (_PARAMS_FILE, _META_FILE):
            shutil.copyfile(
                os.path.join(r.bundle_dirs[ro.policy], fname),
                os.path.join(dst, fname),
            )
        ro.backed_up.add(r.index)

    def _deploy_bundle(self, src_dir: str, dst_dir: str,
                       corrupt: bool = False) -> float:
        """Roll ``dst_dir`` (a replica's live bundle) onto ``src_dir``'s
        content: params FIRST, json second, each tmp+rename — the
        exporter's atomic attestation ordering, reproduced because the
        router IS an exporter when it rolls a replica forward. Returns the
        new json mtime (the version the replica must attest via healthz).
        ``corrupt`` is the ``canary_corrupt`` chaos fault: truncate the
        params copy so the replica's reload fails AFTER the attestation
        moved — the degraded-not-promoted path."""
        os.makedirs(dst_dir, exist_ok=True)
        for fname in (_PARAMS_FILE, _META_FILE):
            src = os.path.join(src_dir, fname)
            fd, tmp = tempfile.mkstemp(dir=dst_dir, suffix=".tmp")
            os.close(fd)
            try:
                shutil.copyfile(src, tmp)
                if corrupt and fname == _PARAMS_FILE:
                    size = os.path.getsize(tmp)
                    with open(tmp, "rb+") as f:
                        f.truncate(max(1, size // 2))
                    print(f"[router] chaos canary_corrupt: truncated "
                          f"{fname} for {dst_dir}", flush=True)
                os.replace(tmp, os.path.join(dst_dir, fname))
            except BaseException:
                if os.path.exists(tmp):
                    os.remove(tmp)
                raise
        return os.stat(os.path.join(dst_dir, _META_FILE)).st_mtime

    def _cleanup_rollback_dir(self, ro: _Rollout) -> None:
        if ro.rollback_dir is not None:
            shutil.rmtree(ro.rollback_dir, ignore_errors=True)
            ro.rollback_dir = None
        ro.backed_up = set()

    # ----------------------------------------------------------------- status
    # healthz keeps at most this many REMOVED replica rows (newest first
    # by index): scale-down tombstones stay in _replicas forever for
    # index stability, and without a bound a long-lived autoscaled
    # router would serialize every dead row into every probe reply.
    _HEALTHZ_REMOVED_ROWS = 16

    def healthz(self) -> dict:
        with self._lock:
            removed_idx = [r.index for r in self._replicas if r.removed]
            drop = set(removed_idx[:-self._HEALTHZ_REMOVED_ROWS]) \
                if len(removed_idx) > self._HEALTHZ_REMOVED_ROWS else set()
            replicas = [
                {
                    "index": r.index,
                    "addr": r.addr,
                    "admitted": r.admitted,
                    "removed": r.removed,
                    "ejected_reason": r.ejected_reason,
                    "canary": sorted(r.canary_for),
                    "policies": list(r.policies),
                    "inflight": r.inflight,
                    "healthy_streak": r.healthy_streak,
                    "bundle_mtime": r.bundle_mtime,
                    "policy_mtimes": dict(r.policy_mtimes),
                    "pid": r.pid,
                    "replica_id": r.health.get("replica_id"),
                    "status": r.health.get("status"),
                    "compile_count": r.health.get("compile_count"),
                    "params_reloads": r.health.get("params_reloads"),
                    "ok": r.ok,
                    "errors": r.errors,
                }
                for r in self._replicas
                if r.index not in drop
            ]
            admitted = sum(
                1 for r in self._replicas if r.admitted and not r.removed
            )
            inflight = sum(
                r.inflight for r in self._replicas if not r.removed
            )
            rollouts = {
                pol: ro.snapshot_row(self._canary_permille)
                for pol, ro in self._rollouts.items()
            }
            obs_dim = self._obs_dim
            obs_dims = dict(self._obs_dims)
            capacity = admitted * self._replica_capacity
        snap = self.stats.snapshot()
        snap["router"] = True
        snap["status"] = "draining" if self._shutdown.is_set() else (
            "ok" if admitted else "degraded"
        )
        snap["draining"] = self._shutdown.is_set()
        snap["admitted"] = admitted
        snap["inflight"] = inflight
        snap["obs_dim"] = obs_dim
        snap["obs_dims"] = obs_dims
        snap["replicas"] = replicas
        # Back-compat: ``canary`` stays the DEFAULT policy's rollout view
        # (the single-rollout schema); every rollout — default
        # included — also appears under ``rollouts`` keyed by policy.
        default_ro = rollouts.get(protocol.DEFAULT_POLICY)
        snap["canary"] = default_ro if default_ro is not None else {
            "state": "idle",
            "fraction": self._canary_permille / 1000.0,
            "version": None,
            "window_baseline": 0,
            "window_canary": 0,
        }
        snap["rollouts"] = rollouts
        # The multi-tenant admission surface: capacity model + exact
        # per-(tenant, class) accounting rows. answered == requests on
        # every row at quiesce — the machine-checked identity.
        snap["capacity"] = {
            "replica_capacity": self._replica_capacity,
            "bulk_fraction": self._bulk_fraction,
            "total": capacity,
            "bulk_limit": int(capacity * self._bulk_fraction),
        }
        snap["tenants"] = self.stats.tenants_snapshot()
        if self._tap is not None:
            # router-position mirror tap books: the smoke/soak
            # recompute the windows_built identity from this block
            snap["mirror"] = self._tap.counters()
        if self._gate_spool is not None:
            snap["gate"] = {
                "spool": self._gate_spool,
                "sigma": self._gate_sigma,
                "min_windows": self._gate_min_windows,
                "min_ess": self._gate_min_ess,
                "band": self._gate_band,
            }
        with self._events_lock:
            snap["events_total"] = self._events_total
            snap["events_tail"] = list(self._events)[-20:]
        if self._chaos is not None:
            snap["chaos_injections"] = self._chaos.injections_total
        # Event-loop I/O core counters: connection
        # census plus the attack-eviction/shed books — slowloris and
        # zero-window evictions, EMFILE accept sheds.
        snap["netio"] = self._loop.stats()
        return snap

    def _metrics_row(self) -> dict:
        """Numeric-only flat row (MetricsLogger contract)."""
        snap = self.stats.snapshot()
        for cls in ("interactive", "bulk"):
            sub = snap.pop(cls, None) or {}
            for k, v in sub.items():
                if v is not None:
                    snap[f"{cls}_{k}"] = v
        with self._lock:
            snap["admitted"] = sum(
                1 for r in self._replicas if r.admitted and not r.removed
            )
            snap["inflight"] = sum(
                r.inflight for r in self._replicas if not r.removed
            )
            snap["canary_active"] = float(any(
                ro.state != "idle" for ro in self._rollouts.values()
            ))
        return {
            k: float(v) for k, v in snap.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)
        }

    def _metrics_loop(self) -> None:
        while not self._shutdown.wait(self._metrics_interval_s):
            self._metrics.log(self.stats.requests_total, self._metrics_row())


def _p99(lats) -> Optional[float]:
    if not lats:
        return None
    s = sorted(lats)
    return s[min(len(s) - 1, int(0.99 * len(s)))]


def _ms(v: Optional[float]):
    return None if v is None else round(v * 1e3, 4)


# --------------------------------------------------------------------- CLI
def parse_bundle_spec(spec: str):
    """One --backend-bundles entry: '' -> None, bare DIR -> default
    policy, 'name=dir+name2=dir2' -> multi-policy mapping."""
    if not spec:
        return None
    if "=" not in spec:
        return spec
    out = {}
    for part in spec.split("+"):
        name, sep, path = part.partition("=")
        if not sep or not name or not path:
            raise SystemExit(
                f"--backend-bundles spec wants name=dir[+name=dir...], "
                f"got {part!r}"
            )
        out[name] = path
    return out


def parse_quota(q: str):
    """'RPS[:BURST]' -> (rate, burst); burst defaults to 2×rate."""
    rate_s, _, burst_s = q.partition(":")
    try:
        rate = float(rate_s)
        burst = float(burst_s) if burst_s else 2.0 * rate
    except ValueError:
        raise SystemExit(f"quota wants RPS[:BURST], got {q!r}") from None
    if rate <= 0 or burst < 1:
        raise SystemExit(f"quota must have RPS > 0 and BURST >= 1, got {q!r}")
    return rate, burst


def build_parser():
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m d4pg_tpu_torch.serve.router",
        description="Replicated serving front-end: least-loaded dispatch, "
                    "health-driven ejection, rolling canary rollout.",
    )
    p.add_argument("--backends", required=True,
                   help="comma-separated host:port of the serve/ replicas")
    p.add_argument("--backend-bundles", default=None,
                   help="comma-separated bundle-dir specs, 1:1 with "
                        "--backends (required for canary rollout: the "
                        "router rolls a replica forward by writing into "
                        "its bundle dir). Each spec is a bare DIR (the "
                        "default policy) or 'name=dir+name2=dir2' for a "
                        "multi-policy replica")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7430,
                   help="0 = ephemeral (printed on startup)")
    p.add_argument("--probe-interval", type=float, default=0.5,
                   help="seconds between healthz probe rounds")
    p.add_argument("--probe-timeout", type=float, default=2.0,
                   help="per-probe budget; past it the replica is ejected")
    p.add_argument("--readmit-after", type=int, default=2,
                   help="consecutive healthy probes before (re-)admission")
    p.add_argument("--dispatch-retries", type=int, default=1,
                   help="bounded re-dispatches on a different replica when "
                        "one sheds or dies mid-stream")
    p.add_argument("--stuck-after", type=float, default=30.0,
                   help="eject a replica whose in-flight dispatches stop "
                        "resolving for this many seconds even though its "
                        "healthz still answers ok (a wedged device thread); "
                        "ejection fails the stuck requests over. 0 disables")
    p.add_argument("--retry-seed", type=int, default=0)
    p.add_argument("--wait-replicas", type=int, default=None,
                   help="block startup until N replicas admitted "
                        "(default: all backends)")
    p.add_argument("--wait-timeout", type=float, default=120.0)
    p.add_argument("--canary-bundle", action="append", default=None,
                   metavar="[POLICY=]DIR",
                   help="bundle dir to watch for rollouts: each new "
                        "bundle.json mtime there starts a canary rollout. "
                        "Bare DIR rolls the default policy; POLICY=DIR "
                        "rolls that policy only (repeatable — one "
                        "independent rollout state machine per policy)")
    p.add_argument("--tenant-quota", action="append", default=[],
                   metavar="TENANT=RPS[:BURST]",
                   help="per-tenant token-bucket admission quota "
                        "(repeatable); requests past it shed OVERLOADED "
                        "'quota' before dispatch. BURST defaults to 2×RPS")
    p.add_argument("--default-quota", default=None, metavar="RPS[:BURST]",
                   help="quota applied to tenants without an explicit "
                        "--tenant-quota (unset = unlimited)")
    p.add_argument("--replica-capacity", type=int, default=0,
                   help="per-replica inflight capacity for the "
                        "class-aware shed: fleet capacity = admitted "
                        "replicas × this. Bulk requests shed past "
                        "--bulk-fraction of it, interactive past all of "
                        "it — bulk sheds FIRST under overload. 0 "
                        "disables the class tier (quotas still apply)")
    p.add_argument("--bulk-fraction", type=float, default=0.5,
                   help="fraction of fleet capacity the bulk class may "
                        "occupy before it sheds (the interactive-p99 "
                        "protection knob)")
    p.add_argument("--flood-burst", type=int, default=200,
                   help="synthetic request count per tenant_flood / "
                        "policy_skew chaos injection")
    p.add_argument("--canary-fraction", type=float, default=0.25,
                   help="deterministic request fraction routed to canary "
                        "replicas while observing")
    p.add_argument("--canary-window", type=int, default=256,
                   help="sliding comparison window per group (requests)")
    p.add_argument("--canary-min-samples", type=int, default=40,
                   help="per-group samples required before a verdict")
    p.add_argument("--canary-max-error-increase", type=float, default=0.05,
                   help="canary error rate above baseline+this rolls back")
    p.add_argument("--canary-p99-ratio", type=float, default=3.0,
                   help="canary p99 above baseline*this (+10ms) rolls back")
    p.add_argument("--canary-attest-timeout", type=float, default=30.0,
                   help="seconds a deployed replica gets to attest the new "
                        "bundle_mtime before the rollout rolls back")
    p.add_argument("--canary-observe-timeout", type=float, default=600.0,
                   help="seconds the observation windows get to reach "
                        "--canary-min-samples before the rollout rolls "
                        "back (too little traffic must not wedge a "
                        "rollout in 'observing' forever)")
    g = p.add_argument_group("flywheel (d4pg_tpu_torch/flywheel)")
    g.add_argument("--mirror-fraction", type=float, default=0.0,
                   help="mirror tap at the ROUTER: fraction of served "
                        "episodes (per client connection, Bresenham-"
                        "striped) whose obs/action/reward traffic becomes "
                        "training windows; needs clients that echo reward "
                        "via FEEDBACK frames (flywheel/sim_client.py)")
    g.add_argument("--mirror-bundle", default=None, metavar="DIR",
                   help="bundle dir giving the tap its obs/action dims, "
                        "n-step/gamma, and generation tags (default: the "
                        "first --backend-bundles default-policy dir)")
    g.add_argument("--mirror-ingest", default=None, metavar="HOST:PORT",
                   help="fleet ingest to stream mirrored WINDOWS2 frames "
                        "to (the learner's --fleet-listen port)")
    g.add_argument("--mirror-spool", default=None, metavar="DIR",
                   help="on-disk spool of mirrored frames; also the "
                        "default --gate-spool")
    g.add_argument("--gate-spool", default=None, metavar="DIR",
                   help="arm the off-policy promotion gate on this mirror "
                        "spool: a canary additionally needs its "
                        "importance-weighted return estimate over the "
                        "mirrored windows to clear the gate before it "
                        "promotes (defaults to --mirror-spool when set)")
    g.add_argument("--gate-sigma", type=float, default=0.3,
                   help="exploration σ the behavior propensities were "
                        "logged under (must match the clients' "
                        "--noise-sigma); the candidate is scored as "
                        "N(μ_cand(s), σ²)")
    g.add_argument("--gate-min-windows", type=int, default=16,
                   help="mirrored windows required for a verdict: a "
                        "starved gate refuses, it never guesses")
    g.add_argument("--gate-min-ess", type=float, default=4.0,
                   help="minimum effective sample size: below it the "
                        "candidate is too far off the serving "
                        "distribution to estimate, and is refused")
    g.add_argument("--gate-band", type=float, default=1.0,
                   help="tolerated estimated-return shortfall vs the "
                        "behavior policy before the gate refuses")
    g.add_argument("--gate-max-windows", type=int, default=512,
                   help="newest spool windows the gate evaluates over")
    p.add_argument("--log-dir", default=None,
                   help="append router metrics rows (metrics.jsonl) here")
    p.add_argument("--metrics-interval", type=float, default=30.0)
    p.add_argument("--io-read-stall-s", type=float,
                   default=netio.loop.DEFAULT_READ_STALL_S,
                   help="event loop: evict a connection whose partial "
                        "frame makes no completion progress for this long "
                        "(the slowloris bound)")
    p.add_argument("--io-write-stall-s", type=float,
                   default=netio.loop.DEFAULT_WRITE_STALL_S,
                   help="event loop: evict a connection that drains none "
                        "of its buffered replies for this long (the "
                        "zero-window bound)")
    p.add_argument("--chaos", default=None, metavar="PLAN",
                   help="deterministic fault injection (d4pg_tpu_torch/chaos.py): "
                        "replica_kill@N / replica_slow@N:ms / "
                        "canary_corrupt@N / tenant_flood@N:tenant / "
                        "policy_skew@N / mirror_drop@N / gate_stall@N:s / "
                        "slowloris@N:bps / zero_window@N:ms / "
                        "fd_exhaust@N:ms "
                        "(scaledown_during_canary@N ticks in the "
                        "autoscaler)")
    p.add_argument("--debug-guards", action="store_true",
                   help="arm the runtime witnesses (lock-order, flow "
                        "conservation): drain checks the recorded lock "
                        "nesting and the admission/gate/tenant accounting "
                        "identities, raising on any imbalance")
    g = p.add_argument_group("autoscaler (serve/autoscaler.py)")
    g.add_argument("--autoscale", action="store_true",
                   help="run the healthz-driven autoscaler in-process: "
                        "spawn/drain replicas via d4pg_tpu_torch/utils/"
                        "spawnlib.py "
                        "between --autoscale-min and --autoscale-max")
    g.add_argument("--autoscale-bundle", default=None,
                   help="source bundle dir for spawned replicas (each "
                        "spawn gets its OWN copy under "
                        "--autoscale-workdir; default: the first "
                        "--backend-bundles default-policy dir)")
    g.add_argument("--autoscale-workdir", default=None,
                   help="where spawned replicas' bundle copies and "
                        "the pool bookkeeping live (default: a mkdtemp)")
    g.add_argument("--autoscale-min", type=int, default=1)
    g.add_argument("--autoscale-max", type=int, default=4)
    g.add_argument("--autoscale-interval", type=float, default=2.0,
                   help="seconds between control samples")
    g.add_argument("--autoscale-samples", type=int, default=3,
                   help="CONSECUTIVE breaching samples before any action "
                        "(never scale on one sample)")
    g.add_argument("--autoscale-cooldown", type=float, default=30.0,
                   help="hold after any action: new capacity needs warmup "
                        "+ K-probe admission before its effect is "
                        "measurable")
    g.add_argument("--autoscale-up-load", type=float, default=0.8,
                   help="inflight/capacity above this breaches toward "
                        "scale-up")
    g.add_argument("--autoscale-down-load", type=float, default=0.3,
                   help="inflight/capacity below this breaches toward "
                        "scale-down (hysteresis: well under the up "
                        "threshold)")
    g.add_argument("--autoscale-p99-slo", type=float, default=None,
                   help="interactive-tier p99 SLO in ms: violating it "
                        "breaches toward scale-up regardless of load")
    g.add_argument("--autoscale-shed", type=float, default=0.05,
                   help="shed rate (since last sample) above this "
                        "breaches toward scale-up")
    g.add_argument("--replica-args", default="",
                   help="extra args for spawned serve replicas, e.g. "
                        "'--max-batch 8 --max-wait-us 500'")
    return p


def main(argv=None) -> None:
    import sys

    from d4pg_tpu_torch.utils.signals import install_graceful_signals

    args = build_parser().parse_args(argv)
    if args.debug_guards:
        # BEFORE the Router/tap build their locks (named_lock wraps only
        # while enabled); drain() then checks nesting + identities.
        lockwitness.enable()
        flowledger.enable()
    backends = [b.strip() for b in args.backends.split(",") if b.strip()]
    bundles = None
    if args.backend_bundles:
        bundles = [
            parse_bundle_spec(b.strip())
            for b in args.backend_bundles.split(",")
        ]
    canary = None
    if args.canary_bundle:
        canary = {}
        for spec in args.canary_bundle:
            name, sep, path = spec.partition("=")
            pol, src = (name, path) if sep and path else (
                protocol.DEFAULT_POLICY, spec
            )
            if pol in canary:
                raise SystemExit(f"--canary-bundle for {pol!r} given twice")
            canary[pol] = src
    quotas = {}
    for spec in args.tenant_quota:
        name, sep, q = spec.partition("=")
        if not sep or not name:
            raise SystemExit(f"--tenant-quota wants TENANT=RPS[:BURST], got {spec!r}")
        quotas[name] = parse_quota(q)
    chaos = None
    if args.chaos:
        from d4pg_tpu_torch.chaos import ChaosInjector, ChaosPlan

        chaos = ChaosInjector(ChaosPlan.parse(args.chaos))
    tap = None
    if args.mirror_fraction > 0:
        from d4pg_tpu_torch.fleet.policy import load_numpy_policy
        from d4pg_tpu_torch.flywheel.spool import MirrorSpool
        from d4pg_tpu_torch.flywheel.tap import MirrorTap

        mirror_bundle = args.mirror_bundle
        if mirror_bundle is None:
            for b in bundles or []:
                if isinstance(b, str):
                    mirror_bundle = b
                    break
                if isinstance(b, dict) and protocol.DEFAULT_POLICY in b:
                    mirror_bundle = b[protocol.DEFAULT_POLICY]
                    break
        if mirror_bundle is None:
            raise SystemExit(
                "--mirror-fraction needs --mirror-bundle (or a "
                "--backend-bundles default-policy dir) for the tap's "
                "dims, n-step/gamma, and generation tags"
            )
        np_pol = load_numpy_policy(mirror_bundle)
        ingest_addr = None
        if args.mirror_ingest:
            ih, _, ip = args.mirror_ingest.rpartition(":")
            ingest_addr = (ih, int(ip))
        spool = MirrorSpool(args.mirror_spool) if args.mirror_spool else None
        tap = MirrorTap(
            obs_dim=np_pol.obs_dim,
            action_dim=np_pol.action_dim,
            n_step=np_pol.n_step,
            gamma=np_pol.gamma,
            fraction=args.mirror_fraction,
            ingest_addr=ingest_addr,
            spool=spool,
            bundle_dir=mirror_bundle,
            env="router",
            tap_id="mirror-router",
            chaos=chaos,
        )
    gate_spool = args.gate_spool or args.mirror_spool
    router = Router(
        backends,
        host=args.host,
        port=args.port,
        bundle_dirs=bundles,
        tenant_quotas=quotas or None,
        default_quota=(
            parse_quota(args.default_quota) if args.default_quota else None
        ),
        replica_capacity=args.replica_capacity,
        bulk_fraction=args.bulk_fraction,
        flood_burst=args.flood_burst,
        probe_interval_s=args.probe_interval,
        probe_timeout_s=args.probe_timeout,
        readmit_after=args.readmit_after,
        dispatch_retries=args.dispatch_retries,
        stuck_after_s=args.stuck_after,
        retry_seed=args.retry_seed,
        canary_bundle=canary,
        canary_fraction=args.canary_fraction,
        canary_window=args.canary_window,
        canary_min_samples=args.canary_min_samples,
        canary_max_err_increase=args.canary_max_error_increase,
        canary_p99_ratio=args.canary_p99_ratio,
        canary_attest_timeout_s=args.canary_attest_timeout,
        canary_observe_timeout_s=args.canary_observe_timeout,
        mirror_tap=tap,
        gate_spool=gate_spool,
        gate_sigma=args.gate_sigma,
        gate_min_windows=args.gate_min_windows,
        gate_min_ess=args.gate_min_ess,
        gate_band=args.gate_band,
        gate_max_windows=args.gate_max_windows,
        log_dir=args.log_dir,
        metrics_interval_s=args.metrics_interval,
        chaos=chaos,
        io_read_stall_s=args.io_read_stall_s,
        io_write_stall_s=args.io_write_stall_s,
    )
    install_graceful_signals(
        router.request_shutdown,
        "[router] {sig}: draining (second signal hard-kills)",
    )
    router.start()
    print(
        f"[router] listening on {router.host}:{router.port} "
        f"backends={','.join(backends)}",
        flush=True,
    )
    want = args.wait_replicas if args.wait_replicas is not None else len(backends)
    if want:
        admitted = router.wait_for_replicas(want, timeout_s=args.wait_timeout)
        print(f"[router] admitted {admitted}/{len(backends)} replicas",
              flush=True)
    scaler = pool = None
    if args.autoscale:
        import shlex
        import tempfile as _tempfile

        from d4pg_tpu_torch.serve.autoscaler import (
            Autoscaler,
            RouterReplicaPool,
            ServingSignalSource,
        )
        from d4pg_tpu_torch.utils.spawnlib import spawn

        src = args.autoscale_bundle
        if src is None:
            for b in bundles or []:
                if isinstance(b, str):
                    src = b
                    break
                if isinstance(b, dict) and protocol.DEFAULT_POLICY in b:
                    src = b[protocol.DEFAULT_POLICY]
                    break
        if src is None:
            raise SystemExit(
                "--autoscale needs --autoscale-bundle (or a "
                "--backend-bundles default-policy dir to clone)"
            )
        workdir = args.autoscale_workdir or _tempfile.mkdtemp(
            prefix="d4pg-autoscale-"
        )
        pool = RouterReplicaPool(
            router, src, workdir, spawn,
            replica_args=shlex.split(args.replica_args),
        )
        scaler = Autoscaler(
            ServingSignalSource(router.healthz),
            pool.scale_up,
            pool.scale_down,
            min_replicas=args.autoscale_min,
            max_replicas=args.autoscale_max,
            interval_s=args.autoscale_interval,
            up_load=args.autoscale_up_load,
            down_load=args.autoscale_down_load,
            p99_slo_ms=args.autoscale_p99_slo,
            shed_threshold=args.autoscale_shed,
            samples=args.autoscale_samples,
            cooldown_s=args.autoscale_cooldown,
            chaos=chaos,
            on_event=lambda kind, **f: router._record_event(kind, **f),
        )
        scaler.start()
        print(
            f"[router] autoscaler on: {args.autoscale_min}.."
            f"{args.autoscale_max} replicas, bundle={src}",
            flush=True,
        )
    router.serve_until_shutdown()
    if tap is not None:
        # after the router's drain: every connection is closed, so the
        # mirror books are final
        tap.close()
        mc = tap.counters()
        print(
            "[router] mirror: "
            + " ".join(f"{k}={mc[k]}" for k in sorted(mc)),
            flush=True,
        )
    if scaler is not None:
        scaler.close()
        print(f"[router] autoscaler: {scaler.snapshot()}", flush=True)
    if pool is not None:
        pool.close()
    snap = router.healthz()
    print(
        f"[router] drained: {snap['replies_ok']} ok, "
        f"{snap['replies_overloaded']} overloaded, "
        f"{snap['replies_error']} failed, "
        f"retries={snap['retries']} ejections={snap['ejections']} "
        f"p99={snap.get('p99_ms')} ms",
        flush=True,
    )
    sys.exit(0)


if __name__ == "__main__":
    main()
