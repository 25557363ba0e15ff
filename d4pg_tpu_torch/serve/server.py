"""Socket front-end: event-loop I/O, hot reload, SLOs (the port's
counterpart of ``d4pg_tpu/serve/server.py``).

All connection I/O (accept, reads, frame reassembly, buffered writes,
progress deadlines) lives on ONE ``d4pg_tpu_torch.netio`` event-loop
thread, so thread count is O(1) in connections: the loop, each resident
policy's batcher (a device thread and a reply thread), a reload watcher,
and a metrics ticker. Replies are queued by whichever thread completes the
future (the reply thread via ``add_done_callback``) through the
thread-safe ``Connection.send`` and flushed by the loop; the ``req_id``
echo makes pipelining safe, so a connection can have many requests in
flight and replies may arrive out of order.

Checkpoint hot-reload: a watcher polls two sources —

- the serving bundle's ``bundle.json`` mtime (the re-export flow:
  ``python -m d4pg_tpu_torch.train --export-bundle`` into the live
  directory; the exporter's params-then-json write ordering makes the
  mtime an attestation), and
- a training run directory (``--watch-run``): the trainer's
  ``best_eval.json`` mtime, whose write-ordering contract says
  ``checkpoints/best_actor.npz`` is already on disk when it moves.

Either way the swap is :meth:`DynamicBatcher.set_params`: the new weights
are copied into each bucket's captured parameters, so a reload costs zero
recaptures and in-flight batches finish on the params they started with.

Graceful drain (SIGTERM path, wired in ``__main__``): stop accepting,
shed new submissions with ``draining``, answer everything queued, then
close. Under ``debug_guards`` the drain then checks, last, that no
captured parameter was rebound, the recompile sentinel (each policy's
``<name>.infer`` at one specialization a bucket), the lock witness
against the port's lock graph and each policy's ``serve-stats`` flow
identity (the latter two no-ops unless the CLI armed them).

Chaos (a :class:`~d4pg_tpu_torch.chaos.ChaosInjector`, the JAX server's
sites): ``sock_reset`` ticks per received frame and resets the
connection; ``slowloris``, ``zero_window`` and ``fd_exhaust`` tick per
accepted connection and launch an attacker on the server's own loop
(``netio/attack.py``); healthz carries ``chaos_injections``.

Flywheel (``mirror_tap=``, a :class:`~d4pg_tpu_torch.flywheel.tap.MirrorTap`
owned by the caller, which closes it after the drain): the DEFAULT
policy's requests and ``FEEDBACK`` frames feed it from the loop thread
(``on_request`` / ``on_feedback``), a closed connection drops its stream
(``on_disconnect``), and healthz carries its counters under ``mirror``.
"""

from __future__ import annotations

import json
import os
import socket
import threading
from typing import Optional

import numpy as np

from d4pg_tpu_torch import netio
from d4pg_tpu_torch.analysis import flowledger, lockwitness
from d4pg_tpu_torch.analysis.ledger import StagingLedger
from d4pg_tpu_torch.analysis.recompile import RecompileSentinel
from d4pg_tpu_torch.netio import attack as netio_attack
from d4pg_tpu_torch.serve import protocol
from d4pg_tpu_torch.serve.batcher import DynamicBatcher, ShedError
from d4pg_tpu_torch.serve.bundle import PolicyBundle, bundle_mtime, load_bundle, params_from_leaves
from d4pg_tpu_torch.serve.protocol import ProtocolError


def load_best_actor_params(run_dir: str, config) -> dict:
    """``checkpoints/best_actor.npz`` from a training run (either
    package's), as the bundle config's actor ``state_dict``."""
    path = os.path.join(run_dir, "checkpoints", "best_actor.npz")
    with np.load(path) as z:
        leaves = [z[k] for k in sorted(z.files)]
    return params_from_leaves(leaves, config, where=path)


class _PolicyRuntime:
    """One resident policy: its bundle, its own batcher (own device and
    reply threads, own stream, own graphs), and its
    reload bookkeeping. The v1 ``ACT`` path serves the DEFAULT one.

    No threads of its own; the server's reload watcher is the only writer
    of the mutable fields below after construction (readers take atomic
    reference snapshots and tolerate being one reload stale)."""

    def __init__(self, policy_id: str, bundle: PolicyBundle, batcher,
                 watch_bundle: bool):
        self.policy_id = policy_id
        self.bundle = bundle
        self.batcher = batcher
        self._watch_bundle = watch_bundle and bundle.path is not None
        self._bundle_mtime = (
            bundle_mtime(bundle.path) if self._watch_bundle else None
        )
        # The json mtime of the bundle this policy is actually SERVING.
        # Distinct from ``_bundle_mtime`` (the watch bookmark), which
        # advances even when a reload FAILS: a policy offered a corrupt
        # bundle must keep attesting the OLD version.
        self._serving_bundle_mtime = (
            bundle_mtime(bundle.path) if bundle.path is not None else None
        )
        self._last_reload: Optional[str] = None

    def healthz_row(self) -> dict:
        """The per-policy healthz surface: the serving version, reload
        outcome, and this policy's own stats."""
        snap = self.batcher.stats.snapshot()
        last_reload = self._last_reload
        return {
            "bundle_mtime": self._serving_bundle_mtime,
            "last_reload": last_reload,
            "status": (
                "degraded"
                if last_reload is not None and last_reload.startswith("failed")
                else "ok"
            ),
            "compile_count": self.batcher.compile_count,
            "buckets": list(self.batcher.buckets),
            "queue_depth": self.batcher.queue_depth,
            "obs_dim": self.bundle.obs_dim,
            "action_dim": self.bundle.action_dim,
            "inflight": snap["inflight"],
            "requests_total": snap["requests_total"],
            "replies_ok": snap["replies_ok"],
            "shed_total": snap["shed_total"],
            "params_reloads": snap["params_reloads"],
            "p99_ms": snap["p99_ms"],
        }


class PolicyServer:
    def __init__(
        self,
        bundle: PolicyBundle,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        max_batch: int = 64,
        max_wait_us: int = 2000,
        queue_limit: int = 256,
        default_deadline_ms: float = 0.0,
        watch_run: Optional[str] = None,
        watch_bundle: bool = True,
        poll_interval_s: float = 2.0,
        log_dir: Optional[str] = None,
        metrics_interval_s: float = 30.0,
        debug_guards: bool = False,
        chaos=None,
        replica_id: Optional[int] = None,
        policies: Optional[dict] = None,
        mirror_tap=None,
        io_read_stall_s: float = netio.loop.DEFAULT_READ_STALL_S,
        io_write_stall_s: float = netio.loop.DEFAULT_WRITE_STALL_S,
        device=None,
    ):
        self.bundle = bundle
        # Fleet attribution (--replica-id): stamped into healthz and every
        # metrics.jsonl row.
        self.replica_id = replica_id
        self.host = host
        self._requested_port = port
        self.port: Optional[int] = None
        self.default_deadline_s = (
            default_deadline_ms / 1e3 if default_deadline_ms else None
        )
        # --debug-guards: every batch after warmup dispatches under
        # set_sync_debug_mode("error"), a staging ledger polices every
        # batcher's input slots (its groups scoped by the batcher's name),
        # and drain() checks that every policy's graphs still read the
        # parameters hot reload writes into and that the recompile sentinel
        # holds each policy's <name>.infer program to one specialization a
        # bucket.
        self.debug_guards = bool(debug_guards)
        self.ledger = StagingLedger("serve") if debug_guards else None
        self.sentinel = RecompileSentinel().start() if debug_guards else None

        def _mk_batcher(pid: str, b: PolicyBundle):
            return DynamicBatcher(
                b.config,
                b.actor_params,
                max_batch=max_batch,
                max_wait_us=max_wait_us,
                queue_limit=queue_limit,
                action_low=b.action_low,
                action_high=b.action_high,
                obs_norm_stats=b.obs_norm,
                guard_sync=debug_guards,
                name="serve" if pid == protocol.DEFAULT_POLICY else f"serve[{pid}]",
                device=device,
                ledger=self.ledger,
                sentinel=self.sentinel,
            )

        # N resident policies behind one front-end: ``bundle`` is the
        # DEFAULT (the one a v1 ACT frame lands on); ``policies`` maps extra
        # policy ids to their bundles. Each policy gets its OWN batcher and
        # its own hot-reload watch — a reload on policy A never touches
        # policy B's graphs or params.
        extra = dict(policies) if policies else {}
        if protocol.DEFAULT_POLICY in extra:
            raise ValueError(
                f"policy id {protocol.DEFAULT_POLICY!r} is reserved for the "
                "--bundle default policy (the v1 backward-compat target)"
            )
        self._policies: dict = {}
        for pid, b in [(protocol.DEFAULT_POLICY, bundle)] + sorted(extra.items()):
            self._policies[pid] = _PolicyRuntime(pid, b, _mk_batcher(pid, b), watch_bundle)
        self._default = self._policies[protocol.DEFAULT_POLICY]
        self.batcher = self._default.batcher
        self.stats = self.batcher.stats
        # the chaos plan's serving sites (ChaosInjector or None)
        self._chaos = chaos
        # the flywheel's mirror tap (or None): fed the DEFAULT policy's
        # request/feedback pairs, its counters in healthz; the caller
        # builds and closes it
        self._tap = mirror_tap
        self._watch_run = watch_run
        self._poll_interval_s = poll_interval_s
        self._best_mtime = self._stat_best() if watch_run else None
        self._log_dir = log_dir
        self._metrics_interval_s = metrics_interval_s
        self._metrics = None

        self._listen_sock: Optional[socket.socket] = None
        # ONE event-loop thread owns every connection.
        self._loop = netio.FrameLoop(
            name="serve-io",
            read_stall_s=io_read_stall_s,
            write_stall_s=io_write_stall_s,
        )
        self._watch_thread: Optional[threading.Thread] = None
        self._metrics_thread: Optional[threading.Thread] = None
        self._shutdown = threading.Event()
        self._started = False

    @property
    def policies(self) -> dict:
        """Resident policy id → its batcher."""
        return {pid: p.batcher for pid, p in self._policies.items()}

    # -------------------------------------------------------------- lifecycle
    def start(self) -> None:
        if self._started:
            raise RuntimeError("server already started")
        self._started = True
        for p in self._policies.values():
            # every bucket of every policy captured before accept
            p.batcher.start(warmup=True)
        self._listen_sock = socket.create_server((self.host, self._requested_port))
        self.port = self._listen_sock.getsockname()[1]
        self._loop.serve(
            self._listen_sock,
            on_frame=self._serve_conn,
            on_open=self._on_conn_open,
            on_close=self._on_conn_close,
            on_protocol_error=self._on_protocol_error,
        )
        self._loop.start()
        if any(p._watch_bundle for p in self._policies.values()) or self._watch_run:
            self._watch_thread = threading.Thread(
                target=self._watch_loop, name="serve-reload", daemon=True
            )
            self._watch_thread.start()
        if self._log_dir:
            from d4pg_tpu_torch.runtime.metrics import MetricsLogger

            self._metrics = MetricsLogger(self._log_dir)
            self._metrics_thread = threading.Thread(
                target=self._metrics_loop, name="serve-metrics", daemon=True
            )
            self._metrics_thread.start()

    def request_shutdown(self) -> None:
        """Signal-handler-safe: just set the event; the draining work
        happens on whoever waits (serve_until_shutdown / drain)."""
        self._shutdown.set()

    def serve_until_shutdown(self) -> None:
        # The main thread's park-until-signal IS the design: nothing but
        # the signal handler (request_shutdown) ends a serving process.
        self._shutdown.wait()
        self.drain()

    def drain(self, timeout: float = 30.0) -> None:
        """Graceful stop: no new connections, shed new requests, answer
        everything already admitted, then tear down."""
        self._shutdown.set()
        # (1) stop accepting; (2) drain the batchers — everything already
        # admitted is answered (replies flow through the still-running
        # loop) while new submissions shed ``draining``; (3) close the loop
        # — flush every connection's queued replies (bounded by the
        # write-progress deadline) and join the one I/O thread.
        self._loop.stop_accepting()
        for p in self._policies.values():
            p.batcher.stop(drain=True, timeout=timeout)
        self._loop.close(flush_timeout_s=5.0)
        self._listen_sock = None
        if self._watch_thread is not None:
            self._watch_thread.join(timeout=self._poll_interval_s + 5)
        if self._metrics_thread is not None:
            self._metrics_thread.join(timeout=self._metrics_interval_s + 5)
        if self._metrics is not None:
            self._metrics.log(self.stats.batches_total, self._metrics_row())
            self._metrics.close()
            self._metrics = None
        if self.debug_guards:
            # Every hot reload must have copied into the captured
            # parameters: a rebound one leaves the graphs serving stale
            # weights. Last on purpose: a trip fails the drain loudly
            # WITHOUT leaking the shutdown path above.
            rebound = {
                pid: names
                for pid, p in self._policies.items()
                if (names := p.batcher.rebound_params())
            }
            if rebound:
                raise RuntimeError(
                    "serve drain: parameters rebound after capture, the "
                    f"graphs serve stale weights (policy: names): {rebound}"
                )
            # one specialization a bucket for the whole run: hot reloads and
            # traffic never built another
            self.sentinel.stop()
            self.sentinel.check("serve drain")
            # the runtime lock order against the port's committed graph
            lockwitness.check_against_committed(where="serve drain")
        # every admitted request resolved as exactly one of ok / shed
        # (inflight 0 once the batchers drained); no-op unless armed
        for pid, p in self._policies.items():
            flowledger.check("serve-stats", p.batcher.stats.snapshot(),
                             where=f"serve drain ({pid})")

    # ------------------------------------------------------------- hot reload
    def _stat_best(self) -> Optional[float]:
        try:
            return os.stat(os.path.join(self._watch_run, "best_eval.json")).st_mtime
        except (OSError, TypeError):
            return None

    def _check_policy_reload(self, p: _PolicyRuntime) -> bool:
        """One reload poll for one resident policy. Returns True if its
        params swapped."""
        if not p._watch_bundle:
            return False
        m = bundle_mtime(p.bundle.path)
        if m is None or m == p._bundle_mtime:
            return False
        swapped = False
        try:
            # Reload the WHOLE bundle, not just the params: a re-export
            # carries fresher normalizer statistics, and serving new params
            # under stale μ/σ silently scales the net's inputs off its
            # trained distribution. Config/bounds changes are REFUSED (they
            # are baked into the captured bucket graphs — honoring them
            # needs a restart).
            fresh = load_bundle(p.bundle.path)
            if fresh.config != p.bundle.config:
                raise ValueError(
                    "agent config changed; restart the server to "
                    "serve it (captured graphs are config-shaped)"
                )
            if not (
                np.array_equal(fresh.action_low, p.bundle.action_low)
                and np.array_equal(fresh.action_high, p.bundle.action_high)
            ):
                raise ValueError(
                    "action bounds changed; restart the server to "
                    "serve them (bounds are baked into the captured graphs)"
                )
            p.batcher.set_params(fresh.actor_params)
            p.batcher.set_obs_norm(fresh.obs_norm)
            p.bundle = fresh
            if p is self._default:
                self.bundle = fresh  # keep the compat alias current
            swapped = True
            p._serving_bundle_mtime = m
            p._last_reload = "ok: bundle"
            print(f"[serve] reloaded bundle {p.bundle.path} (policy {p.policy_id})")
        except Exception as e:
            # ANY load/validation failure (a malformed bundle.json raises
            # KeyError/TypeError, not just OSError/ValueError) means: keep
            # serving the old params. The mtime bookmark still advances
            # below, so a bad export logs once instead of every poll.
            p._last_reload = f"failed: {e}"
            print(
                f"[serve] bundle reload failed (policy {p.policy_id} "
                f"serving old params): {e}"
            )
        p._bundle_mtime = m
        return swapped

    def check_reload(self) -> bool:
        """One reload poll across every resident policy (also callable
        directly — the watch thread is just this on a timer). Returns True
        if any policy's params swapped."""
        swapped = False
        for p in self._policies.values():
            swapped = self._check_policy_reload(p) or swapped
        if self._watch_run:
            m = self._stat_best()
            if m is not None and m != self._best_mtime:
                try:
                    # best_actor.npz carries PARAMS ONLY — a run with
                    # normalized observations hot-reloads via bundle
                    # re-export, which refreshes the statistics too.
                    params = load_best_actor_params(self._watch_run, self.bundle.config)
                    self.batcher.set_params(params)
                    swapped = True
                    # --watch-run is a default-policy contract
                    self._default._last_reload = "ok: best_actor.npz"
                    print(f"[serve] reloaded best_actor.npz from {self._watch_run}")
                except Exception as e:  # same contract as the bundle branch
                    self._default._last_reload = f"failed: {e}"
                    print(f"[serve] run-dir reload failed (serving old params): {e}")
                self._best_mtime = m
        return swapped

    def _watch_loop(self) -> None:
        while not self._shutdown.wait(self._poll_interval_s):
            try:
                self.check_reload()
            except Exception as e:  # the watcher must never die silently mid-run
                print(f"[serve] reload watcher error: {e}")

    # ---------------------------------------------------------------- metrics
    def _metrics_row(self) -> dict:
        """Stats row with the replica identity stamped in. Extra resident
        policies contribute their own rows under a ``policy_<id>_``
        prefix (the default policy keeps the bare keys)."""
        row = self.stats.metrics_row()
        for pid, p in self._policies.items():
            if p is self._default:
                continue
            for k, v in p.batcher.stats.metrics_row().items():
                row[f"policy_{pid}_{k}"] = v
        if self.replica_id is not None:
            row["replica_id"] = float(self.replica_id)
        return row

    def _metrics_loop(self) -> None:
        while not self._shutdown.wait(self._metrics_interval_s):
            self._metrics.log(
                self.stats.batches_total,
                self._metrics_row(),
                timers=self.batcher.timers,
            )

    # ------------------------------------------------------------ connections
    def _on_conn_open(self, conn: netio.Connection) -> None:
        # The connection-level chaos sites fire at accept: each launches an
        # attacker driven by this server's own loop against its own
        # listener, so the evictions are proven on live traffic.
        if self._chaos is not None:
            netio_attack.tick_attacks(self._chaos, self._loop, self.host, self.port)

    def _on_conn_close(self, conn: netio.Connection) -> None:
        if self._tap is not None:
            # the episode's boundary is the connection: a vanished
            # client's half-built window is dropped whole, never flushed
            # as if the episode had ended
            self._tap.on_disconnect(id(conn))

    def _on_protocol_error(self, conn: netio.Connection, exc) -> None:
        # Framing is per-connection state: after a malformed frame the
        # stream is unrecoverable, so this is a connection-fatal ERROR
        # (req_id 0) — the loop flush-closes the connection after this
        # returns. Pipelined siblings on OTHER connections are untouched.
        self.stats.inc("protocol_errors")
        conn.send(protocol.ERROR, 0, str(exc).encode())

    def _reply(self, conn: netio.Connection, msg_type: int, req_id: int,
               payload: bytes = b"") -> None:
        if not conn.send(msg_type, req_id, payload):
            # Client gone before its reply (or evicted for stalling): the
            # batch already computed its action; count it.
            self.stats.inc("dropped_replies")

    def _unknown_policy(self, conn, req_id: int, policy_id: str) -> None:
        # well-formed frame, wrong policy: a per-request ERROR, not a
        # ProtocolError — the connection (and its pipelined siblings)
        # survives
        self.stats.inc("unknown_policy")
        self._reply(
            conn, protocol.ERROR, req_id,
            f"unknown policy {policy_id!r} (resident: {sorted(self._policies)})".encode(),
        )

    def _serve_conn(self, conn: netio.Connection, msg_type: int, req_id: int,
                    payload: bytes) -> None:
        """One complete frame, on the loop thread. Must not block: the
        only slow work — inference — is handed to the policy's batcher and
        replied from its done-callback via the thread-safe
        ``Connection.send``. Raising :class:`ProtocolError` routes to
        ``_on_protocol_error`` (connection-fatal)."""
        reply = self._reply
        if self._chaos is not None and self._chaos.tick("sock_reset") is not None:
            # abortive close (an RST): the peer, and any reply in flight,
            # sees a reset; every other connection keeps being served
            conn.abort()
            return
        if msg_type == protocol.HEALTHZ:
            reply(conn, protocol.HEALTHZ_OK, req_id, json.dumps(self.healthz()).encode())
            return
        if msg_type == protocol.ACT:
            # v1 path: an old client lands on the DEFAULT policy
            pol = self._default
            obs, deadline_us = protocol.decode_act(payload, pol.bundle.obs_dim)
        elif msg_type == protocol.ACT2:
            obs, deadline_us, policy_id, _qos, _tenant = protocol.decode_act2(payload)
            # QoS/tenant ride the frame for a router's admission tier; the
            # replica itself routes on policy only.
            pol = self._policies.get(policy_id)
            if pol is None:
                self._unknown_policy(conn, req_id, policy_id)
                return
            if obs.shape[0] != pol.bundle.obs_dim:
                reply(
                    conn, protocol.ERROR, req_id,
                    f"obs is {obs.shape[0]}-dim, policy "
                    f"{policy_id!r} wants {pol.bundle.obs_dim}".encode(),
                )
                return
        elif msg_type == protocol.FEEDBACK:
            # Reward echo for this connection's previous ACT (the
            # flywheel's loop). Malformed frames are per-request ERRORs; a
            # valid one is ALWAYS acked, so a client need not know whether
            # a tap is attached.
            fb = protocol.decode_feedback(payload)
            fpol = self._policies.get(fb["policy_id"])
            if fpol is None:
                self._unknown_policy(conn, req_id, fb["policy_id"])
                return
            if (
                fb["action"].shape[0] != fpol.bundle.action_dim
                or fb["next_obs"].shape[0] != fpol.bundle.obs_dim
            ):
                reply(
                    conn, protocol.ERROR, req_id,
                    f"feedback dims ({fb['action'].shape[0]} act, "
                    f"{fb['next_obs'].shape[0]} obs) do not match "
                    f"policy {fb['policy_id']!r} "
                    f"({fpol.bundle.action_dim} act, "
                    f"{fpol.bundle.obs_dim} obs)".encode(),
                )
                return
            self.stats.inc("feedback_frames")
            if self._tap is not None and fpol is self._default:
                self._tap.on_feedback(id(conn), fb)
            reply(conn, protocol.FEEDBACK_OK, req_id)
            return
        else:
            raise ProtocolError(f"unexpected message type {msg_type}")
        if self._tap is not None and pol is self._default:
            # this connection's latest request obs: its next FEEDBACK
            # frame completes the pair
            self._tap.on_request(id(conn), obs)
        deadline_s = deadline_us / 1e6 if deadline_us else self.default_deadline_s
        try:
            fut = pol.batcher.submit(obs, deadline_s)
        except ShedError as e:
            reply(conn, protocol.OVERLOADED, req_id, e.reason.encode())
            return

        def deliver(f, conn=conn, req_id=req_id):
            exc = f.exception()
            if exc is None:
                # inside f's own done-callback: resolved, result() cannot block
                reply(conn, protocol.ACT_OK, req_id, protocol.encode_action(f.result()))
            elif isinstance(exc, ShedError):
                reply(conn, protocol.OVERLOADED, req_id, exc.reason.encode())
            else:
                reply(conn, protocol.ERROR, req_id, str(exc).encode())

        fut.add_done_callback(deliver)

    # ----------------------------------------------------------------- status
    def healthz(self) -> dict:
        snap = self.stats.snapshot()
        # "draining" once shutdown is requested; "degraded" while
        # healthy-but-stale (ANY policy's last hot-reload attempt failed,
        # so its traffic is served on older params); "ok" otherwise.
        rows = {pid: p.healthz_row() for pid, p in self._policies.items()}
        if self._shutdown.is_set():
            status = "draining"
        elif any(r["status"] == "degraded" for r in rows.values()):
            status = "degraded"
        else:
            status = "ok"
        snap["status"] = status
        snap["draining"] = self._shutdown.is_set()
        snap["last_reload"] = rows[protocol.DEFAULT_POLICY]["last_reload"]
        snap["queue_depth"] = self.batcher.queue_depth
        # Aggregates across EVERY resident policy: compile_count is the
        # whole process's capture count, inflight the dispatch-weight gauge.
        snap["compile_count"] = sum(p.batcher.compile_count for p in self._policies.values())
        snap["inflight"] = sum(r["inflight"] for r in rows.values())
        snap["params_reloads"] = sum(r["params_reloads"] for r in rows.values())
        snap["buckets"] = list(self.batcher.buckets)
        snap["obs_dim"] = self.bundle.obs_dim
        snap["action_dim"] = self.bundle.action_dim
        # the DEFAULT policy's serving-bundle version; per-policy versions
        # ride the ``policies`` rows
        snap["bundle_mtime"] = rows[protocol.DEFAULT_POLICY]["bundle_mtime"]
        snap["policies"] = rows
        snap["replica_id"] = self.replica_id
        snap["pid"] = os.getpid()
        if self._tap is not None:
            # every counter of the tap's window identity
            snap["mirror"] = self._tap.counters()
        snap["stage_ms"] = {
            k: round(v, 4) for k, v in self.batcher.timers.summary_ms().items()
        }
        # the event loop's connection census and eviction books
        snap["netio"] = self._loop.stats()
        if self._chaos is not None:
            snap["chaos_injections"] = self._chaos.injections_total
        return snap
