"""The remote actor host: env + numpy policy → windows over the wire (the
port's copy of ``d4pg_tpu/fleet/actor.py``).

``python -m d4pg_tpu_torch.fleet.actor --connect HOST:PORT --bundle DIR``

One process an actor host, with no torch in it: the policy is a
:class:`~d4pg_tpu_torch.fleet.policy.NumpyPolicy` read from a serving
bundle, the env is the host adapter
(``envs/gym_adapter.make_host_env``), and the n-step collapse is the
port's own :class:`~d4pg_tpu_torch.replay.nstep_writer.NStepWriter`
writing into a local spool, so the windows that cross the wire are the
rows the in-process writer would have inserted.

The bundle is the weight distribution: the trainer re-exports it (params
first, json last, each atomic) at every publication, and this host polls
``bundle.json``'s mtime and swaps the whole policy (params, obs-norm
statistics, generation) between env steps. Each window is tagged with
the generation of the policy that made it, so the ingest can drop stale
experience and count it.

Failures:

- reconnects under the bounded ``utils/retry.py:Backoff``; frames not
  acknowledged at a disconnect are dropped, never resent (at most once:
  a duplicate window would weigh a transition twice, a lost one costs a
  little data), and the spool of unsent windows survives the reconnect;
- flow control: at most ``max_inflight`` unacknowledged frames (the
  server's HELLO_OK says how many); when the credits run out, the env
  loop waits. While disconnected, the bounded spool drops its oldest
  windows instead, so a dead learner cannot grow this host's memory;
- an ``OVERLOADED`` ``queue_full`` reply counts the frame's windows shed.

SIGTERM or SIGINT drains: the env loop stops, the spool's windows ship,
the acks are awaited a few seconds, the counters are printed, exit 0.
``--debug-guards`` checks the ``fleet-actor`` flow identity there and arms
the lock witness; ``--chaos`` ticks the actor's fault sites
(``reconnect_flap``, ``slow_link``, ``pixel_truncate``, ``stale_bundle``,
``stale_stats``, ``her_actor_kill``).
"""

from __future__ import annotations

import argparse
import os
import random
import struct
import sys
import threading
import time
from collections import deque
from typing import Optional

import numpy as np

from d4pg_tpu_torch.analysis import flowledger, lockwitness
from d4pg_tpu_torch.fleet import wire
from d4pg_tpu_torch.fleet.policy import NumpyPolicy, bundle_meta_mtime, load_numpy_policy
from d4pg_tpu_torch.replay.her import HindsightWriter
from d4pg_tpu_torch.replay.nstep_writer import NStepWriter
from d4pg_tpu_torch.serve import protocol
from d4pg_tpu_torch.serve.protocol import ProtocolError
from d4pg_tpu_torch.utils.retry import Backoff

STAT_KEYS = (
    "env_steps",
    "episodes",
    "windows_emitted",
    "windows_sent",
    "windows_acked",
    "windows_shed",
    "windows_stale",
    "windows_dropped_reconnect",
    "windows_dropped_spool",
    "frames_sent",
    "reconnects",
    "bundle_reloads",
    "generation",
)
ACK_KEYS = {
    "accepted": "windows_acked",
    "stale": "windows_stale",
    "shed": "windows_shed",
    "dropped": "windows_dropped_reconnect",
}


class _Spool:
    """A bounded FIFO of complete windows, each tagged with the bundle
    generation, the stats generation and the relabelled flag in force
    when it was emitted. ``add`` is the buffer method the n-step writer
    calls. The env loop alone uses it; past ``limit`` the oldest window
    goes (the stalest)."""

    def __init__(self, limit: int):
        self.limit = int(limit)
        self.rows: deque = deque()
        self.dropped = 0
        self.generation = 0        # set by the actor at every policy swap
        self.stats_generation = 0  # set at every statistics swap
        self.relabeled = False     # set by the HER writer factory

    def add(self, obs, action, reward, next_obs, discount) -> None:
        if len(self.rows) >= self.limit:
            self.rows.popleft()
            self.dropped += 1
        self.rows.append((
            (self.generation, self.stats_generation, self.relabeled),
            np.asarray(obs, np.float32),
            np.asarray(action, np.float32),
            float(reward),
            np.asarray(next_obs, np.float32),
            float(discount),
        ))

    def __len__(self) -> int:
        return len(self.rows)

    def take_frame(self, max_rows: int):
        """Pop the longest run of one tag, at most ``max_rows`` →
        ``(tag, columns)``, or None when empty. One tag a frame keeps the
        frame's single header true across a swap or a relabel pass."""
        if not self.rows:
            return None
        tag = self.rows[0][0]
        rows = []
        while self.rows and len(rows) < max_rows and self.rows[0][0] == tag:
            rows.append(self.rows.popleft())
        return tag, {
            "obs": np.stack([r[1] for r in rows]),
            "action": np.stack([r[2] for r in rows]),
            "reward": np.asarray([r[3] for r in rows], np.float32),
            "next_obs": np.stack([r[4] for r in rows]),
            "discount": np.asarray([r[5] for r in rows], np.float32),
        }


class _HerWriterFactory:
    """The ``writer_factory`` the port's :class:`HindsightWriter` calls
    once for an episode's original pass and once a relabel pass: its
    first call of an episode marks the spooled windows original, every
    later one relabelled (what the wire's flag tells the ingest, which
    folds no statistics from relabelled windows).
    :meth:`FleetActor._her_flush` restarts it each episode."""

    def __init__(self, spool: _Spool, n_step: int, gamma: float):
        self.spool = spool
        self.n_step = n_step
        self.gamma = gamma
        self.calls = 0

    def __call__(self) -> NStepWriter:
        self.calls += 1
        self.spool.relabeled = self.calls > 1
        return NStepWriter(self.spool, self.n_step, self.gamma)


class FleetLink:
    """One connection to the ingest server: the HELLO handshake at once,
    then pipelined windows frames acknowledged on a reader thread, at
    most the server's in-flight window of them."""

    def __init__(self, host: str, port: int, hello: dict, *, on_ack,
                 connect_timeout_s: float = 10.0):
        import socket

        self._on_ack = on_ack  # (kind, n), kind in accepted|stale|shed|dropped
        self._sock = socket.create_connection((host, port), timeout=connect_timeout_s)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            protocol.write_frame(self._sock, protocol.HELLO, 0, wire.encode_hello(**hello))
            frame = protocol.read_frame(self._sock)  # under the connect timeout
            if frame is None:
                raise ProtocolError("server closed during handshake")
            msg_type, _req_id, payload = frame
            if msg_type == protocol.ERROR:
                # a structured refusal names its gap codes; a plain error
                # (another failure, an older server) passes through
                refusal = wire.decode_refusal(payload)
                if refusal is not None:
                    codes = ",".join(g.get("code", "?") for g in refusal.get("gaps", ()))
                    raise RuntimeError(
                        f"ingest refused handshake{f' [{codes}]' if codes else ''}: "
                        f"{refusal.get('message', '')}"
                    )
                raise RuntimeError(
                    f"ingest refused handshake: {payload.decode('utf-8', 'replace')}")
            if msg_type != protocol.HELLO_OK:
                raise ProtocolError(f"unexpected handshake reply {msg_type}")
            ok = wire.decode_hello_ok(payload)
        except BaseException:
            self._sock.close()
            raise
        self.server_generation = int(ok["generation"])
        self.max_windows = int(ok["max_windows_per_frame"])
        self.max_inflight = int(ok["max_inflight"])
        # the negotiated capabilities; None from a server that does not
        # negotiate, which replies without them
        self.caps: Optional[dict] = ok.get("caps")
        self.server_stats_generation = int(ok.get("stats_generation", 0))
        self.obs_mode = (self.caps or {}).get("obs_mode", "f32")
        # WINDOWS2 only where its header matters (rows that are not f32,
        # or stats tags): plain f32 traffic stays on the v1 frame
        self._use_v2 = self.obs_mode != "f32" or bool((self.caps or {}).get("obs_norm"))
        # the reader waits between acks for as long as it takes: the
        # handshake's timeout must not end an idle, healthy connection
        self._sock.settimeout(None)
        self._rfile = self._sock.makefile("rb")
        self._credits = threading.Semaphore(self.max_inflight)
        self._pending: dict = {}  # req_id -> windows in the frame
        self._pending_lock = lockwitness.named_lock("FleetLink._pending_lock")
        self._next_id = 0
        self._dead: Optional[Exception] = None
        self._closed = False
        self._reader = threading.Thread(target=self._read_loop, name="fleet-link-reader",
                                        daemon=True)
        self._reader.start()

    @property
    def dead(self) -> Optional[Exception]:
        return self._dead

    def acquire_credit(self, timeout: float) -> bool:
        """Flow control: True once an in-flight slot is free; False when the
        timeout lapses or the link died."""
        if self._dead is not None:
            return False
        return self._credits.acquire(timeout=timeout)

    def release_credit(self) -> None:
        """Give back a credit that sent nothing."""
        self._credits.release()

    def _payload(self, tag, cols: dict):
        generation, stats_gen, relabeled = tag
        if self._use_v2:
            return protocol.WINDOWS2, wire.encode_windows2(
                generation, stats_gen, self.obs_mode, relabeled, cols["obs"], cols["action"],
                cols["reward"], cols["next_obs"], cols["discount"])
        return protocol.WINDOWS, wire.encode_windows(
            generation, cols["obs"], cols["action"], cols["reward"], cols["next_obs"],
            cols["discount"])

    def send_windows(self, tag, cols: dict, truncate: bool = False) -> int:
        """Send one frame (the caller holds a credit); ``tag`` is the
        spool's ``(generation, stats_generation, relabeled)``. Returns the
        frame's window count; OSError on a dead or broken socket. A failed
        send's windows are counted dropped exactly once: here, or by the
        reader's sweep when it got there first.

        ``truncate`` is chaos ``pixel_truncate``: the header declares the
        whole payload, the body stops halfway and the socket is reset, as
        a host dying in ``sendall`` leaves it. The server drops the torn
        frame whole; this side counts its windows dropped."""
        n = len(cols["reward"])
        with self._pending_lock:
            self._next_id = (self._next_id + 1) & 0xFFFFFFFF
            req_id = self._next_id
            self._pending[req_id] = n
        if self._dead is not None:
            self._fail_send(req_id)
            raise OSError("link is dead")
        msg_type, payload = self._payload(tag, cols)
        try:
            if truncate:
                protocol.write_truncated_frame(self._sock, msg_type, req_id, payload,
                                               len(payload) // 2)
                self._reset()
                raise OSError("chaos: frame truncated mid-stream")
            protocol.write_frame(self._sock, msg_type, req_id, payload)
        except OSError:
            self._fail_send(req_id)
            raise
        return n

    def _fail_send(self, req_id: int) -> None:
        """A registered frame never went out: its windows are dropped,
        unless the reader's sweep already counted them (the pop says)."""
        with self._pending_lock:
            n = self._pending.pop(req_id, None)
        if n is not None:
            self._on_ack("dropped", n)

    def _read_loop(self) -> None:
        err: Exception = ConnectionError("server closed the connection")
        try:
            while True:
                frame = protocol.read_frame(self._rfile)
                if frame is None:
                    break
                msg_type, req_id, payload = frame
                with self._pending_lock:
                    n = self._pending.pop(req_id, None)
                if n is None:
                    if msg_type == protocol.ERROR:
                        err = RuntimeError(payload.decode("utf-8", "replace"))
                        break
                    continue
                if msg_type == protocol.WINDOWS_OK:
                    accepted, stale = wire.decode_windows_ok(payload)
                    if accepted:
                        self._on_ack("accepted", accepted)
                    if stale:
                        self._on_ack("stale", stale)
                elif msg_type == protocol.OVERLOADED:
                    self._on_ack("shed", n)
                elif msg_type == protocol.ERROR:
                    # the frame died with the connection, server-side
                    self._on_ack("dropped", n)
                    err = RuntimeError(payload.decode("utf-8", "replace"))
                    break
                else:
                    # an unexpected reply to a known frame: its entry is
                    # popped, so count its windows dropped (or they vanish
                    # from the books) and end the link
                    self._on_ack("dropped", n)
                    raise ProtocolError(f"unexpected reply type {msg_type}")
                self._credits.release()
        except (OSError, ProtocolError) as e:
            if not self._closed:
                err = ConnectionError(str(e))
        finally:
            # dead first, then the sweep: a racing send either lands in the
            # swept dict (counted here) or sees the link dead and fails
            # itself
            self._dead = err
            with self._pending_lock:
                pending, self._pending = list(self._pending.values()), {}
            # in flight at the disconnect: dropped, never resent
            for n in pending:
                self._on_ack("dropped", n)
                self._credits.release()

    def _reset(self) -> None:
        """End the connection now, as a host that died mid-send ends it.
        The reader's buffered file holds a reference to the socket, so
        ``close()`` alone leaves it open (the server would wait out its
        read deadline for the torn frame, and this side would send into
        a closed socket meanwhile): ``shutdown`` ends the stream at once,
        the server's ``read_frame`` raises EOF mid-frame, the reader's
        EOF marks the link dead, and the linger of 0 resets what is left
        when the last reference closes."""
        import socket

        try:
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
        except OSError:
            pass
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()

    def inflight(self) -> int:
        with self._pending_lock:
            return len(self._pending)

    def abort(self) -> None:
        """An abortive close (chaos ``reconnect_flap``): the server sees a
        reset."""
        protocol.abortive_close(self._sock)
        self.close()

    def close(self) -> None:
        import socket

        self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        self._reader.join(timeout=5)
        try:
            self._rfile.close()
        except OSError:
            pass


class FleetActor:
    """The env, policy and uplink loop. Construct, then :meth:`run`."""

    def __init__(
        self,
        *,
        connect: str,
        bundle_dir: str,
        env_id: Optional[str] = None,
        num_envs: int = 1,
        seed: int = 0,
        noise_sigma: float = 0.3,
        batch_windows: int = 16,
        spool_limit: int = 1024,
        poll_interval_s: float = 2.0,
        max_env_steps: int = 0,
        stats_interval_s: float = 10.0,
        reconnect_attempts: int = 60,
        connect_timeout_s: float = 10.0,
        stop_event: Optional[threading.Event] = None,
        chaos=None,
        actor_id: Optional[str] = None,
        her: bool = False,
        her_k: int = 4,
        variant: int = 0,
    ):
        host, _, port = connect.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"--connect must be HOST:PORT, got {connect!r}")
        self.host, self.port = host, int(port)
        self.bundle_dir = bundle_dir
        self.policy: NumpyPolicy = load_numpy_policy(bundle_dir)
        self.env_id = env_id or self.policy.env
        if not self.env_id:
            raise ValueError("bundle carries no env id; pass --env explicitly")
        self.num_envs = int(num_envs)
        if self.num_envs < 1:
            raise ValueError(
                f"--num-envs must be >= 1, got {num_envs} (a fleet actor "
                "host exists to run envs; 0 envs is the learner-side "
                "train.py --num-envs 0 flag, not this one)"
            )
        self.seed = int(seed)
        self.noise_sigma = float(noise_sigma)
        self.batch_windows = int(batch_windows)
        self.poll_interval_s = float(poll_interval_s)
        self.max_env_steps = int(max_env_steps)
        self.stats_interval_s = float(stats_interval_s)
        self.reconnect_attempts = int(reconnect_attempts)
        self.connect_timeout_s = float(connect_timeout_s)
        self._stop = stop_event if stop_event is not None else threading.Event()
        self._chaos = chaos
        self.actor_id = actor_id or f"{self.env_id}-actor"
        self.her = bool(her)
        self.her_k = int(her_k)
        # the league variant this host is assigned to: declared in the
        # HELLO, and a non-zero one checked against the HELLO_OK's echo
        self.variant = int(variant)
        self._rng = np.random.default_rng(seed)
        self.spool = _Spool(spool_limit)
        self.spool.generation = self.policy.generation
        self.spool.stats_generation = self.policy.stats_generation
        self._bundle_mtime = self.policy.mtime
        self._link: Optional[FleetLink] = None
        # while disconnected the env loop keeps collecting (the spool
        # absorbs) and _ensure_link tries once whenever _retry_at passed
        self._backoff: Optional[Backoff] = None
        self._retry_at = 0.0
        self._stats = dict.fromkeys(STAT_KEYS, 0)
        self._stats["generation"] = self.policy.generation
        self._stats_lock = lockwitness.named_lock("FleetActor._stats_lock")  # acks vs the loop

        from d4pg_tpu_torch.envs.gym_adapter import make_host_env

        self.envs = [make_host_env(self.env_id) for _ in range(self.num_envs)]
        if self.her:
            # the port's own HindsightWriter relabels here, into the spool
            # through a factory that tags original and relabelled passes
            for env in self.envs:
                if not getattr(env, "is_goal_env", False) or not hasattr(env, "compute_reward"):
                    raise ValueError(f"--her needs a goal-dict env; {self.env_id!r} is not one")
            self._her_factories = [
                _HerWriterFactory(self.spool, self.policy.n_step, self.policy.gamma)
                for _ in range(self.num_envs)
            ]
            self.writers = [
                HindsightWriter(
                    writer_factory=self._her_factories[i],
                    compute_reward=self.envs[i].compute_reward,
                    k_future=self.her_k,
                    rng=np.random.default_rng(self.seed + 7000 + i),
                )
                for i in range(self.num_envs)
            ]
        else:
            self.writers = [NStepWriter(self.spool, self.policy.n_step, self.policy.gamma)
                            for _ in range(self.num_envs)]
        self._obs = np.stack(
            [env.reset(seed=self.seed + 1000 * i) for i, env in enumerate(self.envs)]
        ).astype(np.float32)
        if self.her:
            # the relabeller's goal views before each step
            self._goal_prev = [self._goal_view(env) for env in self.envs]
            # each env's (generation, stats generation) at its episode's
            # start: HER holds a whole episode back, and a swap inside it
            # must not stamp already-acted steps as fresh (the ingest may
            # drop a partly fresh episode, never accept stale windows)
            self._her_episode_tag = [(self.policy.generation, self.policy.stats_generation)
                                     for _ in range(self.num_envs)]
        if self._obs.shape[1] != self.policy.obs_dim:
            raise ValueError(
                f"env {self.env_id!r} observations are {self._obs.shape[1]}-dim, "
                f"bundle policy expects {self.policy.obs_dim}"
            )

    # ---------------------------------------------------------------- stats
    def _inc(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self._stats[key] += n

    def stats(self) -> dict:
        with self._stats_lock:
            out = dict(self._stats)
        out["windows_dropped_spool"] = self.spool.dropped
        out["spool_depth"] = len(self.spool)
        return out

    def _on_ack(self, kind: str, n: int) -> None:
        self._inc(ACK_KEYS[kind], n)

    def request_stop(self) -> None:
        """Signal-safe: sets the event only."""
        self._stop.set()

    # ----------------------------------------------------------------- link
    def _hello(self) -> dict:
        """The HELLO payload of every connect (the loop's and the drain's).
        ``caps`` says what this host can produce; the server picks from it
        or refuses with reasons (``replay/source.py:negotiate_fleet``).
        bf16 is always offered: the wire encodes it with or without
        ``ml_dtypes``."""
        return dict(
            actor_id=self.actor_id,
            env=self.env_id,
            obs_dim=self.policy.obs_dim,
            action_dim=self.policy.action_dim,
            n_step=self.policy.n_step,
            gamma=self.policy.gamma,
            generation=self.policy.generation,
            caps=dict(
                wire=2,
                obs_modes=["f32", "u8", "bf16"],
                her=self.her,
                obs_norm=self.policy.has_obs_norm,
                variant=self.variant,
            ),
        )

    def _check_negotiated(self, link: FleetLink) -> None:
        """A server that does not negotiate (no caps in HELLO_OK) is fine
        for plain f32 traffic and fatal for a host that needs the
        capability wire (HER tags, stats generations, pixel rows, a
        variant)."""
        if link.caps is None and (self.her or self.policy.has_obs_norm
                                  or self.policy.pixel_shape is not None or self.variant != 0):
            raise RuntimeError(
                "ingest server does not speak capability negotiation "
                "but this actor needs it "
                f"(her={self.her}, obs_norm={self.policy.has_obs_norm}, "
                f"pixel={self.policy.pixel_shape is not None}, "
                f"variant={self.variant})"
            )
        if self.variant != 0 and link.caps is not None:
            echoed = int(link.caps.get("variant", 0))
            if echoed != self.variant:
                # another variant behind this port: streaming on would
                # feed its replay another policy's experience
                raise RuntimeError(
                    f"ingest server is league variant {echoed}, this "
                    f"actor is assigned variant {self.variant} — wrong "
                    "port (the league controller re-points actors when "
                    "a slot's variant is replaced)"
                )

    def _ensure_link(self) -> bool:
        """Connected, or ONE paced reconnect attempt under the bounded
        Backoff that does not block. False while disconnected: the env
        loop keeps collecting into the spool (which drops its oldest past
        its limit). RuntimeError once the attempts are spent."""
        if self._link is not None and self._link.dead is None:
            return True
        if self._link is not None:
            self._link.close()  # sweeps the unacked: windows_dropped_reconnect
            self._link = None
            self._inc("reconnects")
        if self._backoff is None:
            self._backoff = Backoff(
                base_s=0.2, max_s=5.0, max_attempts=self.reconnect_attempts,
                rng=random.Random(self.seed),  # deterministic jitter (chaos)
            )
            self._retry_at = time.monotonic()  # the first attempt is at once
        if self._stop.is_set() or time.monotonic() < self._retry_at:
            return False
        try:
            link = FleetLink(self.host, self.port, self._hello(), on_ack=self._on_ack,
                             connect_timeout_s=self.connect_timeout_s)
        except (OSError, ProtocolError) as e:
            return self._retry_later(e)
        self._check_negotiated(link)  # a config skew: fatal, not retried
        if self._chaos is not None and self._chaos.tick("reconnect_flap") is not None:
            # a reset right after a good handshake: the next attempt runs
            # on the same schedule (the success never reset it)
            link.abort()
            self._inc("reconnects")
            return self._retry_later(RuntimeError("chaos reconnect_flap"))
        self._backoff = None
        self._link = link
        if link.server_generation > self.policy.generation:
            # the HELLO_OK says this bundle is already stale: reload now
            # rather than stream a poll interval of windows to be dropped
            self._maybe_reload_bundle()
        return True

    def _retry_later(self, err: Exception) -> bool:
        delay = self._backoff.next_delay()
        if delay is None:
            raise RuntimeError(
                f"could not reach ingest server {self.host}:{self.port} "
                f"after {self.reconnect_attempts} bounded retries: {err}"
            )
        self._retry_at = time.monotonic() + delay
        return False

    def _flush_once(self, deadline: Optional[float] = None) -> bool:
        """Ship one frame of the spool. False when nothing went (empty
        spool, stopping, or the link died). ``deadline`` (a monotonic
        instant) marks the drain: no reconnect under the Backoff, and the
        credit wait gives up at the deadline rather than on the stop."""
        if not self.spool.rows:
            return False
        if deadline is not None:
            if self._link is None or self._link.dead is not None:
                return False
        elif not self._ensure_link():
            return False
        link = self._link
        # flow control: wait for an in-flight slot, and the env loop with us
        while not link.acquire_credit(timeout=0.5):
            if link.dead is not None:
                return False
            if deadline is not None:
                # the drain: the stop is always set there, so only the
                # deadline ends the wait for a slow but live server
                if time.monotonic() >= deadline:
                    return False
            elif self._stop.is_set():
                return False
        frame = self.spool.take_frame(link.max_windows)
        if frame is None:
            link.release_credit()
            return False
        tag, cols = frame
        truncate = False
        if self._chaos is not None:
            e = self._chaos.tick("slow_link")
            if e is not None:
                # stall this send: the server's read deadline tolerates a
                # slow live peer, and flow control absorbs the stall
                self._stop.wait((e.arg if e.arg is not None else 100.0) / 1e3)
            if self._chaos.tick("pixel_truncate") is not None:
                truncate = True
        try:
            n = link.send_windows(tag, cols, truncate=truncate)
        except OSError:
            # dropped whole at the disconnect, and counted once
            return False
        self._inc("windows_sent", n)
        self._inc("frames_sent")
        return True

    # --------------------------------------------------------------- bundle
    def _maybe_reload_bundle(self) -> None:
        m = bundle_meta_mtime(self.bundle_dir)
        if m is None or m == self._bundle_mtime:
            return
        if self._chaos is not None and self._chaos.tick("stale_bundle") is not None:
            # skip this swap and advance the bookmark: the host acts on
            # the old generation until the next export, and the ingest
            # drops its windows as stale
            self._bundle_mtime = m
            print("[fleet-actor] chaos stale_bundle: skipping hot-swap, "
                  f"staying on generation {self.policy.generation}", flush=True)
            return
        try:
            fresh = load_numpy_policy(self.bundle_dir)
        except (OSError, ValueError, KeyError) as e:
            # a torn or malformed export: keep the old policy, and log it
            # once (the bookmark advances)
            self._bundle_mtime = m
            print(f"[fleet-actor] bundle reload failed (keeping old): {e}", flush=True)
            return
        if (self._chaos is not None and fresh.has_obs_norm
                and self._chaos.tick("stale_stats") is not None):
            # the fresh params on the old statistics: the windows carry the
            # old stats generation, which the ingest drops past the lag
            fresh.retain_stats_from(self.policy)
            print("[fleet-actor] chaos stale_stats: keeping stats "
                  f"generation {fresh.stats_generation} under params "
                  f"generation {fresh.generation}", flush=True)
        self._bundle_mtime = fresh.mtime
        self.policy = fresh
        self.spool.generation = fresh.generation
        self.spool.stats_generation = fresh.stats_generation
        with self._stats_lock:
            self._stats["generation"] = fresh.generation
            self._stats["bundle_reloads"] += 1
        print(f"[fleet-actor] hot-swapped bundle generation={fresh.generation}", flush=True)

    # ------------------------------------------------------------- env loop
    @staticmethod
    def _goal_view(env) -> tuple:
        """(observation, achieved_goal, desired_goal), copied: the
        relabeller holds them for the whole episode."""
        g = env.last_goal_obs
        return (
            np.asarray(g["observation"], np.float32).copy(),
            np.asarray(g["achieved_goal"], np.float32).copy(),
            np.asarray(g["desired_goal"], np.float32).copy(),
        )

    def _her_flush(self, i: int, truncated: bool) -> None:
        """An episode's end: relabel and flush through the HindsightWriter,
        all of it stamped with the episode's starting tag, then back to the
        live policy's tags."""
        cur = (self.spool.generation, self.spool.stats_generation)
        self.spool.generation, self.spool.stats_generation = self._her_episode_tag[i]
        try:
            self._her_factories[i].calls = 0
            self.writers[i].end_episode(truncated=truncated)
        finally:
            self.spool.generation, self.spool.stats_generation = cur
            self.spool.relabeled = False  # the next episode starts original
        self._her_episode_tag[i] = (self.policy.generation, self.policy.stats_generation)

    def _maybe_her_actor_kill(self) -> None:
        """Chaos ``her_actor_kill``: SIGKILL this host at its Nth env step
        (ticked once an env a loop), mid-episode. The buffered HER episode
        dies with it, so nothing torn reaches the wire; frames in flight
        die whole at the server."""
        if self._chaos.tick("her_actor_kill") is not None:
            import signal

            print("[chaos] her_actor_kill: SIGKILL self", flush=True)
            os.kill(os.getpid(), signal.SIGKILL)

    def _step_envs(self) -> None:
        a = self.policy.act(self._obs)
        if self.noise_sigma > 0.0:
            a = a + self.noise_sigma * self._rng.standard_normal(a.shape).astype(np.float32)
        np.clip(a, -1.0, 1.0, out=a)
        for i, env in enumerate(self.envs):
            if self._chaos is not None:
                self._maybe_her_actor_kill()
            obs2, r, term, trunc, _info = env.step(a[i])
            if self.her:
                g_next = self._goal_view(env)
                g_prev = self._goal_prev[i]
                self.writers[i].add(
                    observation=g_prev[0], achieved_goal=g_prev[1], desired_goal=g_prev[2],
                    action=a[i].copy(), reward=float(r), next_observation=g_next[0],
                    next_achieved_goal=g_next[1], terminated=bool(term),
                )
                if term or trunc:
                    self._her_flush(i, truncated=not bool(term))
                    self._obs[i] = env.reset()
                    self._goal_prev[i] = self._goal_view(env)
                    self._inc("episodes")
                else:
                    self._obs[i] = obs2
                    self._goal_prev[i] = g_next
                continue
            # copied: the n-step writer keeps obs without a copy, and the
            # row is overwritten just below
            self.writers[i].add(self._obs[i].copy(), a[i], r, obs2,
                                terminated=term, truncated=trunc)
            if term or trunc:
                self._obs[i] = env.reset()
                self._inc("episodes")
            else:
                self._obs[i] = obs2
        self._inc("env_steps", self.num_envs)

    # ------------------------------------------------------------------ run
    def run(self) -> dict:
        """The main loop; returns the final counters. Runs until
        ``max_env_steps`` (0 = until stopped) or :meth:`request_stop`."""
        next_poll = time.monotonic() + self.poll_interval_s
        next_stats = time.monotonic() + self.stats_interval_s
        try:
            while not self._stop.is_set():
                if self.max_env_steps and self._stats["env_steps"] >= self.max_env_steps:
                    break
                now = time.monotonic()
                if now >= next_poll:
                    self._maybe_reload_bundle()
                    next_poll = now + self.poll_interval_s
                if now >= next_stats:
                    print(f"[fleet-actor] {self.stats()}", flush=True)
                    next_stats = now + self.stats_interval_s
                before = len(self.spool) + self.spool.dropped
                self._step_envs()
                self._inc("windows_emitted", len(self.spool) + self.spool.dropped - before)
                while len(self.spool) >= self.batch_windows and not self._stop.is_set():
                    if not self._flush_once():
                        break
            self._drain()
        finally:
            if self._link is not None:
                self._link.close()
                self._link = None
            for env in self.envs:
                if hasattr(env, "close"):
                    env.close()
        out = self.stats()
        print(f"[fleet-actor] drained: {out}", flush=True)
        # debug_guards: every emitted window is booked under one terminal
        # (acked, stale, shed, dropped) or still spooled
        flowledger.check("fleet-actor", out, where="actor drain")
        return out

    def _drain(self) -> None:
        """The final flush, bounded: ship the spool's windows and wait a
        little for the acks. A dead server means they count dropped; the
        drain never holds up a SIGTERM."""
        deadline = time.monotonic() + 5.0
        if self._link is None or self._link.dead is not None:
            # one bounded connect, never the Backoff's whole budget
            if self._link is not None:
                self._link.close()
                self._link = None
                self._inc("reconnects")
            try:
                self._link = FleetLink(self.host, self.port, self._hello(),
                                       on_ack=self._on_ack,
                                       connect_timeout_s=min(2.0, self.connect_timeout_s))
            except (OSError, ProtocolError, RuntimeError):
                return  # unreachable: what is spooled counts in spool_depth
        while self.spool.rows and time.monotonic() < deadline:
            if self._link.dead is not None or not self._flush_once(deadline=deadline):
                break
        link = self._link
        while link.inflight() > 0 and time.monotonic() < deadline:
            if link.dead is not None:
                break
            time.sleep(0.02)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m d4pg_tpu_torch.fleet.actor",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--connect", required=True, metavar="HOST:PORT",
                   help="the learner's ingest endpoint (train --fleet-listen)")
    p.add_argument("--bundle", required=True,
                   help="the bundle directory the trainer publishes (--fleet-bundle), "
                        "polled for hot swaps")
    p.add_argument("--env", default=None,
                   help="host env id (default: the bundle's provenance env); on the "
                        "card's machine pixel_pendulum_host, the host twin of "
                        "pixel_pendulum")
    p.add_argument("--num-envs", type=int, default=1,
                   help="envs in this process (one batched numpy forward a step)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--noise-sigma", type=float, default=0.3,
                   help="gaussian exploration noise in the (-1, 1) action box "
                        "(0 = deterministic)")
    p.add_argument("--batch-windows", type=int, default=16,
                   help="windows spooled before a frame ships")
    p.add_argument("--spool-limit", type=int, default=1024,
                   help="the bounded window spool; past it the oldest windows "
                        "drop (counted) while disconnected")
    p.add_argument("--poll-interval", type=float, default=2.0,
                   help="seconds between bundle.json mtime polls (the hot-swap cadence)")
    p.add_argument("--max-steps", type=int, default=0,
                   help="stop after this many env steps (0 = until a signal)")
    p.add_argument("--stats-interval", type=float, default=10.0)
    p.add_argument("--reconnect-attempts", type=int, default=60,
                   help="the bounded Backoff's attempts a disconnection; spending "
                        "them exits 1 (a supervisor restarts the host)")
    p.add_argument("--her", action="store_true",
                   help="hindsight relabelling on this host (goal-dict envs); the "
                        "learner must run --her too (negotiated at HELLO)")
    p.add_argument("--her-k", type=int, default=4,
                   help="relabelled copies a step (HER 'future' k)")
    p.add_argument("--variant", type=int, default=0,
                   help="the league variant this host is assigned to, declared in "
                        "the HELLO and matched exactly against the learner's "
                        "(0 = none)")
    p.add_argument("--chaos", default=None, metavar="PLAN",
                   help="deterministic fault injection (d4pg_tpu_torch/chaos.py), the "
                        "actor's sites: reconnect_flap@N, stale_bundle@N, "
                        "slow_link@N:ms, stale_stats@N, pixel_truncate@N, "
                        "her_actor_kill@N")
    p.add_argument("--debug-guards", action="store_true",
                   help="arm the lock witness and the flow ledger: the drain fails "
                        "on a lock-order contradiction or a window the books lost")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.debug_guards:
        # before FleetActor() builds its named locks
        lockwitness.enable()
        flowledger.enable()
    chaos = None
    if args.chaos:
        from d4pg_tpu_torch.chaos import ChaosInjector, ChaosPlan

        chaos = ChaosInjector(ChaosPlan.parse(args.chaos))
    actor = FleetActor(
        connect=args.connect,
        bundle_dir=args.bundle,
        env_id=args.env,
        num_envs=args.num_envs,
        seed=args.seed,
        noise_sigma=args.noise_sigma,
        batch_windows=args.batch_windows,
        spool_limit=args.spool_limit,
        poll_interval_s=args.poll_interval,
        max_env_steps=args.max_steps,
        stats_interval_s=args.stats_interval,
        reconnect_attempts=args.reconnect_attempts,
        chaos=chaos,
        her=args.her,
        her_k=args.her_k,
        variant=args.variant,
    )
    from d4pg_tpu_torch.utils.signals import install_graceful_signals

    install_graceful_signals(
        actor.request_stop,
        "[signal] {sig}: draining spool and exiting (second signal hard-kills)",
    )
    print(f"[fleet-actor] {actor.actor_id}: env={actor.env_id} x{actor.num_envs} -> "
          f"{actor.host}:{actor.port} (bundle generation {actor.policy.generation})",
          flush=True)
    try:
        actor.run()
    except RuntimeError as e:
        print(f"[fleet-actor] fatal: {e}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
