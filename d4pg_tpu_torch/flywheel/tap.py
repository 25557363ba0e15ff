"""The mirror tap: live obs→action→reward traffic → WINDOWS2 frames (the
port's copy of ``d4pg_tpu/flywheel/tap.py``, with C-6 repaired).

Rides inside a serving process (``serve/server.py``) and mirrors a
configured fraction of live traffic into the training plane:

- the server records each served request's observation
  (:meth:`MirrorTap.on_request`) and hands the client's reward echo to
  :meth:`MirrorTap.on_feedback` (the ``FEEDBACK`` frame: the executed
  action, the reward, next_obs, the episode bits, the behavior log-prob);
- striping is per EPISODE, with the router canary's Bresenham
  (``(seq · permille) % 1000 < permille``) per connection: an n-step
  window needs contiguous steps, so sampling per step would never
  complete one;
- mirrored steps run through the port's
  :class:`~d4pg_tpu_torch.replay.nstep_writer.NStepWriter`, the float64
  accumulation and float32 rounding the in-process and fleet-actor paths
  use, so mirrored windows are the rows those paths would store;
- completed windows leave on a sender thread as generation-tagged
  WINDOWS2 frames with the behavior log-prob column (``FLAG_LOGPROB``),
  to BOTH sinks: the fleet ingest (HELLO with ``source: "mirror"``, so
  the learner counts them apart) and the on-disk
  :class:`~d4pg_tpu_torch.flywheel.spool.MirrorSpool` the promotion gate
  reads. The spool is written first: the gate's picture of behavior
  traffic must not depend on the learner being up.

A frame holds at most what fits ``MAX_PAYLOAD`` with the log-prob
column, and no more than the ingest's ``max_windows_per_frame``; a
larger batch leaves as several frames, to both sinks (C-6: the JAX tap
encodes up to ``batch_windows`` windows in one frame, which at pixel
width and float32 rows exceeds ``MAX_PAYLOAD``, so its sender thread
dies and every later window stays pending). Below that cap the frames
and counters are the JAX tap's, byte for byte.

The accounting identity (the ``mirror-tap`` family of
``analysis/flow_identities.py``, checked at :meth:`MirrorTap.close`)::

    windows_built == windows_acked + windows_stale + windows_shed
                     + windows_dropped_chaos + windows_dropped_link
                     + windows_dropped_full + pending

``mirror_drop`` chaos ticks at the sender once per window, BEFORE either
sink: the window is lost on the data path, and ``windows_dropped_chaos``
keeps the identity exact.

numpy and the stdlib only, no torch.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from collections import deque
from typing import Optional

import numpy as np

from d4pg_tpu_torch.analysis import flowledger, lockwitness
from d4pg_tpu_torch.fleet import wire
from d4pg_tpu_torch.replay.nstep_writer import NStepWriter
from d4pg_tpu_torch.serve import protocol
from d4pg_tpu_torch.serve.protocol import ProtocolError

# tap counter keys, in healthz and report order
TAP_COUNTER_KEYS = (
    "feedback_steps",
    "feedback_unpaired",
    "episodes_seen",
    "episodes_mirrored",
    "windows_built",
    "windows_acked",
    "windows_stale",
    "windows_shed",
    "windows_dropped_chaos",
    "windows_dropped_link",
    "windows_dropped_full",
    "frames_sent",
    "spool_records",
    "link_reconnects",
    "generation",
)


def _bundle_generations(bundle_dir: str) -> tuple:
    """(generation, stats_generation) from a bundle's ``bundle.json``, the
    tag every mirrored frame carries (the serving bundle IS the behavior
    policy). Missing or torn meta gives (0, 0): the ingest's staleness
    rule then decides, the tap never guesses."""
    try:
        with open(os.path.join(bundle_dir, "bundle.json")) as f:
            meta = json.load(f).get("meta") or {}
        gen = int(meta.get("generation", 0))
        return gen, int(meta.get("stats_generation", gen))
    except (OSError, ValueError, TypeError):
        return 0, 0


class MirrorLink:
    """One synchronous connection to the fleet ingest: HELLO as a
    ``source: "mirror"`` peer, then one WINDOWS2 frame in flight at a
    time (mirror volume is a fraction of serving traffic). Raises
    OSError or ProtocolError on any failure; the tap's sender paces the
    reconnects."""

    def __init__(self, host: str, port: int, hello: dict, timeout_s: float = 10.0):
        self.sock = socket.create_connection((host, port), timeout=timeout_s)
        self.sock.settimeout(timeout_s)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.rfile = self.sock.makefile("rb")
        try:
            protocol.write_frame(self.sock, protocol.HELLO, 0, wire.encode_hello(**hello))
            frame = protocol.read_frame(self.rfile)
            if frame is None:
                raise ProtocolError("EOF before HELLO_OK")
            msg_type, _req_id, payload = frame
            if msg_type == protocol.ERROR:
                raise ProtocolError(
                    "ingest refused mirror handshake: "
                    f"{payload.decode('utf-8', 'replace')}"
                )
            if msg_type != protocol.HELLO_OK:
                raise ProtocolError(f"unexpected handshake reply type {msg_type}")
            ok = wire.decode_hello_ok(payload)
            self.max_windows = ok["max_windows_per_frame"]
            self.obs_mode = (ok.get("caps") or {}).get("obs_mode", "f32")
        except BaseException:
            self.close()
            raise

    def send(self, payload: bytes) -> tuple:
        """One frame, one ack → ``(accepted, dropped_stale, shed)``."""
        protocol.write_frame(self.sock, protocol.WINDOWS2, 1, payload)
        frame = protocol.read_frame(self.rfile)
        if frame is None:
            raise ProtocolError("EOF awaiting WINDOWS_OK")
        msg_type, _req_id, reply = frame
        if msg_type == protocol.WINDOWS_OK:
            accepted, dropped = wire.decode_windows_ok(reply)
            return accepted, dropped, 0
        if msg_type == protocol.OVERLOADED:
            return 0, 0, 1  # the whole frame shed (queue_full)
        if msg_type == protocol.ERROR:
            raise ProtocolError(f"ingest error: {reply.decode('utf-8', 'replace')}")
        raise ProtocolError(f"unexpected ack type {msg_type}")

    def close(self) -> None:
        # The buffered reader holds a reference to the socket, so close()
        # alone would leave the connection open: shut it down first, so
        # the ingest's reader sees EOF at once (C-5's lesson).
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.rfile.close()
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class _RowSink:
    """The ``buffer`` an NStepWriter emits into: collects rows so the tap
    can pair each with its behavior log-prob in emission order."""

    def __init__(self):
        self.rows = []

    def add(self, obs, action, reward, next_obs, discount):
        self.rows.append((obs, action, reward, next_obs, discount))

    def drain(self):
        rows, self.rows = self.rows, []
        return rows


class _Stream:
    """One client connection's mirror state, touched only under the tap's
    lock (episodes are sequential on a connection by the FEEDBACK
    contract)."""

    def __init__(self, n_step: int, gamma: float):
        self.sink = _RowSink()
        self.writer = NStepWriter(self.sink, n_step, gamma)
        self.lp_queue: deque = deque()  # behavior log-probs, in step order
        self.pending_obs: Optional[np.ndarray] = None
        self.episode_open = False
        self.mirroring = False
        self.seq = 0


class MirrorTap:
    # _thread_error goes None → exception once, by the sender thread
    # (check_alive checks, then raises); the link, reconnect and
    # generation cursors are touched ONLY by the sender thread (_sender_loop
    # → _flush → _ensure_link / _refresh_generation): one writer, one
    # reader, no lock
    _THREAD_SAFE = (
        "_thread_error", "_link", "_retry_at", "_retry_delay",
        "_gen", "_stats_gen", "_meta_mtime",
    )

    def __init__(
        self,
        *,
        obs_dim: int,
        action_dim: int,
        n_step: int,
        gamma: float,
        fraction: float,
        ingest_addr: Optional[tuple] = None,
        spool=None,
        bundle_dir: Optional[str] = None,
        env: str = "unknown",
        tap_id: str = "mirror",
        max_pending: int = 4096,
        batch_windows: int = 32,
        reconnect_min_s: float = 0.5,
        reconnect_max_s: float = 10.0,
        chaos=None,
    ):
        if not 0.0 <= fraction <= 1.0:
            raise ValueError(f"mirror fraction must be in [0,1]: {fraction}")
        self.obs_dim = int(obs_dim)
        self.action_dim = int(action_dim)
        self.n_step = int(n_step)
        self.gamma = float(gamma)
        self.permille = int(round(fraction * 1000))
        self.ingest_addr = ingest_addr
        self.spool = spool
        self.bundle_dir = bundle_dir
        self.env = env
        self.tap_id = tap_id
        self.max_pending = int(max_pending)
        self.batch_windows = int(batch_windows)
        self._reconnect_min_s = float(reconnect_min_s)
        self._reconnect_max_s = float(reconnect_max_s)
        self._chaos = chaos

        self._streams: dict = {}
        self._lock = lockwitness.named_lock("MirrorTap._lock")
        self._counters = dict.fromkeys(TAP_COUNTER_KEYS, 0)

        # (row, logprob) pairs awaiting the sender, bounded: past it NEW
        # windows drop with a counter (the tap must never push back on the
        # serving plane it rides in)
        self._pending: deque = deque()
        self._cond = lockwitness.named_condition("MirrorTap._cond")
        self._stop = False  # guarded by _cond

        self._link: Optional[MirrorLink] = None
        self._retry_at = 0.0
        self._retry_delay = self._reconnect_min_s
        self._gen = 0
        self._stats_gen = 0
        self._meta_mtime: Optional[float] = None
        self._thread_error: Optional[BaseException] = None
        self._sender = threading.Thread(target=self._sender_loop, name="mirror-tap-sender",
                                        daemon=True)
        self._sender.start()

    # --------------------------------------------------------------- counters
    def _inc(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._counters[key] += n

    def counters(self) -> dict:
        with self._lock:
            out = dict(self._counters)
        with self._cond:
            out["pending"] = len(self._pending)
        out["permille"] = self.permille
        return out

    def check_alive(self) -> None:
        if self._thread_error is not None:
            raise RuntimeError("mirror tap sender died") from self._thread_error

    # -------------------------------------------------------------- tap hooks
    def on_request(self, key, obs: np.ndarray) -> None:
        """Every served request of the mirrored policy: remembers the
        observation the NEXT feedback on this connection pairs with (the
        FEEDBACK contract is request → feedback, in turn, a connection)."""
        with self._lock:
            stream = self._streams.get(key)
            if stream is None:
                stream = self._streams[key] = _Stream(self.n_step, self.gamma)
            stream.pending_obs = np.asarray(obs, np.float32)

    def on_feedback(self, key, fb: dict) -> None:
        """One reward echo: pairs it with the pending request observation,
        runs the mirrored episode through the n-step writer and queues the
        windows it completes for the sender."""
        rows = None
        with self._lock:
            stream = self._streams.get(key)
            if stream is None or stream.pending_obs is None:
                self._counters["feedback_unpaired"] += 1
                return
            obs, stream.pending_obs = stream.pending_obs, None
            if not stream.episode_open:
                # an episode boundary: the stripe decision, Bresenham per
                # stream, so any fraction spreads evenly, never in bursts
                stream.seq += 1
                stream.mirroring = (stream.seq * self.permille) % 1000 < self.permille
                stream.episode_open = True
                self._counters["episodes_seen"] += 1
                if stream.mirroring:
                    self._counters["episodes_mirrored"] += 1
            self._counters["feedback_steps"] += 1
            done = fb["terminated"] or fb["truncated"]
            if stream.mirroring:
                stream.lp_queue.append(float(fb["log_prob"]))
                stream.writer.add(
                    obs,
                    np.asarray(fb["action"], np.float32),
                    fb["reward"],
                    np.asarray(fb["next_obs"], np.float32),
                    fb["terminated"],
                    fb["truncated"],
                )
                emitted = stream.sink.drain()
                if emitted:
                    # one behavior log-prob per emitted window, in the
                    # writer's emission order: each pop takes the oldest
                    # unemitted step's propensity
                    rows = [(row, stream.lp_queue.popleft()) for row in emitted]
            if done:
                stream.episode_open = False
                stream.lp_queue.clear()
                stream.writer.reset()
        if rows:
            self._enqueue(rows)

    def on_disconnect(self, key) -> None:
        """Drops the connection's stream whole: a torn episode's unfinished
        window must never emit (the pool's ``drop_actor`` contract)."""
        with self._lock:
            self._streams.pop(key, None)

    def _enqueue(self, rows: list) -> None:
        dropped = 0
        with self._cond:
            for pair in rows:
                if len(self._pending) >= self.max_pending:
                    dropped += 1
                else:
                    self._pending.append(pair)
            self._cond.notify()
        self._inc("windows_built", len(rows))
        if dropped:
            self._inc("windows_dropped_full", dropped)

    # ----------------------------------------------------------------- sender
    def _refresh_generation(self) -> None:
        if self.bundle_dir is None:
            return
        try:
            mtime = os.stat(os.path.join(self.bundle_dir, "bundle.json")).st_mtime
        except OSError:
            return
        if mtime == self._meta_mtime:
            return
        self._meta_mtime = mtime
        self._gen, self._stats_gen = _bundle_generations(self.bundle_dir)
        with self._lock:
            self._counters["generation"] = self._gen

    def _hello(self) -> dict:
        return {
            "actor_id": self.tap_id,
            "env": self.env,
            "obs_dim": self.obs_dim,
            "action_dim": self.action_dim,
            "n_step": self.n_step,
            "gamma": self.gamma,
            "generation": self._gen,
            "caps": {
                "wire": 2,
                "obs_modes": ["f32", "u8"],
                "her": False,
                "obs_norm": False,
                "variant": 0,
                "source": "mirror",
            },
        }

    def _ensure_link(self) -> Optional[MirrorLink]:
        if self._link is not None:
            return self._link
        if self.ingest_addr is None:
            return None
        now = time.monotonic()
        if now < self._retry_at:
            return None
        try:
            self._link = MirrorLink(self.ingest_addr[0], self.ingest_addr[1], self._hello())
            self._retry_delay = self._reconnect_min_s
            self._inc("link_reconnects")
        except (OSError, ProtocolError):
            self._retry_at = now + self._retry_delay
            self._retry_delay = min(self._retry_delay * 2, self._reconnect_max_s)
            return None
        return self._link

    def _frame_cap(self, link: Optional[MirrorLink], obs_mode: str) -> int:
        """The most windows one frame may carry: what fits ``MAX_PAYLOAD``
        with the log-prob column, and no more than the ingest advertised."""
        fit = wire.max_windows_per_frame(self.obs_dim, self.action_dim, obs_mode=obs_mode,
                                         logprob=True)
        return fit if link is None else max(1, min(fit, int(link.max_windows)))

    def _sender_loop(self) -> None:
        try:
            while True:
                batch = []
                with self._cond:
                    while not self._pending and not self._stop:
                        self._cond.wait(0.2)
                    if not self._pending and self._stop:
                        return
                    while self._pending and len(batch) < self.batch_windows:
                        batch.append(self._pending.popleft())
                self._flush(batch)
        except BaseException as e:
            self._thread_error = e
            raise

    def _flush(self, batch: list) -> None:
        # mirror_drop: the window is lost on the data path, before EITHER
        # sink; its counter is the only trace, and the identity balances
        # through it
        if self._chaos is not None:
            kept = []
            for pair in batch:
                if self._chaos.tick("mirror_drop") is not None:
                    self._inc("windows_dropped_chaos")
                else:
                    kept.append(pair)
            batch = kept
        if not batch:
            return
        self._refresh_generation()
        link = self._ensure_link()
        obs_mode = link.obs_mode if link is not None else "f32"
        cap = self._frame_cap(link, obs_mode)
        for start in range(0, len(batch), cap):
            self._send_frame(batch[start:start + cap], obs_mode)

    def _send_frame(self, frame: list, obs_mode: str) -> None:
        """One frame of at most the cap's windows: spooled, then sent on
        the link the batch started with while it lives."""
        n = len(frame)
        obs = np.stack([r[0] for r, _lp in frame])
        action = np.stack([r[1] for r, _lp in frame])
        reward = np.asarray([r[2] for r, _lp in frame], np.float32)
        next_obs = np.stack([r[3] for r, _lp in frame])
        discount = np.asarray([r[4] for r, _lp in frame], np.float32)
        logprob = np.asarray([lp for _r, lp in frame], np.float32)
        payload = wire.encode_windows2(
            self._gen, self._stats_gen, obs_mode, False,
            obs, action, reward, next_obs, discount, logprob=logprob,
        )
        if self.spool is not None:
            # spool FIRST: the windows are honest behavior data whether or
            # not the ingest is up or shedding
            self.spool.append(payload)
            self._inc("spool_records")
        link = self._link
        if link is None:
            self._inc("windows_dropped_link", n)
            return
        try:
            accepted, stale, shed = link.send(payload)
        except (OSError, ProtocolError):
            link.close()
            self._link = None
            self._retry_at = time.monotonic() + self._retry_delay
            self._inc("windows_dropped_link", n)
            return
        self._inc("frames_sent")
        if shed:
            self._inc("windows_shed", n)
        else:
            self._inc("windows_acked", accepted)
            self._inc("windows_stale", stale)

    # -------------------------------------------------------------- lifecycle
    def close(self, timeout: float = 15.0) -> None:
        """Drains the pending queue (bounded, so this ends), stops the
        sender and checks the ``mirror-tap`` identity (a no-op unless the
        flow ledger is armed)."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._sender.join(timeout=timeout)
        if self._link is not None:
            self._link.close()
            self._link = None
        if self.spool is not None:
            self.spool.close()
        flowledger.check("mirror-tap", self.counters(), where="tap close")
