"""The experience-ingest server: fleet actors' windows → the replay writer
(the port's copy of ``d4pg_tpu/fleet/ingest.py``).

The learner's half of the collection fleet. Actor hosts (``python -m
d4pg_tpu_torch.fleet.actor``) connect over the serve framing, open with
``HELLO`` (dims, n-step and gamma checked against the replay's, the
capabilities negotiated; a mismatch is refused before any window lands)
and then stream ``WINDOWS`` / ``WINDOWS2`` frames of complete n-step
windows. The threads:

- one accept thread;
- one reader thread a connection, its reads bounded by
  ``read_timeout_s``, so a half-open peer is closed (the actor reconnects
  under its Backoff) instead of holding a thread for good;
- one writer thread that drains a bounded frame queue into
  ``buffer.add_batch``, the call the in-process n-step writers make, so
  fleet and in-process replay hold the same rows. The buffer's own lock
  orders it against the learner's draws and priority write-backs, and a
  prioritized buffer seeds each new row's leaf at the max priority under
  that lock; ``total_added`` advances after the rows are written, which
  is what the device ring's mirror reads.

Admission, per frame, as the serve batcher admits requests:

- a full queue answers ``OVERLOADED`` ``queue_full`` at once
  (``windows_shed``);
- a frame made under a bundle generation older than ``current −
  max_gen_lag`` is counted (``windows_dropped_stale_gen``) and never
  written, and so is one acted under stale obs-norm statistics
  (``windows_dropped_stale_stats``); the trainer bumps the generation at
  every bundle publication;
- a torn frame never reaches replay: actors ship complete windows, a
  frame cut by a disconnect dies in ``read_frame`` as a ProtocolError,
  whole, and an actor drops, never resends, what was unacknowledged.

A uint8 replay takes the u8 wire's bytes as they are: its frames are
decoded to uint8 (``wire.decode_windows2(raw_u8=True)``) and the buffer
stores them without a float round trip. With obs-norm (fleet-only runs)
the writer folds the statistics once per original window, before
``add_batch``; relabelled windows fold nothing.

``debug_guards``: the writer's two rotating staging slots are tagged in
the trainer's :class:`~d4pg_tpu_torch.analysis.ledger.StagingLedger`
(written before each fill, held across the ``add_batch`` copy), and
``close`` checks the ``fleet-ingest`` flow identity.

numpy and the stdlib only, like every fleet module.
"""

from __future__ import annotations

import errno
import json
import socket
import threading
import time
from collections import deque
from typing import Optional

import numpy as np

from d4pg_tpu_torch.analysis import flowledger, lockwitness
from d4pg_tpu_torch.analysis.ledger import NULL_LEDGER
from d4pg_tpu_torch.fleet import wire
from d4pg_tpu_torch.netio import configure_reply_timeout
from d4pg_tpu_torch.replay import source
from d4pg_tpu_torch.replay.uniform import Transition
from d4pg_tpu_torch.serve import protocol
from d4pg_tpu_torch.serve.protocol import ProtocolError

# counter keys, in the order of the metrics rows and the healthz reply
COUNTER_KEYS = (
    "windows_ingested",
    # windows_ingested split by the HELLO's source: the collection fleet
    # ("actor") and the flywheel's serving tap ("mirror")
    "windows_from_actors",
    "windows_from_mirror",
    "windows_dropped_stale_gen",
    "windows_dropped_stale_stats",
    "windows_shed",
    "frames_total",
    "bytes_total",
    "connections",
    "connections_total",
    "protocol_errors",
    "handshake_refusals",
    "generation",
    "stats_generation",
)
COLUMNS = ("obs", "action", "reward", "next_obs", "discount")


class IngestServer:
    """A bounded-queue experience ingest in front of a replay buffer, which
    needs ``add_batch(Transition)`` only (uniform and PER buffers both)."""

    def __init__(
        self,
        buffer,
        *,
        obs_dim: int,
        action_dim: int,
        n_step: int,
        gamma: float,
        host: str = "127.0.0.1",
        port: int = 0,
        queue_limit: int = 64,
        read_timeout_s: float = 120.0,
        max_gen_lag: int = 1,
        max_inflight: int = 8,
        caps: Optional[dict] = None,
        obs_norm=None,
        ledger=None,
        chaos=None,
    ):
        assert queue_limit >= 1 and max_inflight >= 1
        self.buffer = buffer
        self.obs_dim = int(obs_dim)
        self.action_dim = int(action_dim)
        self.n_step = int(n_step)
        self.gamma = float(gamma)
        self.host = host
        self._requested_port = port
        self.port: Optional[int] = None
        self.queue_limit = int(queue_limit)
        self.read_timeout_s = float(read_timeout_s)
        self.max_gen_lag = int(max_gen_lag)
        self.max_inflight = int(max_inflight)
        # What the learner's replay needs of actors (obs wire mode, HER,
        # stats tags, its league variant); None = the first actors' f32,
        # no HER, no stats, variant 0.
        self.caps = dict(caps) if caps is not None else {
            "obs_mode": "f32", "her": False, "obs_norm": False,
        }
        self.caps.setdefault("variant", 0)
        # the one statistics writer of a fleet-only obs-norm run
        # (source.py's obs_norm_fleet_single_writer gap keeps local
        # collection out): one fold per original window
        self._obs_norm = obs_norm
        self.max_windows = wire.max_windows_per_frame(
            obs_dim, action_dim, obs_mode=self.caps["obs_mode"]
        )
        self._chaos = chaos
        # u8 rows land in a uint8 replay as the wire's bytes
        self._raw_u8 = (self.caps["obs_mode"] == "u8"
                        and np.dtype(getattr(buffer, "obs_dtype", np.float32)) == np.uint8)

        # Readers append (columns, fold, source); the writer drains. Past
        # queue_limit a reader sheds with OVERLOADED.
        self._queue: deque = deque()
        self._cond = lockwitness.named_condition("IngestServer._cond")
        self._stop = False  # guarded by _cond

        # The writer's two rotating staging slots, tagged in the ledger
        # under debug_guards: add_batch copies them synchronously, so a
        # hold spans exactly the copy.
        cap = self.max_windows * 2
        obs_dtype = np.uint8 if self._raw_u8 else np.float32
        self._staging = [
            {
                "obs": np.zeros((cap, obs_dim), obs_dtype),
                "action": np.zeros((cap, action_dim), np.float32),
                "reward": np.zeros(cap, np.float32),
                "next_obs": np.zeros((cap, obs_dim), obs_dtype),
                "discount": np.zeros(cap, np.float32),
            }
            for _ in range(2)
        ]
        self._staging_cap = cap
        self._staging_flip = 0  # the writer thread's alone
        self._ledger = ledger if ledger is not None else NULL_LEDGER
        self._staging_group = "fleet.ingest"

        self._counters = dict.fromkeys(COUNTER_KEYS, 0)
        self._counters_lock = lockwitness.named_lock("IngestServer._counters_lock")

        self._listen_sock: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._writer_thread: Optional[threading.Thread] = None
        self._conns: set = set()
        self._conns_lock = lockwitness.named_lock("IngestServer._conns_lock")
        self._shutdown = threading.Event()
        self._thread_error: Optional[BaseException] = None
        self._started = False

    # -------------------------------------------------------------- lifecycle
    def start(self) -> "IngestServer":
        if self._started:
            raise RuntimeError("ingest server already started")
        self._started = True
        self._listen_sock = socket.create_server((self.host, self._requested_port))
        self.port = self._listen_sock.getsockname()[1]
        self._writer_thread = threading.Thread(
            target=self._writer_loop, name="fleet-ingest-writer", daemon=True)
        self._writer_thread.start()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="fleet-ingest-accept", daemon=True)
        self._accept_thread.start()
        return self

    def close(self, timeout: float = 30.0) -> None:
        """Drain and stop: no new connection; every frame already admitted
        to the queue is written to replay; then the threads stop."""
        self._shutdown.set()
        if self._listen_sock is not None:
            # shutdown() and a connection of its own: close() alone does
            # not wake a thread blocked in accept()
            try:
                self._listen_sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            wake = "127.0.0.1" if self.host in ("0.0.0.0", "") else self.host
            try:
                with socket.create_connection((wake, self.port), timeout=1):
                    pass
            except OSError:
                pass
            try:
                self._listen_sock.close()
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)
            self._accept_thread = None
        # the readers block in recv; closing their sockets wakes them
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._writer_thread is not None:
            self._writer_thread.join(timeout=timeout)
            if self._writer_thread.is_alive():
                raise RuntimeError("ingest writer thread failed to drain")
            self._writer_thread = None
        # debug_guards: the per-source split balances once the queue drained
        flowledger.check("fleet-ingest", self.counters(), where="ingest close")

    def check_alive(self) -> None:
        if self._thread_error is not None:
            raise RuntimeError("fleet ingest thread died") from self._thread_error

    # --------------------------------------------------------------- counters
    def _inc(self, key: str, n: int = 1) -> None:
        with self._counters_lock:
            self._counters[key] += n

    def set_generation(self, generation: int) -> None:
        """The trainer's call at every bundle publication: from here on,
        windows made under generations older than ``generation −
        max_gen_lag`` are dropped. The obs-norm statistics ride the same
        bundle, so their generation moves with it."""
        with self._counters_lock:
            self._counters["generation"] = int(generation)
            self._counters["stats_generation"] = int(generation)

    @property
    def generation(self) -> int:
        with self._counters_lock:
            return self._counters["generation"]

    @property
    def stats_generation(self) -> int:
        with self._counters_lock:
            return self._counters["stats_generation"]

    def counters(self) -> dict:
        """A snapshot of the counters; the trainer puts them into every
        metrics row as ``fleet_<key>``."""
        with self._counters_lock:
            return dict(self._counters)

    # ------------------------------------------------------------ connections
    def _accept_loop(self) -> None:
        while not self._shutdown.is_set():
            try:
                conn, _addr = self._listen_sock.accept()
            except OSError as e:
                if self._shutdown.is_set():
                    return  # the listening socket closed: draining
                if e.errno in (errno.EBADF, errno.EINVAL):
                    # the listening socket died without a drain: surface it
                    # (check_alive) rather than never accepting again while
                    # the learner waits
                    self._thread_error = e
                    return
                # transient (ECONNABORTED from a reset between SYN and
                # accept, as partition and flap traffic makes, or a brief
                # EMFILE): keep accepting
                time.sleep(0.05)
                continue
            if self._shutdown.is_set():
                try:
                    conn.close()  # close()'s own wake-up connection
                except OSError:
                    pass
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # acks' sends are bounded: an actor that stops reading must not
            # wedge its reader thread
            configure_reply_timeout(conn)
            # reads are bounded too: a peer gone half-open is closed
            conn.settimeout(self.read_timeout_s)
            with self._conns_lock:
                self._conns.add(conn)
            self._inc("connections_total")
            self._inc("connections")
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name="fleet-ingest-conn", daemon=True).start()

    def _healthz(self, conn, req_id: int) -> None:
        protocol.write_frame(conn, protocol.HEALTHZ_OK, req_id,
                             json.dumps(self.counters()).encode())

    def _handshake(self, conn, rfile) -> Optional[dict]:
        """The first frame that is not a HEALTHZ must be a valid HELLO; the
        reply is HELLO_OK or ERROR. Returns the negotiated capabilities
        when the connection may stream windows, else None. HEALTHZ is
        answered before the handshake, as on the serve port."""
        while True:
            frame = protocol.read_frame(rfile)
            if frame is None:
                return None
            msg_type, req_id, payload = frame
            if msg_type != protocol.HEALTHZ:
                break
            self._healthz(conn, req_id)
        if msg_type != protocol.HELLO:
            raise ProtocolError(f"expected HELLO as the first frame, got type {msg_type}")
        hello = wire.decode_hello(payload)  # the numbers come typed
        problems = []
        if hello["obs_dim"] != self.obs_dim:
            problems.append(f"obs_dim {hello['obs_dim']} != {self.obs_dim}")
        if hello["action_dim"] != self.action_dim:
            problems.append(f"action_dim {hello['action_dim']} != {self.action_dim}")
        if hello["n_step"] != self.n_step:
            problems.append(f"n_step {hello['n_step']} != {self.n_step}")
        if abs(hello["gamma"] - self.gamma) > 1e-9:
            problems.append(f"gamma {hello['gamma']} != {self.gamma}")
        actor_caps = hello.get("caps") or source.LEGACY_ACTOR_CAPS
        chosen, gaps = source.negotiate_fleet(self.caps, actor_caps)
        if problems or gaps:
            # a misconfigured actor fails at connect, before it streams
            # windows of the wrong MDP
            self._inc("handshake_refusals")
            protocol.write_frame(
                conn, protocol.ERROR, req_id,
                wire.encode_refusal("; ".join(problems + [g.message for g in gaps]), gaps),
            )
            return None
        protocol.write_frame(
            conn, protocol.HELLO_OK, req_id,
            wire.encode_hello_ok(
                generation=self.generation,
                max_windows=self.max_windows,
                max_inflight=self.max_inflight,
                # caps only to an actor that sent caps: the v1 reply stays
                # the v1 bytes
                caps=chosen if hello.get("caps") is not None else None,
                stats_generation=self.stats_generation,
            ),
        )
        return chosen

    def _decode(self, msg_type: int, payload: bytes):
        """A windows frame → ``(generation, stats generation or None,
        relabelled, columns)``; a frame the connection's negotiation does
        not allow is a ProtocolError."""
        if msg_type == protocol.WINDOWS:
            # the first actors' frame: f32 rows, no stats tag, allowed only
            # on the plain wire (on a u8, bf16 or obs-norm ingest it would
            # bypass the negotiated encoding)
            if self.caps["obs_mode"] != "f32" or self.caps["obs_norm"]:
                raise ProtocolError(
                    "WINDOWS (v1) frame on a connection that "
                    f"negotiated obs_mode={self.caps['obs_mode']!r}"
                    f"/obs_norm={self.caps['obs_norm']}; speak WINDOWS2"
                )
            gen, cols = wire.decode_windows(payload, self.obs_dim, self.action_dim)
            return gen, None, False, cols
        if msg_type == protocol.WINDOWS2:
            gen, stats_gen, obs_mode, relabeled, cols = wire.decode_windows2(
                payload, self.obs_dim, self.action_dim, raw_u8=self._raw_u8)
            if obs_mode != self.caps["obs_mode"]:
                raise ProtocolError(
                    f"WINDOWS2 frame carries obs_mode={obs_mode!r}, "
                    f"connection negotiated {self.caps['obs_mode']!r}"
                )
            # the flywheel's log-prob column feeds its gate, not replay
            cols.pop("logprob", None)
            return gen, stats_gen, relabeled, cols
        raise ProtocolError(f"unexpected message type {msg_type}")

    def _admit(self, conn, req_id: int, payload_len: int, gen: int, stats_gen,
               relabeled: bool, cols: dict, src: str) -> None:
        """Count, then drop (stale), shed (queue full) or queue one frame,
        and answer it."""
        self._inc("frames_total")
        self._inc("bytes_total", payload_len)
        n = len(cols["reward"])
        if gen < self.generation - self.max_gen_lag:
            # made by a policy the learner has moved past: dropped,
            # counted, and the actor told
            self._inc("windows_dropped_stale_gen", n)
            protocol.write_frame(conn, protocol.WINDOWS_OK, req_id, wire.encode_windows_ok(0, n))
            return
        if (self.caps["obs_norm"] and stats_gen is not None
                and stats_gen < self.stats_generation - self.max_gen_lag):
            # acted under normalizer statistics the learner has moved
            # past: the same staleness, counted apart
            self._inc("windows_dropped_stale_stats", n)
            protocol.write_frame(conn, protocol.WINDOWS_OK, req_id, wire.encode_windows_ok(0, n))
            return
        fold = bool(self.caps["obs_norm"]) and not relabeled
        with self._cond:
            full = len(self._queue) >= self.queue_limit
            if not full:
                self._queue.append((cols, fold, src))
                self._cond.notify()
        if full:
            # the writer is behind: an honest no, and the actor backs off
            self._inc("windows_shed", n)
            protocol.write_frame(conn, protocol.OVERLOADED, req_id, b"queue_full")
            return
        protocol.write_frame(conn, protocol.WINDOWS_OK, req_id, wire.encode_windows_ok(n, 0))

    def _serve_conn(self, conn: socket.socket) -> None:
        rfile = conn.makefile("rb")
        try:
            negotiated = self._handshake(conn, rfile)
            if negotiated is None:
                return
            src = str(negotiated.get("source", "actor"))
            while True:
                frame = protocol.read_frame(rfile)
                if frame is None:
                    return  # clean EOF: the actor drained and closed
                if self._chaos is not None and self._chaos.tick("partition") is not None:
                    # an abortive close with frames in flight, the
                    # partition's shape: the actor drops what is unacked
                    # and reconnects under its Backoff, never resending
                    protocol.abortive_close(conn)
                    raise OSError("chaos: injected partition")
                msg_type, req_id, payload = frame
                if msg_type == protocol.HEALTHZ:
                    self._healthz(conn, req_id)
                    continue
                gen, stats_gen, relabeled, cols = self._decode(msg_type, payload)
                self._admit(conn, req_id, len(payload), gen, stats_gen, relabeled, cols, src)
        except ProtocolError as e:
            # framing is lost: ERROR once, close. A frame cut mid-payload
            # died in read_frame and never reached the queue.
            self._inc("protocol_errors")
            try:
                protocol.write_frame(conn, protocol.ERROR, 0, str(e).encode())
            except OSError:
                pass
        except OSError:
            pass  # a reset, the read deadline, or close() shut the socket
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            self._inc("connections", -1)
            try:
                rfile.close()
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass

    # ---------------------------------------------------------------- writer
    def _writer_loop(self) -> None:
        try:
            while True:
                frames = []
                with self._cond:
                    while not self._queue and not self._stop:
                        self._cond.wait(0.2)
                    if not self._queue and self._stop:
                        return
                    # every frame queued since the last wake, up to the
                    # staging slot: one add_batch a wake
                    rows = 0
                    while self._queue:
                        n = len(self._queue[0][0]["reward"])
                        if frames and rows + n > self._staging_cap:
                            break
                        frames.append(self._queue.popleft())
                        rows += n
                self._write_frames(frames)
        except BaseException as e:
            self._thread_error = e
            raise

    def _write_frames(self, frames: list) -> None:
        """``frames``: ``(columns, fold, source)`` triples off the queue."""
        total = sum(len(f["reward"]) for f, _fold, _src in frames)
        if total == 0:
            return
        if self._obs_norm is not None:
            # the one statistics writer, before add_batch, so no sampled
            # batch sees rows its statistics have not folded
            for f, fold, _src in frames:
                if fold:
                    self._obs_norm.update(f["obs"])
        flip = self._staging_flip
        self._staging_flip = 1 - flip
        self._ledger.write(self._staging_group, flip, writer="fleet-ingest-writer")
        staging = self._staging[flip]
        if total <= self._staging_cap:
            pos = 0
            for f, _fold, _src in frames:
                n = len(f["reward"])
                for k in COLUMNS:
                    staging[k][pos:pos + n] = f[k]
                pos += n
            cols = {k: staging[k][:total] for k in COLUMNS}
        else:
            # a single frame larger than a slot is written unstaged
            cols = {k: np.concatenate([f[k] for f, _fold, _src in frames]) for k in COLUMNS}
        hold = self._ledger.hold(self._staging_group, flip, holder="fleet-ingest-add_batch")
        try:
            self.buffer.add_batch(Transition(*(cols[k] for k in COLUMNS)))
        finally:
            # add_batch copied under the buffer's lock: the slot is free
            hold.release()
        mirror = sum(len(f["reward"]) for f, _fold, s in frames if s == "mirror")
        self._inc("windows_ingested", total)
        if mirror:
            self._inc("windows_from_mirror", mirror)
        if total - mirror:
            self._inc("windows_from_actors", total - mirror)
