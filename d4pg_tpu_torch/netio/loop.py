"""The event loop itself: FrameLoop + Connection (the port's copy of
``d4pg_tpu/netio/loop.py``).

One thread (``<name>`` from the constructor, default ``netio-loop``)
owns a ``selectors.DefaultSelector`` (epoll on linux — O(ready), not
O(connections), which is what makes 10k idle connections cheap) and is
the only thread that touches socket state. Everything other threads may
do — ``Connection.send`` from a batcher callback, ``call_soon``/
``call_later``, ``close`` — either takes the connection's queue lock or
marshals onto the loop via the callback queue + a socketpair wakeup.

Handler callbacks (``on_frame``/``on_open``/``on_close``/
``on_protocol_error``) run ON the loop thread and must not block: a
``time.sleep`` or a blocking socket call in a callback stalls every
connection on the loop. The socket calls inside this module are all
non-blocking (each says so where it is made).
"""

from __future__ import annotations

import errno
import heapq
import os
import selectors
import socket
import struct
import threading
import time
from collections import deque
from typing import Callable, Optional

from d4pg_tpu_torch.analysis import lockwitness
from d4pg_tpu_torch.serve import protocol

__all__ = ["Connection", "FrameLoop", "configure_reply_timeout"]

#: Write-progress deadline default: a peer that drains nothing for this
#: long forfeits the connection.
DEFAULT_WRITE_STALL_S = 10.0
#: Read-progress (frame-completion) deadline default: once a partial
#: frame exists the peer has this long to finish it.
DEFAULT_READ_STALL_S = 30.0
#: Per-connection buffered-reply watermark: a never-reading peer can
#: make the server hold at most this many queued bytes before eviction.
DEFAULT_WRITE_BUFFER_LIMIT = 8 << 20

_RECV_CHUNK = 1 << 17
_ACCEPTS_PER_TICK = 64
_ACCEPT_BACKOFF_S = 0.1
# errnos that mean "out of descriptors/buffers", not "this one client
# misbehaved": shed admission-controlled instead of killing the loop.
_EXHAUSTION_ERRNOS = tuple(
    getattr(errno, n) for n in ("EMFILE", "ENFILE", "ENOBUFS", "ENOMEM")
    if hasattr(errno, n)
)


def configure_reply_timeout(sock, timeout_s: float = DEFAULT_WRITE_STALL_S) -> None:
    """The write deadline of an endpoint that replies from a thread (the
    fleet ingest's readers): ``SO_SNDTIMEO`` bounds every blocking reply
    write, so a peer that stops reading makes the write time out (and the
    thread close the connection) instead of wedging the thread for good.
    The loop's front ends have the write-progress deadline instead."""
    try:
        sock.setsockopt(
            socket.SOL_SOCKET, socket.SO_SNDTIMEO,
            struct.pack("ll", int(timeout_s), 0),
        )
    except OSError:
        # best effort: not every stack has it, and the deadline bounds a
        # fault, it does not make the replies right
        pass


class Connection:
    """One accepted socket on a :class:`FrameLoop`.

    Socket/selector/deadline state is loop-thread-owned. The outbound
    frame queue is the one cross-thread surface: :meth:`send` (any
    thread) appends under ``_lock``; the loop flushes. Identity (``id``
    of this object) is the per-connection key front-ends hand to taps
    and logs, exactly as the thread path keyed on the socket object.
    """

    # Loop-thread-owned fields (single writer: every mutation happens on
    # the loop thread; `send` only appends to the deque under _lock and
    # reads flags written under the same lock).
    _THREAD_SAFE = (
        "_out_off", "_read_deadline", "_write_deadline",
        "_read_timer_armed", "_write_timer_armed", "closed",
    )

    __slots__ = (
        "loop", "sock", "addr",
        "assembler",
        "_lock", "_out", "_out_bytes", "_out_off",
        "closed", "_close_requested",
        "_read_deadline", "_read_timer_armed",
        "_write_deadline", "_write_timer_armed",
    )

    def __init__(self, loop: "FrameLoop", sock, addr):
        self.loop = loop
        self.sock = sock
        self.addr = addr
        self.assembler = protocol.FrameAssembler()
        self._lock = lockwitness.named_lock("Connection._lock")
        self._out: deque = deque()      # encoded frames awaiting the kernel
        self._out_bytes = 0             # total queued (watermark input)
        self._out_off = 0               # sent bytes of the head frame
        self.closed = False
        self._close_requested = False
        self._read_deadline: Optional[float] = None
        self._read_timer_armed = False
        self._write_deadline: Optional[float] = None
        self._write_timer_armed = False

    # ------------------------------------------------------------- any thread
    def send(self, msg_type: int, req_id: int, payload: bytes = b"") -> bool:
        """Queue one frame (encoded via ``protocol.encode_frame`` — the
        byte-compat anchor) and kick the flush. Returns False when the
        connection is already closed/closing, so the caller can book a
        dropped reply — same contract as the thread path's OSError on a
        dead socket."""
        buf = protocol.encode_frame(msg_type, req_id, payload)
        with self._lock:
            if self.closed or self._close_requested:
                return False
            self._out.append(buf)
            self._out_bytes += len(buf)
        if self.loop.on_loop_thread():
            self.loop._flush(self)
        else:
            self.loop.call_soon(self.loop._flush, self)
        return True

    def close(self) -> None:
        """Flush whatever is queued, then close (the graceful path:
        ERROR-then-close, drain). The write-progress deadline still
        bounds the flush — a peer that will not drain it gets evicted,
        not waited on forever."""
        with self._lock:
            if self.closed or self._close_requested:
                return
            self._close_requested = True
        if self.loop.on_loop_thread():
            self.loop._flush(self)
        else:
            self.loop.call_soon(self.loop._flush, self)

    def abort(self) -> None:
        """Abortive close NOW (RST; queued frames dropped)."""
        if self.loop.on_loop_thread():
            self.loop._teardown(self, abortive=True)
        else:
            self.loop.call_soon(self.loop._teardown, self, True)

    @property
    def write_backlog(self) -> int:
        """Queued-but-unsent reply bytes (tests/observability)."""
        with self._lock:
            return self._out_bytes

    def __repr__(self) -> str:
        return f"Connection({self.addr!r}, closed={self.closed})"


class FrameLoop:
    """The selectors loop. Construct, :meth:`serve` a listening socket,
    :meth:`start`; tear down with :meth:`stop_accepting` (drain step 1)
    then :meth:`close` (bounded flush of every connection, loop-thread
    join). Thread count is O(1) in connections: this thread is the only
    one netio ever creates."""

    # Loop state below is loop-thread-owned after start() (single
    # writer); cross-thread producers go through _cb_lock'd call_soon.
    # _tid is written once by the loop thread at startup and only read
    # elsewhere; _flush_deadline/_accept_paused flip on the loop thread;
    # _timer_seq is bumped only in _call_at, which always runs on the
    # loop (call_later marshals the heap push through call_soon).
    _THREAD_SAFE = (
        "_tid", "_stats", "_flush_deadline", "_accept_paused",
        "_reserve_fd", "_listener", "_stopping", "_timer_seq",
    )

    def __init__(
        self,
        *,
        name: str = "netio-loop",
        read_stall_s: float = DEFAULT_READ_STALL_S,
        write_stall_s: float = DEFAULT_WRITE_STALL_S,
        write_buffer_limit: int = DEFAULT_WRITE_BUFFER_LIMIT,
    ):
        self.name = name
        self.read_stall_s = float(read_stall_s)
        self.write_stall_s = float(write_stall_s)
        self.write_buffer_limit = int(write_buffer_limit)
        self._selector = selectors.DefaultSelector()
        self._conns: set = set()
        self._listener = None
        self._on_frame: Optional[Callable] = None
        self._on_open: Optional[Callable] = None
        self._on_close: Optional[Callable] = None
        self._on_protocol_error: Optional[Callable] = None
        self._thread: Optional[threading.Thread] = None
        self._tid: Optional[int] = None
        self._stopping = threading.Event()
        self._flush_deadline: Optional[float] = None
        # cross-thread → loop marshalling
        self._cb_lock = lockwitness.named_lock("FrameLoop._cb_lock")
        self._callbacks: deque = deque()
        self._waker_r, self._waker_w = socket.socketpair()
        self._waker_r.setblocking(False)
        self._waker_w.setblocking(False)
        self._selector.register(self._waker_r, selectors.EVENT_READ, "waker")
        # timers: (when, seq, fn) min-heap, loop-thread-owned
        self._timers: list = []
        self._timer_seq = 0
        # EMFILE shed machinery: one fd held in reserve so a full table
        # can still accept-reply-close instead of wedging the listener
        self._reserve_fd: Optional[int] = None
        self._accept_paused = False
        self._shed_reply = protocol.encode_frame(
            protocol.OVERLOADED, 0, b"fd_exhausted"
        )
        # loop counters: loop-thread single-writer; stats() copies (int
        # reads are atomic under the GIL — same contract as gauges)
        self._stats = {
            "conns_open": 0,
            "conns_total": 0,
            "frames_in": 0,
            "frames_out": 0,
            "dropped_frames": 0,
            "evicted_read_stall": 0,
            "evicted_write_stall": 0,
            "accept_shed": 0,
            "accept_backoffs": 0,
            "accept_errors": 0,
        }

    # ------------------------------------------------------------------ setup
    def serve(
        self,
        listen_sock,
        *,
        on_frame: Callable,
        on_open: Optional[Callable] = None,
        on_close: Optional[Callable] = None,
        on_protocol_error: Optional[Callable] = None,
    ) -> None:
        """Adopt a listening socket (``socket.create_server`` result) and
        the frame handler. Must be called before :meth:`start`.

        - ``on_frame(conn, msg_type, req_id, payload)`` — one complete
          frame. Raising :class:`protocol.ProtocolError` routes to the
          protocol-error path (reply-and-close), exactly like a framing
          error from the assembler.
        - ``on_open(conn)`` / ``on_close(conn)`` — connection lifecycle
          (close fires exactly once per opened connection).
        - ``on_protocol_error(conn, exc)`` — framing/decode violation;
          after it returns the loop flush-closes the connection. Default:
          reply ``ERROR`` req_id 0 and close (the thread-path contract).
        """
        if self._thread is not None:
            raise RuntimeError("serve() must precede start()")
        listen_sock.setblocking(False)
        self._listener = listen_sock
        self._on_frame = on_frame
        self._on_open = on_open
        self._on_close = on_close
        self._on_protocol_error = on_protocol_error
        self._selector.register(listen_sock, selectors.EVENT_READ, "accept")
        try:
            self._reserve_fd = os.open(os.devnull, os.O_RDONLY)
        except OSError:
            self._reserve_fd = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name=self.name, daemon=True
        )
        self._thread.start()

    def on_loop_thread(self) -> bool:
        return threading.get_ident() == self._tid

    # --------------------------------------------------------- cross-thread API
    def call_soon(self, fn: Callable, *args) -> None:
        """Run ``fn(*args)`` on the loop thread, soon. Threadsafe."""
        with self._cb_lock:
            self._callbacks.append((fn, args))
        self._wake()

    def call_later(self, delay_s: float, fn: Callable, *args) -> None:
        """Run ``fn(*args)`` on the loop thread after ``delay_s``.
        Threadsafe (marshals the heap push onto the loop)."""
        when = time.monotonic() + max(0.0, delay_s)
        if self.on_loop_thread():
            self._call_at(when, fn, *args)
        else:
            self.call_soon(self._call_at, when, fn, *args)

    def connections(self) -> list:
        """Snapshot of open connections (drain/observability)."""
        return list(self._conns)

    def stats(self) -> dict:
        """Loop counters snapshot (healthz's ``netio`` section)."""
        return dict(self._stats)

    def stop_accepting(self, timeout_s: float = 2.0) -> None:
        """Close the listener (drain step 1: no new connections; every
        open connection keeps being served). Synchronous up to
        ``timeout_s``; safe to call twice."""
        if self._thread is None or not self._thread.is_alive():
            self._close_listener()
            return
        done = threading.Event()

        def _do():
            self._close_listener()
            done.set()

        self.call_soon(_do)
        done.wait(timeout_s)

    def close(self, flush_timeout_s: float = 5.0) -> None:
        """Stop the loop: no new connections, flush every connection's
        queued replies (bounded by ``flush_timeout_s`` AND the write-
        progress deadline), close them, join the loop thread. Idempotent."""
        if self._thread is None:
            # never started: tear down directly (tests, failed start)
            self._stopping.set()
            self._close_listener()
            for conn in list(self._conns):
                self._teardown(conn)
            self._final_cleanup()
            return
        self.call_soon(self._begin_shutdown, flush_timeout_s)
        self._thread.join(timeout=flush_timeout_s + 5.0)

    # ------------------------------------------------------------ loop thread
    def _run(self) -> None:
        self._tid = threading.get_ident()
        while True:
            now = time.monotonic()
            if self._stopping.is_set():
                if not self._conns or (
                    self._flush_deadline is not None
                    and now >= self._flush_deadline
                ):
                    break
            timeout = self._select_timeout(now)
            try:
                events = self._selector.select(timeout)
            except OSError as e:
                # transient (EINTR-shaped); a poisoned selector would
                # spin here, so say so loudly and keep going — conns are
                # still torn down by deadlines/callbacks
                print(f"[netio] {self.name}: select failed: {e}", flush=True)
                events = []
            for key, mask in events:
                data = key.data
                if data == "accept":
                    self._do_accept()
                elif data == "waker":
                    self._drain_waker()
                else:
                    conn = data
                    if mask & selectors.EVENT_WRITE and not conn.closed:
                        self._flush(conn)
                    if mask & selectors.EVENT_READ and not conn.closed:
                        self._on_readable(conn)
            self._run_timers()
            self._run_callbacks()
        # loop exit: drop whatever is left, then release loop resources
        for conn in list(self._conns):
            self._teardown(conn)
        self._final_cleanup()

    def _select_timeout(self, now: float) -> float:
        with self._cb_lock:
            if self._callbacks:
                return 0.0
        if self._timers:
            return min(max(0.0, self._timers[0][0] - now), 0.5)
        return 0.5

    def _drain_waker(self) -> None:
        try:
            # non-blocking socketpair read; drains the wakeup bytes
            while self._waker_r.recv(4096):
                pass
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            pass

    def _run_callbacks(self) -> None:
        while True:
            with self._cb_lock:
                if not self._callbacks:
                    return
                fn, args = self._callbacks.popleft()
            try:
                fn(*args)
            except Exception as e:  # a bad callback must not kill the loop
                print(f"[netio] {self.name}: callback failed: {e!r}", flush=True)

    def _call_at(self, when: float, fn: Callable, *args) -> None:
        self._timer_seq += 1
        heapq.heappush(self._timers, (when, self._timer_seq, fn, args))

    def _run_timers(self) -> None:
        now = time.monotonic()
        while self._timers and self._timers[0][0] <= now:
            _when, _seq, fn, args = heapq.heappop(self._timers)
            try:
                fn(*args)
            except Exception as e:  # a bad timer must not kill the loop
                print(f"[netio] {self.name}: timer failed: {e!r}", flush=True)

    def _wake(self) -> None:
        try:
            self._waker_w.send(b"\x01")
        except (BlockingIOError, InterruptedError):
            pass  # wake pipe full = loop is already waking
        except OSError:
            pass  # loop torn down

    # ----------------------------------------------------------------- accept
    def _do_accept(self) -> None:
        for _ in range(_ACCEPTS_PER_TICK):
            if self._listener is None:
                return
            try:
                # non-blocking listener; EWOULDBLOCK caught below
                sock, addr = self._listener.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError as e:
                if self._stopping.is_set() or self._listener is None:
                    return
                if e.errno in _EXHAUSTION_ERRNOS:
                    self._shed_accept()
                    return
                if e.errno in (errno.EBADF, errno.EINVAL):
                    # listener died under us without a drain: loud, and
                    # stop selecting on it — the rest of the loop lives on
                    print(
                        f"[netio] {self.name}: accept loop dead: {e}",
                        flush=True,
                    )
                    self._close_listener()
                    return
                self._stats["accept_errors"] += 1
                return  # transient (ECONNABORTED et al.); selector re-fires
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass  # reply latency tweak only; not fatal
            conn = Connection(self, sock, addr)
            self._conns.add(conn)
            self._stats["conns_open"] += 1
            self._stats["conns_total"] += 1
            try:
                self._selector.register(
                    sock, selectors.EVENT_READ, conn
                )
            except (ValueError, KeyError, OSError) as e:
                print(f"[netio] {self.name}: register failed: {e}", flush=True)
                self._teardown(conn)
                continue
            if self._on_open is not None:
                try:
                    self._on_open(conn)
                except Exception as e:
                    print(
                        f"[netio] {self.name}: on_open failed: {e!r}",
                        flush=True,
                    )

    def _shed_accept(self) -> None:
        """Descriptor table full mid-accept. Burn the reserve fd to
        accept exactly one waiting connection, answer it ``OVERLOADED
        fd_exhausted`` best-effort, close it, reopen the reserve — the
        client gets an explicit admission-controlled shed and the accept
        loop survives. If even the reserve cannot reopen, pause
        accepting briefly instead of spinning on a perpetually-ready
        listener."""
        if self._reserve_fd is not None:
            try:
                os.close(self._reserve_fd)
            except OSError:
                pass
            self._reserve_fd = None
            sock = None
            try:
                # non-blocking listener, freed-fd one-shot accept
                sock, _addr = self._listener.accept()
            except OSError:
                sock = None
            if sock is not None:
                try:
                    sock.setblocking(False)
                    # non-blocking best-effort shed reply
                    sock.send(self._shed_reply)
                except OSError:
                    pass  # best-effort: the close below is the real answer
                try:
                    sock.close()
                except OSError:
                    pass
                self._stats["accept_shed"] += 1
            try:
                self._reserve_fd = os.open(os.devnull, os.O_RDONLY)
            except OSError:
                self._reserve_fd = None
        if self._reserve_fd is None and not self._accept_paused \
                and self._listener is not None:
            # still exhausted: stop selecting on the listener for a beat
            self._accept_paused = True
            self._stats["accept_backoffs"] += 1
            try:
                self._selector.unregister(self._listener)
            except (KeyError, ValueError, OSError):
                pass
            self._call_at(
                time.monotonic() + _ACCEPT_BACKOFF_S, self._resume_accept
            )

    def _resume_accept(self) -> None:
        self._accept_paused = False
        if self._listener is None or self._stopping.is_set():
            return
        if self._reserve_fd is None:
            try:
                self._reserve_fd = os.open(os.devnull, os.O_RDONLY)
            except OSError:
                self._reserve_fd = None
        try:
            self._selector.register(self._listener, selectors.EVENT_READ,
                                    "accept")
        except (KeyError, ValueError, OSError):
            pass

    def _close_listener(self) -> None:
        if self._listener is None:
            return
        try:
            self._selector.unregister(self._listener)
        except (KeyError, ValueError, OSError):
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        self._listener = None

    # ------------------------------------------------------------------- read
    def _on_readable(self, conn: Connection) -> None:
        try:
            # non-blocking socket; EWOULDBLOCK caught below
            data = conn.sock.recv(_RECV_CHUNK)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._teardown(conn)
            return
        if not data:
            try:
                conn.assembler.check_eof()
            except protocol.ProtocolError as e:
                self._protocol_error(conn, e)
            else:
                self._teardown(conn)  # clean EOF at a frame boundary
            return
        conn.assembler.feed(data)
        completed = 0
        try:
            while True:
                frame = conn.assembler.next_frame()
                if frame is None:
                    break
                completed += 1
                self._stats["frames_in"] += 1
                self._on_frame(conn, *frame)
                if conn.closed:
                    return  # the handler tore it down
        except protocol.ProtocolError as e:
            self._protocol_error(conn, e)
            return
        except OSError:
            self._teardown(conn)
            return
        except Exception as e:
            # a handler bug must cost one connection, never the loop
            print(
                f"[netio] {self.name}: on_frame failed: {e!r}", flush=True
            )
            self._teardown(conn)
            return
        # Read-progress deadline: arm on entering mid-frame, RE-arm only
        # on frame completion — so a slowloris drip (bytes but never a
        # frame) cannot reset its clock, while a busy pipeliner whose
        # buffer always holds a partial tail never gets evicted.
        if conn.assembler.mid_frame:
            if completed or conn._read_deadline is None:
                conn._read_deadline = time.monotonic() + self.read_stall_s
                if not conn._read_timer_armed:
                    conn._read_timer_armed = True
                    self._call_at(conn._read_deadline,
                                  self._check_read_deadline, conn)
        else:
            conn._read_deadline = None

    def _check_read_deadline(self, conn: Connection) -> None:
        conn._read_timer_armed = False
        if conn.closed or conn._read_deadline is None:
            return
        now = time.monotonic()
        if now < conn._read_deadline:  # progress since this timer was set
            conn._read_timer_armed = True
            self._call_at(conn._read_deadline,
                          self._check_read_deadline, conn)
            return
        self._stats["evicted_read_stall"] += 1
        self._evict(conn,
                    f"read stall: frame incomplete after {self.read_stall_s}s")

    # ------------------------------------------------------------------ write
    def _flush(self, conn: Connection) -> None:
        """Push queued frames into the kernel until it stops taking them.
        Loop thread only (cross-thread senders marshal via call_soon)."""
        if conn.closed:
            return
        progressed = False
        while True:
            with conn._lock:
                if not conn._out:
                    break
                head = conn._out[0]
            try:
                # non-blocking socket; EWOULDBLOCK caught below
                n = conn.sock.send(
                    memoryview(head)[conn._out_off:]
                )
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                self._teardown(conn)
                return
            if n <= 0:
                break
            progressed = True
            conn._out_off += n
            if conn._out_off >= len(head):
                conn._out_off = 0
                with conn._lock:
                    conn._out.popleft()
                    conn._out_bytes -= len(head)
                self._stats["frames_out"] += 1
        with conn._lock:
            pending = conn._out_bytes
        if pending:
            if pending > self.write_buffer_limit:
                # watermark breach: the peer is not draining and the
                # backlog is past what we are willing to hold for it
                self._stats["evicted_write_stall"] += 1
                self._evict(
                    conn,
                    f"write backlog {pending} bytes > limit "
                    f"{self.write_buffer_limit}",
                )
                return
            self._set_mask(conn, selectors.EVENT_READ | selectors.EVENT_WRITE)
            # Write-progress deadline: (re)armed on any kernel progress,
            # first armed when the backlog appears — SO_SNDTIMEO's
            # "no progress for N seconds" contract, loop-owned.
            if progressed or conn._write_deadline is None:
                conn._write_deadline = time.monotonic() + self.write_stall_s
                if not conn._write_timer_armed:
                    conn._write_timer_armed = True
                    self._call_at(conn._write_deadline,
                                  self._check_write_deadline, conn)
        else:
            conn._write_deadline = None
            self._set_mask(conn, selectors.EVENT_READ)
            if conn._close_requested:
                self._teardown(conn)

    def _check_write_deadline(self, conn: Connection) -> None:
        conn._write_timer_armed = False
        if conn.closed or conn._write_deadline is None:
            return
        now = time.monotonic()
        if now < conn._write_deadline:
            conn._write_timer_armed = True
            self._call_at(conn._write_deadline,
                          self._check_write_deadline, conn)
            return
        self._stats["evicted_write_stall"] += 1
        self._evict(
            conn,
            f"write stall: peer drained nothing for {self.write_stall_s}s",
        )

    def _set_mask(self, conn: Connection, mask: int) -> None:
        try:
            key = self._selector.get_key(conn.sock)
        except (KeyError, ValueError):
            return
        if key.events != mask:
            try:
                self._selector.modify(conn.sock, mask, conn)
            except (KeyError, ValueError, OSError):
                pass

    # --------------------------------------------------------------- teardown
    def _protocol_error(self, conn: Connection, exc) -> None:
        handler = self._on_protocol_error
        if handler is not None:
            try:
                handler(conn, exc)
            except Exception as e:
                print(
                    f"[netio] {self.name}: on_protocol_error failed: {e!r}",
                    flush=True,
                )
        else:
            conn.send(protocol.ERROR, 0, str(exc).encode("utf-8"))
        conn.close()  # flush the ERROR, then FIN (write deadline bounds it)

    def _evict(self, conn: Connection, reason: str) -> None:
        """Deadline/watermark eviction: best-effort one-shot ERROR notice
        (the peer's read side may still be intact), then immediate
        teardown — never a flush wait on a peer that already proved it
        will not drain."""
        try:
            # non-blocking one-shot courtesy notice; EWOULDBLOCK acceptable
            conn.sock.send(
                protocol.encode_frame(
                    protocol.ERROR, 0, reason.encode("utf-8")
                )
            )
        except OSError:
            pass
        self._teardown(conn)

    def _teardown(self, conn: Connection, abortive: bool = False) -> None:
        with conn._lock:
            if conn.closed:
                return
            conn.closed = True
            leftover = len(conn._out)
            conn._out.clear()
            conn._out_bytes = 0
        self._stats["dropped_frames"] += leftover
        conn._read_deadline = None
        conn._write_deadline = None
        try:
            self._selector.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        if abortive:
            protocol.abortive_close(conn.sock)
        else:
            try:
                conn.sock.close()
            except OSError:
                pass
        if conn in self._conns:
            self._conns.discard(conn)
            self._stats["conns_open"] -= 1
            if self._on_close is not None:
                try:
                    self._on_close(conn)
                except Exception as e:
                    print(
                        f"[netio] {self.name}: on_close failed: {e!r}",
                        flush=True,
                    )

    def _begin_shutdown(self, flush_timeout_s: float) -> None:
        self._close_listener()
        if not self._stopping.is_set():
            self._stopping.set()
            self._flush_deadline = time.monotonic() + flush_timeout_s
        for conn in list(self._conns):
            conn.close()  # flush-then-close; deadlines bound the flush

    def _final_cleanup(self) -> None:
        self._close_listener()
        try:
            self._selector.unregister(self._waker_r)
        except (KeyError, ValueError, OSError):
            pass
        for s in (self._waker_r, self._waker_w):
            try:
                s.close()
            except OSError:
                pass
        if self._reserve_fd is not None:
            try:
                os.close(self._reserve_fd)
            except OSError:
                pass
            self._reserve_fd = None
        try:
            self._selector.close()
        except OSError:
            pass
