"""Socket client for the policy server: blocking or pipelined (the port's
copy of ``d4pg_tpu/serve/client.py``; it speaks to either package's
server).

``act`` is the simple call; ``act_async`` pipelines — many requests in
flight on one connection, matched to replies by the echoed ``req_id`` on a
dedicated reader thread. A load generator is built on the pipelined form:
an open-loop arrival process must keep issuing at its offered rate
regardless of reply latency, which a blocking call cannot do.

Bounded retry (``retries=``, OFF by default): ``act`` re-attempts on
:class:`Overloaded` / :class:`ConnectionClosed` under a seeded jittered
:class:`~d4pg_tpu_torch.utils.retry.Backoff`, transparently re-dialing a
dead link between attempts. Off by default on purpose — a shed is an
explicit server signal and most callers (load generators, shed-rate
checks) must SEE it, not have it retried away. The retry path serializes
reconnects behind a lock but is meant for blocking single-caller use;
``act_async`` never retries (a pipelined caller owns its own policy).
"""

from __future__ import annotations

import random
import socket
import threading
from concurrent.futures import Future
from typing import Optional

import numpy as np

from d4pg_tpu_torch.analysis import lockwitness
from d4pg_tpu_torch.serve import protocol
from d4pg_tpu_torch.serve.protocol import ProtocolError
from d4pg_tpu_torch.utils.retry import Backoff


class Overloaded(RuntimeError):
    """The server shed the request (reason: queue_full | deadline |
    draining). Retry with backoff if you must; the action was not computed."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class ServerError(RuntimeError):
    """Server-side failure or protocol violation reply."""


class ConnectionClosed(RuntimeError):
    """The connection died with requests still in flight."""


class PolicyClient:
    # ``_dead`` is written without a lock: a single transition
    # None→exception by the reader thread; submitters read it
    # check-then-fail (the mark-dead-then-sweep ordering note in _read_loop)

    def __init__(
        self,
        host: str,
        port: int,
        timeout: float = 30.0,
        *,
        retries: int = 0,
        retry_seed: Optional[int] = None,
        policy_id: Optional[str] = None,
        qos: Optional[str] = None,
        tenant: Optional[str] = None,
    ):
        self.host = host
        self.port = port
        self.timeout = timeout
        # Multi-tenant identity (all optional): with NONE of them set the
        # client emits v1 ``ACT`` frames byte-identical to the first wire —
        # full interop with old servers. Setting any switches requests to
        # the v2 ``ACT2`` frame (policy routing + router QoS/quota
        # admission); against an OLD server those fail loudly with the
        # server's "protocol version" ERROR, never a decode crash.
        self.policy_id = policy_id
        self.tenant = tenant or ""
        if qos is not None and qos not in ("interactive", "bulk"):
            raise ValueError(f"qos must be 'interactive' or 'bulk', got {qos!r}")
        self.qos = qos
        # Opt-in bounded retry for act(): attempts beyond the first on
        # Overloaded/ConnectionClosed, paced by a seeded Backoff (jitter
        # must not synchronize a retrying fleet; seeding keeps runs
        # deterministic). 0 = historical fast-fail semantics.
        self._retries = int(retries)
        self._retry_rng = random.Random(retry_seed)
        # Serializes _reconnect against concurrent act() retries; never
        # held while blocking on a reply (only during dial/teardown).
        self._conn_lock = lockwitness.named_lock("PolicyClient._conn_lock")
        self._send_lock = lockwitness.named_lock("PolicyClient._send_lock")
        self._pending: dict[int, Future] = {}
        self._pending_lock = lockwitness.named_lock("PolicyClient._pending_lock")
        self._next_id = 0
        self._closed = False
        self._connect()

    def _connect(self) -> None:
        """Dial and arm a fresh link (init + the retry path's re-dial)."""
        self._sock = socket.create_connection(
            (self.host, self.port), timeout=self.timeout
        )
        # ``timeout`` governs CONNECT and the default future wait in act();
        # the socket itself must block indefinitely — the reader thread sits
        # in read() between replies, and a socket timeout there would kill
        # the reader (and with it the whole client) after `timeout` idle
        # seconds on a perfectly healthy connection.
        self._sock.settimeout(None)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # Buffered read side (same rationale as the server): one kernel
        # read per burst of pipelined replies, not per frame piece.
        self._rfile = self._sock.makefile("rb")
        with self._pending_lock:
            self._pending = {}
        # Terminal error once the reader exits: without it, a request
        # issued AFTER the reader died would register a future nobody can
        # ever resolve (the send usually still succeeds into the kernel
        # buffer of a FIN'd socket) and hang its caller for the full
        # timeout instead of failing fast.
        self._dead: Exception | None = None
        self._reader = threading.Thread(
            target=self._read_loop, name="policy-client-reader", daemon=True
        )
        self._reader.start()

    def _reconnect(self) -> None:
        """Tear down a dead link and dial a new one (retry path only).
        The old reader is joined BEFORE the new link arms so its death
        sweep (which writes ``_dead``) can never clobber the fresh link's
        state; pending futures of the old link were already failed by
        that sweep."""
        with self._conn_lock:
            if self._closed:
                # close() is final: the retry path must not resurrect a
                # closed client with a fresh socket + reader thread the
                # owner will never tear down
                raise ConnectionClosed("client closed")
            if self._dead is None:
                return  # another retrying caller already re-dialed
            try:
                self._sock.close()
            except OSError:
                pass
            # Bounded join under a lock only retrying act() callers ever
            # take (never the reader or any hot path); the old reader MUST
            # be dead before the new link arms, or its death sweep would
            # clobber the fresh link's _dead/_pending.
            self._reader.join(timeout=5)
            try:
                self._rfile.close()
            except OSError:
                pass
            self._connect()

    # ------------------------------------------------------------------ plumbing
    def _register(self) -> tuple[int, Future]:
        fut: Future = Future()
        with self._pending_lock:
            self._next_id = (self._next_id + 1) & 0xFFFFFFFF
            req_id = self._next_id
            self._pending[req_id] = fut
        return req_id, fut

    def _read_loop(self) -> None:
        err: Exception = ConnectionClosed("server closed the connection")
        try:
            while True:
                frame = protocol.read_frame(self._rfile)
                if frame is None:
                    break
                msg_type, req_id, payload = frame
                with self._pending_lock:
                    fut = self._pending.pop(req_id, None)
                if fut is None:
                    # ERROR with req_id 0 is the server's "your framing is
                    # broken, closing" notice — surface it to every waiter.
                    if msg_type == protocol.ERROR:
                        err = ServerError(payload.decode("utf-8", "replace"))
                        break
                    continue
                if msg_type == protocol.ACT_OK:
                    fut.set_result(protocol.decode_action(payload))
                elif msg_type == protocol.FEEDBACK_OK:
                    fut.set_result(True)
                elif msg_type == protocol.HEALTHZ_OK:
                    fut.set_result(payload.decode("utf-8", "replace"))
                elif msg_type == protocol.OVERLOADED:
                    fut.set_exception(
                        Overloaded(payload.decode("utf-8", "replace"))
                    )
                elif msg_type == protocol.ERROR:
                    fut.set_exception(
                        ServerError(payload.decode("utf-8", "replace"))
                    )
                else:
                    fut.set_exception(
                        ProtocolError(f"unexpected reply type {msg_type}")
                    )
        except (OSError, ProtocolError) as e:
            if not self._closed:
                err = ConnectionClosed(str(e))
        finally:
            # Order: mark dead FIRST, then sweep — a racing act_async
            # either lands in the swept dict (failed here) or sees _dead
            # after registering and fails itself.
            self._dead = err
            with self._pending_lock:
                pending, self._pending = list(self._pending.values()), {}
            for fut in pending:
                if not fut.done():
                    fut.set_exception(err)

    def _send(self, msg_type: int, req_id: int, payload: bytes) -> None:
        with self._send_lock:
            protocol.write_frame(self._sock, msg_type, req_id, payload)

    # ------------------------------------------------------------------ API
    def _fail_if_dead(self, req_id: int, fut: Future) -> bool:
        if self._dead is None:
            return False
        with self._pending_lock:
            self._pending.pop(req_id, None)
        if not fut.done():
            fut.set_exception(self._dead)
        return True

    def act_async(
        self,
        obs: np.ndarray,
        deadline_ms: Optional[float] = None,
        *,
        policy_id: Optional[str] = None,
        qos: Optional[str] = None,
        tenant: Optional[str] = None,
    ) -> Future:
        req_id, fut = self._register()
        if self._fail_if_dead(req_id, fut):
            return fut
        deadline_us = int(deadline_ms * 1e3) if deadline_ms else 0
        policy_id = policy_id if policy_id is not None else self.policy_id
        qos = qos if qos is not None else self.qos
        tenant = tenant if tenant is not None else self.tenant
        if policy_id is None and qos is None and not tenant:
            # pure v1 request: byte-identical to the first clients' frame
            msg_type = protocol.ACT
            payload = protocol.encode_act(obs, deadline_us)
        else:
            msg_type = protocol.ACT2
            payload = protocol.encode_act2(
                obs, deadline_us,
                policy_id=policy_id or protocol.DEFAULT_POLICY,
                qos=(
                    protocol.QOS_BULK if qos == "bulk"
                    else protocol.QOS_INTERACTIVE
                ),
                tenant=tenant,
            )
        try:
            self._send(msg_type, req_id, payload)
        except OSError as e:
            with self._pending_lock:
                self._pending.pop(req_id, None)
            if not fut.done():
                fut.set_exception(ConnectionClosed(str(e)))
        return fut

    def act(
        self,
        obs: np.ndarray,
        deadline_ms: Optional[float] = None,
        timeout: Optional[float] = None,
        *,
        policy_id: Optional[str] = None,
        qos: Optional[str] = None,
        tenant: Optional[str] = None,
    ) -> np.ndarray:
        """One action, blocking. Raises :class:`Overloaded` when shed
        (after the bounded ``retries=`` budget, when one was configured —
        a dead link is re-dialed between attempts). ``policy_id`` /
        ``qos`` / ``tenant`` override the client-level defaults per call."""
        timeout = timeout if timeout is not None else self.timeout
        kw = dict(policy_id=policy_id, qos=qos, tenant=tenant)
        if not self._retries:
            return self.act_async(obs, deadline_ms, **kw).result(timeout)
        last: Optional[Exception] = None
        backoff = Backoff(
            base_s=0.05,
            max_s=2.0,
            max_attempts=self._retries,
            rng=self._retry_rng,
        )
        for _attempt in backoff:
            if self._dead is not None:
                try:
                    self._reconnect()
                except OSError as e:
                    last = ConnectionClosed(f"reconnect failed: {e}")
                    continue
            try:
                return self.act_async(obs, deadline_ms, **kw).result(timeout)
            except (Overloaded, ConnectionClosed) as e:
                last = e  # bounded: the Backoff iterator sleeps, then stops
        assert last is not None
        raise last

    def feedback_async(
        self,
        reward: float,
        action: np.ndarray,
        next_obs: np.ndarray,
        *,
        log_prob: float = 0.0,
        terminated: bool = False,
        truncated: bool = False,
        policy_id: Optional[str] = None,
    ) -> Future:
        """The flywheel reward echo (``FEEDBACK``, frame version 2): the
        env outcome of the EXECUTED action for this connection's previous
        request, with its behavior log-prob. Resolves True on the
        server's ack; against an old server it fails loudly with the
        version ERROR — plain v1 traffic never emits this frame."""
        req_id, fut = self._register()
        if self._fail_if_dead(req_id, fut):
            return fut
        payload = protocol.encode_feedback(
            reward,
            action,
            next_obs,
            log_prob=log_prob,
            terminated=terminated,
            truncated=truncated,
            policy_id=(
                policy_id if policy_id is not None
                else (self.policy_id or protocol.DEFAULT_POLICY)
            ),
        )
        try:
            self._send(protocol.FEEDBACK, req_id, payload)
        except OSError as e:
            with self._pending_lock:
                self._pending.pop(req_id, None)
            if not fut.done():
                fut.set_exception(ConnectionClosed(str(e)))
        return fut

    def feedback(self, *args, timeout: Optional[float] = None, **kw) -> bool:
        return self.feedback_async(*args, **kw).result(
            timeout if timeout is not None else self.timeout
        )

    def healthz(self, timeout: Optional[float] = None) -> dict:
        import json

        req_id, fut = self._register()
        if not self._fail_if_dead(req_id, fut):
            self._send(protocol.HEALTHZ, req_id, b"")
        return json.loads(
            fut.result(timeout if timeout is not None else self.timeout)
        )

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        self._reader.join(timeout=5)
        try:
            self._rfile.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
