"""Length-prefixed binary wire protocol of the policy server (the port's
copy of ``d4pg_tpu/serve/protocol.py``; frames are byte-identical to the
JAX package's, so either package's client talks to either server).

One frame per message, fixed little-endian header, raw float32 payloads —
no serialization library on the hot path (a pickle/JSON round-trip per
request would dwarf the actor forward itself at serving batch sizes).

Frame layout::

    magic    2s   b"D4"
    version  u8   PROTOCOL_VERSION
    type     u8   MsgType
    req_id   u32  client-chosen id, echoed verbatim in the reply (enables
                  pipelining: many requests in flight per connection)
    length   u32  payload byte count (<= MAX_PAYLOAD)
    payload  bytes

Frame versioning: every frame carries the LOWEST version that can express
its type — the v1 sublanguage is byte-for-byte what the first servers
spoke, so an old client sees identical reply bytes, and plain ACT traffic
works against old servers unchanged. ``ACT2`` (policy-id routing) and
``FEEDBACK`` need version 2; an old server's ``read_frame`` rejects the
version byte with a clear ``protocol version 2 (this server speaks 1)``
ERROR reply — a new client fails loudly, never with a decode crash.
``read_frame`` here accepts every version in ``SUPPORTED_VERSIONS``.

Message types and payloads:

- ``ACT``          → ``u32 deadline_us`` (0 = none, relative to arrival)
                     followed by ``obs_dim`` float32s. v1: no policy id —
                     a server holding N policies serves it the DEFAULT
                     policy.
- ``ACT2``         → ``u8 qos  u8 policy_len  u8 tenant_len  u8 reserved
                     u32 deadline_us`` + policy_id utf-8 + tenant utf-8 +
                     obs float32s. ``policy_id`` routes to a resident
                     bundle; ``qos`` (0 = interactive, 1 = bulk) and
                     ``tenant`` ride the frame for a router's admission
                     tier. Unknown policy → per-request ``ERROR`` reply
                     (the frame is well-formed; the connection survives).
- ``ACT_OK``       ← ``action_dim`` float32s.
- ``OVERLOADED``   ← utf-8 reason (``queue_full`` | ``deadline`` |
                     ``draining``). The request was SHED, not failed: the
                     client may retry with backoff.
- ``ERROR``        ← utf-8 message. Protocol violations (bad magic/size);
                     the server closes the connection after sending.
- ``HEALTHZ``      → empty payload.
- ``HEALTHZ_OK``   ← utf-8 JSON: the server's stats snapshot.
- ``FEEDBACK``     → ``u8 policy_len  u8 action_dim  u8 flags (bit 0
                     terminated, bit 1 truncated)  u8 reserved
                     f32 reward  f32 log_prob`` + policy_id utf-8 +
                     executed action float32s + next_obs float32s: a
                     client's reward echo for its previous request.
- ``FEEDBACK_OK``  ← empty. Ack; a server with no mirror tap still acks.

``HELLO`` / ``HELLO_OK`` / ``WINDOWS`` / ``WINDOWS2`` / ``WINDOWS_OK`` are
the experience-ingest service's types (the collection fleet,
``d4pg_tpu_torch/fleet``; their payload codecs are ``fleet/wire.py``),
in the one id space.

``read_frame`` returns ``None`` on clean EOF (peer closed between frames)
and raises :class:`ProtocolError` on anything malformed — oversized
declared length, bad magic, version mismatch, or EOF mid-frame.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

MAGIC = b"D4"
# Highest version this code speaks; frames go out at the lowest version
# that can carry their type (``_frame_version``) so the v1 sublanguage
# stays byte-identical to the first servers' in both directions.
PROTOCOL_VERSION = 2
SUPPORTED_VERSIONS = (1, 2)
# Generous for observation vectors (a 348-dim Humanoid obs is ~1.4 KB;
# even a flattened 96×96×4 pixel obs is ~147 KB) while bounding what a
# malicious/buggy client can make the server buffer per frame.
MAX_PAYLOAD = 1 << 20

HEADER = struct.Struct("<2sBBII")
_DEADLINE = struct.Struct("<I")
_ACT2_HEAD = struct.Struct("<BBBBI")  # qos, policy_len, tenant_len, rsvd, deadline
# policy_len, action_dim, flags, rsvd, reward, log_prob
_FEEDBACK_HEAD = struct.Struct("<BBBBff")

# message types (one id space across serving AND fleet ingest: the framing
# layer is shared, so a frame routed at the wrong port fails loudly on type)
ACT = 1
ACT_OK = 2
OVERLOADED = 3
ERROR = 4
HEALTHZ = 5
HEALTHZ_OK = 6
HELLO = 7         # fleet actor handshake (fleet/wire.py)
HELLO_OK = 8
WINDOWS = 9       # batch of complete n-step windows
WINDOWS_OK = 10
ACT2 = 11         # versioned multi-tenant request: policy_id + QoS + tenant
WINDOWS2 = 12     # capability-era window frame: obs mode + stats generation
FEEDBACK = 13     # flywheel reward echo: env outcome of the served action
FEEDBACK_OK = 14

# QoS classes carried in the ACT2 frame. Interactive is the protected
# tier (a router sheds bulk FIRST under overload);
# bulk is the best-effort batch tier.
QOS_INTERACTIVE = 0
QOS_BULK = 1
QOS_NAMES = {QOS_INTERACTIVE: "interactive", QOS_BULK: "bulk"}

# Per-type frame-version floor: a type absent here rides version 1 (the
# first wire language). ``write_frame`` applies it, so call sites never
# choose a version — interop with old peers is automatic for old types,
# and new types fail loudly on old peers with a version error.
_FRAME_MIN_VERSION = {ACT2: 2, WINDOWS2: 2, FEEDBACK: 2, FEEDBACK_OK: 2}


class ProtocolError(Exception):
    """Malformed frame — the connection is unrecoverable past this point
    (framing is lost), so handlers reply ERROR once and close."""


def abortive_close(sock) -> None:
    """Close with SO_LINGER 0 — an RST on real stacks, so the peer (and
    any frame in flight) sees an immediate reset instead of an orderly
    FIN. The teardown for an abortive connection close."""
    import socket as _socket

    try:
        sock.setsockopt(
            _socket.SOL_SOCKET, _socket.SO_LINGER, struct.pack("ii", 1, 0)
        )
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


def probe_healthz(host: str, port: int, timeout_s: float = 2.0) -> dict:
    """One-shot healthz probe: connect, ask, decode, close.

    Deliberately NOT a :class:`~d4pg_tpu_torch.serve.client.PolicyClient`: a
    prober runs this on a timer against possibly-dead backends — a persistent pipelined client
    would hide exactly the connect-failure signal ejection keys on, and
    a probe must never outlive its timeout (``settimeout`` bounds every
    recv). Raises ``OSError`` (connect/timeout) or :class:`ProtocolError`
    (malformed reply) — the caller maps both to "unhealthy"."""
    import json
    import socket

    with socket.create_connection((host, port), timeout=timeout_s) as s:
        s.settimeout(timeout_s)
        write_frame(s, HEALTHZ, 0)
        frame = read_frame(s)
        if frame is None:
            raise ProtocolError("EOF before healthz reply")
        msg_type, _req_id, payload = frame
        if msg_type != HEALTHZ_OK:
            raise ProtocolError(f"unexpected healthz reply type {msg_type}")
        return json.loads(payload.decode("utf-8", "replace"))


def recv_exact(stream, n: int) -> Optional[bytes]:
    """Read exactly ``n`` bytes; None on EOF at a frame boundary (n>0 and
    zero bytes read); ProtocolError on EOF mid-read.

    ``stream`` is either a raw socket or a buffered file over one
    (``sock.makefile("rb")``). Both hot paths use the buffered form — one
    kernel read typically services a whole frame (or several, pipelined)
    instead of a recv syscall per header/payload piece, which measured as
    a large share of per-request cost on the serving hot path."""
    read = getattr(stream, "read", None)
    if read is not None:  # buffered file: read(n) is already exact-or-EOF
        buf = read(n)
        if not buf:
            return None
        if len(buf) < n:
            raise ProtocolError(f"EOF mid-frame ({len(buf)}/{n} bytes)")
        return buf
    buf = bytearray()
    while len(buf) < n:
        chunk = stream.recv(n - len(buf))
        if not chunk:
            if not buf:
                return None
            raise ProtocolError(f"EOF mid-frame ({len(buf)}/{n} bytes)")
        buf.extend(chunk)
    return bytes(buf)


def read_frame(stream) -> Optional[Tuple[int, int, bytes]]:
    """One ``(msg_type, req_id, payload)`` frame from a socket or buffered
    file; None on clean EOF. Accepts every version in
    ``SUPPORTED_VERSIONS`` — the version byte gates frame-level features
    (``ACT2`` rides v2), not the connection."""
    hdr = recv_exact(stream, HEADER.size)
    if hdr is None:
        return None
    magic, version, msg_type, req_id, length = HEADER.unpack(hdr)
    if magic != MAGIC:
        raise ProtocolError(f"bad magic {magic!r}")
    if version not in SUPPORTED_VERSIONS:
        # Wording matters: this exact string is an old peer's loud answer
        # to a too-new frame (the compat regression pins it) — keep the
        # "protocol version" prefix so clients can tell a version skew
        # from a framing bug.
        raise ProtocolError(
            f"protocol version {version} (this server speaks "
            f"{PROTOCOL_VERSION})"
        )
    if length > MAX_PAYLOAD:
        raise ProtocolError(f"payload length {length} > max {MAX_PAYLOAD}")
    payload = b""
    if length:
        payload = recv_exact(stream, length)
        if payload is None:
            raise ProtocolError("EOF before payload")
    return msg_type, req_id, payload


class FrameAssembler:
    """Incremental decoder for the non-blocking I/O core (``d4pg_tpu_torch/
    netio``): ``feed()`` whatever bytes arrived, then drain complete
    frames with ``next_frame()``. Header validation (magic, version,
    MAX_PAYLOAD) happens the moment 16 header bytes exist — a declared-
    oversize frame is rejected before one payload byte is buffered, same
    as ``read_frame``.

    Parity contract: for any byte sequence, the frames and the
    ``ProtocolError`` messages produced here are EXACTLY those of
    ``read_frame`` over a blocking socket — including the EOF cases, which
    the owner reports by calling :meth:`check_eof` when the peer closes.
    Framing lives here, in the protocol module, so the wire format has one
    point of truth: netio moves bytes, it never parses headers."""

    __slots__ = ("_buf", "_head")

    def __init__(self) -> None:
        self._buf = bytearray()
        self._head: Optional[Tuple[int, int, int]] = None

    def feed(self, data: bytes) -> None:
        self._buf += data

    @property
    def mid_frame(self) -> bool:
        """True while a partial frame is pending — the loop's read-progress
        deadline (the slowloris eviction) arms on exactly this state."""
        return self._head is not None or bool(self._buf)

    def next_frame(self) -> Optional[Tuple[int, int, bytes]]:
        """One ``(msg_type, req_id, payload)`` if a complete frame is
        buffered, else None. Raises :class:`ProtocolError` with
        ``read_frame``'s exact wording on a malformed header."""
        if self._head is None:
            if len(self._buf) < HEADER.size:
                return None
            magic, version, msg_type, req_id, length = HEADER.unpack_from(
                self._buf
            )
            if magic != MAGIC:
                raise ProtocolError(f"bad magic {magic!r}")
            if version not in SUPPORTED_VERSIONS:
                raise ProtocolError(
                    f"protocol version {version} (this server speaks "
                    f"{PROTOCOL_VERSION})"
                )
            if length > MAX_PAYLOAD:
                raise ProtocolError(
                    f"payload length {length} > max {MAX_PAYLOAD}"
                )
            del self._buf[:HEADER.size]
            self._head = (msg_type, req_id, length)
        msg_type, req_id, length = self._head
        if len(self._buf) < length:
            return None
        payload = bytes(self._buf[:length])
        del self._buf[:length]
        self._head = None
        return msg_type, req_id, payload

    def check_eof(self) -> None:
        """Peer closed: raise exactly what ``read_frame`` would have — a
        clean frame boundary returns silently, a torn frame raises with
        the blocking path's wording (``recv_exact``'s k/n counts)."""
        if self._head is not None:
            _msg_type, _req_id, length = self._head
            if not self._buf:
                raise ProtocolError("EOF before payload")
            raise ProtocolError(
                f"EOF mid-frame ({len(self._buf)}/{length} bytes)"
            )
        if self._buf:
            raise ProtocolError(
                f"EOF mid-frame ({len(self._buf)}/{HEADER.size} bytes)"
            )


def encode_frame(msg_type: int, req_id: int, payload: bytes = b"") -> bytes:
    """THE frame bytes: header + payload as one object. ``write_frame``
    sends exactly this and the event-loop write path (``d4pg_tpu_torch/netio``)
    enqueues exactly this, so thread and loop servers are byte-identical
    on the wire by construction, not by parallel maintenance.

    The version byte is the TYPE's floor (v1 unless the type needs v2):
    replies to an old client are byte-identical to the first servers', and only a
    frame that actually uses v2 features can trip an old peer's version
    check."""
    if len(payload) > MAX_PAYLOAD:
        raise ProtocolError(f"payload length {len(payload)} > max {MAX_PAYLOAD}")
    return (
        HEADER.pack(
            MAGIC,
            _FRAME_MIN_VERSION.get(msg_type, 1),
            msg_type,
            req_id,
            len(payload),
        )
        + payload
    )


def write_frame(sock, msg_type: int, req_id: int, payload: bytes = b"") -> None:
    if len(payload) > MAX_PAYLOAD:
        raise ProtocolError(f"payload length {len(payload)} > max {MAX_PAYLOAD}")
    # ONE sendall per frame: header+payload concatenated so a concurrent
    # writer on the same socket (replies come from batcher callbacks, the
    # healthz reply from the reader thread) can never interleave a frame —
    # callers still hold a per-connection send lock for ordering.
    sock.sendall(encode_frame(msg_type, req_id, payload))


def write_truncated_frame(
    sock, msg_type: int, req_id: int, payload: bytes, keep: int
) -> None:
    """Chaos only (``pixel_truncate``): send a header that declares the
    whole payload, then only its first ``keep`` bytes, as a peer that dies
    in the middle of ``sendall`` would. The receiver's ``read_frame`` must
    raise :class:`ProtocolError` (EOF mid-frame) and drop the frame whole.
    It lives here because this module owns the header layout."""
    keep = max(0, min(int(keep), len(payload)))
    sock.sendall(
        HEADER.pack(
            MAGIC,
            _FRAME_MIN_VERSION.get(msg_type, 1),
            msg_type,
            req_id,
            len(payload),
        )
        + payload[:keep]
    )


# ----------------------------------------------------------- ACT payloads
def encode_act(obs: np.ndarray, deadline_us: int = 0) -> bytes:
    obs = np.ascontiguousarray(obs, dtype=np.float32)
    return _DEADLINE.pack(int(deadline_us)) + obs.tobytes()


def decode_act(payload: bytes, obs_dim: int) -> Tuple[np.ndarray, int]:
    """Returns ``(obs [obs_dim] f32, deadline_us)``; ProtocolError on any
    size mismatch (the oversized/undersized-request fault path)."""
    want = _DEADLINE.size + 4 * obs_dim
    if len(payload) != want:
        raise ProtocolError(
            f"ACT payload is {len(payload)} bytes, expected {want} "
            f"(obs_dim={obs_dim})"
        )
    (deadline_us,) = _DEADLINE.unpack_from(payload)
    obs = np.frombuffer(payload, np.float32, offset=_DEADLINE.size).copy()
    return obs, deadline_us


DEFAULT_POLICY = "default"


def encode_act2(
    obs: np.ndarray,
    deadline_us: int = 0,
    *,
    policy_id: str = DEFAULT_POLICY,
    qos: int = QOS_INTERACTIVE,
    tenant: str = "",
) -> bytes:
    """The v2 multi-tenant request payload (see module docstring layout).
    ``policy_id``/``tenant`` are utf-8, each bounded to 255 bytes by the
    u8 length fields — plenty for ids, and the bound keeps the decode
    allocation-free beyond the obs copy."""
    pid = policy_id.encode("utf-8")
    ten = tenant.encode("utf-8")
    if len(pid) > 255:
        raise ProtocolError(f"policy_id longer than 255 bytes: {policy_id!r}")
    if len(ten) > 255:
        raise ProtocolError(f"tenant longer than 255 bytes: {tenant!r}")
    if qos not in QOS_NAMES:
        raise ProtocolError(f"unknown qos class {qos!r}")
    obs = np.ascontiguousarray(obs, dtype=np.float32)
    return (
        _ACT2_HEAD.pack(qos, len(pid), len(ten), 0, int(deadline_us))
        + pid
        + ten
        + obs.tobytes()
    )


def decode_act2(payload: bytes) -> Tuple[np.ndarray, int, str, int, str]:
    """Returns ``(obs f32, deadline_us, policy_id, qos, tenant)``. The obs
    length is self-described (total minus headers) — the SERVER validates
    it against the routed policy's obs_dim and answers a per-request
    ``ERROR`` on mismatch, because unlike v1 ``ACT`` the framing here is
    intact either way."""
    if len(payload) < _ACT2_HEAD.size:
        raise ProtocolError(
            f"ACT2 payload is {len(payload)} bytes, header needs "
            f"{_ACT2_HEAD.size}"
        )
    qos, plen, tlen, _rsvd, deadline_us = _ACT2_HEAD.unpack_from(payload)
    if qos not in QOS_NAMES:
        raise ProtocolError(f"unknown qos class {qos}")
    off = _ACT2_HEAD.size
    if len(payload) < off + plen + tlen:
        raise ProtocolError(
            f"ACT2 payload is {len(payload)} bytes, ids declare "
            f"{off + plen + tlen}"
        )
    policy_id = payload[off:off + plen].decode("utf-8", "replace")
    tenant = payload[off + plen:off + plen + tlen].decode("utf-8", "replace")
    obs_off = off + plen + tlen
    if (len(payload) - obs_off) % 4:
        raise ProtocolError(
            f"ACT2 obs bytes ({len(payload) - obs_off}) not float32"
        )
    obs = np.frombuffer(payload, np.float32, offset=obs_off).copy()
    return obs, deadline_us, policy_id or DEFAULT_POLICY, qos, tenant


# Flags carried in the FEEDBACK frame (episode-boundary bits; both unset
# for a mid-episode step).
FEEDBACK_TERMINATED = 1
FEEDBACK_TRUNCATED = 2


def encode_feedback(
    reward: float,
    action: np.ndarray,
    next_obs: np.ndarray,
    *,
    log_prob: float = 0.0,
    terminated: bool = False,
    truncated: bool = False,
    policy_id: str = DEFAULT_POLICY,
) -> bytes:
    """The flywheel reward echo (see module docstring layout). ``action``
    is the EXECUTED action (served action + any client-side exploration
    noise) and ``log_prob`` its density under the client's behavior
    policy — the logged propensity the IS promotion gate divides by."""
    pid = policy_id.encode("utf-8")
    if len(pid) > 255:
        raise ProtocolError(f"policy_id longer than 255 bytes: {policy_id!r}")
    action = np.ascontiguousarray(action, dtype=np.float32)
    if action.ndim != 1 or action.shape[0] > 255:
        raise ProtocolError(
            f"FEEDBACK action must be 1-D with dim <= 255, got "
            f"shape {action.shape}"
        )
    flags = (FEEDBACK_TERMINATED if terminated else 0) | (
        FEEDBACK_TRUNCATED if truncated else 0
    )
    next_obs = np.ascontiguousarray(next_obs, dtype=np.float32)
    return (
        _FEEDBACK_HEAD.pack(
            len(pid), action.shape[0], flags, 0,
            float(reward), float(log_prob),
        )
        + pid
        + action.tobytes()
        + next_obs.tobytes()
    )


def decode_feedback(payload: bytes) -> dict:
    """→ ``{policy_id, reward, log_prob, terminated, truncated, action,
    next_obs}``. The next_obs length is self-described (remainder); the
    SERVER validates both dims against the routed policy and answers a
    per-request ``ERROR`` on mismatch (framing intact, connection
    survives) — the same contract as ``ACT2``."""
    if len(payload) < _FEEDBACK_HEAD.size:
        raise ProtocolError(
            f"FEEDBACK payload is {len(payload)} bytes, header needs "
            f"{_FEEDBACK_HEAD.size}"
        )
    plen, adim, flags, _rsvd, reward, log_prob = _FEEDBACK_HEAD.unpack_from(
        payload
    )
    off = _FEEDBACK_HEAD.size
    if len(payload) < off + plen + 4 * adim:
        raise ProtocolError(
            f"FEEDBACK payload is {len(payload)} bytes, ids+action declare "
            f"{off + plen + 4 * adim}"
        )
    policy_id = payload[off:off + plen].decode("utf-8", "replace")
    off += plen
    action = np.frombuffer(payload, np.float32, adim, offset=off).copy()
    off += 4 * adim
    if (len(payload) - off) % 4:
        raise ProtocolError(
            f"FEEDBACK next_obs bytes ({len(payload) - off}) not float32"
        )
    next_obs = np.frombuffer(payload, np.float32, offset=off).copy()
    return {
        "policy_id": policy_id or DEFAULT_POLICY,
        "reward": float(reward),
        "log_prob": float(log_prob),
        "terminated": bool(flags & FEEDBACK_TERMINATED),
        "truncated": bool(flags & FEEDBACK_TRUNCATED),
        "action": action,
        "next_obs": next_obs,
    }


def encode_action(action: np.ndarray) -> bytes:
    return np.ascontiguousarray(action, dtype=np.float32).tobytes()


def decode_action(payload: bytes) -> np.ndarray:
    if len(payload) % 4:
        raise ProtocolError(f"ACT_OK payload length {len(payload)} not float32")
    return np.frombuffer(payload, np.float32).copy()
