"""Payload codecs of the fleet frames (the port's copy of
``d4pg_tpu/fleet/wire.py``: the same bytes, so an actor of either package
talks to an ingest server of either package).

The frame around each payload (magic, version, type, req_id, length) is
``d4pg_tpu_torch/serve/protocol.py``'s; this module defines what goes
inside.

``HELLO`` (JSON)
    The actor's handshake: ``{actor_id, env, obs_dim, action_dim, n_step,
    gamma, generation}`` and, optionally, ``caps`` — ``{wire, obs_modes,
    her, obs_norm, variant, source}``, what the actor can produce. The
    ingest server refuses a dims, n-step or gamma mismatch before any
    window lands (it would train the wrong MDP) and negotiates ``caps``
    against what the learner's replay needs
    (``replay/source.py:negotiate_fleet``); a mismatch is refused with a
    structured JSON reason (:func:`encode_refusal`). A HELLO without
    ``caps`` negotiates as the first actors did: the v1 wire, f32 rows, no
    HER, no stats tags.

``HELLO_OK`` (JSON)
    ``{generation, max_windows_per_frame, max_inflight}``: the learner's
    bundle generation (a reconnecting actor learns at once that its
    bundle is stale) and the flow-control window. An actor that sent
    ``caps`` also gets the chosen ``caps`` and ``stats_generation``; one
    that did not gets the v1 reply, byte for byte.

``WINDOWS`` (binary, frame version 1)
    ``u32 generation, u32 count`` then ``count`` float32 rows ``obs ·
    action · reward · next_obs · discount``: complete n-step windows, the
    columns of :class:`~d4pg_tpu_torch.replay.uniform.Transition`. The
    n-step return is summed in float64 by the actor's writer and rounded
    to float32 once, where the in-process writer's ``add_batch`` rounds
    it, so fleet and in-process replay hold the same bytes.

``WINDOWS2`` (binary, frame version 2)
    ``u32 generation, u32 stats_generation, u32 count, u8 obs_mode, u8
    flags, u16 reserved`` then column blocks: obs (in the obs mode),
    actions, rewards, next_obs (in the obs mode), discounts (all float32
    but the obs). Obs modes:

    - ``f32``: the bytes of ``WINDOWS``' columns;
    - ``u8``: pixel rows as ``clip(rint(obs·255), 0, 255)``, the replay's
      own uint8 quantization, so a uint8 buffer stores the wire's bytes;
    - ``bf16``: flat rows rounded to bfloat16 (to nearest, ties to even),
      the one lossy mode, by declaration.

    ``flags`` bit 0 (:data:`FLAG_RELABELED`) marks hindsight-relabelled
    windows: the ingest folds no obs-norm statistics from them (the
    original window already counted that step). Bit 1
    (:data:`FLAG_LOGPROB`) appends one float32 column, the behaviour
    policy's log-prob of each window's first action (the flywheel's
    mirror frames); without it the payload is the plain WINDOWS2 bytes.
    The ingest drops the column before ``add_batch``.

``WINDOWS_OK`` (struct)
    ``u32 accepted, u32 dropped_stale``: the frame's account (stale
    covers bundle- and stats-generation drops). A frame the full queue
    sheds is answered ``OVERLOADED`` ``queue_full`` instead.

The bf16 mode uses ``ml_dtypes`` where it is installed (imported when a
bf16 row is first encoded, never for f32 or u8) and otherwise its own
numpy round to nearest even, which gives the same bytes
(``tests/test_torch_fleet.py`` holds the two equal). Decoding a bf16 row
needs neither: it is a 16-bit shift.
"""

from __future__ import annotations

import json
import struct
from typing import Optional, Tuple

import numpy as np

from d4pg_tpu_torch.serve.protocol import MAX_PAYLOAD, ProtocolError

_WINDOWS_HEAD = struct.Struct("<II")   # generation, count
# generation, stats_generation, count, obs_mode, flags, reserved
_WINDOWS2_HEAD = struct.Struct("<IIIBBH")
_WINDOWS_OK = struct.Struct("<II")     # accepted, dropped_stale

# Obs wire modes (the WINDOWS2 header's ``obs_mode``); the negotiation
# uses the same names (replay/source.py:OBS_MODES).
OBS_MODE_IDS = {"f32": 0, "u8": 1, "bf16": 2}
OBS_MODE_NAMES = {v: k for k, v in OBS_MODE_IDS.items()}
OBS_MODE_BYTES = {"f32": 4, "u8": 1, "bf16": 2}

FLAG_RELABELED = 1  # WINDOWS2 flags bit 0: hindsight-relabelled window
FLAG_LOGPROB = 2    # WINDOWS2 flags bit 1: behaviour log-prob column present


def bf16_bits_numpy(x: np.ndarray) -> np.ndarray:
    """float32 → bfloat16 bits (uint16), rounded to nearest with ties to
    even; a NaN keeps its sign and becomes the quiet NaN ``0x7FC0``. The
    conversion ``ml_dtypes`` makes, in numpy alone."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    rounded = (bits + (np.uint32(0x7FFF) + ((bits >> 16) & 1))) >> 16
    nan = (bits & 0x7FFFFFFF) > 0x7F800000
    out = rounded.astype(np.uint16)
    out[nan] = ((bits[nan] >> 16) & 0x8000) | 0x7FC0
    return out


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 → bfloat16 bits: through ``ml_dtypes`` when it is installed
    (imported here, on the first bf16 row), else :func:`bf16_bits_numpy`."""
    x = np.ascontiguousarray(x, np.float32)
    try:
        import ml_dtypes
    except ImportError:
        return bf16_bits_numpy(x)
    return x.astype(ml_dtypes.bfloat16).view(np.uint16)


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bits → float32 (exact: the bits are the float32's top half)."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(np.float32)


def quantize_obs_u8(obs: np.ndarray) -> np.ndarray:
    """[0, 1] float rows → wire bytes, quantized exactly as the uint8 replay
    quantizes at store time (``ReplayBuffer._encode_obs``): a uint8 buffer
    stores these bytes, whichever side quantized them. The 255 is the
    replay's scale, not a default."""
    obs = np.asarray(obs, np.float32)
    return np.clip(np.rint(obs * 255.0), 0.0, 255.0).astype(np.uint8)


def encode_obs_block(obs: np.ndarray, obs_mode: str) -> bytes:
    if obs_mode == "f32":
        return np.ascontiguousarray(obs, np.float32).tobytes()
    if obs_mode == "u8":
        return np.ascontiguousarray(quantize_obs_u8(obs)).tobytes()
    if obs_mode == "bf16":
        return bf16_bits(np.asarray(obs, np.float32)).tobytes()
    raise ProtocolError(f"unknown obs wire mode {obs_mode!r}")


def decode_obs_block(buf: bytes, count: int, obs_dim: int, obs_mode: str,
                     raw_u8: bool = False) -> np.ndarray:
    """Wire bytes → float32 rows, the inverse of :func:`encode_obs_block`.
    u8 rows divide by 255 (a division, never a multiply by 1/255: the
    replay's re-quantization then gives the wire's bytes back); with
    ``raw_u8`` they stay the wire's uint8 bytes, for a uint8 replay that
    stores them as they are."""
    if obs_mode == "f32":
        return np.frombuffer(buf, np.float32).reshape(count, obs_dim).copy()
    if obs_mode == "u8":
        raw = np.frombuffer(buf, np.uint8).reshape(count, obs_dim)
        return raw.copy() if raw_u8 else raw.astype(np.float32) / 255.0
    if obs_mode == "bf16":
        raw = np.frombuffer(buf, np.uint16).reshape(count, obs_dim)
        return bf16_bits_to_f32(raw)
    raise ProtocolError(f"unknown obs wire mode {obs_mode!r}")


def window_row_floats(obs_dim: int, action_dim: int) -> int:
    """float32 slots of a WINDOWS row: obs, action, reward, next_obs,
    discount."""
    return 2 * obs_dim + action_dim + 2


def window_row_bytes(obs_dim: int, action_dim: int,
                     obs_mode: str = "f32") -> int:
    """Wire bytes of a window row in an obs mode (obs and next_obs in the
    mode, the rest float32)."""
    return 2 * obs_dim * OBS_MODE_BYTES[obs_mode] + 4 * (action_dim + 2)


def max_windows_per_frame(obs_dim: int, action_dim: int, cap: int = 256,
                          obs_mode: str = "f32") -> int:
    """The most windows a frame holds inside ``MAX_PAYLOAD``, at most
    ``cap``: a frame is also the unit of a shed and of an ack, so a
    frame without bound would make admission coarse."""
    head = max(_WINDOWS_HEAD.size, _WINDOWS2_HEAD.size)
    fit = (MAX_PAYLOAD - head) // window_row_bytes(obs_dim, action_dim, obs_mode)
    if fit < 1:
        raise ValueError(
            f"one window row (obs_dim={obs_dim}, action_dim={action_dim}, "
            f"obs_mode={obs_mode}) exceeds MAX_PAYLOAD={MAX_PAYLOAD}"
        )
    return max(1, min(cap, fit))


# ------------------------------------------------------------------ HELLO
def _caps_doc(caps: dict) -> dict:
    """The HELLO ``caps`` in their wire form (every key, coerced)."""
    return {
        "wire": int(caps.get("wire", 2)),
        "obs_modes": [str(m) for m in (caps.get("obs_modes") or ["f32"])],
        "her": bool(caps.get("her", False)),
        "obs_norm": bool(caps.get("obs_norm", False)),
        "variant": int(caps.get("variant", 0)),
        "source": str(caps.get("source", "actor")),
    }


def encode_hello(
    *,
    actor_id: str,
    env: str,
    obs_dim: int,
    action_dim: int,
    n_step: int,
    gamma: float,
    generation: int,
    caps: Optional[dict] = None,
) -> bytes:
    doc = {
        "actor_id": actor_id,
        "env": env,
        "obs_dim": int(obs_dim),
        "action_dim": int(action_dim),
        "n_step": int(n_step),
        "gamma": float(gamma),
        "generation": int(generation),
    }
    if caps is not None:
        # ``variant`` is the league variant the host is assigned to (0 =
        # none); ``source`` names the stream ("actor" for the fleet,
        # "mirror" for the flywheel's tap) and only picks the ingest's
        # per-source counter
        doc["caps"] = _caps_doc(caps)
    return json.dumps(doc).encode()


def decode_hello(payload: bytes) -> dict:
    try:
        doc = json.loads(payload.decode())
        # the one coercion point: a missing key (KeyError) or a wrong-typed
        # one ({"obs_dim": null}: TypeError) fails here as a ProtocolError
        # the reader answers, not deep in the validation
        for k in ("obs_dim", "action_dim", "n_step"):
            doc[k] = int(doc[k])
        doc["gamma"] = float(doc["gamma"])
        doc["generation"] = int(doc.get("generation", 0))
        if doc.get("caps") is not None:
            doc["caps"] = _caps_doc(doc["caps"])
        return doc
    except (ValueError, KeyError, TypeError, AttributeError,
            UnicodeDecodeError) as e:
        raise ProtocolError(f"malformed HELLO payload: {e}") from e


def _chosen_caps_doc(caps: dict) -> dict:
    return {
        "obs_mode": str(caps.get("obs_mode", "f32")),
        "her": bool(caps.get("her", False)),
        "obs_norm": bool(caps.get("obs_norm", False)),
        "variant": int(caps.get("variant", 0)),
    }


def encode_hello_ok(
    *,
    generation: int,
    max_windows: int,
    max_inflight: int,
    caps: Optional[dict] = None,
    stats_generation: Optional[int] = None,
) -> bytes:
    doc = {
        "generation": int(generation),
        "max_windows_per_frame": int(max_windows),
        "max_inflight": int(max_inflight),
    }
    if caps is not None:
        # only for an actor that sent caps: the reply to a caps-less HELLO
        # stays the v1 bytes. ``variant`` echoes the learner's, so an
        # assigned actor can tell a wrong port.
        doc["caps"] = _chosen_caps_doc(caps)
        doc["stats_generation"] = int(stats_generation or 0)
    return json.dumps(doc).encode()


def decode_hello_ok(payload: bytes) -> dict:
    try:
        doc = json.loads(payload.decode())
        for k in ("generation", "max_windows_per_frame", "max_inflight"):
            doc[k] = int(doc[k])
        if "caps" in doc:
            doc["caps"] = _chosen_caps_doc(doc["caps"])
            doc["stats_generation"] = int(doc.get("stats_generation", 0))
        return doc
    except (ValueError, KeyError, TypeError, AttributeError,
            UnicodeDecodeError) as e:
        raise ProtocolError(f"malformed HELLO_OK payload: {e}") from e


def encode_refusal(message: str, gaps=()) -> bytes:
    """The ERROR payload of a refused handshake: the readable ``handshake
    refused:`` message (an actor that knows no better prints it as it is)
    and ``gaps``, ``[{code, message}]``, for one that parses them."""
    return json.dumps(
        {
            "refused": "handshake",
            "message": f"handshake refused: {message}",
            "gaps": [{"code": g.code, "message": g.message} for g in gaps],
        }
    ).encode()


def decode_refusal(payload: bytes) -> Optional[dict]:
    """An ERROR payload as a structured refusal; None for a plain-text
    error (another failure, or an older server)."""
    try:
        doc = json.loads(payload.decode())
    except (ValueError, UnicodeDecodeError):
        return None
    if isinstance(doc, dict) and doc.get("refused") == "handshake":
        return doc
    return None


# ---------------------------------------------------------------- WINDOWS
def encode_windows(
    generation: int,
    obs: np.ndarray,
    action: np.ndarray,
    reward: np.ndarray,
    next_obs: np.ndarray,
    discount: np.ndarray,
) -> bytes:
    """``n`` complete windows as one WINDOWS payload; inputs ``[n, obs_dim]
    / [n, action_dim] / [n] / [n, obs_dim] / [n]``."""
    obs = np.ascontiguousarray(obs, np.float32)
    action = np.ascontiguousarray(action, np.float32)
    n, obs_dim = obs.shape
    a = action.shape[1]
    rows = np.empty((n, window_row_floats(obs_dim, a)), np.float32)
    rows[:, :obs_dim] = obs
    rows[:, obs_dim:obs_dim + a] = action
    rows[:, obs_dim + a] = np.asarray(reward, np.float32)
    rows[:, obs_dim + a + 1:2 * obs_dim + a + 1] = np.asarray(next_obs, np.float32)
    rows[:, 2 * obs_dim + a + 1] = np.asarray(discount, np.float32)
    payload = _WINDOWS_HEAD.pack(int(generation), n) + rows.tobytes()
    if len(payload) > MAX_PAYLOAD:
        raise ProtocolError(
            f"WINDOWS payload {len(payload)} bytes > max {MAX_PAYLOAD}; "
            "send fewer windows per frame"
        )
    return payload


def decode_windows(payload: bytes, obs_dim: int, action_dim: int) -> Tuple[int, dict]:
    """→ ``(generation, columns)``, columns named as the Transition fields,
    fresh arrays. A size that does not add up is a ProtocolError (a torn
    or oversized frame)."""
    if len(payload) < _WINDOWS_HEAD.size:
        raise ProtocolError(
            f"WINDOWS payload {len(payload)} bytes < header {_WINDOWS_HEAD.size}"
        )
    generation, count = _WINDOWS_HEAD.unpack_from(payload)
    rowf = window_row_floats(obs_dim, action_dim)
    want = _WINDOWS_HEAD.size + 4 * rowf * count
    if len(payload) != want:
        raise ProtocolError(
            f"WINDOWS payload is {len(payload)} bytes, header declares "
            f"{count} rows of {rowf} float32 = {want}"
        )
    rows = np.frombuffer(payload, np.float32, offset=_WINDOWS_HEAD.size).reshape(count, rowf)
    a = action_dim
    return int(generation), {
        "obs": rows[:, :obs_dim].copy(),
        "action": rows[:, obs_dim:obs_dim + a].copy(),
        "reward": rows[:, obs_dim + a].copy(),
        "next_obs": rows[:, obs_dim + a + 1:2 * obs_dim + a + 1].copy(),
        "discount": rows[:, 2 * obs_dim + a + 1].copy(),
    }


# --------------------------------------------------------------- WINDOWS2
def encode_windows2(
    generation: int,
    stats_generation: int,
    obs_mode: str,
    relabeled: bool,
    obs: np.ndarray,
    action: np.ndarray,
    reward: np.ndarray,
    next_obs: np.ndarray,
    discount: np.ndarray,
    logprob: Optional[np.ndarray] = None,
) -> bytes:
    """``n`` complete windows as one WINDOWS2 payload (column blocks; obs
    and next_obs in ``obs_mode``). ``logprob`` (``[n]``) appends the
    behaviour log-prob column and sets :data:`FLAG_LOGPROB`."""
    if obs_mode not in OBS_MODE_IDS:
        raise ProtocolError(f"unknown obs wire mode {obs_mode!r}")
    obs = np.atleast_2d(np.asarray(obs, np.float32))
    next_obs = np.atleast_2d(np.asarray(next_obs, np.float32))
    action = np.atleast_2d(np.asarray(action, np.float32))
    n = obs.shape[0]
    flags = FLAG_RELABELED if relabeled else 0
    if logprob is not None:
        flags |= FLAG_LOGPROB
    payload = (
        _WINDOWS2_HEAD.pack(int(generation), int(stats_generation), n,
                            OBS_MODE_IDS[obs_mode], flags, 0)
        + encode_obs_block(obs, obs_mode)
        + np.ascontiguousarray(action).tobytes()
        + np.asarray(reward, np.float32).tobytes()
        + encode_obs_block(next_obs, obs_mode)
        + np.asarray(discount, np.float32).tobytes()
        + (b"" if logprob is None else np.asarray(logprob, np.float32).tobytes())
    )
    if len(payload) > MAX_PAYLOAD:
        raise ProtocolError(
            f"WINDOWS2 payload {len(payload)} bytes > max {MAX_PAYLOAD}; "
            "send fewer windows per frame"
        )
    return payload


def decode_windows2(
    payload: bytes, obs_dim: int, action_dim: int, raw_u8: bool = False,
) -> Tuple[int, int, str, bool, dict]:
    """→ ``(generation, stats_generation, obs_mode, relabeled, columns)``,
    the obs decoded to float32 (u8 rows ÷255, bf16 widened; with
    ``raw_u8`` u8 rows stay bytes). ``columns`` has ``logprob`` only when
    the frame declares it. A size that does not add up is a ProtocolError:
    a torn pixel frame dies here, whole."""
    if len(payload) < _WINDOWS2_HEAD.size:
        raise ProtocolError(
            f"WINDOWS2 payload {len(payload)} bytes < header {_WINDOWS2_HEAD.size}"
        )
    gen, stats_gen, count, mode_id, flags, _rsvd = _WINDOWS2_HEAD.unpack_from(payload)
    obs_mode = OBS_MODE_NAMES.get(mode_id)
    if obs_mode is None:
        raise ProtocolError(f"WINDOWS2 declares unknown obs mode {mode_id}")
    has_logprob = bool(flags & FLAG_LOGPROB)
    ob = obs_dim * OBS_MODE_BYTES[obs_mode]
    want = _WINDOWS2_HEAD.size + count * (ob * 2 + 4 * (action_dim + 2))
    if has_logprob:
        want += 4 * count
    if len(payload) != want:
        raise ProtocolError(
            f"WINDOWS2 payload is {len(payload)} bytes, header declares "
            f"{count} rows ({obs_mode} obs"
            f"{', +logprob' if has_logprob else ''}) = {want}"
        )
    off = _WINDOWS2_HEAD.size
    obs = decode_obs_block(payload[off:off + count * ob], count, obs_dim, obs_mode, raw_u8)
    off += count * ob
    action = np.frombuffer(payload, np.float32, count * action_dim,
                           offset=off).reshape(count, action_dim).copy()
    off += 4 * count * action_dim
    reward = np.frombuffer(payload, np.float32, count, offset=off).copy()
    off += 4 * count
    next_obs = decode_obs_block(payload[off:off + count * ob], count, obs_dim, obs_mode, raw_u8)
    off += count * ob
    discount = np.frombuffer(payload, np.float32, count, offset=off).copy()
    off += 4 * count
    cols = {"obs": obs, "action": action, "reward": reward,
            "next_obs": next_obs, "discount": discount}
    if has_logprob:
        cols["logprob"] = np.frombuffer(payload, np.float32, count, offset=off).copy()
    return int(gen), int(stats_gen), obs_mode, bool(flags & FLAG_RELABELED), cols


# ------------------------------------------------------------- WINDOWS_OK
def encode_windows_ok(accepted: int, dropped_stale: int = 0) -> bytes:
    return _WINDOWS_OK.pack(int(accepted), int(dropped_stale))


def decode_windows_ok(payload: bytes) -> Tuple[int, int]:
    if len(payload) != _WINDOWS_OK.size:
        raise ProtocolError(
            f"WINDOWS_OK payload is {len(payload)} bytes, expected {_WINDOWS_OK.size}"
        )
    accepted, dropped_stale = _WINDOWS_OK.unpack(payload)
    return accepted, dropped_stale
