"""Self-targeted connection-level attackers for the chaos harness (the
port's copy of ``d4pg_tpu/netio/attack.py``, on the port's
``netio/loop.py``).

Three ``--chaos`` sites (the policy server and the router tick them at
every accept, through the loop's ``on_open``, so an attack launches while
real traffic is in flight):

- ``slowloris@N[:bps]`` — connect and trickle a valid frame header at
  ``bps`` bytes/second, capped one byte short of a complete frame, then
  go silent mid-frame. The victim's read-progress deadline must evict
  it; no request is ever completed, so the answered identity is
  untouched by construction.
- ``zero_window@N[:ms]`` — connect with a tiny receive buffer, pipeline
  ``HEALTHZ`` bursts, and never read a byte. The victim's replies back
  up until its write-progress deadline (or buffered-bytes watermark)
  evicts the connection. ``HEALTHZ`` is outside the answered identity,
  so the books stay exact while ``evicted_write_stall`` moves.
- ``fd_exhaust@N[:ms]`` — hoard descriptors to EMFILE and hold them for
  ``ms``, driving the victim's listener into the reserve-fd shed path
  (``OVERLOADED fd_exhausted``) mid-accept instead of killing the
  accept loop. Unlike the JAX hoard, which fills the table once, this
  one retakes every descriptor freed inside the hold before each accept
  (``FrameLoop.add_pre_accept``), so no accept of the hold finds a free
  descriptor.

Every attacker runs on the victim's OWN FrameLoop as a timer chain —
zero threads, zero selector registrations — and self-bounds: it stops
when evicted, when its budget expires, or at a hard tick cap.
"""

from __future__ import annotations

import os
import socket

from d4pg_tpu_torch.serve import protocol

__all__ = ["tick_attacks"]

_SLOWLORIS_DEFAULT_BPS = 4.0
_ZERO_WINDOW_DEFAULT_MS = 1500.0
_FD_EXHAUST_DEFAULT_MS = 150.0
_ZERO_WINDOW_INTERVAL_S = 0.05
_ATTACK_MAX_TICKS = 2000  # hard safety bound per attacker


def tick_attacks(chaos, loop, host: str, port: int) -> None:
    """Tick the three connection-attack chaos sites; each fire launches
    one attacker against ``host:port`` driven by ``loop``'s timers."""
    e = chaos.tick("slowloris")
    if e is not None:
        _start_slowloris(
            loop, host, port, float(e.arg or _SLOWLORIS_DEFAULT_BPS)
        )
    e = chaos.tick("zero_window")
    if e is not None:
        _start_zero_window(
            loop, host, port, float(e.arg or _ZERO_WINDOW_DEFAULT_MS)
        )
    e = chaos.tick("fd_exhaust")
    if e is not None:
        _start_fd_exhaust(loop, float(e.arg or _FD_EXHAUST_DEFAULT_MS))


def _quiet_close(sock) -> None:
    try:
        sock.close()
    except OSError:
        pass


def _attack_socket(host: str, port: int, rcvbuf: int = 0):
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    if rcvbuf:
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, rcvbuf)
        except OSError:
            pass  # stack refuses tiny buffers: the attack is just slower
    sock.setblocking(False)
    try:
        sock.connect_ex((host, port))
    except OSError:
        _quiet_close(sock)
        return None
    return sock


def _start_slowloris(loop, host: str, port: int, bps: float) -> None:
    sock = _attack_socket(host, port)
    if sock is None:
        return
    interval = 1.0 / max(0.5, bps)
    # a well-formed ACT frame minus its last byte: the victim sees an
    # eternally-incomplete frame, never an answerable request
    drip = protocol.encode_frame(protocol.ACT, 1, b"\x00" * 24)[:-1]
    state = {"i": 0, "ticks": 0}

    def _tick():
        state["ticks"] += 1
        if state["ticks"] > _ATTACK_MAX_TICKS:
            _quiet_close(sock)
            return
        try:
            if state["i"] < len(drip):
                state["i"] += sock.send(drip[state["i"]:state["i"] + 1])
            else:
                # trickle spent: sit silent mid-frame until evicted
                if sock.recv(4096) == b"":
                    _quiet_close(sock)  # victim hung up: eviction landed
                    return
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            _quiet_close(sock)  # reset by the victim: eviction landed
            return
        loop.call_later(interval, _tick)

    loop.call_later(interval, _tick)


def _start_zero_window(loop, host: str, port: int, ms: float) -> None:
    sock = _attack_socket(host, port, rcvbuf=4096)
    if sock is None:
        return
    # pipelined HEALTHZ storm the attacker will never read the replies of
    burst = b"".join(
        protocol.encode_frame(protocol.HEALTHZ, i + 1) for i in range(64)
    )
    budget_ticks = max(1, int((ms / 1e3) / _ZERO_WINDOW_INTERVAL_S))
    state = {"ticks": 0}

    def _tick():
        state["ticks"] += 1
        if state["ticks"] > min(_ATTACK_MAX_TICKS, budget_ticks):
            _quiet_close(sock)  # budget spent: release the victim
            return
        try:
            # never a recv: the receive window slams shut and stays shut
            sock.send(burst)
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            _quiet_close(sock)  # reset by the victim: eviction landed
            return
        loop.call_later(_ZERO_WINDOW_INTERVAL_S, _tick)

    loop.call_later(_ZERO_WINDOW_INTERVAL_S, _tick)


def _start_fd_exhaust(loop, hold_ms: float) -> None:
    hoard = []

    def _fill():
        try:
            while True:
                hoard.append(os.open(os.devnull, os.O_RDONLY))
        except OSError:
            pass  # EMFILE reached: the table is full

    # Filling once is not enough: any descriptor closed inside the hold (a
    # client's close, an eviction, the attackers' own sockets, another
    # thread) leaves a hole the next accept takes. So the hoard tops the
    # table up again right before every accept while it holds.
    _fill()
    loop.add_pre_accept(_fill)

    def _release():
        loop.remove_pre_accept(_fill)
        for fd in hoard:
            try:
                os.close(fd)
            except OSError:
                pass
        hoard.clear()

    loop.call_later(max(0.01, hold_ms / 1e3), _release)
