"""One event-loop I/O core for the policy server's front-end (the port's
copy of ``d4pg_tpu/netio``).

A single ``selectors``-based loop thread owns every accepted connection —
reads, frame reassembly hand-off, buffered writes, per-connection progress
deadlines, and bounded accept — so a front-end holds tens of thousands of
mostly-idle connections with O(1) threads instead of one thread per
connection.

Division of labor: this package moves bytes and enforces *liveness* — it
never parses or builds a frame header. Framing lives in
``d4pg_tpu_torch.serve.protocol``
(:class:`~d4pg_tpu_torch.serve.protocol.FrameAssembler` on the read side,
:func:`~d4pg_tpu_torch.serve.protocol.encode_frame` on the write side), so
the loop path is byte-identical to the blocking ``read_frame`` /
``write_frame`` path by construction.

Robustness contract:

- **read-progress deadline** — once a partial frame exists, the peer has
  ``read_stall_s`` to complete it; trickling bytes does not reset the
  clock (a slowloris drip never does), completing a frame does. Expiry
  evicts the connection.
- **write-progress deadline** — while reply bytes are buffered, the peer
  must drain *something* every ``write_stall_s``: one zero-window client
  stalls only itself, never a reply thread. A per-connection buffered-
  bytes watermark (``write_buffer_limit``) bounds what a never-reading
  peer can make the server hold.
- **bounded accept** — EMFILE/ENFILE mid-accept sheds the connection
  admission-controlled (a reserve fd is burned to accept + answer
  ``OVERLOADED fd_exhausted`` + close) instead of killing the accept
  loop; if even the reserve cannot reopen, accepting pauses briefly
  rather than spinning.

The loop uses the stdlib, the protocol module and the lock witness's
named locks only. :mod:`d4pg_tpu_torch.netio.attack` holds the chaos
attackers (slowloris, zero-window, fd exhaustion) that the policy server
launches on its own loop at accept under ``--chaos``.
"""

from d4pg_tpu_torch.netio.loop import Connection, FrameLoop

__all__ = ["Connection", "FrameLoop"]
