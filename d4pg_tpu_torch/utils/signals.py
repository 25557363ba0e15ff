"""SIGTERM/SIGINT graceful-stop installer (the port's own copy of
``d4pg_tpu/utils/signals.py``).

- the stop callback runs FIRST and must be signal-safe (set an event,
  nothing else): ``print()`` can raise "reentrant call inside
  BufferedWriter" when the signal lands inside the main thread's own
  stdout write, and the stop must already be armed by then;
- the default disposition is restored second, so a SECOND signal
  hard-kills a wedged process instead of re-arming the stop;
- the informational print runs last, guarded against the reentrancy
  error.
"""

from __future__ import annotations

import signal


def install_graceful_signals(stop_callback, message: str) -> None:
    """Install SIGTERM+SIGINT handlers: arm ``stop_callback`` (first
    signal), restore SIG_DFL (second signal kills), then best-effort print
    ``message`` (``{sig}`` is substituted with the signal name)."""

    def handler(signum, frame):
        stop_callback()
        signal.signal(signum, signal.SIG_DFL)
        try:
            print(message.format(sig=signal.Signals(signum).name), flush=True)
        except RuntimeError:
            pass  # reentrant stdout write; the stop is already armed

    for s in (signal.SIGTERM, signal.SIGINT):
        signal.signal(s, handler)
