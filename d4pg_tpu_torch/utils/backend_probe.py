"""Hermetic device probe (the port's counterpart of
``d4pg_tpu/utils/backend_probe.py``).

A card that is missing, wedged or mis-set-up can make the first CUDA call
raise, hang, or report no device. Probing in a short-timeout subprocess
shields the calling process from all three: it never initializes CUDA
itself unless the probe's answer warrants it. ``chip_smoke.py`` calls it
first and stops on ``(None, 0)``.

Deliberately dependency-free at import time (no torch import).
"""

from __future__ import annotations

import functools
import os
import subprocess
import sys

PROBE = (
    "import torch\n"
    "ok = torch.cuda.is_available()\n"
    "print('cuda' if ok else 'none')\n"
    "print(torch.cuda.device_count() if ok else 0)\n"
)


@functools.lru_cache(maxsize=None)
def probe_default_backend(timeout: float | None = None) -> tuple[str | None, int]:
    """(platform, device_count) of torch's CUDA backend, probed in a
    subprocess: ``("cuda", n)`` with n cards; ``(None, 0)`` when the child
    fails, times out, prints what is not the two lines, or finds no card.

    Memoized: within one process the card either comes up or it does not,
    so callers that probe twice pay the subprocess (and a hang's whole
    timeout) once. ``GRAFT_PROBE_TIMEOUT`` sets the timeout (90 s)."""
    timeout = timeout or float(os.environ.get("GRAFT_PROBE_TIMEOUT", "90"))
    try:
        proc = subprocess.run([sys.executable, "-c", PROBE], capture_output=True, text=True,
                              timeout=timeout)
    except (subprocess.TimeoutExpired, OSError):
        return None, 0
    if proc.returncode != 0:
        return None, 0
    lines = [ln.strip() for ln in proc.stdout.strip().splitlines() if ln.strip()]
    try:
        platform, count = lines[-2], int(lines[-1])
    except (IndexError, ValueError):
        return None, 0
    if platform != "cuda" or count < 1:
        return None, 0
    return platform, count
