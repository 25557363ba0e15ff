"""Process-group lifecycle helpers: setsid spawn, bounded drain, orphan
sweep (the port's copy of ``d4pg_tpu/utils/procs.py``).

Every place that manages replica, actor or learner SUBPROCESSES needs
the same three disciplines:

- **own session per child** (``start_new_session=True``): a learner spawns
  its own actor-pool workers; killing only the leader leaks the workers.
  With the child as a session/group leader, ``killpg`` reaps the whole
  tree, and the child survives *our* death.
- **bounded drain, then group-kill**: SIGTERM first (the graceful
  contract: checkpoint + exit 75, serve drain + exit 0), wait a bounded
  time on ``time.monotonic``, then SIGKILL the *group*: never an
  unbounded ``wait()``, never a leader-only kill.
- **orphan sweep**: after any kill path, verify the group is actually
  empty (``/proc`` scan) and SIGKILL stragglers. "Zero orphaned
  processes" is an asserted contract, not a hope.

Stdlib only (no numpy, no torch): imported by the serve autoscaler and
the spawn harness (:mod:`d4pg_tpu_torch.utils.spawnlib`), both host-only.
The JAX module's ``load_spawnlib`` loads ``scripts/spawnlib.py`` by file
path; that file imports the JAX package, so the port imports its own
harness instead and has no such loader.
"""

from __future__ import annotations

import os
import signal
import socket
import time
from typing import List, Optional


def pid_alive(pid: int) -> bool:
    """True while ``pid`` exists (including as a zombie we cannot reap —
    callers that own the child should poll()/wait() it as well)."""
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def pid_cmdline(pid: int) -> str:
    """The process's argv as one NUL→space string ('' when gone/unreadable).
    Linux ``/proc``: a supervisor uses this to make re-adoption of a
    journaled PID safe against PID reuse (the cmdline must still name what
    it ran)."""
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().replace(b"\0", b" ").decode(errors="replace").strip()
    except OSError:
        return ""


def pids_with_cmdline(*fragments: str) -> List[int]:
    """Every live PID whose cmdline (:func:`pid_cmdline`) contains each of
    ``fragments`` (/proc scan; [] off-Linux): the zero-orphans check of a
    harness that knows what its children ran, not their groups."""
    try:
        entries = os.listdir("/proc")
    except OSError:
        return []
    out: List[int] = []
    for name in entries:
        if name.isdigit():
            cmd = pid_cmdline(int(name))
            if cmd and all(f in cmd for f in fragments):
                out.append(int(name))
    return out


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago (a coordinator's
    or a server's, picked by the harness that starts it)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def group_pids(pgid: int) -> List[int]:
    """Every live PID in process group ``pgid`` (/proc scan; [] off-Linux).

    Cold-path only (kill escalation, orphan sweeps) — a full /proc walk
    per call is fine there and keeps this dependency-free.
    """
    pids: List[int] = []
    try:
        entries = os.listdir("/proc")
    except OSError:
        return pids
    for name in entries:
        if not name.isdigit():
            continue
        pid = int(name)
        try:
            if os.getpgid(pid) == pgid:
                pids.append(pid)
        except (ProcessLookupError, PermissionError, OSError):
            continue
    return pids


def kill_group(pgid: int, sig: int = signal.SIGKILL) -> bool:
    """Signal the whole group; False when it is already gone."""
    if pgid <= 0:
        return False
    try:
        os.killpg(pgid, sig)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def wait_pid_gone(pid: int, timeout_s: float, *, proc=None,
                  poll_s: float = 0.05) -> bool:
    """Wait (monotonic-bounded) until ``pid`` is gone. When ``proc`` (a
    ``subprocess.Popen``) is given it is polled too, so our own children
    are reaped instead of lingering as zombies that keep pid_alive true."""
    deadline = time.monotonic() + max(0.0, timeout_s)
    while True:
        if proc is not None and proc.poll() is not None:
            return True
        if not pid_alive(pid):
            return True
        if time.monotonic() >= deadline:
            return False
        time.sleep(poll_s)


def drain_or_kill(
    proc,
    *,
    pgid: Optional[int] = None,
    sig: int = signal.SIGTERM,
    drain_timeout_s: float = 120.0,
    kill_timeout_s: float = 10.0,
    label: str = "process",
) -> Optional[int]:
    """THE bounded stop escalation, once: ``sig`` (graceful drain) →
    bounded wait → SIGKILL the whole group (falling back to the leader
    when no group is known) → bounded reap. Returns the exit code, or
    ``None`` when even the kill wait expired (the caller should log and
    sweep)."""
    rc = proc.poll()
    if rc is not None:
        if pgid:
            reap_orphans([pgid], label=label)
        return rc
    try:
        proc.send_signal(sig)
    except (ProcessLookupError, OSError):
        pass
    if wait_pid_gone(proc.pid, drain_timeout_s, proc=proc):
        rc = proc.poll()
        if pgid:
            # the leader drained; sweep any children it failed to take down
            reap_orphans([pgid], label=label)
        return rc
    print(f"[procs] {label} (pid {proc.pid}) ignored signal {sig} for "
          f"{drain_timeout_s:.0f}s; killing the group", flush=True)
    if pgid:
        kill_group(pgid, signal.SIGKILL)
    try:
        proc.kill()
    except (ProcessLookupError, OSError):
        pass
    if not wait_pid_gone(proc.pid, kill_timeout_s, proc=proc):
        print(f"[procs] {label} (pid {proc.pid}) survived SIGKILL "
              f"{kill_timeout_s:.0f}s (D-state?)", flush=True)
        return None
    if pgid:
        reap_orphans([pgid], label=label)
    return proc.poll()


def reap_orphans(pgids, *, label: str = "group",
                 kill_timeout_s: float = 5.0) -> List[int]:
    """SIGKILL every surviving member of the given process groups and
    return the PIDs that were still alive (the sweep's finding — callers
    assert it empty where 'zero orphans' is a contract). Idempotent and
    safe on long-gone groups."""
    found: List[int] = []
    for pgid in pgids:
        if not pgid or pgid <= 0:
            continue
        survivors = group_pids(pgid)
        if not survivors:
            continue
        found.extend(survivors)
        print(f"[procs] orphan sweep: {label} pgid {pgid} still has "
              f"{survivors}; SIGKILLing the group", flush=True)
        kill_group(pgid, signal.SIGKILL)
        deadline = time.monotonic() + kill_timeout_s
        while group_pids(pgid) and time.monotonic() < deadline:
            time.sleep(0.05)
    return found
