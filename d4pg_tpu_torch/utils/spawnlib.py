"""Subprocess harness for the port's process-spawning CLIs (the port's copy
of ``scripts/spawnlib.py``, inside the package because that file imports
the JAX package's ``utils/procs``).

The router's autoscaler spawns serve replicas and actor hosts through it,
and the CLI checks spawn serve and router processes with it: each child's
stdout is pumped through a tagged tee, and its ``listening on host:port``
startup line is scraped for the ephemeral port. Backed by
:mod:`d4pg_tpu_torch.utils.procs`:

- :func:`spawn_group` starts the child as its OWN session/group leader
  (setsid), so (a) killing it can take its whole subtree (a learner's
  pool workers) and (b) it survives the spawner's death;
- :meth:`Spawned.stop` is THE bounded escalation (SIGTERM drain →
  bounded wait → group SIGKILL → sweep);
- :func:`reap_orphans` sweeps every group this module ever spawned and
  returns the survivors it had to kill ([] is the "zero orphaned
  processes" assertion).

Stdlib only: no numpy, no torch.
"""

import signal
import subprocess
import sys
import threading

from d4pg_tpu_torch.utils import procs

__all__ = ["Spawned", "reap_orphans", "spawn", "spawn_group"]

# Every process group spawn_group() created in this process, for the
# final reap_orphans() sweep (pgid of a setsid child == its pid).
_GROUP_PGIDS = []


class Spawned:
    """A CLI subprocess with a stdout pump thread: ``lines`` collects
    everything printed (tagged onto our stdout as it arrives), and the
    first ``listening on host:port`` line parses into ``wait_port()``."""

    def __init__(self, argv, tag, new_session=False, env=None):
        self.tag = tag
        self.proc = subprocess.Popen(
            argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=new_session, env=env,
        )
        # setsid children lead their own group (pgid == pid); plain spawns
        # share ours — stop() then escalates on the leader only.
        self.pgid = self.proc.pid if new_session else 0
        if new_session:
            _GROUP_PGIDS.append(self.pgid)
        self.lines = []
        self.port_event = threading.Event()
        self._port_box = []
        threading.Thread(
            target=self._pump, name=f"pump-{tag}", daemon=True
        ).start()

    def _pump(self):
        for line in self.proc.stdout:
            sys.stdout.write(f"[{self.tag}] {line}")
            self.lines.append(line)
            if "listening on" in line and not self._port_box:
                addr = line.split("listening on", 1)[1].split()[0]
                self._port_box.append(int(addr.rsplit(":", 1)[1]))
                self.port_event.set()
        self.port_event.set()  # EOF: don't leave a waiter hanging

    def wait_port(self, timeout=180.0):
        assert self.port_event.wait(timeout) and self._port_box, (
            f"{self.tag} never reported its port"
        )
        return self._port_box[0]

    def stop(self, sig=signal.SIGTERM, drain_timeout_s=120.0,
             kill_timeout_s=10.0):
        """Bounded stop: ``sig`` → wait ``drain_timeout_s`` → SIGKILL the
        group (setsid spawns) / leader → bounded reap. Returns the exit
        code (None only if the kill itself wedged)."""
        rc = procs.drain_or_kill(
            self.proc, pgid=self.pgid, sig=sig,
            drain_timeout_s=drain_timeout_s, kill_timeout_s=kill_timeout_s,
            label=self.tag,
        )
        if self.pgid and not procs.group_pids(self.pgid):
            # confirmed empty: drop it from the sweep registry so a
            # kernel-recycled pgid can never be group-killed later
            try:
                _GROUP_PGIDS.remove(self.pgid)
            except ValueError:
                pass
        return rc


def spawn(argv, tag, env=None):
    return Spawned(argv, tag, env=env)


def spawn_group(argv, tag, env=None):
    """Spawn as a session/process-group leader (setsid): kills can take
    the whole subtree, and the child outlives this process."""
    return Spawned(argv, tag, new_session=True, env=env)


def reap_orphans():
    """SIGKILL any survivor in any group this process spawned via
    :func:`spawn_group`; returns the PIDs that were still alive. Callers
    with a zero-orphans contract assert the return is empty."""
    return procs.reap_orphans(list(_GROUP_PGIDS), label="spawnlib")
