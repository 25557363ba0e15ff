"""The relaunching supervisor of a multi-process run: recovery from the
chaos site ``host_kill`` (the port's counterpart of
``scripts/multihost_smoke.sh``).

Two legs over the train CLI as two processes on the device placement
(``--dp 2 --num-processes 2``, one lane each, over gloo; two ranks on one
card also take gloo, ``parallel/distributed.py:choose_backend``), each
process started by ``utils/spawnlib.py`` in a session of its own:

1. **The kill.** Both processes run with ``--chaos host_kill@N:1``:
   process 1 SIGKILLs itself at its Nth megastep dispatch, after the
   checkpoint at step c committed (its gathers are collectives, so both
   processes were alive) and strictly before the next save. The harness
   waits for the victim, checks that SIGKILL ended it, then reaps the
   survivor with SIGKILL (a drain would run collectives against a dead
   peer) and checks that no manifest names a step past c.
2. **The relaunch.** Both processes again with ``--resume``: each must
   print ``resumed from step c``, restore the replay snapshot (each
   process deals itself its lanes' rows) and the device-PER sidecar (each
   lane its subtree), and end with a ``done:`` line whose model metrics
   (every key but ``*_per_sec``) are equal across the processes, and
   with a ``[train] kernel launches: {...}`` line.

No process may be left behind. :func:`run` does both legs
(:func:`kill_leg`, then :func:`relaunch_leg`) and returns what it saw;
every failed check raises :class:`SupervisorError`. From the command
line, :func:`run` (K = 8, a checkpoint every 16 grad steps, the kill at
dispatch 4, legs of 64 and 16 grad steps), on the card
unless ``--device cpu``, further train CLI flags of both legs (the width,
the replay, the eval) after ``--``; prints one JSON line, exit 1 on a
failed check::

    python -m d4pg_tpu_torch.tools.multihost_smoke --device cpu --dir /tmp/mh \\
        -- --hidden-sizes 16,16 --num-envs 2 --bsize 8 --warmup 64 --rmsize 4096
    python -m d4pg_tpu_torch.tools.multihost_smoke --dir runs/mh   # on the card

Stdlib only (no torch): the trainers are the child processes.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import signal
import subprocess
import sys
import time

from d4pg_tpu_torch.train import LAUNCHES_LINE
from d4pg_tpu_torch.utils import procs, spawnlib

PROCESSES = 2
VICTIM = 1
# run()'s legs: c = 16, the kill at grad step 24, the relaunch 16 more
K = 8
INTERVAL = 16
KILL_AT = 4
LEG1_STEPS = 64
LEG2_STEPS = 16


class SupervisorError(RuntimeError):
    """A check of the supervisor failed."""


def committed_step(kill_at: int, k: int, interval: int) -> int:
    """The last step checkpointed before process 1 dies at its
    ``kill_at``-th dispatch of ``k`` grad steps, saving at every crossing
    of ``interval``. ``ValueError`` unless that save is followed by a whole
    dispatch before the kill (the dispatch's collectives then prove that
    process 0 finished writing it) and the kill lands strictly before the
    next save."""
    saves = [d for d in range(1, kill_at) if (d * k) // interval > ((d - 1) * k) // interval]
    if not saves or saves[-1] > kill_at - 2:
        raise ValueError(
            f"host_kill@{kill_at} with K = {k} and a checkpoint interval of {interval}: "
            "the kill must follow a save by at least one whole dispatch"
        )
    return saves[-1] * k


def _argv(args, *, device: str, run_dir: str, port: int, rank: int, k: int,
          interval: int, total: int, extra) -> list:
    return [
        sys.executable, "-m", "d4pg_tpu_torch.train", "--device", device,
        "--replay-placement", "device", "--p-replay", "--steps-per-dispatch", str(k),
        "--dp", str(PROCESSES), "--num-processes", str(PROCESSES),
        "--coordinator", f"127.0.0.1:{port}", "--process-id", str(rank),
        "--checkpoint-interval", str(interval), "--snapshot-replay", "--debug-guards",
        "--total-steps", str(total), "--log-dir", run_dir, *extra, *args,
    ]


def _spawn_ranks(leg: str, run_dir: str, env, leg_args, **kw) -> list:
    """Both processes of a leg, each in a session of its own, on a fresh
    coordinator port."""
    port = procs.free_port()
    return [spawnlib.spawn_group(_argv(leg_args, run_dir=run_dir, port=port, rank=r, **kw),
                                 f"{leg}.p{r}", env=env)
            for r in range(PROCESSES)]


def _save_log(run_dir: str, name: str, handle) -> None:
    with open(os.path.join(run_dir, f"{name}.log"), "w") as f:
        f.writelines(handle.lines)


def _wait(handle, timeout_s: float) -> int:
    """The exit code of ``handle``'s process within ``timeout_s``, or a
    :class:`SupervisorError` (after the group is killed)."""
    try:
        return handle.proc.wait(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        procs.drain_or_kill(handle.proc, pgid=handle.pgid, sig=signal.SIGKILL,
                            drain_timeout_s=10.0, label=handle.tag)
        raise SupervisorError(f"{handle.tag} did not end within {timeout_s:.0f} s") from None


def _pump_done(handle, timeout_s: float = 10.0) -> None:
    """Let the stdout pump reach EOF, so ``handle.lines`` is complete."""
    deadline = time.monotonic() + timeout_s
    while not handle.port_event.is_set() and time.monotonic() < deadline:
        time.sleep(0.01)


def _leftovers(run_dir: str) -> list:
    """PIDs of live train CLI processes whose cmdline names ``run_dir``."""
    return procs.pids_with_cmdline("-m d4pg_tpu_torch.train", f"--log-dir {run_dir}")


def kill_leg(run_dir: str, *, device: str = "cuda", k: int, interval: int, kill_at: int,
             total: int, extra=(), env=None, timeout_s: float = 600.0) -> dict:
    """Leg 1: both processes under ``host_kill@kill_at:1``; the victim must
    die by SIGKILL, the survivor is reaped with SIGKILL, and the manifests
    must stop at the committed step. Returns the leg's record."""
    c = committed_step(kill_at, k, interval)
    if total <= kill_at * k:
        raise ValueError(f"leg 1 of {total} grad steps ends before dispatch {kill_at}")
    t0 = time.monotonic()
    handles = _spawn_ranks("leg1", run_dir, env, ["--chaos", f"host_kill@{kill_at}:{VICTIM}"],
                           device=device, k=k, interval=interval, total=total, extra=list(extra))
    victim, survivor = handles[VICTIM], handles[1 - VICTIM]
    try:
        victim_rc = _wait(victim, timeout_s)
    finally:
        # the survivor blocks or fails on its next collective: SIGKILL it
        # (a SIGTERM drain would checkpoint through collectives)
        survivor_exited = survivor.proc.poll() is not None
        survivor_rc = procs.drain_or_kill(survivor.proc, pgid=survivor.pgid,
                                          sig=signal.SIGKILL, drain_timeout_s=10.0,
                                          label=survivor.tag)
        for h in handles:
            if h.proc.poll() is None:
                procs.drain_or_kill(h.proc, pgid=h.pgid, sig=signal.SIGKILL,
                                    drain_timeout_s=10.0, label=h.tag)
            _pump_done(h)
            _save_log(run_dir, f"leg1_{h.tag.split('.')[1]}", h)
    wall = time.monotonic() - t0
    killed = [ln for ln in victim.lines if "[chaos] host_kill: SIGKILL process" in ln]
    if not killed:
        raise SupervisorError("leg 1: host_kill never fired: "
                              + "".join(victim.lines[-20:]))
    if victim_rc != -signal.SIGKILL:
        raise SupervisorError(f"leg 1: the victim ended with {victim_rc}, not by SIGKILL")
    from d4pg_tpu_torch.runtime import manifest

    ckpt = os.path.join(run_dir, "checkpoints")
    steps = manifest.manifest_steps(ckpt)
    if c not in manifest.intact_steps(ckpt):
        raise SupervisorError(f"leg 1: no intact checkpoint at step {c} (manifests {steps})")
    if max(steps) != c:
        raise SupervisorError(f"leg 1: manifests {steps} go past the committed step {c}")
    return {"committed_step": c, "kill_at_dispatch": kill_at, "kill_line": killed[0].strip(),
            "victim_rc": victim_rc, "survivor_rc": survivor_rc,
            "survivor_exited_before_reap": survivor_exited, "manifest_steps": steps,
            "wall_s": wall}


def parse_done(lines) -> dict:
    """The dict of the last ``done:`` line."""
    done = [ln for ln in lines if ln.startswith("done:")]
    if not done:
        raise SupervisorError("no done: line")
    return ast.literal_eval(done[-1][len("done:"):].strip())


def parse_launches(lines) -> dict:
    """The dict of the last ``[train] kernel launches:`` line."""
    got = [ln for ln in lines if ln.startswith(LAUNCHES_LINE)]
    if not got:
        raise SupervisorError("no kernel launches line")
    return json.loads(got[-1][len(LAUNCHES_LINE):])


def relaunch_leg(run_dir: str, committed: int, *, device: str = "cuda", k: int, interval: int,
                 total: int, extra=(), env=None, timeout_s: float = 600.0) -> dict:
    """Leg 2: both processes again with ``--resume`` for ``total`` grad
    steps; each must resume from ``committed`` with the replay snapshot and
    the device-PER sidecar and finish with equal model metrics."""
    t0 = time.monotonic()
    handles = _spawn_ranks("leg2", run_dir, env, ["--resume"], device=device, k=k,
                           interval=interval, total=total, extra=list(extra))
    try:
        rcs = [_wait(h, timeout_s) for h in handles]
    finally:
        for r, h in enumerate(handles):
            if h.proc.poll() is None:
                procs.drain_or_kill(h.proc, pgid=h.pgid, sig=signal.SIGKILL,
                                    drain_timeout_s=10.0, label=h.tag)
            _pump_done(h)
            _save_log(run_dir, f"leg2_p{r}", h)
    wall = time.monotonic() - t0
    if rcs != [0] * PROCESSES:
        raise SupervisorError(f"leg 2: exit codes {rcs}: "
                              + " | ".join("".join(h.lines[-15:]) for h in handles))
    want = (f"resumed from step {committed}", "restored replay snapshot",
            "restored device-PER priorities")
    ranks = []
    for r, h in enumerate(handles):
        for w in want:
            if not any(w in ln for ln in h.lines):
                raise SupervisorError(f"leg 2: process {r} did not print {w!r}")
        restored = next(ln for ln in h.lines if "restored replay snapshot" in ln)
        ranks.append({"done": parse_done(h.lines), "launches": parse_launches(h.lines),
                      "replay_rows_restored": int(restored.split(":")[1].split()[0])})
    model = [{key: v for key, v in r["done"].items() if not key.endswith("_per_sec")}
             for r in ranks]
    if any(m != model[0] for m in model[1:]):
        raise SupervisorError(f"leg 2: done lines differ across processes: {model}")
    return {"rcs": rcs, "resumed_from": committed, "ranks": ranks, "model_metrics": model[0],
            "wall_s": wall}


def run(run_dir: str, *, device: str = "cuda", extra=(), env=None,
        timeout_s: float = 600.0) -> dict:
    """Both legs in ``run_dir`` (made if missing) at ``K``, ``INTERVAL``,
    ``KILL_AT``, ``LEG1_STEPS`` and ``LEG2_STEPS``, then the orphan checks.
    ``extra``: further train CLI flags of both legs (the width, the
    replay, the eval)."""
    run_dir = os.path.abspath(run_dir)
    os.makedirs(run_dir, exist_ok=True)
    kw = dict(device=device, k=K, interval=INTERVAL, extra=extra, env=env, timeout_s=timeout_s)
    leg1 = kill_leg(run_dir, kill_at=KILL_AT, total=LEG1_STEPS, **kw)
    leg2 = relaunch_leg(run_dir, leg1["committed_step"], total=LEG2_STEPS, **kw)
    swept = spawnlib.reap_orphans()
    left = _leftovers(run_dir)
    if swept or left:
        raise SupervisorError(f"orphans: swept {swept}, still running {left}")
    return {"leg1": leg1, "leg2": leg2, "orphans_swept": swept}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m d4pg_tpu_torch.tools.multihost_smoke",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--dir", required=True, help="the run dir (log dir of both legs)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("train_args", nargs=argparse.REMAINDER,
                   help="-- then further train CLI flags of both legs (e.g. the width)")
    args = p.parse_args(argv)
    extra = [a for a in args.train_args if a != "--"]
    try:
        out = run(args.dir, device=args.device, extra=extra)
    except SupervisorError as e:
        print(json.dumps({"ok": False, "error": str(e)}), flush=True)
        return 1
    print(json.dumps({"ok": True, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
