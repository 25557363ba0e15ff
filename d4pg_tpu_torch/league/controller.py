"""The league controller: population based training over N variant
learners, crash-consistent (the port's copy of
``d4pg_tpu/league/controller.py``, taking the same decisions and writing
the same journal, so each package's controller resumes the other's).

**Population.** A variant is one learner process with its own run dir
(``<league>/v<uid>``), hyperparameter genome, seed and, in fleet mode,
ingest port; its fleet HELLO declares the variant id, so an actor host
assigned to one variant never streams into another's replay.

**Exploit/explore.** Each generation ranks the members on a fitness read
from their metrics rows (``best_eval.json`` as the fallback), stops the
worst quartile (SIGTERM, the learner checkpoints and exits 75; past a
bounded wait its process group is SIGKILLed, ``utils/procs``), forks the
best one's newest manifest-verified checkpoint steps into a new run dir
(``runtime/manifest.fork_checkpoint``, the digests the trainer's
``restore_verified`` trusts), perturbs the genome and starts the clone
with ``--resume``. The clone then passes a canary-shaped gate: it must
attest (its ``trainer_meta.json`` rewritten under its OWN variant id,
so the fork restored and the clone committed a save of its own), then
show a fitness at least the culled member's, else it is stopped and the
slot re-forked from the parent's unperturbed genome (a rollback).

**Crash consistency.** Every durable decision is written to
``league.json`` (atomically) before anything relies on it, and every
step that applies one is idempotent, so a controller killed at any
instant restarts into the SAME generation. Learners run in sessions of
their own and outlive the controller; a restart re-adopts the live ones
by PID and ``/proc`` cmdline, books the ones that died meanwhile as
crashes and restarts them under a seeded per-variant
``utils/retry.Backoff``, quarantining a variant that crash-loops. A
half-applied generation replays its journaled decisions; it never draws
new ones. Each variant's process tenures balance exactly
(``spawned + adopted == exited_0 + exited_75 + exited_err + killed +
live``, the ``league-tenure`` identity of ``analysis/flow_identities``).

Stdlib only (no torch, no numpy): the controller moves processes and
JSON, never tensors, and restarts in milliseconds.
"""

from __future__ import annotations

import json
import os
import random
import shutil
import signal
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from d4pg_tpu_torch.analysis import flowledger
from d4pg_tpu_torch.runtime import manifest as ckpt_manifest
from d4pg_tpu_torch.utils import procs
from d4pg_tpu_torch.utils.retry import Backoff

JOURNAL_SCHEMA = "league/v1"

# Genome key -> train CLI flag. Unknown keys are refused when a league is
# built, so a misspelt gene cannot become a silent no-op.
GENOME_FLAGS = {
    "lr_actor": "--lr-actor",
    "lr_critic": "--lr-critic",
    "noise_epsilon": "--noise-epsilon",
    "tau": "--tau",
    "batch_size": "--bsize",
    "n_step": "--n-step",
    "max_episode_steps": "--max-steps",
}
# The explore step perturbs the continuous genes only; the integer genes
# (batch_size, n_step, max_episode_steps) change shapes or the MDP itself
# and pass through unchanged.
PERTURB_KEYS = ("lr_actor", "lr_critic", "noise_epsilon", "tau")
PERTURB_FACTORS = (0.8, 1.25)


def perturb_genome(genome: dict, rng: random.Random) -> dict:
    """Multiply each continuous gene by 0.8 or 1.25, independently, drawn
    from ``rng`` (seeded: a league's decisions replay run after run)."""
    out = dict(genome)
    for k in PERTURB_KEYS:
        if k in out:
            out[k] = float(out[k]) * rng.choice(PERTURB_FACTORS)
    return out


def genome_argv(genome: dict) -> List[str]:
    """The train CLI flags of ``genome``, in key order; ``ValueError`` on
    a key outside :data:`GENOME_FLAGS`."""
    argv: List[str] = []
    for k, v in sorted(genome.items()):
        flag = GENOME_FLAGS.get(k)
        if flag is None:
            raise ValueError(
                f"unknown genome key {k!r} (known: {sorted(GENOME_FLAGS)})"
            )
        argv += [flag, repr(v) if not isinstance(v, str) else v]
    return argv


def _atomic_json(path: str, doc: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
    os.replace(tmp, path)


@dataclass
class LeagueConfig:
    league_dir: str
    learner_argv: List[str]          # the base learner command (after `--`)
    genomes: List[dict]              # one per slot: the seed population
    seed: int = 0
    generations: int = 1
    poll_interval_s: float = 0.5
    gen_timeout_s: float = 600.0     # decide on whatever fitness exists after this
    drain_timeout_s: float = 60.0    # SIGTERM -> group SIGKILL bound
    attest_timeout_s: float = 180.0  # a fork must attest within this
    observe_timeout_s: float = 300.0  # ...and show a fitness within this
    fork_depth: int = 2              # intact steps copied per fork
    restart_max_attempts: int = 4    # per-variant Backoff budget
    fitness_source: str = "metrics"  # metrics | best_eval
    # fleet mode: an ingest port per slot, actor hosts per variant
    fleet_base_port: int = 0         # 0 = local collection
    actors_per_variant: int = 0
    actor_argv: List[str] = field(default_factory=list)
    chaos: Optional[str] = None
    summary_out: Optional[str] = None


class LeagueController:
    """See the module docstring. Construct, then :meth:`run`. ``spawnlib``
    (default :mod:`d4pg_tpu_torch.utils.spawnlib`) starts the learner and
    actor processes, each in a session of its own."""

    def __init__(self, config: LeagueConfig, spawnlib=None):
        if len(config.genomes) < 2:
            raise ValueError(
                f"a league needs >= 2 variants, got {len(config.genomes)}"
            )
        for g in config.genomes:
            genome_argv(g)  # validates keys
        self.config = config
        self.dir = os.path.abspath(config.league_dir)
        os.makedirs(self.dir, exist_ok=True)
        if spawnlib is None:
            from d4pg_tpu_torch.utils import spawnlib
        self._spawnlib = spawnlib
        self._rng = random.Random(config.seed)
        self._chaos = None
        if config.chaos:
            from d4pg_tpu_torch.chaos import ChaosInjector, ChaosPlan

            self._chaos = ChaosInjector(ChaosPlan.parse(config.chaos))
        self._stop = False
        # runtime only, never journaled: a restart re-arms them
        self._handles: Dict[int, object] = {}       # uid -> Spawned
        self._actor_handles: Dict[int, list] = {}   # slot -> [Spawned]
        self._backoffs: Dict[int, Backoff] = {}
        self._retry_at: Dict[int, float] = {}
        self._spawned_at: Dict[int, float] = {}
        # actor hosts respawn under a seeded Backoff too: a crash-looping
        # actor never becomes a spawn every tick, and a slot that spends
        # its budget stops getting actors (with an event) for good
        self._actor_backoffs: Dict[int, Backoff] = {}
        self._actor_retry_at: Dict[int, float] = {}
        self._actor_given_up: set = set()
        # (size, mtime) of each run dir's metrics file: an unchanged file
        # is not read again on the next tick
        self._fitness_stat: Dict[int, tuple] = {}
        self._observe_armed_at: Optional[float] = None
        self._gen_opened_at = time.monotonic()
        self._events_path = os.path.join(self.dir, "league_events.jsonl")
        self._orphans_swept = 0
        self._stuck = False
        self.state: dict = {}  # the journaled state
        self._load_or_init()

    # ------------------------------------------------------------- journal
    def _journal_path(self) -> str:
        return os.path.join(self.dir, "league.json")

    def _commit(self) -> None:
        """Persist the whole league state atomically, at every durable
        transition: the write is the decision. What precedes it must be
        re-derivable, what follows it idempotent."""
        _atomic_json(self._journal_path(), self.state)

    def _event(self, event: str, **kw) -> None:
        rec = {"t": round(time.monotonic(), 3), "event": event,
               "gen": self.state.get("generation"), **kw}
        print(f"[league] {json.dumps(rec)}", flush=True)
        with open(self._events_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def _load_or_init(self) -> None:
        path = self._journal_path()
        if os.path.exists(path):
            try:
                with open(path) as f:
                    doc = json.load(f)
            except (OSError, ValueError) as e:
                raise RuntimeError(
                    f"league journal {path} is unreadable ({e}); a torn "
                    "journal means the atomic-write contract broke — "
                    "refusing to guess league state"
                ) from e
            if doc.get("schema") != JOURNAL_SCHEMA:
                raise RuntimeError(
                    f"league journal schema {doc.get('schema')!r} != "
                    f"{JOURNAL_SCHEMA!r}"
                )
            if doc.get("seed") != self.config.seed or (
                doc.get("slots") != len(self.config.genomes)
            ):
                raise RuntimeError(
                    "league journal disagrees with the CLI (seed "
                    f"{doc.get('seed')} vs {self.config.seed}, slots "
                    f"{doc.get('slots')} vs {len(self.config.genomes)}) — "
                    "resume with the original arguments or use a fresh dir"
                )
            self.state = doc
            self._event("journal_resumed",
                        pending=bool(self.state.get("pending")))
            return
        variants: Dict[str, dict] = {}
        members: Dict[str, int] = {}
        for slot, genome in enumerate(self.config.genomes):
            uid = slot + 1
            members[str(slot)] = uid
            variants[str(uid)] = self._new_variant(
                uid, slot, dict(genome), parent=None, born_gen=0
            )
        self.state = {
            "schema": JOURNAL_SCHEMA,
            "seed": self.config.seed,
            "slots": len(self.config.genomes),
            "generation": 0,
            "next_uid": len(self.config.genomes) + 1,
            "members": members,
            "variants": variants,
            "lineage": [],
            "promotions": 0,
            "rollbacks": 0,
            "gen_baseline": {},
            "pending": None,
        }
        self._commit()
        self._event("league_created", slots=len(self.config.genomes))

    def _new_variant(self, uid: int, slot: int, genome: dict,
                     parent: Optional[int], born_gen: int) -> dict:
        return {
            "uid": uid,
            "slot": slot,
            "genome": genome,
            "parent": parent,
            "born_gen": born_gen,
            "seed": self.config.seed * 1000 + uid,
            "status": "new",   # new|live|dead|retired|quarantined|finished
            "pid": 0,
            "pgid": 0,
            "spawned": 0,
            "adopted": 0,
            "exited_0": 0,
            "exited_75": 0,
            "exited_err": 0,
            "killed": 0,
            "restarts": 0,
            "live": 0,
            "fitness": None,
            "fitness_step": -1,
        }

    # -------------------------------------------------------------- layout
    def run_dir(self, uid: int) -> str:
        return os.path.join(self.dir, f"v{uid:04d}")

    def _variant(self, uid: int) -> dict:
        return self.state["variants"][str(uid)]

    def _members(self) -> Dict[int, int]:
        return {int(s): u for s, u in self.state["members"].items()}

    def _fleet_port(self, slot: int) -> int:
        return self.config.fleet_base_port + slot

    def _learner_argv(self, v: dict) -> List[str]:
        argv = list(self.config.learner_argv)
        argv += genome_argv(v["genome"])
        argv += [
            "--log-dir", self.run_dir(v["uid"]),
            "--seed", str(v["seed"]),
            "--variant-id", str(v["uid"]),
            "--league-generation", str(v["born_gen"]),
            # always: a fresh run dir ignores it, a forked or restarted
            # one needs it (the other half of the exit-75 contract)
            "--resume",
        ]
        if self.config.fleet_base_port:
            argv += [
                "--fleet-listen", str(self._fleet_port(v["slot"])),
                "--fleet-host", "127.0.0.1",
                "--fleet-bundle", os.path.join(self.run_dir(v["uid"]),
                                               "bundle"),
                "--num-envs", "0",
            ]
        return argv

    # --------------------------------------------------------- supervision
    def _spawn(self, uid: int, *, restart: bool = False) -> None:
        v = self._variant(uid)
        handle = self._spawnlib.spawn_group(
            self._learner_argv(v), f"v{uid:04d}"
        )
        self._handles[uid] = handle
        self._spawned_at[uid] = time.monotonic()
        v["pid"], v["pgid"] = handle.proc.pid, handle.pgid
        v["spawned"] += 1
        v["live"] = 1
        v["status"] = "live"
        if restart:
            v["restarts"] += 1
        # the counter, the pid and the liveness in ONE write: the tenure
        # identity can only be short by a live process the journal missed,
        # which the adoption scan of the next start finds
        self._commit()
        self._event("learner_spawned", uid=uid, pid=v["pid"],
                    restart=restart)

    def _find_running(self, uid: int) -> Optional[int]:
        """A live learner of this variant's run dir, by a ``/proc`` cmdline
        scan: adopts a spawn whose journal write was lost. The cmdline must
        name the run dir, so a reused PID is never adopted."""
        marker = self.run_dir(uid)
        for name in os.listdir("/proc"):
            if not name.isdigit():
                continue
            pid = int(name)
            cmd = procs.pid_cmdline(pid)
            if marker in cmd and "--log-dir" in cmd:
                return pid
        return None

    def _reconcile(self) -> None:
        """At a (re)start: re-adopt the live learners, book the ones that
        died unwatched, and find spawns the journal missed."""
        for uid in sorted(self._members().values()):
            v = self._variant(uid)
            if v["status"] not in ("live", "new"):
                continue
            alive = (
                v["pid"]
                and procs.pid_alive(v["pid"])
                and self.run_dir(uid) in procs.pid_cmdline(v["pid"])
            )
            if v["live"] and alive:
                self._event("learner_adopted", uid=uid, pid=v["pid"])
                # the same tenure goes on (no counter moves); without the
                # Popen handle, supervision reads /proc
                self._spawned_at[uid] = time.monotonic()
                continue
            if v["live"] and not alive:
                # died while no controller watched: its exit code is lost
                # with it (re-parented to init), so it books as a crash
                v["live"] = 0
                v["exited_err"] += 1
                v["status"] = "dead"
                self._commit()
                self._event("learner_died_unsupervised", uid=uid)
                continue
            pid = self._find_running(uid)
            if pid is not None:
                # the spawn happened but its journal write did not: adopt
                v["pid"], v["live"] = pid, 1
                try:
                    v["pgid"] = os.getpgid(pid)
                except (ProcessLookupError, OSError):
                    v["pgid"] = 0
                v["adopted"] += 1
                v["status"] = "live"
                self._commit()
                self._spawned_at[uid] = time.monotonic()
                self._event("learner_adopted_unjournaled", uid=uid, pid=pid)

    def _poll_rc(self, uid: int) -> Optional[int]:
        """None while the learner runs; once it is gone, its exit code, or
        -1 for an adopted process whose code cannot be known."""
        handle = self._handles.get(uid)
        v = self._variant(uid)
        if handle is not None:
            return handle.proc.poll()
        if procs.pid_alive(v["pid"]) and (
            self.run_dir(uid) in procs.pid_cmdline(v["pid"])
        ):
            return None
        return -1

    def _classify_exit(self, uid: int, rc: Optional[int]) -> None:
        v = self._variant(uid)
        v["live"] = 0
        v["pid"] = 0
        if rc == 0:
            v["exited_0"] += 1
            v["status"] = "finished"
        elif rc == 75:
            v["exited_75"] += 1
            v["status"] = "dead"
        else:
            v["exited_err"] += 1
            v["status"] = "dead"
        self._commit()
        self._event("learner_exited", uid=uid, rc=rc, status=v["status"])

    def _supervise(self) -> None:
        """Restart dead members under their seeded Backoff; quarantine a
        member whose budget is spent."""
        for _slot, uid in sorted(self._members().items()):
            v = self._variant(uid)
            if v["status"] == "live":
                rc = self._poll_rc(uid)
                if rc is None:
                    # up for a while: the next failure starts the
                    # schedule over (only consecutive failures count)
                    if (
                        uid in self._backoffs
                        and time.monotonic() - self._spawned_at.get(uid, 0)
                        > 30.0
                    ):
                        self._backoffs.pop(uid, None)
                        self._retry_at.pop(uid, None)
                    continue
                self._classify_exit(uid, rc)
            if v["status"] == "new":
                self._spawn(uid)
                continue
            if v["status"] != "dead":
                continue
            if uid not in self._retry_at:
                bo = self._backoffs.setdefault(uid, Backoff(
                    base_s=0.5, max_s=10.0,
                    max_attempts=self.config.restart_max_attempts,
                    rng=random.Random(v["seed"] + 7919),
                ))
                delay = bo.next_delay()
                if delay is None:
                    v["status"] = "quarantined"
                    self._commit()
                    self._event("variant_quarantined", uid=uid,
                                restarts=v["restarts"])
                    continue
                self._retry_at[uid] = time.monotonic() + delay
                continue
            if time.monotonic() >= self._retry_at[uid]:
                del self._retry_at[uid]
                self._spawn(uid, restart=True)

    def _stop_learner(self, uid: int, *, reason: str) -> None:
        """SIGTERM (the learner checkpoints and exits 75), a bounded wait,
        SIGKILL of the whole process group, an orphan sweep. ``killed``
        ticks in the same journal write that clears the liveness, so the
        stop is booked exactly once."""
        v = self._variant(uid)
        if not v["live"]:
            return
        handle = self._handles.pop(uid, None)
        if handle is not None:
            rc = handle.stop(
                drain_timeout_s=self.config.drain_timeout_s,
            )
        else:
            rc = self._kill_adopted(v)
        v["live"] = 0
        v["pid"] = 0
        v["killed"] += 1
        v["status"] = "retired"
        self._commit()
        self._event("learner_killed", uid=uid, rc=rc, reason=reason)

    def _kill_adopted(self, v: dict) -> Optional[int]:
        """The stop of a re-adopted learner, which cannot be waited on:
        SIGTERM, poll ``/proc`` within the bound, then the group kill."""
        pid, pgid = v["pid"], v["pgid"]
        try:
            os.kill(pid, signal.SIGTERM)
        except (ProcessLookupError, OSError):
            pass
        if not procs.wait_pid_gone(pid, self.config.drain_timeout_s):
            procs.kill_group(pgid or pid, signal.SIGKILL)
            procs.wait_pid_gone(pid, 10.0)
        if pgid:
            self._orphans_swept += len(
                procs.reap_orphans([pgid], label=f"v{v['uid']:04d}")
            )
        return None

    # -------------------------------------------------------------- actors
    def _sync_actors(self) -> None:
        """Fleet mode: keep ``actors_per_variant`` actor hosts on each
        slot, pinned (``--variant``) to its CURRENT member. When a member
        is replaced, its hosts drain and new ones start against the new
        run dir's bundle once the new learner has published it."""
        if not self.config.fleet_base_port or not self.config.actors_per_variant:
            return
        for slot, uid in sorted(self._members().items()):
            v = self._variant(uid)
            handles = self._actor_handles.get(slot, [])
            died = False
            stale = [
                h for h in handles
                if getattr(h, "league_uid", None) != uid
                or h.proc.poll() is not None
            ]
            for h in stale:
                handles.remove(h)
                if getattr(h, "league_uid", None) != uid:
                    h.stop(drain_timeout_s=20.0)
                    self._event("actor_drained", slot=slot,
                                uid=getattr(h, "league_uid", None))
                else:
                    died = True
            if died:
                # a crash, not a replacement: pace the respawn under the
                # slot's seeded Backoff
                bo = self._actor_backoffs.setdefault(slot, Backoff(
                    base_s=0.5, max_s=15.0, max_attempts=8,
                    rng=random.Random(self.config.seed + 500 + slot),
                ))
                delay = bo.next_delay()
                if delay is None:
                    if slot not in self._actor_given_up:
                        self._actor_given_up.add(slot)
                        self._event("actor_slot_given_up", slot=slot)
                else:
                    self._actor_retry_at[slot] = time.monotonic() + delay
            elif handles and (
                time.monotonic()
                - max(getattr(h, "spawned_at", 0.0) for h in handles)
                > 30.0
            ):
                # stable actors: the next crash starts the schedule over
                self._actor_backoffs.pop(slot, None)
            if v["status"] != "live":
                continue
            if slot in self._actor_given_up or (
                time.monotonic() < self._actor_retry_at.get(slot, 0.0)
            ):
                self._actor_handles[slot] = handles
                continue
            bundle = os.path.join(self.run_dir(uid), "bundle", "bundle.json")
            if not os.path.exists(bundle):
                continue  # not published yet
            while len(handles) < self.config.actors_per_variant:
                n = len(handles)
                h = self._spawnlib.spawn_group(
                    [
                        sys.executable, "-m", "d4pg_tpu_torch.fleet.actor",
                        "--connect",
                        f"127.0.0.1:{self._fleet_port(slot)}",
                        "--bundle", os.path.dirname(bundle),
                        "--variant", str(uid),
                        "--seed", str(v["seed"] + 100 + n),
                        "--reconnect-attempts", "400",
                    ] + list(self.config.actor_argv),
                    f"actor{slot}.{n}",
                )
                h.league_uid = uid
                h.spawned_at = time.monotonic()
                handles.append(h)
                self._event("actor_spawned", slot=slot, uid=uid, n=n)
            self._actor_handles[slot] = handles

    def _stop_actors(self, slot: Optional[int] = None) -> None:
        slots = [slot] if slot is not None else list(self._actor_handles)
        for s in slots:
            for h in self._actor_handles.get(s, []):
                h.stop(drain_timeout_s=20.0)
            self._actor_handles[s] = []

    # ------------------------------------------------------------- fitness
    def _read_fitness(self, uid: int) -> None:
        v = self._variant(uid)
        run = self.run_dir(uid)
        # in metrics mode an unchanged metrics file is not read again
        sig = None
        if self.config.fitness_source == "metrics":
            try:
                st = os.stat(os.path.join(run, "metrics.jsonl"))
                sig = (st.st_size, st.st_mtime_ns)
            except OSError:
                sig = None
            if sig is not None and self._fitness_stat.get(uid) == sig:
                return
        fit = None
        if self.config.fitness_source == "metrics":
            fit = self._fitness_from_metrics(run)
            if fit is not None and sig is not None:
                self._fitness_stat[uid] = sig
        if fit is None:
            fit = self._fitness_from_best_eval(run)
        if fit is None:
            return
        score, step = fit
        if step != v["fitness_step"] or score != v["fitness"]:
            v["fitness"], v["fitness_step"] = score, step
            # advisory: journaled so a restarted controller ranks on the
            # same numbers; a lost update only delays a generation
            self._commit()

    @staticmethod
    def _fitness_from_metrics(run: str):
        """The newest eval row of ``metrics.jsonl`` (read from its last
        256 KiB; rows are only appended): the EWMA return when the row has
        it, else the eval mean."""
        path = os.path.join(run, "metrics.jsonl")
        try:
            with open(path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - (256 << 10)))
                tail = f.read().decode(errors="replace").splitlines()
        except OSError:
            return None
        for line in reversed(tail):
            try:
                row = json.loads(line)
            except ValueError:
                continue  # the tail's cut first line, or a partial last one
            for key in ("avg_test_reward_ewma", "eval_return_mean"):
                if key in row:
                    return float(row[key]), int(row.get("step", 0))
        return None

    @staticmethod
    def _fitness_from_best_eval(run: str):
        try:
            with open(os.path.join(run, "best_eval.json")) as f:
                doc = json.load(f)
            return float(doc["eval_return_mean"]), int(doc.get("step", 0))
        except (OSError, ValueError, KeyError, TypeError):
            return None

    def _rankable(self) -> List[int]:
        """Members with a fitness that are live or finished. A quarantined
        member is not ranked: it lost already."""
        out = []
        for _slot, uid in sorted(self._members().items()):
            v = self._variant(uid)
            if v["status"] in ("live", "finished") and v["fitness"] is not None:
                out.append(uid)
        return out

    def _generation_ready(self) -> bool:
        baseline = self.state.get("gen_baseline", {})
        members = self._members()
        fresh = 0
        for uid in members.values():
            v = self._variant(uid)
            if v["status"] == "quarantined":
                continue
            if v["fitness"] is None:
                return False
            if v["fitness_step"] > baseline.get(str(uid), -1):
                fresh += 1
            else:
                return False
        if fresh >= 2:
            return True
        return False

    # ------------------------------------------------ exploit and explore
    def _open_generation(self) -> None:
        """Journal each member's fitness step as the watermark it must pass
        before the next decision, so a restarted controller waits on the
        same ones."""
        self.state["gen_baseline"] = {
            str(uid): self._variant(uid)["fitness_step"]
            for uid in self._members().values()
        }
        self._commit()
        self._gen_opened_at = time.monotonic()

    def _plan_generation(self) -> None:
        """The decision, journaled before it has any effect: the worst
        quartile is culled and each victim's slot gets a perturbed clone
        of a top member, drawn from the seeded stream."""
        ranked = sorted(
            self._rankable(), key=lambda u: self._variant(u)["fitness"]
        )
        if len(ranked) < 2:
            self._event("generation_skipped", why="fewer than 2 rankable")
            self._open_generation()
            return
        kills = max(1, len(ranked) // 4)
        actions = []
        for i in range(kills):
            victim = ranked[i]
            src = ranked[-1 - (i % max(1, len(ranked) - kills))]
            child_uid = self.state["next_uid"]
            self.state["next_uid"] += 1
            actions.append({
                "phase": "planned",
                "kill_uid": victim,
                "src_uid": src,
                "child_uid": child_uid,
                "genome": perturb_genome(
                    self._variant(src)["genome"], self._rng
                ),
                "reason": "clone",
                "bar_fitness": self._variant(victim)["fitness"],
                "fork_steps": [],
            })
        self.state["pending"] = {
            "gen": self.state["generation"],
            "actions": actions,
        }
        self._commit()
        self._event(
            "generation_planned",
            actions=[
                {k: a[k] for k in ("kill_uid", "src_uid", "child_uid")}
                for a in actions
            ],
        )

    def _advance_pending(self) -> None:
        pending = self.state.get("pending")
        if not pending:
            return
        for action in pending["actions"]:
            if action["phase"] != "done":
                self._advance_action(pending, action)
                if action["phase"] != "done":
                    return  # one action in flight at a time
        # every action resolved: the generation commits exactly once
        self.state["pending"] = None
        self.state["generation"] = pending["gen"] + 1
        self._commit()
        self._event("generation_done", next_gen=self.state["generation"])
        self._open_generation()

    def _advance_action(self, pending: dict, action: dict) -> None:
        phase = action["phase"]
        if phase == "planned":
            # idempotent on replay: stopping a stopped learner books
            # nothing (killed ticks inside _stop_learner's one write,
            # which this phase write follows)
            self._stop_learner(action["kill_uid"], reason="pbt_cull")
            self._stop_actors(self._variant(action["kill_uid"])["slot"])
            action["phase"] = "culled"
            self._commit()
            return
        if phase == "culled":
            self._apply_fork(action)
            return
        if phase == "forked":
            child = action["child_uid"]
            if self._variant(child)["status"] == "new":
                self._spawn(child)
            self._observe_armed_at = time.monotonic()
            action["phase"] = "observing"
            self._commit()
            self._event("observe_started", uid=child)
            return
        if phase == "observing":
            self._observe(pending, action)

    def _apply_fork(self, action: dict) -> None:
        """The checkpoint fork: verify and copy the source's newest intact
        steps, then write ``variant.json`` LAST as the fork's commit
        record (a replayed fork that finds it skips the copy)."""
        src_uid, child_uid = action["src_uid"], action["child_uid"]
        victim = self._variant(action["kill_uid"])
        dst = self.run_dir(child_uid)
        marker = os.path.join(dst, "variant.json")
        if not os.path.exists(marker):
            if os.path.exists(dst):
                # a fork half copied before a crash: rebuild it whole
                shutil.rmtree(dst)
            os.makedirs(dst, exist_ok=True)
            steps = ckpt_manifest.fork_checkpoint(
                os.path.join(self.run_dir(src_uid), "checkpoints"),
                os.path.join(dst, "checkpoints"),
                depth=self.config.fork_depth,
            )
            action["fork_steps"] = steps
            if self._chaos is not None:
                e = self._chaos.tick("clone_corrupt")
                if e is not None and steps:
                    # a torn fork: the newest copied step truncated after
                    # its manifest landed, so the clone's verify-on-restore
                    # must fall back to the older copy
                    from d4pg_tpu_torch.chaos import truncate_checkpoint_step

                    sd = ckpt_manifest.default_step_dir(
                        os.path.join(dst, "checkpoints"), steps[-1]
                    )
                    if sd is not None:
                        truncate_checkpoint_step(sd)
            _atomic_json(marker, {
                "uid": child_uid,
                "slot": victim["slot"],
                "genome": action["genome"],
                "parent": src_uid,
                "born_gen": self.state["generation"],
                "seed": self.config.seed * 1000 + child_uid,
                "fork_steps": steps,
                "reason": action["reason"],
            })
        # the child, its lineage edge and the slot handover commit with
        # the phase flip; a crash between variant.json and this write
        # re-enters here, never adding a second edge
        if str(child_uid) not in self.state["variants"]:
            self.state["variants"][str(child_uid)] = self._new_variant(
                child_uid, victim["slot"], action["genome"],
                parent=src_uid, born_gen=self.state["generation"],
            )
        if not any(
            e["child"] == child_uid for e in self.state["lineage"]
        ):
            self.state["lineage"].append({
                "child": child_uid,
                "parent": src_uid,
                "gen": self.state["generation"],
                "reason": action["reason"],
            })
        self.state["members"][str(victim["slot"])] = child_uid
        action["phase"] = "forked"
        self._commit()
        self._event("checkpoint_forked", src=src_uid, child=child_uid,
                    steps=action["fork_steps"])

    def _attested(self, uid: int) -> bool:
        """Whether ``trainer_meta.json`` carries the clone's OWN variant id:
        the fork restored and the clone committed a checkpoint of its own."""
        try:
            with open(os.path.join(
                self.run_dir(uid), "checkpoints", "trainer_meta.json"
            )) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            return False
        return int(meta.get("variant_id", -1)) == uid

    def _observe(self, pending: dict, action: dict) -> None:
        child_uid = action["child_uid"]
        v = self._variant(child_uid)
        if self._observe_armed_at is None:
            self._observe_armed_at = time.monotonic()
        waited = time.monotonic() - self._observe_armed_at
        if v["status"] == "quarantined":
            if action["reason"] == "rollback_refork":
                # the parent's own recipe crash-looping is a sick slot,
                # not a bad genome: give the slot up, never re-fork forever
                return self._give_up_slot(action, "refork_crash_looping")
            return self._rollback(pending, action, "clone_crash_looping")
        attested = self._attested(child_uid)
        if not attested:
            if waited > self.config.attest_timeout_s:
                if action["reason"] == "rollback_refork":
                    # likewise a re-fork that cannot attest: bounded
                    return self._give_up_slot(action, "refork_attest_timeout")
                return self._rollback(pending, action, "attest_timeout")
            return
        if action["reason"] == "rollback_refork":
            # the parent's own recipe is the rollback target itself: it
            # needs no observation window
            return self._promote(action, why="rollback_refork_attested")
        self._read_fitness(child_uid)
        if v["fitness"] is not None and v["fitness_step"] >= 0:
            bar = action.get("bar_fitness")
            if bar is None or v["fitness"] >= bar:
                return self._promote(action, why="fitness_beats_bar")
            return self._rollback(pending, action, "fitness_below_bar")
        if waited > self.config.observe_timeout_s:
            return self._rollback(pending, action, "observe_timeout")

    def _give_up_slot(self, action: dict, why: str) -> None:
        """A rollback re-fork failed for good: stop it, quarantine the
        slot's member and resolve the action as a second rollback, so the
        generation can still commit."""
        uid = action["child_uid"]
        self._stop_learner(uid, reason=f"give_up:{why}")
        self._variant(uid)["status"] = "quarantined"
        self.state["rollbacks"] += 1
        action["phase"] = "done"
        self._commit()
        self._observe_armed_at = None
        self._event("slot_given_up", uid=uid, why=why)

    def _promote(self, action: dict, *, why: str) -> None:
        self.state["promotions"] += 1
        action["phase"] = "done"
        self._commit()
        self._observe_armed_at = None
        self._event("clone_promoted", uid=action["child_uid"], why=why)

    def _rollback(self, pending: dict, action: dict, why: str) -> None:
        """Stop the failed clone and re-fork the source's UNPERTURBED genome
        into the slot (counted; the re-fork promotes once it attests). The
        counter and the replacement action commit in one write."""
        failed = action["child_uid"]
        self._stop_learner(failed, reason=f"rollback:{why}")
        child_uid = self.state["next_uid"]
        self.state["next_uid"] += 1
        self.state["rollbacks"] += 1
        replacement = {
            "phase": "culled",   # the victim is gone already
            "kill_uid": failed,
            "src_uid": action["src_uid"],
            "child_uid": child_uid,
            "genome": dict(self._variant(action["src_uid"])["genome"]),
            "reason": "rollback_refork",
            "bar_fitness": None,
            "fork_steps": [],
        }
        pending["actions"][pending["actions"].index(action)] = replacement
        self._commit()
        self._observe_armed_at = None
        self._event("clone_rolled_back", uid=failed, why=why,
                    refork_as=child_uid)

    # ----------------------------------------------------------- main loop
    def request_stop(self) -> None:
        """Signal-safe: only sets the flag the loop reads."""
        self._stop = True

    def tick(self) -> None:
        if self._chaos is not None:
            e = self._chaos.tick("controller_kill")
            if e is not None:
                # the crash the journal is for: no cleanup, no flush; the
                # rerun must resume the SAME generation and re-adopt
                print("[chaos] controller_kill: SIGKILL self", flush=True)
                os.kill(os.getpid(), signal.SIGKILL)
            e = self._chaos.tick("variant_kill")
            if e is not None:
                live = [u for u in sorted(self._members().values())
                        if self._variant(u)["live"]]
                if live:
                    victim = live[(self.config.seed + e.at) % len(live)]
                    vv = self._variant(victim)
                    print(f"[chaos] variant_kill: SIGKILL v{victim:04d} "
                          f"(pid {vv['pid']})", flush=True)
                    procs.kill_group(vv["pgid"] or vv["pid"], signal.SIGKILL)
        self._supervise()
        self._sync_actors()
        statuses = [
            self._variant(uid)["status"] for uid in self._members().values()
        ]
        if (
            sum(1 for s in statuses if s != "quarantined") < 2
            and not self.state.get("pending")
        ):
            # fewer than two members can rank again and nothing is in
            # flight: the league cannot progress, so it stops loudly
            # (all quarantined, or one survivor) instead of spinning
            self._event("league_stuck", statuses=statuses)
            self._stuck = True
            self._stop = True
            return
        for uid in self._members().values():
            if self._variant(uid)["live"]:
                self._read_fitness(uid)
        self._advance_pending()
        if (
            self.state.get("pending") is None
            and self.state["generation"] < self.config.generations
        ):
            timed_out = (
                time.monotonic() - self._gen_opened_at
                > self.config.gen_timeout_s
            )
            if self._generation_ready() or (
                timed_out and len(self._rankable()) >= 2
            ):
                self._plan_generation()

    def run(self) -> int:
        """Reconcile, tick until the target generation (or a stop), shut
        down and write the summary; 0 when the tenure identity holds, no
        orphan was swept and the league did not get stuck."""
        self._reconcile()
        self._event("league_started", generation=self.state["generation"],
                    target=self.config.generations)
        while (
            not self._stop
            and self.state["generation"] < self.config.generations
        ):
            self.tick()
            if self.state["generation"] >= self.config.generations:
                break
            time.sleep(self.config.poll_interval_s)
        self.shutdown()
        summary = self.write_summary()
        ok = bool(summary["identity_ok"]) and summary["orphans_swept"] == 0
        self._event("league_finished",
                    generations=self.state["generation"],
                    promotions=self.state["promotions"],
                    rollbacks=self.state["rollbacks"],
                    identity_ok=ok)
        return 0 if ok and not self._stuck else 1

    def shutdown(self) -> None:
        """Stop every actor host and learner (gracefully first), then sweep
        every process group the journal names: zero orphaned learners is
        checked, not hoped for."""
        self._stop_actors()
        for uid in sorted(self._members().values()):
            self._stop_learner(uid, reason="shutdown")
        # only groups whose survivors still name this league: a pgid
        # journaled long ago may belong to an unrelated group by now (the
        # PID-reuse guard of _reconcile, on the kill side)
        pgids = [
            pg for pg in (
                v.get("pgid", 0) for v in self.state["variants"].values()
            )
            if pg and any(
                self.dir in procs.pid_cmdline(p)
                for p in procs.group_pids(pg)
            )
        ]
        self._orphans_swept += len(
            procs.reap_orphans(pgids, label="league")
        )
        self._orphans_swept += len(self._spawnlib.reap_orphans())

    # ------------------------------------------------------------- summary
    def write_summary(self) -> dict:
        """``league_summary.json`` (schema ``league-soak/v1``, the JAX
        controller's): per-variant counters, lineage, promotions and
        rollbacks, ``identity_ok`` and ``orphans_swept``. Under
        ``--debug-guards`` the tenure identity is also checked row by row
        through the flow ledger, which raises on an imbalance."""
        variants = {}
        for uid_s, v in self.state["variants"].items():
            variants[uid_s] = {
                k: v[k] for k in (
                    "slot", "parent", "born_gen", "genome", "fitness",
                    "fitness_step", "spawned", "adopted", "exited_0",
                    "exited_75", "exited_err", "killed", "live",
                    "restarts", "status",
                )
            }
            variants[uid_s]["quarantined"] = v["status"] == "quarantined"
        identity_ok = all(
            v["spawned"] + v["adopted"]
            == v["exited_0"] + v["exited_75"] + v["exited_err"]
            + v["killed"] + v["live"]
            for v in variants.values()
        )
        flowledger.check_rows("league-tenure", variants,
                              where="league summary")
        summary = {
            "backend": "cpu",  # where the controller runs; learners own devices
            "schema": "league-soak/v1",
            "seed": self.config.seed,
            "slots": self.state["slots"],
            "generations_completed": self.state["generation"],
            "promotions": self.state["promotions"],
            "rollbacks": self.state["rollbacks"],
            "quarantined": sum(
                1 for v in variants.values() if v["quarantined"]
            ),
            "chaos_injections": (
                self._chaos.injections_total if self._chaos else 0
            ),
            "orphans_swept": self._orphans_swept,
            "identity_ok": identity_ok,
            "members": self.state["members"],
            "variants": variants,
            "lineage": self.state["lineage"],
        }
        out = os.path.join(self.dir, "league_summary.json")
        _atomic_json(out, summary)
        if self.config.summary_out:
            _atomic_json(self.config.summary_out, summary)
        return summary
