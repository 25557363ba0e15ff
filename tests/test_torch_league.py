"""The port's league controller (``d4pg_tpu_torch/league``) against the JAX
package's (``d4pg_tpu/league``), on the CPU.

Learners are each package's deterministic stub (``scripts/
league_stub_learner.py``, ``d4pg_tpu_torch/tools/league_stub_learner.py``):
the train CLI's league surface (manifest-attested checkpoints, the exit-75
drain, the trainer_meta attestation, a fitness set by the genome) in
milliseconds. Held against the JAX package:

- the genome: the same seed gives the same ``perturb_genome`` draws, the
  same ``genome_argv`` and the same refusal of an unknown gene;
- the fork: ``runtime/manifest.fork_checkpoint`` copies the same steps
  and files as the JAX one (newest intact, a torn source step skipped,
  the source's checkpoint GC winning a race, a torn fork falling back);
- the controller: the same seed, genomes and stubs give the same
  sequence of decisions in ``league_events.jsonl`` (culls, forks, the
  clone genomes, promotions, rollbacks, quarantines, generations),
  ignoring pids, times and the fork's step numbers (they follow the
  stubs' clocks), and the same final lineage and counters; the cases are
  the JAX tests' (``tests/test_league.py``): the planted winner promoted,
  a rollback on a fitness below the bar, a crash-looping variant
  quarantined, an all-quarantined and a lone-survivor league stopping
  with rc 1;
- the journal: each package's controller, killed mid-generation,
  is resumed by the other's to the end of the same generation;
- the learner: a port learner with ``--variant-id`` writes the JAX
  ``static`` metrics columns and ``trainer_meta`` keys, and its fleet
  HELLO declares the variant as the JAX learner's does; each package's
  actor HELLO is refused by the other's ingest with ``variant_mismatch``.
"""

import json
import os
import random
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from d4pg_tpu.fleet import actor as jactor
from d4pg_tpu.fleet import ingest as jingest
from d4pg_tpu.league import controller as jctl
from d4pg_tpu.replay import source as jsource
from d4pg_tpu.runtime import manifest as jmanifest
from d4pg_tpu_torch.fleet import actor as pactor
from d4pg_tpu_torch.fleet import ingest as pingest
from d4pg_tpu_torch.league import controller as pctl
from d4pg_tpu_torch.replay import source as psource
from d4pg_tpu_torch.runtime import manifest as pmanifest
from d4pg_tpu_torch.utils import procs
from tools.d4pglint.schema_check import check_league_soak, check_metrics_jsonl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUBS = {
    "jax": [sys.executable, os.path.join(REPO, "scripts", "league_stub_learner.py")],
    "port": [sys.executable, "-m", "d4pg_tpu_torch.tools.league_stub_learner"],
}
CTL = {"jax": jctl, "port": pctl}
CLI = {"jax": "d4pg_tpu.league", "port": "d4pg_tpu_torch.league"}
STUB_ARGS = ["--checkpoint-interval", "4", "--eval-interval", "2", "--tick-seconds", "0.03"]

GOOD = {"lr_actor": 1e-4, "max_episode_steps": 50}
MID = {"lr_actor": 1e-4, "max_episode_steps": 200}
BAD = {"lr_actor": 1e-3, "max_episode_steps": 250}
DIVERGED = {"lr_actor": 1.0, "max_episode_steps": 50}


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return env


def _config(pkg, league_dir, genomes, **kw):
    base = dict(
        league_dir=str(league_dir), learner_argv=STUBS[pkg] + STUB_ARGS, genomes=genomes,
        seed=7, generations=1, poll_interval_s=0.1, gen_timeout_s=60.0, drain_timeout_s=20.0,
        attest_timeout_s=20.0, observe_timeout_s=20.0,
    )
    base.update(kw)
    return CTL[pkg].LeagueConfig(**base)


def _league_pids(league_dir):
    """Live stub learners of this league (the zero-orphans scan)."""
    return procs.pids_with_cmdline(str(league_dir), "league_stub")


# ------------------------------------------------------------------ imports
def test_league_modules_load_no_torch_and_no_jax():
    """The controller moves processes and JSON: it, its CLI and the stub
    load neither torch nor numpy nor anything of the JAX package."""
    code = (
        "import sys\n"
        "import d4pg_tpu_torch.league, d4pg_tpu_torch.league.controller\n"
        "import d4pg_tpu_torch.league.__main__, d4pg_tpu_torch.tools.league_stub_learner\n"
        "import d4pg_tpu_torch.tools.multihost_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'numpy', 'jax', 'd4pg_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# ------------------------------------------------------------------- genome
@pytest.mark.parametrize("seed", [0, 3, 7, 1234])
def test_perturb_genome_and_argv_are_the_jax_ones(seed):
    genome = {"lr_actor": 1e-4, "lr_critic": 3e-4, "noise_epsilon": 0.3, "tau": 0.001,
              "batch_size": 16, "n_step": 3, "max_episode_steps": 200}
    ours, ref = random.Random(seed), random.Random(seed)
    for _ in range(8):  # a league's stream of draws
        a, b = pctl.perturb_genome(genome, ours), jctl.perturb_genome(genome, ref)
        assert a == b and a["max_episode_steps"] == 200 and a["batch_size"] == 16
        assert pctl.genome_argv(a) == jctl.genome_argv(b)
    assert pctl.GENOME_FLAGS == jctl.GENOME_FLAGS and pctl.PERTURB_KEYS == jctl.PERTURB_KEYS
    assert pctl.JOURNAL_SCHEMA == jctl.JOURNAL_SCHEMA


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_genome_argv_refuses_unknown_keys(pkg):
    with pytest.raises(ValueError, match="unknown genome key 'learning_rate'"):
        CTL[pkg].genome_argv({"learning_rate": 1e-4})
    with pytest.raises(ValueError, match="a league needs >= 2 variants"):
        CTL[pkg].LeagueController(_config(pkg, "/nonexistent", [GOOD]))


# --------------------------------------------------------------------- fork
def _fake_run(man, run_dir, steps, content=b"x" * 512):
    ckpt = os.path.join(run_dir, "checkpoints")
    os.makedirs(ckpt, exist_ok=True)
    meta = os.path.join(ckpt, "trainer_meta.json")
    for step in steps:
        sd = os.path.join(ckpt, str(step))
        os.makedirs(sd, exist_ok=True)
        with open(os.path.join(sd, "params.bin"), "wb") as f:
            f.write(content + str(step).encode())
        with open(meta, "w") as f:
            json.dump({"env_steps": step}, f)
        man.write_manifest_file(man.manifest_path(ckpt, step), man.build_manifest(step, sd, [meta]))
    return ckpt


def _tree(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for fn in files:
            p = os.path.join(dirpath, fn)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _fork_case(man, tmp, case, monkeypatch):
    src = _fake_run(man, os.path.join(tmp, "src"), [4, 8, 12])
    dst = os.path.join(tmp, "dst", "checkpoints")
    if case == "torn_source":
        with open(os.path.join(src, "12", "params.bin"), "rb+") as f:
            f.truncate(100)
    if case == "gc_race":
        real, calls = man._copy_fork, []

        def racy(src_dir, dst_dir, good):
            if not calls:
                calls.append(1)
                raise FileNotFoundError("step 12 directory is gone")
            return real(src_dir, dst_dir, good)

        monkeypatch.setattr(man, "_copy_fork", racy)
    copied = man.fork_checkpoint(src, dst, depth=2)
    if case == "clone_corrupt":
        from d4pg_tpu_torch.chaos import truncate_checkpoint_step

        truncate_checkpoint_step(os.path.join(dst, str(copied[-1])))
    with pytest.raises(FileExistsError):
        man.fork_checkpoint(src, dst, depth=2)
    return copied, man.intact_steps(dst), _tree(dst)


@pytest.mark.parametrize("case", ["newest", "torn_source", "gc_race", "clone_corrupt"])
def test_fork_copies_what_the_jax_fork_copies(case, tmp_path, monkeypatch):
    ours = _fork_case(pmanifest, str(tmp_path / "port"), case, monkeypatch)
    ref = _fork_case(jmanifest, str(tmp_path / "jax"), case, monkeypatch)
    assert ours == ref
    copied, intact, files = ours
    assert copied == ([4, 8] if case == "torn_source" else [8, 12])
    assert intact == {"torn_source": [4, 8], "clone_corrupt": [8]}.get(case, [8, 12])
    assert "trainer_meta.json" in files


# ---------------------------------------------------------- the controller
DECISIONS = ("generation_planned", "checkpoint_forked", "learner_killed", "clone_promoted",
             "clone_rolled_back", "slot_given_up", "generation_done")


def _decisions(league_dir):
    """The decision events, without pids, times, exit codes and fork steps;
    shutdown stops are not decisions."""
    out = []
    with open(os.path.join(league_dir, "league_events.jsonl")) as f:
        for line in f:
            e = json.loads(line)
            if e["event"] not in DECISIONS or e.get("reason") == "shutdown":
                continue
            out.append({k: v for k, v in e.items() if k not in ("t", "pid", "rc", "steps")})
    return out


def _run_league(pkg, league_dir, genomes, **kw):
    ctl = CTL[pkg].LeagueController(_config(pkg, league_dir, genomes, **kw))
    rc = ctl.run()
    assert _league_pids(ctl.dir) == []
    return rc, ctl


LEAGUES = {
    "promote": ([GOOD, MID, BAD], {}, 0),
    "rollback": ([{"lr_actor": 1e-4, "max_episode_steps": 50},
                  {"lr_actor": 1e-4, "max_episode_steps": 51},
                  {"lr_actor": 1e-4, "max_episode_steps": 52}], {}, 0),
    "quarantine": ([GOOD, MID, DIVERGED], {"restart_max_attempts": 2}, 0),
    "all_terminal": ([DIVERGED, DIVERGED, DIVERGED], {"restart_max_attempts": 1}, 1),
    "lone_survivor": ([GOOD, DIVERGED, DIVERGED], {"restart_max_attempts": 1}, 1),
}


@pytest.mark.parametrize("case", sorted(LEAGUES))
def test_controller_takes_the_jax_controllers_decisions(case, tmp_path):
    genomes, kw, want_rc = LEAGUES[case]
    runs = {pkg: _run_league(pkg, tmp_path / pkg, [dict(g) for g in genomes], **kw)
            for pkg in ("jax", "port")}
    (rc, ctl), (jrc, jctl_) = runs["port"], runs["jax"]
    assert rc == jrc == want_rc
    assert _decisions(ctl.dir) == _decisions(jctl_.dir)
    s, js = ctl.state, jctl_.state
    for key in ("generation", "promotions", "rollbacks", "lineage", "members", "next_uid"):
        assert s[key] == js[key], key
    quarantined = {u for u, v in s["variants"].items() if v["status"] == "quarantined"}
    assert quarantined == {u for u, v in js["variants"].items() if v["status"] == "quarantined"}
    for uid, v in s["variants"].items():
        assert v["genome"] == js["variants"][uid]["genome"] and v["parent"] == js["variants"][uid]["parent"]
    if case == "promote":
        # the JAX test's claims: the worst culled, the clone of the planted
        # winner (uid 1) promoted with a perturbed lr
        [edge] = s["lineage"]
        assert (edge["parent"], edge["reason"], s["promotions"]) == (1, "clone", 1)
        assert ctl._variant(3)["status"] == "retired" and ctl._variant(3)["killed"] == 1
        assert ctl._variant(edge["child"])["genome"]["lr_actor"] in (1e-4 * 0.8, 1e-4 * 1.25)
    if case == "rollback":
        assert [e["reason"] for e in s["lineage"]] == ["clone", "rollback_refork"]
        assert ctl._variant(s["lineage"][-1]["child"])["genome"] == genomes[0]
    if case == "quarantine":
        v3 = ctl._variant(3)
        assert (v3["status"], v3["restarts"], v3["exited_err"]) == ("quarantined", 2, 3)
        assert s["generation"] == 1
    if case in ("all_terminal", "lone_survivor"):
        assert sum(v["status"] == "quarantined" for v in s["variants"].values()) >= 2
    if want_rc == 0:
        assert check_league_soak(os.path.join(ctl.dir, "league_summary.json")) == []


def test_crash_looping_refork_gives_up_the_slot(tmp_path):
    """A rollback re-fork that crash-loops resolves as a second rollback
    and quarantines the slot's member; no new clone is minted."""
    ctl = pctl.LeagueController(_config("port", tmp_path / "league", [GOOD, MID, BAD]))
    action = {"phase": "observing", "kill_uid": 3, "src_uid": 1, "child_uid": 4,
              "genome": dict(GOOD), "reason": "rollback_refork", "bar_fitness": None,
              "fork_steps": []}
    pending = {"gen": 0, "actions": [action]}
    ctl.state["variants"]["4"] = ctl._new_variant(4, 2, dict(GOOD), parent=1, born_gen=0)
    ctl.state["variants"]["4"]["status"] = "quarantined"
    ctl.state["pending"] = pending
    before = ctl.state["next_uid"]
    ctl._observe(pending, action)
    assert action["phase"] == "done" and ctl.state["next_uid"] == before
    assert ctl.state["rollbacks"] == 1
    ctl.shutdown()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_journal_refuses_mismatched_resume_args(pkg, tmp_path):
    """Each package's journal, opened by the port with other arguments."""
    CTL[pkg].LeagueController(_config(pkg, tmp_path / "league", [GOOD, MID, BAD])).shutdown()
    with pytest.raises(RuntimeError, match="journal disagrees"):
        pctl.LeagueController(_config("port", tmp_path / "league", [GOOD, MID, BAD], seed=8))
    with pytest.raises(RuntimeError, match="journal disagrees"):
        pctl.LeagueController(_config("port", tmp_path / "league", [GOOD, MID]))


# ------------------------------------------- a controller killed, resumed
def _cli(pkg, league_dir, chaos=None):
    argv = [sys.executable, "-m", CLI[pkg], "--dir", str(league_dir), "--seed", "7",
            "--generations", "1", "--poll-interval", "0.1", "--gen-timeout", "60",
            "--drain-timeout", "20", "--attest-timeout", "20", "--observe-timeout", "20",
            "--genome", "lr_actor=1e-4,max_episode_steps=50",
            "--genome", "lr_actor=1e-4,max_episode_steps=200",
            "--genome", "lr_actor=1e-3,max_episode_steps=250"]
    if chaos:
        argv += ["--chaos", chaos]
    return argv + ["--"] + STUBS[pkg] + STUB_ARGS


@pytest.mark.parametrize("killed,resumed,how", [
    ("port", "port", "chaos"), ("jax", "port", "chaos"), ("port", "jax", "chaos"),
    ("port", "port", "sigkill"),
])
def test_a_killed_controller_resumes_the_same_generation(killed, resumed, how, tmp_path):
    """Leg 1: the ``killed`` package's CLI dies by SIGKILL mid-generation,
    from its own ``controller_kill`` chaos site (with ``variant_kill`` and
    ``clone_corrupt``) or from outside once its journal holds a pending
    generation. Leg 2: the ``resumed`` package's CLI prints
    ``journal_resumed``, finishes that generation exactly once and leaves
    no learner behind."""
    league = tmp_path / "league"
    if how == "chaos":
        first = subprocess.run(
            _cli(killed, league, "seed=5;variant_kill@2;clone_corrupt@1;controller_kill@8"),
            cwd=REPO, env=_env(), capture_output=True, text=True, timeout=120)
        assert first.returncode == -signal.SIGKILL, first.stdout[-2000:]
        assert "controller_kill: SIGKILL self" in first.stdout
        assert "variant_kill: SIGKILL" in first.stdout
    else:
        proc = subprocess.Popen(_cli(killed, league), cwd=REPO, env=_env(),
                                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        deadline, doc = time.monotonic() + 60, {}
        while time.monotonic() < deadline and not doc.get("pending"):
            assert proc.poll() is None, "the controller ended before the kill window"
            try:
                doc = json.loads((league / "league.json").read_text())
            except (OSError, ValueError):
                pass
            time.sleep(0.02)
        assert doc.get("pending"), "no pending generation within the deadline"
        time.sleep(random.Random(71).uniform(0.0, 0.4))
        proc.kill()
        proc.wait()
    gen_before = json.loads((league / "league.json").read_text())["generation"]
    rerun = subprocess.run(_cli(resumed, league), cwd=REPO, env=_env(), capture_output=True,
                           text=True, timeout=120)
    assert rerun.returncode == 0, rerun.stdout[-3000:]
    assert "journal_resumed" in rerun.stdout
    final = json.loads((league / "league.json").read_text())
    assert final["generation"] == gen_before + 1 == 1 and final["pending"] is None
    assert final["promotions"] + final["rollbacks"] >= 1
    done = [e for e in _decisions(league) if e["event"] == "generation_done"]
    assert [e["gen"] for e in done] == [1]
    assert check_league_soak(str(league / "league_summary.json")) == []
    assert _league_pids(league) == []


# ----------------------------------------------------- the learner surface
def test_a_port_learner_writes_the_jax_league_columns_and_meta(tmp_path, capsys):
    """``--variant-id 3 --league-generation 1`` on the train CLI: every
    metrics row carries the pair right after ``step`` and ``t`` (the JAX
    ``MetricsLogger(static=...)`` layout; the JAX schema gate passes),
    ``trainer_meta.json`` carries the JAX keys (the controllers' attestation
    reads it), and the run prints its kernel launch line."""
    from d4pg_tpu.runtime.metrics import MetricsLogger as JMetricsLogger
    from d4pg_tpu_torch.train import main

    run = tmp_path / "run"
    main(["--device", "cpu", "--hidden-sizes", "16,16", "--num-envs", "2", "--bsize", "8",
          "--warmup", "64", "--rmsize", "4096", "--total-steps", "8", "--eval-interval", "4",
          "--eval-episodes", "1", "--checkpoint-interval", "8", "--variant-id", "3",
          "--league-generation", "1", "--log-dir", str(run)])
    out = capsys.readouterr().out
    launches = [ln for ln in out.splitlines() if ln.startswith("[train] kernel launches: ")]
    assert len(launches) == 1
    assert sorted(json.loads(launches[0].split(": ", 1)[1])) == sorted(
        ["project", "fused_fwd", "fused_bwd", "tree_count", "fused_step"])
    path = run / "metrics.jsonl"
    rows = [json.loads(line) for line in open(path)]
    assert [r["step"] for r in rows] == [4, 8]
    jlog = JMetricsLogger(str(tmp_path / "jax"), use_tensorboard=False,
                          static={"variant_id": 3, "league_generation": 1})
    jlog.log(4, {"critic_loss": 0.5})
    jlog.close()
    [jrow] = [json.loads(line) for line in open(tmp_path / "jax" / "metrics.jsonl")]
    for r in rows:
        assert list(r)[:4] == list(jrow)[:4] == ["step", "t", "variant_id", "league_generation"]
        assert (r["variant_id"], r["league_generation"]) == (3.0, 1.0)
    assert check_metrics_jsonl(str(path)) == []
    meta = json.loads((run / "checkpoints" / "trainer_meta.json").read_text())
    assert sorted(meta) == ["env_steps", "ewma_return", "league_generation", "variant_id"]
    assert (meta["variant_id"], meta["league_generation"]) == (3, 1)
    # both controllers attest variant 3 from it
    for pkg in ("jax", "port"):
        ctl = CTL[pkg].LeagueController.__new__(CTL[pkg].LeagueController)
        ctl.run_dir = lambda uid: str(run)
        assert ctl._attested(3) and not ctl._attested(4)


def _bundle(path):
    from d4pg_tpu_torch.agent.state import D4PGConfig
    from d4pg_tpu_torch.models.actor import Actor
    from d4pg_tpu_torch.serve.bundle import export_bundle

    cfg = D4PGConfig(obs_dim=3, action_dim=1, hidden_sizes=(8, 8), n_step=3)
    export_bundle(str(path), cfg, Actor(3, 1, (8, 8), generator=torch.Generator().manual_seed(0)),
                  meta={"generation": 0, "env": "Pendulum-v1"})


class _Buf:
    obs_dtype = np.float32

    def add_batch(self, t):
        pass


@pytest.mark.parametrize("direction", ["jax_actor_port_ingest", "port_actor_jax_ingest"])
def test_variant_mismatch_is_refused_across_packages(direction, tmp_path):
    """A learner's fleet caps declare its ``--variant-id`` as the JAX
    learner's do; an actor host assigned to variant 2 is refused by the
    other package's variant-9 ingest with ``variant_mismatch``, and one
    assigned to 9 is accepted with the variant echoed."""
    from d4pg_tpu.config import TrainConfig as JTrainConfig
    from d4pg_tpu_torch.config import TrainConfig

    ours = psource.learner_fleet_caps(psource.from_train_config(
        TrainConfig(fleet_listen=0, variant_id=9)))
    ref = jsource.learner_fleet_caps(jsource.from_train_config(
        JTrainConfig(fleet_listen=0, variant_id=9)))
    assert ours == ref and ours["variant"] == 9
    _bundle(tmp_path)
    port_ingest = direction == "jax_actor_port_ingest"
    actor_mod, ingest_mod = (jactor, pingest) if port_ingest else (pactor, jingest)
    srv = ingest_mod.IngestServer(_Buf(), obs_dim=3, action_dim=1, n_step=3, gamma=0.99,
                                  caps=ours).start()
    try:
        for variant, refused in ((2, True), (9, False)):
            actor = actor_mod.FleetActor(connect=f"127.0.0.1:{srv.port}",
                                         bundle_dir=str(tmp_path), env_id="Pendulum-v1",
                                         num_envs=1, variant=variant)
            try:
                if refused:
                    with pytest.raises(RuntimeError, match=r"\[variant_mismatch\]"):
                        actor_mod.FleetLink("127.0.0.1", srv.port, actor._hello(),
                                            on_ack=lambda *a: None)
                else:
                    link = actor_mod.FleetLink("127.0.0.1", srv.port, actor._hello(),
                                               on_ack=lambda *a: None)
                    assert link.caps["variant"] == 9
                    actor._check_negotiated(link)
                    link.close()
            finally:
                for env in actor.envs:
                    env.close()
        deadline = time.monotonic() + 10
        while srv.counters()["connections"] and time.monotonic() < deadline:
            time.sleep(0.02)
        assert srv.counters()["handshake_refusals"] == 1
    finally:
        srv.close()
