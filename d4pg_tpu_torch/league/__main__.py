"""``python -m d4pg_tpu_torch.league``: the league controller CLI, with the
JAX CLI's flags.

Everything after ``--`` is the BASE learner command; the controller
appends each variant's flags (its genome, ``--log-dir``, ``--seed``,
``--variant-id``, ``--league-generation``, ``--resume``, and in fleet
mode the fleet wiring). A seeded three-variant league of port learners
on the CPU::

    python -m d4pg_tpu_torch.league --dir /tmp/league --seed 7 --generations 1 \\
        --genome 'lr_actor=1e-4,max_episode_steps=50' \\
        --genome 'lr_actor=1e-4,max_episode_steps=200' \\
        --genome 'lr_actor=1e-3,max_episode_steps=250' \\
        -- python -m d4pg_tpu_torch.train --device cpu --hidden-sizes 16,16 \\
           --num-envs 2 --bsize 8 --warmup 64 --rmsize 4096 \\
           --eval-interval 8 --eval-episodes 1 --checkpoint-interval 8 \\
           --total-steps 100000 --snapshot-replay

Without ``--device cpu`` the learners run on the CUDA card (they raise
when there is none). SIGTERM/SIGINT stop the league gracefully (every
learner drained, every process group swept); a second signal kills. A
controller killed with SIGKILL is the supported crash: rerun the same
command and the journal resumes the same generation.
"""

from __future__ import annotations

import argparse
import shlex
import sys


def parse_genome(spec: str) -> dict:
    """``k=v,k=v`` with numeric values; integers stay integers (batch_size
    and the other structural genes)."""
    genome = {}
    for tok in spec.split(","):
        tok = tok.strip()
        if not tok:
            continue
        k, sep, v = tok.partition("=")
        if not sep:
            raise ValueError(f"bad genome entry {tok!r} (want key=value)")
        try:
            genome[k.strip()] = int(v)
        except ValueError:
            genome[k.strip()] = float(v)
    if not genome:
        raise ValueError(f"empty genome spec {spec!r}")
    return genome


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m d4pg_tpu_torch.league",
        description="crash-consistent PBT league controller",
    )
    p.add_argument("--dir", required=True,
                   help="league root: per-variant run dirs (v0001, ...), "
                        "the league.json journal, league_events.jsonl, "
                        "league_summary.json")
    p.add_argument("--genome", action="append", required=True,
                   metavar="K=V,K=V",
                   help="one per variant slot (repeat N times): the seed "
                        "population's hyperparameter genomes")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--generations", type=int, default=1,
                   help="exploit/explore cycles to run before draining")
    p.add_argument("--poll-interval", type=float, default=0.5)
    p.add_argument("--gen-timeout", type=float, default=600.0,
                   help="force the exploit/explore decision on whatever "
                        "fitness exists after this many seconds")
    p.add_argument("--drain-timeout", type=float, default=60.0,
                   help="SIGTERM -> group-SIGKILL escalation bound per "
                        "learner (the exit-75 drain window)")
    p.add_argument("--attest-timeout", type=float, default=180.0,
                   help="a forked clone must re-attest (trainer_meta "
                        "under its own variant id) within this, else "
                        "rollback")
    p.add_argument("--observe-timeout", type=float, default=300.0,
                   help="an attested clone must produce a fitness "
                        "reading within this, else rollback")
    p.add_argument("--fork-depth", type=int, default=2,
                   help="intact checkpoint steps copied per fork (>1 "
                        "gives the clone restore-fallback depth)")
    p.add_argument("--restart-attempts", type=int, default=4,
                   help="per-variant seeded Backoff budget before a "
                        "crash-looping variant is quarantined")
    p.add_argument("--fitness", choices=["metrics", "best_eval"],
                   default="metrics",
                   help="fitness signal: newest eval row in "
                        "metrics.jsonl (default; best_eval.json is the "
                        "fallback either way)")
    p.add_argument("--fleet-base-port", type=int, default=0,
                   help="fleet mode: slot i's learner ingests on "
                        "PORT+i with --num-envs 0 and publishes its "
                        "bundle; 0 = local collection")
    p.add_argument("--actors-per-variant", type=int, default=0,
                   help="fleet mode: actor hosts spawned per slot, "
                        "pinned to the slot's current variant id "
                        "(re-pointed when the variant is replaced)")
    p.add_argument("--actor-args", default="",
                   help="extra args for spawned fleet actor hosts "
                        "(python -m d4pg_tpu_torch.fleet.actor)")
    p.add_argument("--chaos", default=None, metavar="PLAN",
                   help="controller chaos sites: variant_kill@N / "
                        "controller_kill@N (per control tick), "
                        "clone_corrupt@N (per fork)")
    p.add_argument("--summary-out", default=None,
                   help="also write the end-of-run summary "
                        "(league-soak/v1 schema) here")
    p.add_argument("--debug-guards", action="store_true",
                   help="arm the conservation ledger: the end-of-run "
                        "summary re-checks every variant's process-tenure "
                        "identity (league-tenure) and raises on imbalance")
    p.add_argument("learner", nargs=argparse.REMAINDER,
                   help="-- then the base learner command")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    learner = list(args.learner)
    if learner and learner[0] == "--":
        learner = learner[1:]
    if not learner:
        raise SystemExit(
            "no learner command: pass it after `--`, e.g. "
            "`... -- python -m d4pg_tpu_torch.train --env pendulum ...`"
        )
    try:
        genomes = [parse_genome(g) for g in args.genome]
    except ValueError as e:
        raise SystemExit(str(e))
    if args.debug_guards:
        from d4pg_tpu_torch.analysis import flowledger

        flowledger.enable()
    from d4pg_tpu_torch.league.controller import LeagueConfig, LeagueController

    config = LeagueConfig(
        league_dir=args.dir,
        learner_argv=learner,
        genomes=genomes,
        seed=args.seed,
        generations=args.generations,
        poll_interval_s=args.poll_interval,
        gen_timeout_s=args.gen_timeout,
        drain_timeout_s=args.drain_timeout,
        attest_timeout_s=args.attest_timeout,
        observe_timeout_s=args.observe_timeout,
        fork_depth=args.fork_depth,
        restart_max_attempts=args.restart_attempts,
        fitness_source=args.fitness,
        fleet_base_port=args.fleet_base_port,
        actors_per_variant=args.actors_per_variant,
        # shlex: a quoted value with spaces (an actor --chaos plan) stays
        # one argument, without literal quote characters
        actor_argv=shlex.split(args.actor_args) if args.actor_args else [],
        chaos=args.chaos,
        summary_out=args.summary_out,
    )
    controller = LeagueController(config)
    from d4pg_tpu_torch.utils.signals import install_graceful_signals

    install_graceful_signals(
        controller.request_stop,
        "[signal] {sig}: draining the league "
        "(second signal hard-kills)",
    )
    return controller.run()


if __name__ == "__main__":
    sys.exit(main())
