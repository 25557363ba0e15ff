"""Run serving phases of ``chip_smoke.py`` alone on the card, each in a
process of its own, optionally on a second checkout in turns (this tree,
the other, the other, this tree), to compare two commits in one call.

Each run exports a seeded 3x256 Pendulum bundle (the width of
``chip_smoke.py``'s ``serve`` bundle) and calls the phase with it; its
full output goes to ``--out``, and one JSON summary line a run is
printed, after the card's name and power limit::

    python -m d4pg_tpu_torch.tools.chip_phases --phase serve_guards_chaos \\
        --phase router_serve --other /path/to/parent/checkout --out runs/chip_phases

Phases: ``serve_guards_chaos`` (the serve CLI under connection attacks:
its ``netio`` sheds and evictions) and ``router_serve`` (the replicated
front end: load through the router and direct, rollouts, autoscaler,
replica kill). A phase the other checkout lacks is run on this tree only.
Exits non-zero when any run fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

PHASES = ("serve_guards_chaos", "router_serve")
_RUN = r"""
import os, sys, tempfile
tree, phase = sys.argv[1], sys.argv[2]
sys.path.insert(0, tree)
os.chdir(tree)
import torch
import chip_smoke as cs
from d4pg_tpu_torch.agent.state import D4PGConfig
from d4pg_tpu_torch.models.actor import Actor
from d4pg_tpu_torch.serve import export_bundle
card = cs.nvidia_smi()
with tempfile.TemporaryDirectory() as tmp:
    cfg = D4PGConfig(obs_dim=3, action_dim=1)
    export_bundle(f"{tmp}/bundle_default", cfg,
                  Actor(3, 1, cfg.hidden_sizes, generator=torch.Generator().manual_seed(0)))
    if phase == "serve_guards_chaos":
        cs.serve_guards_chaos_phase(card, f"{tmp}/bundle_default")
    else:
        cs.router_serve_phase(card, f"{tmp}/bundle_default", tmp)
"""
# the fields of each phase's line a summary keeps
_KEEP = {
    "serve_guards_chaos": ("netio", "window_s", "churn", "chaos_injections"),
    "router_serve": ("load", "router_over_direct", "router_cpu_s_per_s", "replies_vs_cpu",
                     "canary_promoted", "canary_rolled_back", "autoscale", "replica_kill",
                     "phase_s"),
}


def _has_phase(tree: str, phase: str) -> bool:
    with open(os.path.join(tree, "chip_smoke.py")) as f:
        return f"def {phase}_phase(" in f.read()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m d4pg_tpu_torch.tools.chip_phases",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--phase", action="append", choices=PHASES, required=True)
    p.add_argument("--other", default=None, help="a second checkout, run in turns with this one")
    p.add_argument("--out", default="runs/chip_phases", help="where each run's full output goes")
    p.add_argument("--timeout", type=float, default=900.0, help="seconds a run may take")
    args = p.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    os.makedirs(args.out, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    runs = []
    for phase in args.phase:
        if args.other and _has_phase(args.other, phase):
            runs += [("this", here, phase), ("other", args.other, phase),
                     ("other", args.other, phase), ("this", here, phase)]
        else:
            runs.append(("this", here, phase))
    failed = 0
    for i, (name, tree, phase) in enumerate(runs):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-c", _RUN, tree, phase], capture_output=True,
                           text=True, timeout=args.timeout, cwd=tree)
        took = time.perf_counter() - t0
        with open(os.path.join(args.out, f"chip_phases_{i}_{name}_{phase}.log"), "w") as f:
            f.write(r.stdout + "\n----- stderr\n" + r.stderr)
        row = {"run": i, "tree": name, "phase": phase, "rc": r.returncode, "s": took,
               "card": card}
        lines = [ln for ln in r.stdout.splitlines() if ln.startswith('{"phase"')]
        if lines:
            line = json.loads(lines[-1])
            row.update({k: line.get(k) for k in _KEEP[phase]})
        else:
            row["stderr_tail"] = r.stderr[-2000:]
        failed += r.returncode != 0
        print(json.dumps(row), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
