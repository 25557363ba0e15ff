#!/usr/bin/env python3
"""Grad steps/s of the synchronous learner paths of one checkout.

    python3 d4pg_tpu_torch/tools/path_rates.py [--root DIR] [--steps N]

Imports ``d4pg_tpu_torch`` from the checkout at ``--root`` (default: the
one holding this script) and runs, on one CUDA card, at the full default
width with a 1000-env-step warmup and seed 0, the synchronous paths of
``chip_smoke.py``: ``slice`` (host, K = 1, NumPy trees), ``host_block``
(host, K = 8, native tree), ``hybrid_slice`` (hybrid, K = 8, native tree,
``debug_guards``) and ``device_fused_descent`` (device, K = 8,
``debug_guards``). Each run prints one JSON line: the path,
``grad_steps_per_sec`` of the metrics row and the host-clock ms a grad
step of every stage. Only options that every commit of the port since
the hybrid placement knows are set, so that two checkouts (a parent and
its change) can be run alternately in one call on one card and compared.

``--wire`` runs instead the host K = 1 path (``slice``) four ways in
turns, float32 and bfloat16 ``transfer_dtype``, each with and without
``debug_guards``, then the same four in reverse order: the bfloat16
wire's cost against float32's, and the sync guard's.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
K = 8
PATHS = {
    "slice": dict(tree_backend="numpy"),
    "host_block": dict(steps_per_dispatch=K, tree_backend="native"),
    "hybrid_slice": dict(replay_placement="hybrid", steps_per_dispatch=K,
                         tree_backend="native", debug_guards=True),
    "device_fused_descent": dict(replay_placement="device", steps_per_dispatch=K,
                                 fused_descent=True, debug_guards=True),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE), help="the checkout whose package is run")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--wire", action="store_true",
                    help="host K = 1 with the float32 and the bfloat16 wire, guard off and on")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import dataclasses

    import torch

    from d4pg_tpu_torch.agent.state import D4PGConfig
    from d4pg_tpu_torch.config import TrainConfig
    from d4pg_tpu_torch.runtime.trainer import Trainer

    if not torch.cuda.is_available():
        print("path_rates: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    n = args.steps
    runs = list(PATHS.items())
    if args.wire:
        ways = [(f"slice_{dtype}_wire{'_guarded' if guard else ''}",
                 dict(tree_backend="numpy", transfer_dtype=dtype, debug_guards=guard))
                for guard in (False, True) for dtype in ("float32", "bfloat16")]
        runs = ways + ways[::-1]
    with tempfile.TemporaryDirectory() as tmp:
        for i, (path, kw) in enumerate(runs):
            cfg = TrainConfig(
                env="pendulum", total_steps=n, warmup_steps=1000, eval_interval=n,
                eval_episodes=1, log_dir=f"{tmp}/{i}_{path}", seed=0, prioritized=True,
                agent=dataclasses.replace(D4PGConfig(), projection_backend="fused"), **kw,
            )
            trainer = Trainer(cfg, device="cuda")
            try:
                row = trainer.train()
                torch.cuda.synchronize()
            finally:
                trainer.close()
            stages = trainer.timers.scalars()
            print(json.dumps({
                "phase": "path_rates", "root": str(root), "path": path, "grad_steps": n,
                "grad_steps_per_sec": row["grad_steps_per_sec"],
                "stage_ms_per_step": {
                    key[len("stage_"):-len("_s")]: stages[key] * 1e3 / n
                    for key in sorted(stages) if key.endswith("_s")
                },
                "card": card,
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
