#!/usr/bin/env python3
"""Which half of the asynchronous host data plane costs or saves what.

    python3 d4pg_tpu_torch/tools/async_split.py [--steps N] [--k K]
        [--tree-backend numpy|native] [--repeats R]

Runs the host-placement learner of ``chip_smoke.py`` (full default width,
1000-env-step warmup, seed 0) on one CUDA card in four modes: synchronous,
``prefetch`` only, ``async_priority_writeback`` only, and both; in the
order sync, prefetch, writeback, both, then reversed, ``R`` times, so that
drift of the host between runs falls on every mode alike. Each run prints
one JSON line: the mode, ``grad_steps_per_sec`` of the metrics row and the
host-clock ms a grad step of the data-plane and dispatch stages
(``priority_writeback`` sums both threads when the flusher runs).
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]  # the checkout holding chip_smoke.py
MODES = {
    "sync": {},
    "prefetch": {"prefetch": True},
    "writeback": {"async_priority_writeback": True},
    "both": {"prefetch": True, "async_priority_writeback": True},
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--k", type=int, default=1, help="grad steps per dispatch")
    ap.add_argument("--tree-backend", choices=["numpy", "native"], default="numpy")
    ap.add_argument("--repeats", type=int, default=1)
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import chip_smoke
    import torch

    from d4pg_tpu_torch.config import TrainConfig
    from d4pg_tpu_torch.runtime.trainer import Trainer

    if not torch.cuda.is_available():
        print("async_split: no CUDA device", file=sys.stderr)
        return 2
    card = chip_smoke.nvidia_smi()
    order = list(MODES) + list(reversed(MODES))
    with tempfile.TemporaryDirectory() as tmp:
        for r in range(args.repeats):
            for i, mode in enumerate(order):
                cfg = TrainConfig(
                    env="pendulum", total_steps=args.steps, warmup_steps=1000,
                    eval_interval=args.steps, eval_episodes=1, log_dir=f"{tmp}/{r}_{i}_{mode}",
                    seed=chip_smoke.SEED, steps_per_dispatch=args.k,
                    tree_backend=args.tree_backend, **MODES[mode],
                )
                trainer = Trainer(cfg, device="cuda")
                try:
                    row = trainer.train()
                    torch.cuda.synchronize()
                finally:
                    trainer.close()
                chip_smoke.emit({
                    "phase": "async_split", "mode": mode, "repeat": r, "k": args.k,
                    "tree_backend": args.tree_backend, "grad_steps": args.steps,
                    "grad_steps_per_sec": row["grad_steps_per_sec"],
                    "stage_ms_per_step": chip_smoke.stage_ms_per_step(
                        trainer.timers.scalars(), args.steps),
                    "card": card,
                })
    return 0


if __name__ == "__main__":
    sys.exit(main())
