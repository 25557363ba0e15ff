#!/usr/bin/env python3
"""Kernel B2's device time, and B1b's beside it, for one checkout.

    python3 d4pg_tpu_torch/tools/b2_time.py [--root DIR]

Times ``cuda_projection.project`` (B2) of the ``d4pg_tpu_torch`` package
under ``DIR`` (default: this checkout) on one CUDA card at B = 256 on the
Pendulum support, at the learner's A = 51 and at A = 1024, and
``cuda_projection.fused_loss_bwd`` (B1b) at A = 51 and 1024, on
``chip_smoke.py``'s ``make_inputs``. B2 and B1b form m with one body, so
B1b's time shows what sharing it costs. Run it on two checkouts in one
machine, alternating, to compare their kernels.

For each kernel and A it prints one JSON line: ``ms``, the device time of
one call (``chip_smoke.device_ms``: 100 calls in a CUDA graph),
``floor_ms`` (``chip_smoke.floor_ms``), and ``max_abs_err`` against the
plain version, which is reported, not checked.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]  # the checkout holding chip_smoke.py


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=HERE,
                    help="checkout whose d4pg_tpu_torch is timed")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import chip_smoke  # this checkout's harness, whatever --root is

    sys.path.insert(0, str(args.root.resolve()))  # the package under test first
    import torch

    from d4pg_tpu_torch.ops import cuda_projection as cp
    from d4pg_tpu_torch.ops.categorical import make_support

    if not torch.cuda.is_available():
        print("b2_time: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    gen = torch.Generator(device).manual_seed(chip_smoke.SEED)
    floor = chip_smoke.floor_ms()
    card = chip_smoke.nvidia_smi()
    B = 256
    for A in (51, 1024):
        support = make_support(-300.0, 0.0, A)
        q, p, r, d, g_ce, g_ov = chip_smoke.make_inputs(B, A, support, gen, device)
        kernels = {
            "c51_project": (lambda: cp.project(support, p, r, d),
                            lambda: cp.project_plain(support, p, r, d)),
            "c51_fused_loss_bwd": (
                lambda: cp.fused_loss_bwd(support, q, p, r, d, g_ce, g_ov),
                lambda: cp.fused_loss_bwd_plain(support, q, p, r, d, g_ce, g_ov)),
        }
        for name, (fn, plain) in kernels.items():
            err = float((fn() - plain()).abs().max())
            chip_smoke.emit({
                "phase": "b2_time", "root": str(args.root), "package": cp.__file__,
                "name": name, "B": B, "A": A, "ms": chip_smoke.device_ms(fn),
                "floor_ms": floor, "max_abs_err": err, "card": card,
            })
    return 0


if __name__ == "__main__":
    sys.exit(main())
