#!/usr/bin/env python3
"""Kernel B3's device time alone, and its two kernels', for one checkout.

    python3 d4pg_tpu_torch/tools/b3_split.py [--root DIR]

Times ``cuda_tree.find_prefix`` of the ``d4pg_tpu_torch`` package under
``DIR`` (default: this checkout) on one CUDA card, at the main path's
shape: L = 2^20 leaves as the megastep meets them (``chip_smoke.py``'s
``main_path_leaves``) and n = 2048 and 256 stratified prefixes, made
contiguous here so that no copy runs before the launch. Run it on two
checkouts in one machine, alternating, to compare their kernels alone.

For each n it prints one JSON line: ``ms``, the device time of one call
(``chip_smoke.device_ms``: 100 calls in a CUDA graph), and
``kernel_durations_us``, the median duration of each kernel the call
launches from a ``torch.profiler`` trace of 50 eager calls. Pass 2 may be
a programmatic dependent launch that starts during pass 1 and waits in
the kernel, so these durations overlap and need not sum to ``ms``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]  # the checkout holding chip_smoke.py


def kernel_durations_us(fn, calls: int = 50) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
            times.setdefault(name.split("::")[-1].split()[-1], []).append(e.time_range.elapsed_us())
    return {k: statistics.median(v) for k, v in times.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=HERE,
                    help="checkout whose d4pg_tpu_torch is timed")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import chip_smoke  # this checkout's harness, whatever --root is

    sys.path.insert(0, str(args.root.resolve()))  # the package under test first
    import torch

    from d4pg_tpu_torch.ops import cuda_tree

    if not torch.cuda.is_available():
        print("b3_split: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    gen = torch.Generator(device).manual_seed(chip_smoke.SEED)
    leaves = chip_smoke.main_path_leaves(gen, device)
    total = leaves.sum()
    for n in (chip_smoke.K * 256, 256):
        u = torch.rand(n, generator=gen, device=device)
        pre = ((torch.arange(n, device=device) + u) * (total / n)).contiguous()

        def call(pre=pre):
            return cuda_tree.find_prefix(leaves, pre)

        idx, _ = call()
        torch.cuda.synchronize()
        plain = cuda_tree.find_prefix_plain(leaves, pre)
        chip_smoke.emit({
            "phase": "b3_split", "root": str(args.root), "package": cuda_tree.__file__,
            "L": leaves.numel(), "n": n, "ms": chip_smoke.device_ms(call),
            "kernel_durations_us": kernel_durations_us(call),
            "draws_differing_from_plain": int((idx != plain).sum()),
            "card": chip_smoke.nvidia_smi(),
        })
    return 0


if __name__ == "__main__":
    sys.exit(main())
