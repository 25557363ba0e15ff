"""Append-only JSONL metrics and host-side stage timers (counterpart of
``d4pg_tpu/runtime/metrics.py`` and the timers of
``d4pg_tpu/utils/profiling.py``).

Rows carry the JAX package's keys: ``step``, ``t``, the train-step
metrics, the throughput counters, the eval scalars and the cumulative
``stage_<name>_s`` / ``stage_<name>_calls`` counters. Every value is a
number. TensorBoard is not written; NVTX ranges wait for ROADMAP A11.

The stage timers read the host clock. On the card the learner's work is
asynchronous, so ``train_dispatch`` and ``megastep_dispatch`` measure the
enqueue, and the wait for the device lands in whichever stage next
synchronizes (the priority write-back's fetch, or the next collection's
copy to the host).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Mapping


def interval_crossed(prev_step: int, step: int, interval: int) -> bool:
    """True when advancing prev_step→step crossed a multiple of interval."""
    return step // interval > prev_step // interval


class StageTimers:
    """Cumulative seconds and call counts per named stage of the host loop."""

    STAGES = (
        "env_step",            # acting forward + env step + n-step collapse
        "replay_insert",       # ring/tree insert
        "sample",              # PER descent + gather
        "h2d_stage",           # pinned copy + host→device transfer start
        "train_dispatch",      # train_step enqueue
        "priority_writeback",  # device→host priority fetch + tree update
        "ingest_chunk",        # device placement: host ring → device ring flush
        "megastep_dispatch",   # device placement: K-step megastep enqueue
    )

    def __init__(self):
        self._s = {k: 0.0 for k in self.STAGES}
        self._n = {k: 0 for k in self.STAGES}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._s[name] += time.perf_counter() - t0
            self._n[name] += 1

    def scalars(self) -> dict:
        out = {}
        for k, v in self._s.items():
            out[f"stage_{k}_s"] = v
            out[f"stage_{k}_calls"] = float(self._n[k])
        return out


class MetricsLogger:
    """Appends one JSON object per :meth:`log` call to
    ``<log_dir>/metrics.jsonl``."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._t0 = time.monotonic()

    def log(self, step: int, scalars: Mapping[str, float], timers=None) -> None:
        rec = {"step": int(step), "t": time.monotonic() - self._t0}
        rec.update({k: float(v) for k, v in scalars.items()})
        if timers is not None:
            rec.update(timers.scalars())
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()
