"""Append-only JSONL metrics (counterpart of ``d4pg_tpu/runtime/metrics.py``).

Rows carry the JAX package's keys: ``step``, ``t``, the train-step
metrics, the throughput counters, the eval scalars and the cumulative
``stage_<name>_s`` / ``stage_<name>_calls`` counters of
:class:`~d4pg_tpu_torch.utils.profiling.StageTimers` (re-exported here).
Every value is a number. TensorBoard is not written.

The stage timers read the host clock. On the card the learner's work is
asynchronous, so ``train_dispatch`` and ``megastep_dispatch`` measure the
enqueue, and the wait for the device lands in whichever stage next
synchronizes (the priority write-back's fetch, or the next collection's
copy to the host). Under ``async_priority_writeback`` the
``priority_writeback`` stage sums the loop thread's hand-off and the
flusher thread's fetch and tree update, so per grad step it is no longer
time on the loop's critical path.
"""

from __future__ import annotations

import json
import os
import time
from typing import Mapping

from d4pg_tpu_torch.utils.profiling import StageTimers

__all__ = ["MetricsLogger", "StageTimers", "interval_crossed"]


def interval_crossed(prev_step: int, step: int, interval: int) -> bool:
    """True when advancing prev_step→step crossed a multiple of interval."""
    return step // interval > prev_step // interval


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
