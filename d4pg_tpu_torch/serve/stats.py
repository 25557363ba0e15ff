"""Serving observability: latency percentiles + batch/queue histograms
(the port's copy of ``d4pg_tpu/serve/stats.py``, same snapshot keys).

The serving SLO surface is p50/p95/p99 request latency, the batch-size
distribution (how well the window fills), queue depth (how close to
shedding), and the shed counters themselves. All of it aggregates here and
is snapshotted by the ``healthz`` reply and the periodic
:class:`~d4pg_tpu_torch.runtime.metrics.MetricsLogger` row — the same
jsonl pipeline training runs log through, so serve metrics plot with the
same tooling.

Everything is lock-protected and O(1) per request; percentile computation
happens only at snapshot time over a bounded reservoir.
"""

from __future__ import annotations

import time

import numpy as np

from d4pg_tpu_torch.analysis import lockwitness


class LatencyReservoir:
    """Sliding window of the last ``size`` request latencies.

    A plain ring, not a decaying sample: serving percentiles should reflect
    the RECENT regime (the thing an operator alarms on), and a few thousand
    samples bound the snapshot cost while covering seconds of traffic at
    any realistic rate.
    """

    def __init__(self, size: int = 8192):
        self._buf = np.zeros(size, np.float64)
        self._n = 0          # total ever recorded
        self._lock = lockwitness.named_lock("LatencyReservoir._lock")

    def add(self, seconds: float) -> None:
        with self._lock:
            self._buf[self._n % len(self._buf)] = seconds
            self._n += 1

    def percentiles_ms(self, qs=(50, 95, 99)) -> dict:
        with self._lock:
            n = min(self._n, len(self._buf))
            if n == 0:
                return {f"p{q}_ms": None for q in qs}
            window = self._buf[:n].copy()
        vals = np.percentile(window, qs)
        return {f"p{q}_ms": round(float(v) * 1e3, 4) for q, v in zip(qs, vals)}

    @property
    def count(self) -> int:
        with self._lock:
            return self._n


class Histogram:
    """Counts per bucket over fixed upper-edge boundaries (last bucket is
    open-ended). Used for batch sizes (edges = the batcher's bucket sizes)
    and queue depth (powers of two up to the queue limit)."""

    def __init__(self, edges):
        self.edges = tuple(int(e) for e in edges)
        self._counts = [0] * (len(self.edges) + 1)
        self._lock = lockwitness.named_lock("Histogram._lock")

    def add(self, value: int) -> None:
        i = 0
        while i < len(self.edges) and value > self.edges[i]:
            i += 1
        with self._lock:
            self._counts[i] += 1

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self._counts)
        out = {}
        for i, e in enumerate(self.edges):
            out[f"le_{e}"] = counts[i]
        out["inf"] = counts[-1]
        return out


class ServeStats:
    """One aggregation point for every serving counter.

    Shared by the connection handlers (request/shed/error counts), the
    batcher device thread (batch sizes, per-batch device time via
    StageTimers), and the reply path (latency reservoir). ``snapshot()``
    is the healthz payload and the periodic metrics row.
    """

    def __init__(self, batch_edges, queue_edges):
        self.latency = LatencyReservoir()
        self.batch_hist = Histogram(batch_edges)
        self.queue_hist = Histogram(queue_edges)
        self._lock = lockwitness.named_lock("ServeStats._lock")
        self._t0 = time.monotonic()
        self.requests_total = 0
        self.replies_ok = 0
        self.shed_queue_full = 0
        self.shed_deadline = 0
        self.shed_draining = 0
        self.protocol_errors = 0
        self.dropped_replies = 0   # client gone before its reply
        self.unknown_policy = 0    # well-formed ACT2 naming a non-resident policy
        self.feedback_frames = 0   # reward echoes accepted (flywheel mirror)
        self.batches_total = 0
        self.padded_rows_total = 0
        self.params_version = 0
        self.params_reloads = 0
        # Admitted-but-unanswered gauge (+1 at enqueue, −1 when the request
        # future resolves — any way): a router's least-loaded dispatch
        # signal, read from healthz.
        self.inflight = 0

    def inc(self, field: str, by: int = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + by)

    def observe_batch(self, n: int, bucket: int) -> None:
        self.batch_hist.add(n)
        with self._lock:
            self.batches_total += 1
            self.padded_rows_total += bucket - n

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "uptime_s": round(time.monotonic() - self._t0, 3),
                "inflight": self.inflight,
                "requests_total": self.requests_total,
                "replies_ok": self.replies_ok,
                "shed_queue_full": self.shed_queue_full,
                "shed_deadline": self.shed_deadline,
                "shed_draining": self.shed_draining,
                "protocol_errors": self.protocol_errors,
                "dropped_replies": self.dropped_replies,
                "unknown_policy": self.unknown_policy,
                "feedback_frames": self.feedback_frames,
                "batches_total": self.batches_total,
                "padded_rows_total": self.padded_rows_total,
                "params_version": self.params_version,
                "params_reloads": self.params_reloads,
            }
        shed = out["shed_queue_full"] + out["shed_deadline"] + out["shed_draining"]
        out["shed_total"] = shed
        if out["requests_total"]:
            out["shed_rate"] = round(shed / out["requests_total"], 6)
        out.update(self.latency.percentiles_ms())
        out["batch_size_hist"] = self.batch_hist.snapshot()
        out["queue_depth_hist"] = self.queue_hist.snapshot()
        if out["batches_total"]:
            out["mean_batch"] = round(
                out["replies_ok"] / out["batches_total"], 3
            )
        return out

    def metrics_row(self) -> dict:
        """Flat scalars-only view for MetricsLogger (histograms flattened,
        None percentiles dropped — jsonl rows are float-valued)."""
        snap = self.snapshot()
        row = {}
        for k, v in snap.items():
            if isinstance(v, dict):
                for bk, bv in v.items():
                    row[f"{k}_{bk}"] = float(bv)
            elif v is not None:
                row[k] = float(v)
        return row
