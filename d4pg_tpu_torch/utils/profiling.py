"""Profiling: trace capture, named host ranges, per-stage counters.

The port's counterpart of ``d4pg_tpu/utils/profiling.py``, on torch:

- :func:`profile_trace` captures a ``torch.profiler`` trace (host ops,
  CUDA kernels and copies) for a bounded window and writes it into a
  directory as a Chrome trace (``*.pt.trace.json``, torch's own format:
  chrome://tracing, Perfetto or TensorBoard's torch profiler plugin read
  it). The reference writes a TensorBoard XLA trace instead;
- :func:`annotate` tags a host region (``host/prefetch``) so host stalls
  line up with device work on that trace; on a CUDA build it is also an
  NVTX range, which Nsight Systems shows;
- :class:`StageTimers` keeps cumulative host-clock seconds and call
  counts per data-plane stage, and opens the same range (``host/<name>``)
  around each stage.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch


@contextlib.contextmanager
def _range(name: str, nvtx: bool):
    """A ``record_function`` range, and an NVTX range when ``nvtx``."""
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def annotate(name: str):
    """Named host region on the profiler trace (and NVTX on CUDA)."""
    return _range(name, torch.cuda.is_available())


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """Capture a ``torch.profiler`` trace of the CPU activity of every
    thread and (with a card) the CUDA activity inside the block, written
    into ``log_dir`` as ``<host>_<pid>.<ms>.pt.trace.json`` when the block
    ends (no-op when ``log_dir`` is None)."""
    if not log_dir:
        yield
        return
    from torch._C._profiler import _ExperimentalConfig

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
        # every thread's ranges, the priority write-back thread's too (by
        # default only the thread that starts the trace is recorded)
        experimental_config=_ExperimentalConfig(profile_all_threads=True),
    ):
        yield


class StageTimers:
    """Cumulative per-stage wall-time counters for the host data plane.

    ``stage(name)`` adds the enclosed host-clock time to the named counter
    and opens the range ``host/<name>`` (``host/sample``, ...) on the
    profiler trace. Thread-safe: the learner loop and the priority
    write-back thread report into one set of counters, so a row shows the
    TOTAL host time of a stage over every thread. Any name is accepted; :attr:`STAGES` lists the ones the
    trainer uses.
    """

    STAGES = (
        "env_step",            # acting forward + env step + n-step collapse
        "replay_insert",       # ring/tree insert
        "sample",              # PER descent + gather
        "h2d_stage",           # pinned copy + host→device transfer start
        "train_dispatch",      # train_step enqueue
        "priority_writeback",  # device→host priority fetch + tree update
        "ingest_chunk",        # device placement: host ring → device ring flush
        "ingest_stage",        # device placement: the next flush's first chunk staged
        "megastep_dispatch",   # device placement: K-step megastep enqueue
        "checkpoint_save",     # state + meta + snapshots + manifest
        "checkpoint_restore",  # resume (its ring flush also counts as ingest_chunk)
    )

    RANGE_PREFIX = "host/"

    def __init__(self):
        self._nvtx = torch.cuda.is_available()
        self._lock = threading.Lock()
        self._acc: dict[str, float] = {}
        self._n: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            with _range(self.RANGE_PREFIX + name, self._nvtx):
                yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._acc[name] = self._acc.get(name, 0.0) + dt
                self._n[name] = self._n.get(name, 0) + 1

    def ensure(self, name: str) -> None:
        """Pin a stage into the scalars at 0 s and 0 calls, so a stage that
        a mode never runs reads as an explicit zero, not as absent."""
        with self._lock:
            self._acc.setdefault(name, 0.0)
            self._n.setdefault(name, 0)

    def scalars(self) -> dict:
        """``stage_<name>_s`` cumulative seconds and ``stage_<name>_calls``
        for every stage seen (or ensured)."""
        with self._lock:
            out: dict = {}
            for k, v in self._acc.items():
                out[f"stage_{k}_s"] = v
                out[f"stage_{k}_calls"] = float(self._n[k])
            return out

    def summary_ms(self, per: int | None = None) -> dict:
        """Mean ms per call of each stage, or per ``per`` units (e.g. per
        grad step) when given."""
        with self._lock:
            return {
                k: v * 1e3 / (per if per else max(self._n[k], 1))
                for k, v in self._acc.items()
            }

    def reset(self) -> None:
        with self._lock:
            self._acc.clear()
            self._n.clear()
