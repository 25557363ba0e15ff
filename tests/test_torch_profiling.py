"""The port's ``utils/profiling.py`` against ``d4pg_tpu/utils/profiling.py``
on the CPU: the stage timers' counts and row keys, and the trace.

Tolerances: counts and keys are exact. Seconds are host-clock sums and are
held only to be non-negative and ordered (never compared across packages).
"""

import glob
import json
import sys
import threading

import pytest

from d4pg_tpu.utils.profiling import StageTimers as JStageTimers
from d4pg_tpu_torch.runtime.metrics import StageTimers as MetricsStageTimers
from d4pg_tpu_torch.utils.profiling import StageTimers, annotate, profile_trace


def test_timers_are_exact_under_eight_threads():
    """8 threads x 1000 stages on one shared name and one of their own,
    with a short switch interval: no lost update."""
    timers = StageTimers()
    n_threads, n_iter = 8, 1000
    start = threading.Barrier(n_threads)

    def work(i):
        start.wait(timeout=30)
        for _ in range(n_iter):
            with timers.stage("shared"):
                pass
            with timers.stage(f"own_{i}"):
                pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    row = timers.scalars()
    assert row["stage_shared_calls"] == n_threads * n_iter
    for i in range(n_threads):
        assert row[f"stage_own_{i}_calls"] == n_iter
    assert row["stage_shared_s"] >= 0.0
    per_call = timers.summary_ms()
    assert per_call["shared"] == pytest.approx(row["stage_shared_s"] * 1e3 / (n_threads * n_iter))


def test_unknown_names_are_accepted_and_ensure_pins_a_zero():
    timers = StageTimers()
    assert MetricsStageTimers is StageTimers  # the old import path still works
    with timers.stage("no_such_stage_in_STAGES"):
        pass
    timers.ensure("h2d_stage")
    timers.ensure("no_such_stage_in_STAGES")  # never resets a live counter
    row = timers.scalars()
    assert row["stage_no_such_stage_in_STAGES_calls"] == 1.0
    assert row["stage_h2d_stage_s"] == 0.0 and row["stage_h2d_stage_calls"] == 0.0
    assert timers.summary_ms(per=4)["h2d_stage"] == 0.0
    timers.reset()
    assert timers.scalars() == {}


def test_row_keys_equal_the_reference_for_the_same_stages():
    ours, ref = StageTimers(), JStageTimers()
    for t in (ours, ref):
        t.ensure("megastep_dispatch")
        for name in ("sample", "h2d_stage", "train_dispatch", "sample", "priority_writeback",
                     "checkpoint_save", "ingest_stage"):
            with t.stage(name):
                pass
    a, b = ours.scalars(), ref.scalars()
    assert sorted(a) == sorted(b)
    for k in a:
        if k.endswith("_calls"):
            assert a[k] == b[k], k
    assert sorted(ours.summary_ms()) == sorted(ref.summary_ms())


def test_profile_trace_on_the_cpu_holds_the_host_ranges_of_every_thread(tmp_path):
    timers = StageTimers()
    other_ran = threading.Event()

    def other():
        with timers.stage("priority_writeback"):
            other_ran.set()

    with profile_trace(str(tmp_path)):
        with timers.stage("sample"):
            pass
        with annotate("host/prefetch"):
            pass
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
    assert other_ran.is_set()
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events if e.get("cat") == "user_annotation"}
    assert {"host/sample", "host/prefetch", "host/priority_writeback"} <= names
    with profile_trace(None):  # no directory: no trace, no error
        pass


def test_the_range_prefix_is_a_constructor_argument(tmp_path):
    """The serving batcher's timers open ``serve/<name>`` ranges; the
    default stays ``host/`` for every learner caller."""
    serve = StageTimers(annotate_prefix="serve/")
    with profile_trace(str(tmp_path)):
        with serve.stage("device_infer"):
            pass
        with StageTimers().stage("sample"):
            pass
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"}
    assert {"serve/device_infer", "host/sample"} <= names
    assert serve.scalars()["stage_device_infer_calls"] == 1.0
