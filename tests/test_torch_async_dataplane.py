"""The port's asynchronous host data plane on the CPU: ``--prefetch``, the
``--async-writeback`` flusher thread and the declared actions, against the
JAX package's trainer where the two can be compared.

- The prefetch trainer tests are the reference's (``tests/test_prefetch.py``):
  exact grad-step counts, finite metrics, the tree off its seed, and the
  first dispatch's critic loss equal with prefetch on and off at the
  reference's abs 1e-6 (on one device the two first dispatches are the
  same computation on the same batch).
- Loop structure: the JAX ``Trainer`` and the port's run the same tiny
  Pendulum config (NumPy trees, K = 2, 8 grad steps), prefetch off and on,
  and record the calls on their replay buffer in order: ``add_batch`` row
  counts, ``sample_block`` (B, K, step) and ``update_priorities`` shapes.
  The sequences must be equal; the values in them differ across the
  packages (other networks, other env noise), the order must not.
- The flusher: counts and orders are exact; the snapshot test compares
  the tree's leaves bit for bit.
"""

import glob
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from d4pg_tpu.agent.state import D4PGConfig as JConfig
from d4pg_tpu.config import TrainConfig as JTrainConfig
from d4pg_tpu.config import apply_env_preset as j_apply_env_preset
from d4pg_tpu.runtime.trainer import Trainer as JTrainer
from d4pg_tpu_torch.agent.state import D4PGConfig
from d4pg_tpu_torch.config import TrainConfig
from d4pg_tpu_torch.runtime.trainer import Trainer

HIDDEN = (16, 16)


def _trainer(tmp_path, name="run", **kw):
    base = dict(num_envs=2, batch_size=8, warmup_steps=64, total_steps=8, eval_interval=1000,
                eval_episodes=1, replay_capacity=512, log_dir=str(tmp_path / name),
                agent=D4PGConfig(hidden_sizes=HIDDEN))
    base.update(kw)
    return Trainer(TrainConfig(**base), device="cpu")


def _finite(row, keys=("critic_loss", "q_mean", "actor_loss", "priority_mean")):
    for k in keys:
        assert math.isfinite(row[k]), (k, row[k])


# ------------------------------------------------------------------ prefetch
@pytest.mark.parametrize("k", [1, 4])
def test_prefetch_trainer_end_to_end(tmp_path, k):
    t = _trainer(tmp_path, steps_per_dispatch=k, prefetch=True, tree_backend="numpy")
    try:
        row = t.train()
        assert t.grad_steps == 8 and t._staged is None
        _finite(row)
        stages = t.timers.scalars()
        # every dispatch consumed one sample: the primed one, then the staged ones
        assert stages["stage_sample_calls"] == stages["stage_train_dispatch_calls"] == 8 // k
        n = len(t.buffer)
        leaves = t.buffer._sum.get(np.arange(n))
        seed = t.buffer._max_priority ** t.buffer.alpha
        assert (np.abs(leaves - seed) > 1e-12).any()  # priorities written back
        assert t.writebacks_applied == 8 // k
    finally:
        t.close()


def test_prefetch_first_dispatch_equals_no_prefetch(tmp_path):
    losses = []
    for prefetch in (False, True):
        t = _trainer(tmp_path, f"first_{prefetch}", total_steps=1, batch_size=16, warmup_steps=32,
                     prefetch=prefetch)
        try:
            losses.append(float(t.train()["critic_loss"]))
        finally:
            t.close()
    assert losses[0] == pytest.approx(losses[1], abs=1e-6)


# ----------------------------------------------------------- loop structure
def _record_buffer_calls(buf, log):
    for name in ("add_batch", "sample_block", "update_priorities"):
        fn = getattr(buf, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            if _name == "add_batch":
                log.append((_name, len(a[0].obs)))
            elif _name == "sample_block":
                log.append((_name, a[0], a[1], kw.get("step")))
            else:
                log.append((_name, tuple(np.shape(a[1]))))
            return _fn(*a, **kw)

        setattr(buf, name, spy)


@pytest.mark.parametrize("prefetch", [False, True])
def test_buffer_call_sequence_equals_the_jax_trainer(tmp_path, prefetch):
    common = dict(env="pendulum", total_steps=8, warmup_steps=64, batch_size=8, num_envs=2,
                  eval_interval=1000, checkpoint_interval=1000, steps_per_dispatch=2,
                  prefetch=prefetch, tree_backend="numpy", eval_episodes=1)
    logs = []
    jt = JTrainer(j_apply_env_preset(JTrainConfig(
        log_dir=str(tmp_path / "jax"), agent=JConfig(hidden_sizes=HIDDEN), **common)))
    tt = Trainer(TrainConfig(log_dir=str(tmp_path / "torch"), agent=D4PGConfig(hidden_sizes=HIDDEN),
                             **common), device="cpu")
    for t in (jt, tt):
        log = []
        _record_buffer_calls(t.buffer, log)
        try:
            t.train()
        finally:
            t.close()
        logs.append(log)
    assert logs[0] == logs[1]
    samples = [c for c in logs[1] if c[0] == "sample_block"]
    assert len(samples) == 4 and logs[1].count(("update_priorities", (2, 8))) == 4
    if prefetch:  # the batch for dispatch 2 is sampled right after dispatch 1
        assert [c[3] for c in samples] == [0, 0, 2, 4]


# -------------------------------------------------------- async write-back
def _spy_order(t):
    """Record each dispatch's sampled indices and each applied write-back's
    indices, in order."""
    sampled, applied = [], []
    sample_block, update = t.buffer.sample_block, t.buffer.update_priorities

    def spy_sample(*a, **kw):
        out = sample_block(*a, **kw)
        sampled.append(out["indices"].idx.copy())
        return out

    def spy_update(indices, priorities):
        applied.append(np.asarray(indices.idx).reshape(-1, np.asarray(indices.idx).shape[-1]))
        return update(indices, priorities)

    t.buffer.sample_block, t.buffer.update_priorities = spy_sample, spy_update
    return sampled, applied


@pytest.mark.parametrize("prefetch", [False, True])
def test_async_writeback_applies_every_dispatch_once_in_order(tmp_path, prefetch):
    t = _trainer(tmp_path, steps_per_dispatch=2, total_steps=16, async_priority_writeback=True,
                 prefetch=prefetch, tree_backend="native")
    sampled, applied = _spy_order(t)
    try:
        _finite(t.train())
    finally:
        t.close()
    assert len(sampled) == len(applied) == 8 == t.writebacks_applied
    for s, a in zip(sampled, applied):
        np.testing.assert_array_equal(s.reshape(a.shape), a)
    # drained, stopped, idle; nothing left for the lagged path
    assert t._wb_thread is None and t._wb_queue is None and t._wb_idle.is_set()
    assert t._pending is None and t._staged is None
    assert t.buffer._max_priority > 1.0


def test_a_dead_flusher_fails_the_run(tmp_path):
    t = _trainer(tmp_path, total_steps=16, async_priority_writeback=True)

    def boom(indices, priorities):
        raise ValueError("write-back failure")

    t.buffer.update_priorities = boom
    try:
        with pytest.raises(RuntimeError, match="priority write-back thread died") as info:
            t.train()
    finally:
        t.close()
    assert isinstance(info.value.__cause__, ValueError)
    assert t._wb_thread is None  # stopped in the finally, no hang


def test_snapshot_under_the_flusher_holds_the_drained_tree(tmp_path):
    """A slow flusher: the end-of-run --snapshot-replay checkpoint must wait
    for every queued write-back, so the snapshot's leaves are the tree's
    final leaves (the synchronous lagged write-back lands after it)."""
    t = _trainer(tmp_path, total_steps=6, async_priority_writeback=True, snapshot_replay=True,
                 checkpoint_interval=1000)
    update = t.buffer.update_priorities

    def slow(indices, priorities):
        time.sleep(0.05)
        return update(indices, priorities)

    t.buffer.update_priorities = slow
    try:
        t.train()
    finally:
        t.close()
    assert t.writebacks_applied == 6
    with np.load(tmp_path / "run" / "checkpoints" / "replay.npz") as z:
        n = int(z["size"])
        np.testing.assert_array_equal(z["tree_priorities"], t.buffer._sum.get(np.arange(n)))
        assert float(z["max_priority"]) == t.buffer._max_priority > 1.0


def test_preemption_leaves_through_the_finally_with_the_thread_stopped(tmp_path):
    t = _trainer(tmp_path, total_steps=100, async_priority_writeback=True, prefetch=True,
                 checkpoint_interval=1000)
    dispatch = t._dispatch_once

    def dispatch_then_preempt(*a, **kw):
        out = dispatch(*a, **kw)
        if t._dispatches == 3:
            t.request_preemption()
        return out

    t._dispatch_once = dispatch_then_preempt
    try:
        t.train()
    finally:
        t.close()
    assert t.preempted and t.grad_steps == 3 and t.ckpt.latest_step() == 3
    assert t._wb_thread is None and t._staged is None  # the staged 4th batch is dropped
    assert t.writebacks_applied == 3


# ---------------------------------------------------------- declared actions
@pytest.mark.parametrize("placement", ["device", "hybrid"])
def test_prefetch_is_declared_ignored_off_the_host_placement(tmp_path, capsys, placement):
    params = []
    for prefetch in (True, False):
        t = _trainer(tmp_path, f"{placement}_{prefetch}", replay_placement=placement,
                     steps_per_dispatch=4, prefetch=prefetch)
        try:
            assert t.config.prefetch is False
            t.train()
            params.append([p.detach().clone() for p in t.state.critic.parameters()])
        finally:
            t.close()
        if prefetch:
            out = capsys.readouterr().out
            assert (f"--prefetch double-buffers the host batch upload, which "
                    f"replay_placement={placement} removes; ignoring it") in out
    for a, b in zip(*params):
        assert torch.equal(a, b)


def test_ingest_prefetch_is_declared_ignored_on_the_host_placement(tmp_path, capsys):
    t = _trainer(tmp_path, ingest_prefetch=True)
    try:
        assert t.config.ingest_prefetch is False
        assert "--ingest-prefetch" in capsys.readouterr().out
        t.train()
        assert t.timers.scalars()["stage_ingest_stage_calls"] == 0
    finally:
        t.close()


def test_ingest_prefetch_on_the_device_placement_stages_once_a_dispatch(tmp_path):
    """The sync loop collects and flushes before each dispatch, so at
    stage() nothing is pending: it is called once a dispatch and stages no
    chunk (a concurrent writer is what gives it rows)."""
    t = _trainer(tmp_path, replay_placement="device", steps_per_dispatch=4, fused_descent=True,
                 ingest_prefetch=True, total_steps=16)
    try:
        t.train()
        stages = t.timers.scalars()
        assert stages["stage_ingest_stage_calls"] == stages["stage_megastep_dispatch_calls"] == 4
        assert t._ring_sync._staged is None
    finally:
        t.close()


# ------------------------------------------------------------------------ CLI
def _cli(tmp_path, *args):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = repo
    out = subprocess.run(
        [sys.executable, "-m", "d4pg_tpu_torch.train", "--device", "cpu", "--hidden-sizes", "16,16",
         "--num-envs", "2", "--bsize", "8", "--warmup", "64", "--rmsize", "4096",
         "--eval-episodes", "1", "--log-dir", str(tmp_path / "run"), *args],
        cwd=repo, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    return [json.loads(line) for line in open(tmp_path / "run" / "metrics.jsonl")]


def test_cli_host_k4_prefetch_async_writeback_with_a_trace(tmp_path):
    rows = _cli(tmp_path, "--steps-per-dispatch", "4", "--tree-backend", "native", "--prefetch",
                "--async-writeback", "--profile-dir", str(tmp_path / "trace"),
                "--total-steps", "64", "--eval-interval", "32")
    assert [r["step"] for r in rows] == [32, 64]
    for r in rows:
        _finite(r)
        assert r["stage_train_dispatch_calls"] == r["step"] / 4
        assert r["stage_priority_writeback_calls"] >= r["step"] / 4  # hand-offs + flusher wakes
    traces = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    assert len(traces) == 1  # grad steps [12, 60) of the leg


def test_cli_device_ingest_prefetch(tmp_path):
    rows = _cli(tmp_path, "--replay-placement", "device", "--p-replay", "--steps-per-dispatch", "4",
                "--fused-descent", "--ingest-prefetch", "--total-steps", "16", "--eval-interval", "8")
    assert [r["step"] for r in rows] == [8, 16]
    for r in rows:
        _finite(r)
        assert r["stage_ingest_stage_calls"] == r["stage_megastep_dispatch_calls"] == r["step"] / 4


@pytest.mark.parametrize("flag", ["--async-collect", "--publish-interval=5", "--concurrent-eval",
                                  "--no-concurrent-eval"])
def test_host_pool_flags_are_refused_naming_a5_d(flag):
    """The host actor pool's flags (ROADMAP A5 (d), ported) parse into the
    config as the JAX CLI parses them, and are no longer refused."""
    from d4pg_tpu_torch.train import UNPORTED_FLAGS, build_parser, config_from_args, refuse_unported

    refuse_unported([flag])  # raises nothing
    assert flag.split("=")[0] not in UNPORTED_FLAGS
    cfg = config_from_args(build_parser().parse_args([flag]))
    want = {"--async-collect": ("async_collect", True), "--publish-interval=5": ("publish_interval", 5),
            "--concurrent-eval": ("concurrent_eval", True),
            "--no-concurrent-eval": ("concurrent_eval", False)}[flag]
    assert getattr(cfg, want[0]) == want[1]
