"""CPU smokes of the whole slice: the CLI ``python -m d4pg_tpu_torch.train
--device cpu`` at small width, and the ``Trainer`` loop's bookkeeping."""

import json
import math
import os
import subprocess
import sys

import numpy as np

from d4pg_tpu_torch.agent.state import D4PGConfig
from d4pg_tpu_torch.config import TrainConfig
from d4pg_tpu_torch.runtime.trainer import SEGMENT_LEN, Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cli_smoke_writes_finite_metrics(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-m", "d4pg_tpu_torch.train", "--device", "cpu",
         "--hidden-sizes", "32,32", "--num-envs", "2", "--bsize", "32",
         "--warmup", "128", "--total-steps", "20", "--eval-interval", "10",
         "--eval-episodes", "1", "--log-dir", str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [10, 20]
    for r in rows:
        for k in ("critic_loss", "q_mean", "actor_loss", "eval_return_mean",
                  "grad_steps_per_sec", "stage_train_dispatch_s"):
            assert math.isfinite(r[k]), (k, r[k])
        assert all(isinstance(v, (int, float)) for v in r.values())
    assert rows[-1]["replay_size"] >= 128


def _trainer(tmp_path, **kw):
    agent = D4PGConfig(hidden_sizes=(16, 16), **kw.pop("agent", {}))
    cfg = TrainConfig(num_envs=2, batch_size=16, warmup_steps=100, total_steps=8,
                      eval_interval=4, eval_episodes=2, log_dir=str(tmp_path),
                      agent=agent, **kw)
    return Trainer(cfg, device="cpu")


def test_warmup_fills_replay_and_training_budget_collects(tmp_path):
    t = _trainer(tmp_path, env_steps_per_train_step=16.0)
    assert t.config.agent.dist.v_min == -300.0 and t.config.agent.dist.v_max == 0.0
    t.warmup()
    per_collect = 2 * SEGMENT_LEN
    assert t.env_steps == 2 * per_collect and len(t.buffer) == t.env_steps
    row = t.train(total_steps=8)  # 8 steps x 16 env steps = 2 more collects
    t.close()
    assert t.env_steps == 4 * per_collect and t.grad_steps == 8
    assert row["env_steps"] == 4 * per_collect
    # every sampled batch's priorities were written back (lag flushed at the end)
    assert t.timers.scalars()["stage_priority_writeback_calls"] == 8
    assert t.buffer._max_priority > 1.0


def test_uniform_replay_and_projection_rung(tmp_path):
    t = _trainer(tmp_path, prioritized=False, agent=dict(projection_backend="projection"))
    row = t.train()
    t.close()
    assert math.isfinite(row["critic_loss"]) and t.grad_steps == 8
    assert t.timers.scalars()["stage_priority_writeback_calls"] == 0
    lines = open(os.path.join(str(tmp_path), "metrics.jsonl")).read().splitlines()
    assert len(lines) == 2


def test_explicit_support_is_not_clobbered_by_the_preset(tmp_path):
    from d4pg_tpu_torch.models.critic import DistConfig

    t = _trainer(tmp_path, agent=dict(dist=DistConfig(v_min=-500.0, v_max=10.0)))
    t.close()
    assert (t.config.agent.dist.v_min, t.config.agent.dist.v_max) == (-500.0, 10.0)
    assert t.config.agent.n_step == 3 and t.config.replay_capacity == 1_000_000


def test_eval_returns_are_pendulum_scale(tmp_path):
    from d4pg_tpu_torch.runtime.evaluator import evaluate

    import torch

    t = _trainer(tmp_path)
    ev = evaluate(t.config.agent, t.env, t.state.actor, torch.Generator().manual_seed(0), 3)
    t.close()
    # 200 steps of reward in [-16.3, 0]
    assert -16.3 * 200 <= ev["eval_return_mean"] <= 0.0
    assert ev["eval_return_std"] >= 0.0 and np.isfinite(ev["eval_return_std"])
