"""``python -m d4pg_tpu_torch.train --on-device`` on the CPU: the runs of
Pendulum and HalfCheetah at narrow widths, the checkpoint and ``--resume``
pair, the exits 75 of SIGTERM and of the RSS watchdog, and the refusals
(``--replay-placement`` other than host with the JAX CLI's message,
``--dp 3`` over 2 envs with the JAX mesh's divisibility error, and a
``--critic-head`` neither package has)."""

import json
import math
import os
import signal
import subprocess
import sys
import time

import pytest

from tools.d4pglint.schema_check import check_metrics_jsonl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--device", "cpu", "--on-device", "--hidden-sizes", "16,16", "--num-envs", "2",
         "--bsize", "16", "--warmup", "64", "--rmsize", "4096", "--eval-episodes", "1"]


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env.setdefault("OMP_NUM_THREADS", "2")
    return env


def _run(args, timeout=300):
    return subprocess.run([sys.executable, "-m", "d4pg_tpu_torch.train", *args], cwd=REPO,
                          env=_env(), capture_output=True, text=True, timeout=timeout)


def _rows(log_dir):
    return [json.loads(line) for line in open(os.path.join(log_dir, "metrics.jsonl"))]


def _finite(row):
    return all(math.isfinite(v) for v in row.values())


@pytest.mark.parametrize("env_name,extra", [("pendulum", []), ("halfcheetah", ["--max-steps", "50"])])
def test_cli_on_device_runs_and_logs_finite_rows(env_name, extra, tmp_path):
    out = _run(SMALL + ["--env", env_name, "--total-steps", "128", "--eval-interval", "64",
                        "--log-dir", str(tmp_path), *extra])
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    rows = _rows(tmp_path)
    # 2 envs x 32 steps = 64 env steps and 64 grad steps an iteration
    assert [r["step"] for r in rows] == [64, 128]
    assert all(_finite(r) for r in rows)
    assert [r["replay_size"] for r in rows] == [128, 192] and rows[-1]["env_steps"] == 192
    for key in ("critic_loss", "eval_return_mean", "train_reward_per_episode_boundary",
                "grad_steps_per_sec", "env_steps_per_sec", "best_eval_return"):
        assert key in rows[-1], key
    assert check_metrics_jsonl(str(tmp_path / "metrics.jsonl")) == []
    assert os.path.exists(tmp_path / "checkpoints" / "manifest_128.json")
    assert os.listdir(tmp_path / "checkpoints_best") and os.path.exists(tmp_path / "best_eval.json")


def test_cli_on_device_checkpoint_then_resume(tmp_path):
    args = SMALL + ["--total-steps", "128", "--eval-interval", "64", "--checkpoint-interval", "64",
                    "--log-dir", str(tmp_path)]
    first = _run(args)
    assert first.returncode == 0, first.stdout[-2000:] + first.stderr[-2000:]
    second = _run(args + ["--resume"])
    assert second.returncode == 0, second.stdout[-2000:] + second.stderr[-2000:]
    assert "[checkpoint] resumed from step 128" in second.stdout
    rows = _rows(tmp_path)
    assert [r["step"] for r in rows] == [64, 128, 192, 256]
    # the ring is not checkpointed: the resumed leg re-warms an empty one
    # (one 64-row warmup segment, then its own iterations), while env_steps
    # continue from the trainer meta
    assert [r["replay_size"] for r in rows] == [128, 192, 128, 192]
    assert [r["env_steps"] for r in rows] == [128, 192, 320, 384]
    assert all(_finite(r) for r in rows)
    ck = sorted(os.listdir(tmp_path / "checkpoints"))
    assert ck == ["128", "192", "256", "manifest_128.json", "manifest_192.json",
                  "manifest_256.json", "trainer_meta.json"]


def test_cli_on_device_rss_watchdog_exits_75(tmp_path):
    out = _run(SMALL + ["--total-steps", "256", "--eval-interval", "64", "--max-rss-gb", "0.001",
                        "--log-dir", str(tmp_path)])
    assert out.returncode == 75, out.stdout[-2000:] + out.stderr[-2000:]
    assert "[rss-watchdog]" in out.stdout
    assert os.path.exists(tmp_path / "checkpoints" / "manifest_64.json")


def test_cli_on_device_sigterm_exits_75_with_a_checkpoint(tmp_path):
    proc = subprocess.Popen(
        [sys.executable, "-m", "d4pg_tpu_torch.train", *SMALL, "--total-steps", "1000000",
         "--eval-interval", "64", "--log-dir", str(tmp_path)],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        lines = []
        deadline = time.monotonic() + 240
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("[step 64]"):
                proc.send_signal(signal.SIGTERM)
                break
            assert time.monotonic() < deadline, "".join(lines[-20:])
        rest, _ = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
    text = "".join(lines) + rest
    assert proc.returncode == 75, text[-2000:]
    assert "[preempt] stop requested" in text
    # the CLI's launch line at exit 75 (the kernels' plain versions on the CPU count none)
    assert '[train] kernel launches: {"project": 0, "fused_fwd": 0' in text
    steps = [n for n in os.listdir(tmp_path / "checkpoints") if n.isdigit()]
    assert steps and all(os.path.exists(tmp_path / "checkpoints" / f"manifest_{s}.json") for s in steps)


def test_action_repeat_other_than_one_is_refused_on_both_loops(tmp_path):
    """The host trainer and the on-device loop build their env with the
    run's ``--action-repeat``, which the ported envs refuse unless 1."""
    from d4pg_tpu_torch.config import TrainConfig
    from d4pg_tpu_torch.runtime.on_device import OnDeviceRun
    from d4pg_tpu_torch.runtime.trainer import Trainer

    cfg = TrainConfig(env="halfcheetah", action_repeat=2, log_dir=str(tmp_path))
    for entry in (Trainer, OnDeviceRun):
        with pytest.raises(ValueError, match="--action-repeat is only supported for dmc:/dmc_pixels: envs"):
            entry(cfg, device="cpu")


@pytest.mark.parametrize("flags,expect", [
    (["--replay-placement", "device"], "on_device_placement: --replay-placement configures the HOST "
                                       "trainer's data plane"),
    (["--dp", "3"], "num_envs (2) must be divisible by mesh axis 'dp' size 3"),
    (["--critic-head", "quantile"], "invalid choice: 'quantile'"),
], ids=["placement", "dp", "critic_head"])
def test_cli_on_device_refusals(flags, expect, tmp_path):
    out = _run(SMALL + ["--total-steps", "64", "--log-dir", str(tmp_path), *flags], timeout=120)
    assert out.returncode != 0
    assert expect in out.stderr, out.stderr[-2000:]
    assert not os.path.exists(tmp_path / "metrics.jsonl")
