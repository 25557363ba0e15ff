"""Where ``--batch-scale`` is applied: in the CLI, as the JAX package
applies it (``train.py:config_from_args``, after the env preset), never
in a trainer. A trainer built from code runs the batch its config names,
the JAX one and the port's alike, and a trainer built on another one's
config does not scale it again. Exact (integer fields)."""

import dataclasses

import pytest

import train as jtrain
from d4pg_tpu.agent import D4PGConfig as JConfig
from d4pg_tpu.config import TrainConfig as JTrainConfig
from d4pg_tpu.config import apply_env_preset as j_apply_env_preset
from d4pg_tpu.runtime.trainer import Trainer as JTrainer
from d4pg_tpu_torch.agent import D4PGConfig
from d4pg_tpu_torch.config import TrainConfig
from d4pg_tpu_torch.runtime.on_device import OnDeviceRun
from d4pg_tpu_torch.runtime.trainer import Trainer
from d4pg_tpu_torch.train import build_parser, config_from_args

KW = dict(env="pendulum", batch_size=8, steps_per_dispatch=8, warmup_steps=64, batch_scale=2,
          num_envs=2, replay_capacity=4096, eval_episodes=1, total_steps=8)


def _triple(cfg):
    return cfg.batch_size, cfg.steps_per_dispatch, cfg.warmup_steps


def test_trainers_built_from_code_keep_the_batch_of_the_config(tmp_path):
    jt = JTrainer(j_apply_env_preset(JTrainConfig(
        log_dir=str(tmp_path / "jax"), agent=JConfig(hidden_sizes=(8, 8)), **KW)))
    t = Trainer(TrainConfig(log_dir=str(tmp_path / "torch"), agent=D4PGConfig(hidden_sizes=(8, 8)),
                            **KW), device="cpu")
    try:
        assert _triple(t.config) == _triple(jt.config) == (8, 8, 64)
        assert (t.config.agent.lr_critic, t.config.agent.per_beta_steps) == (
            jt.config.agent.lr_critic, jt.config.agent.per_beta_steps)
        again = Trainer(dataclasses.replace(t.config, log_dir=str(tmp_path / "again")),
                        device="cpu")
        again.close()
        assert _triple(again.config) == (8, 8, 64)
    finally:
        jt.close()
        t.close()


def test_the_on_device_run_keeps_the_batch_of_the_config(tmp_path):
    run = OnDeviceRun(TrainConfig(log_dir=str(tmp_path), agent=D4PGConfig(hidden_sizes=(8, 8)),
                                  **KW), device="cpu")
    assert _triple(run.config) == (8, 8, 64)


@pytest.mark.parametrize("scale", ["1", "2", "8"])
def test_each_cli_scales_the_batch(scale):
    argv = ["--env", "pendulum", "--bsize", "8", "--steps-per-dispatch", "8", "--warmup", "64",
            "--batch-scale", scale]
    ours = config_from_args(build_parser().parse_args(argv))
    ref = jtrain.config_from_args(jtrain.build_parser().parse_args(argv))
    s = int(scale)
    assert _triple(ours) == _triple(ref) == (8 * s, max(1, 8 // s), 64 * s)
    for f in ("lr_actor", "lr_critic", "per_beta_steps"):
        assert getattr(ours.agent, f) == getattr(ref.agent, f), f
