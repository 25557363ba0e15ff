"""End to end: the port's learner demonstrably learns Pendulum on the CPU,
at the bar of ``tests/test_integration.py::test_d4pg_learns_pendulum``
(the same recipe: 6000 grad steps after a 2000-env-step warmup, 8 envs,
B = 128, tau 0.005, lr 5e-4, a (64, 64) trunk, 2 env steps a train step).
The trained policy must beat a random-init one by more than 250 and the
critic loss must fall under 1.15."""

import dataclasses

import pytest
import torch

from d4pg_tpu_torch.agent import create_train_state
from d4pg_tpu_torch.envs import make_env
from d4pg_tpu_torch.runtime.evaluator import evaluate
from d4pg_tpu_torch.runtime.trainer import Trainer
from d4pg_tpu_torch.train import build_parser, config_from_args


@pytest.mark.slow
def test_d4pg_learns_pendulum(tmp_path):
    args = build_parser().parse_args([
        "--device", "cpu", "--env", "pendulum", "--total-steps", "6000", "--warmup", "2000",
        "--eval-interval", "2000", "--checkpoint-interval", "1000000", "--num-envs", "8",
        "--bsize", "128", "--n-step", "3", "--tau", "0.005", "--lr-actor", "5e-4",
        "--lr-critic", "5e-4", "--seed", "0", "--log-dir", str(tmp_path / "integ"),
    ])
    cfg = config_from_args(args)
    cfg = dataclasses.replace(
        cfg, agent=dataclasses.replace(cfg.agent, hidden_sizes=(64, 64)),
        env_steps_per_train_step=2.0,
    )
    trainer = Trainer(cfg, device="cpu")
    env = make_env("pendulum")
    env.max_episode_steps = trainer.config.max_episode_steps
    base_state = create_train_state(trainer.config.agent, 123, "cpu")
    base = evaluate(trainer.config.agent, env, base_state.actor, torch.Generator().manual_seed(7), 10)
    out = trainer.train()
    trainer.close()
    trained = evaluate(trainer.config.agent, env, trainer.state.actor,
                       torch.Generator().manual_seed(7), 10)
    improvement = trained["eval_return_mean"] - base["eval_return_mean"]
    assert improvement > 250.0, (
        f"no learning: random {base['eval_return_mean']:.0f} -> "
        f"trained {trained['eval_return_mean']:.0f}"
    )
    assert out["critic_loss"] < 1.15, f"critic did not converge: {out['critic_loss']}"
