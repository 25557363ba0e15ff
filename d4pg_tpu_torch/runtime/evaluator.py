"""Greedy-policy evaluation (counterpart of ``d4pg_tpu/runtime/evaluator.py``).

All episodes run in parallel as one batch of envs on the actor's device;
an episode's return stops accumulating at its first termination or
truncation. An env that declares ``reports_success`` (a goal env, where
termination means the goal was reached) also gets ``success_rate``: the
share of episodes that terminated before truncation.
"""

from __future__ import annotations

from typing import Optional

import torch

from d4pg_tpu_torch.agent import D4PGConfig, act_deterministic


@torch.no_grad()
def evaluate(
    config: D4PGConfig,
    env,
    actor: torch.nn.Module,
    generator: torch.Generator,
    num_episodes: int = 10,
    max_steps: Optional[int] = None,
) -> dict:
    """Run ``num_episodes`` greedy episodes of at most ``max_steps`` steps
    (default: the env's episode limit); returns the mean and (population)
    standard deviation of their returns."""
    T = max_steps or env.max_episode_steps
    head = getattr(actor, "out", None)  # a tp actor holds its layers in its lanes
    device = head.weight.device if head is not None else next(actor.parameters()).device
    state, obs = env.reset(num_episodes, generator, device)
    ret = torch.zeros(num_episodes, device=device)
    done = torch.zeros(num_episodes, device=device)
    succ = torch.zeros(num_episodes, device=device)
    for _ in range(T):
        action = act_deterministic(config, actor, obs)
        state, obs, r, term, trunc = env.step(state, action)
        ret = ret + r * (1.0 - done)
        succ = torch.maximum(succ, term * (1.0 - done))
        done = torch.maximum(done, torch.maximum(term, trunc))
    rets = ret.cpu()
    out = {
        "eval_return_mean": float(rets.mean()),
        "eval_return_std": float(rets.std(unbiased=False)),
    }
    if getattr(env, "reports_success", False):
        out["success_rate"] = float(succ.mean())
    return out
