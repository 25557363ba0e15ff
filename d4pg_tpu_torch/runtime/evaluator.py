"""Greedy-policy evaluation (counterpart of ``d4pg_tpu/runtime/evaluator.py``).

All episodes run in parallel as one batch of envs on the actor's device;
an episode's return stops accumulating at its first termination or
truncation. An env that declares ``reports_success`` (a goal env, where
termination means the goal was reached) also gets ``success_rate``: the
share of episodes that terminated before truncation.

:class:`GreedyEval` holds the episode batch in tensors of its own and
splits an evaluation into two bodies, the reset and one greedy step
(act, ``env.step``, the return, done and success accumulators), each IN
PLACE on those tensors. :func:`evaluate` runs them eagerly. With
``compiled`` (the on-device loop, the counterpart of the JAX package's
jitted evaluator) each body is a compiled program (``utils/graphs.py``):
on the card a CUDA graph, the step's replayed T times, the reset's
drawing from the eval generator, which is registered with it. The
returns are read back once, after the last step.
"""

from __future__ import annotations

from typing import Optional

import torch

from d4pg_tpu_torch.agent import D4PGConfig, act_deterministic
from d4pg_tpu_torch.runtime.collect import copy_into
from d4pg_tpu_torch.utils import graphs


def _device_of(actor: torch.nn.Module) -> torch.device:
    head = getattr(actor, "out", None)  # a tp actor holds its layers in its lanes
    return head.weight.device if head is not None else next(actor.parameters()).device


class GreedyEval:
    """``num_episodes`` greedy episodes of at most ``max_steps`` steps
    (default: the env's episode limit) of ``actor`` on ``env``, reset
    from ``generator``. :meth:`run` returns the mean and (population)
    standard deviation of their returns; ``returns`` holds them, on the
    actor's device."""

    def __init__(self, config: D4PGConfig, env, actor: torch.nn.Module,
                 generator: torch.Generator, num_episodes: int = 10,
                 max_steps: Optional[int] = None, compiled: bool = False):
        self.config = config
        self.env = env
        self.actor = actor
        self.generator = generator
        self.num_episodes = num_episodes
        self.steps = max_steps or env.max_episode_steps
        self.device = _device_of(actor)
        # the episode batch, made by the first reset and overwritten by
        # every later one
        self.state = self.obs = None
        self.returns = self.done = self.success = None
        self.reset, self.step = self._reset_body, self._step_body
        if compiled:
            self.reset = graphs.Program("eval_reset", self._reset_body, self.device,
                                        state=self.tensors, generators=(generator,))
            self.step = graphs.Program(
                "eval_step", self._step_body, self.device,
                state=lambda: graphs.module_tensors(actor) + self.tensors())

    def tensors(self) -> list:
        """The episode batch's tensors (none before the first reset)."""
        if self.obs is None:
            return []
        return [*self.state, self.obs, self.returns, self.done, self.success]

    @torch.no_grad()
    def _reset_body(self) -> None:
        state, obs = self.env.reset(self.num_episodes, self.generator, self.device)
        if self.obs is None:
            self.state, self.obs = state, obs
            self.returns, self.done, self.success = (
                torch.zeros(self.num_episodes, device=self.device) for _ in range(3))
            return
        copy_into(self.state, state)
        self.obs.copy_(obs)
        for t in (self.returns, self.done, self.success):
            t.zero_()

    @torch.no_grad()
    def _step_body(self) -> None:
        action = act_deterministic(self.config, self.actor, self.obs)
        state, obs, r, term, trunc = self.env.step(self.state, action)
        live = 1.0 - self.done
        self.returns.copy_(self.returns + r * live)
        self.success.copy_(torch.maximum(self.success, term * live))
        self.done.copy_(torch.maximum(self.done, torch.maximum(term, trunc)))
        copy_into(self.state, state)
        self.obs.copy_(obs)

    def run(self) -> dict:
        self.reset()
        for _ in range(self.steps):
            self.step()
        rets = self.returns.cpu()
        out = {
            "eval_return_mean": float(rets.mean()),
            "eval_return_std": float(rets.std(unbiased=False)),
        }
        if getattr(self.env, "reports_success", False):
            out["success_rate"] = float(self.success.mean())
        return out


def evaluate(
    config: D4PGConfig,
    env,
    actor: torch.nn.Module,
    generator: torch.Generator,
    num_episodes: int = 10,
    max_steps: Optional[int] = None,
) -> dict:
    """Run ``num_episodes`` greedy episodes of at most ``max_steps`` steps
    (default: the env's episode limit) eagerly; returns the mean and
    (population) standard deviation of their returns."""
    return GreedyEval(config, env, actor, generator, num_episodes, max_steps).run()
