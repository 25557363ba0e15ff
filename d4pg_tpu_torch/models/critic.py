"""Distributional critic (counterpart of ``d4pg_tpu/models/critic.py``).

State through the first layer, the action concatenated after it, the
remaining ReLU layers, then the categorical (C51) head, which emits float32
LOGITS with atoms in the last axis. Hidden layers are fan-in initialised,
the head at U[0, 3e-4). Only the categorical head is ported; the scalar and
mixture-of-Gaussians heads wait for ROADMAP A10.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
from torch import nn

from d4pg_tpu_torch.models.init import fanin_uniform_, small_uniform_


@dataclass(frozen=True)
class DistConfig:
    """Critic-head configuration (the reference's fields for the
    categorical head; the mixture head's wait with it for ROADMAP A10)."""

    kind: str = "categorical"  # only "categorical" is ported
    num_atoms: int = 51
    v_min: float = -10.0
    v_max: float = 10.0

    @property
    def head_dim(self) -> int:
        if self.kind != "categorical":
            raise NotImplementedError(
                f"critic head {self.kind!r} is not ported yet (ROADMAP A10); "
                "the port has the categorical head only"
            )
        return self.num_atoms


class Critic(nn.Module):
    def __init__(
        self,
        obs_dim: int,
        action_dim: int,
        dist: DistConfig = DistConfig(),
        hidden_sizes: Sequence[int] = (256, 256, 256),
        final_init_scale: float = 3e-4,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.num_hidden = len(hidden_sizes)
        width = obs_dim
        for i, h in enumerate(hidden_sizes):
            # The action joins after the first, state-only layer.
            self.add_module(f"hidden_{i}", nn.Linear(width + (action_dim if i == 1 else 0), h))
            width = h
        if self.num_hidden == 1:
            width += action_dim
        self.out = nn.Linear(width, dist.head_dim)
        if generator is not None:
            for i in range(self.num_hidden):
                fanin_uniform_(self.get_submodule(f"hidden_{i}"), generator)
            small_uniform_(self.out, final_init_scale, generator)

    def forward(self, obs: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.hidden_0(obs))
        x = torch.cat([x, action], dim=-1)
        for i in range(1, self.num_hidden):
            x = torch.relu(self.get_submodule(f"hidden_{i}")(x))
        return self.out(x)
