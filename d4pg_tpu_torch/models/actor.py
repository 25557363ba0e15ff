"""Deterministic policy network (counterpart of ``d4pg_tpu/models/actor.py``).

MLP with ReLU between every hidden layer and a tanh output in (−1, 1);
hidden layers fan-in initialised, the output layer at U[0, 3e-3). Layers
are named ``hidden_<i>`` and ``out`` like the Flax module's, so a Flax
param tree maps onto the ``state_dict`` by name (:mod:`d4pg_tpu_torch.weights`).
Float32 only.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from d4pg_tpu_torch.models.init import fanin_uniform_, small_uniform_


class Actor(nn.Module):
    def __init__(
        self,
        obs_dim: int,
        action_dim: int,
        hidden_sizes: Sequence[int] = (256, 256, 256),
        final_init_scale: float = 3e-3,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.num_hidden = len(hidden_sizes)
        width = obs_dim
        for i, h in enumerate(hidden_sizes):
            self.add_module(f"hidden_{i}", nn.Linear(width, h))
            width = h
        self.out = nn.Linear(width, action_dim)
        if generator is not None:
            for i in range(self.num_hidden):
                fanin_uniform_(self.get_submodule(f"hidden_{i}"), generator)
            small_uniform_(self.out, final_init_scale, generator)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        x = obs
        for i in range(self.num_hidden):
            x = torch.relu(self.get_submodule(f"hidden_{i}")(x))
        return torch.tanh(self.out(x))
