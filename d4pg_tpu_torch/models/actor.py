"""Deterministic policy network (counterpart of ``d4pg_tpu/models/actor.py``).

MLP with ReLU between every hidden layer and a tanh output in (−1, 1);
hidden layers fan-in initialised, the output layer at U[0, 3e-3). Layers
are named ``hidden_<i>`` and ``out`` like the Flax module's, so a Flax
param tree maps onto the ``state_dict`` by name (:mod:`d4pg_tpu_torch.weights`).
The compute dtype is float32 or bfloat16 (the JAX package's
``compute_dtype``): under bfloat16 every layer casts its input and its
float32 master parameters to bfloat16 (:func:`~d4pg_tpu_torch.models.init.
dense`), ReLU and tanh run in bfloat16, and the action comes back as
float32, as the Flax module's ``jnp.tanh(x).astype(jnp.float32)``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from d4pg_tpu_torch.models.init import dense, fanin_uniform_, small_uniform_


class Actor(nn.Module):
    def __init__(
        self,
        obs_dim: int,
        action_dim: int,
        hidden_sizes: Sequence[int] = (256, 256, 256),
        final_init_scale: float = 3e-3,
        generator: torch.Generator | None = None,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
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
        dt = self.compute_dtype
        x = obs
        for i in range(self.num_hidden):
            x = torch.relu(dense(self.get_submodule(f"hidden_{i}"), x, dt))
        return torch.tanh(dense(self.out, x, dt)).float()
