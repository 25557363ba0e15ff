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

With ``pixel_shape`` (H, W, C) the flattened observations go through a
:class:`~d4pg_tpu_torch.models.encoders.PixelEncoder` (``PixelEncoder_0``,
the Flax submodule's name) first, and the trunk reads its
``encoder_embed_dim``-wide embedding.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from d4pg_tpu_torch.models.encoders import PixelEncoder
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
        pixel_shape: Sequence[int] | None = None,
        encoder_embed_dim: int = 50,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.num_hidden = len(hidden_sizes)
        self.pixels = bool(pixel_shape)
        width = obs_dim
        if self.pixels:
            self.PixelEncoder_0 = PixelEncoder(
                pixel_shape, encoder_embed_dim, generator, compute_dtype)
            width = encoder_embed_dim
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
        x = self.PixelEncoder_0(obs) if self.pixels else obs
        for i in range(self.num_hidden):
            x = torch.relu(dense(self.get_submodule(f"hidden_{i}"), x, dt))
        return torch.tanh(dense(self.out, x, dt)).float()
