"""Distributional critic (counterpart of ``d4pg_tpu/models/critic.py``).

State through the first layer, the action concatenated after it, the
remaining ReLU layers, then a float32 value head of one of three kinds
(``DistConfig.kind``): the categorical (C51) head's LOGITS with atoms in
the last axis, a scalar Q (plain DDPG), or the mixture-of-Gaussians head's
[logits | means | log-stds] blocks of M components each. Hidden layers are
fan-in initialised, the head at U[0, 3e-4); the MoG head's bias adds its
component means spread over [v_min, v_max] and log-stds at one bin width
(:func:`mog_bias_offsets`), as the JAX package initialises it.

Under the bfloat16 compute dtype every layer runs as the Flax
``Dense(dtype=bfloat16, param_dtype=float32)`` does
(:func:`~d4pg_tpu_torch.models.init.dense`), the action is cast to
bfloat16 before the concat, and the head's logits come back as float32.

:class:`StackedCritic` is E such critics whose parameters carry a leading
[E] axis (twin critics: E = 2; a REDQ ensemble: E members), the JAX
package's critic pytree stacked along its first axis: kernels [E, in, out]
and biases [E, out] in the Flax layout. Its forward runs every member in
one batched product a layer, obs and action shared across members as under
``vmap`` with unbatched inputs.

With ``pixel_shape`` each critic conv-encodes the flattened observations
before its first layer (``PixelEncoder_0``, as the actor does); a
:class:`StackedCritic` stacks its members' encoders too (the JAX package
stacks E whole critics) and runs them one member after the other,
feeding their [E, B, embed] embeddings to the batched trunk.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
from torch import nn

from d4pg_tpu_torch.models.encoders import PixelEncoder, StackedPixelEncoder
from d4pg_tpu_torch.models.init import dense, fanin_uniform_, small_uniform_


HEAD_KINDS = ("categorical", "scalar", "mixture_gaussian")


@dataclass(frozen=True)
class DistConfig:
    """Critic-head configuration (the JAX ``DistConfig``'s fields)."""

    kind: str = "categorical"  # "categorical" | "scalar" | "mixture_gaussian"
    num_atoms: int = 51
    v_min: float = -10.0
    v_max: float = 10.0
    num_mixtures: int = 5
    # Gauss-Hermite nodes per target component of the MoG Bellman
    # cross-entropy (ops/mog.py)
    quadrature_points: int = 8

    @property
    def head_dim(self) -> int:
        if self.kind == "categorical":
            return self.num_atoms
        if self.kind == "scalar":
            return 1
        if self.kind == "mixture_gaussian":
            return 3 * self.num_mixtures
        raise ValueError(f"unknown critic head kind: {self.kind}")


def mog_bias_offsets(dist: DistConfig) -> torch.Tensor:
    """What the MoG head's bias init adds to its U[0, scale) draw, [3M]
    float32: 0 on the logits, the centers ``v_min + (j + 0.5)·span/M`` on
    the means and ``log(span/M)`` on the log-stds (float32 arithmetic in
    the JAX package's order)."""
    m = dist.num_mixtures
    span = dist.v_max - dist.v_min
    centers = dist.v_min + (torch.arange(m, dtype=torch.float32) + 0.5) * span / m
    log_std = torch.log(torch.tensor(span / m, dtype=torch.float32))
    return torch.cat([torch.zeros(m), centers, log_std.expand(m)])


def mixture_gaussian_params(head: torch.Tensor, num_mixtures: int):
    """Split a mixture head [..., 3M] into (log-weights, means, stds):
    log-softmax of the logits, the means, ``exp(clip(log_std, -5, 5))``."""
    logits, means, log_stds = head.split(num_mixtures, dim=-1)
    return (torch.log_softmax(logits, dim=-1), means,
            torch.exp(log_stds.clamp(-5.0, 5.0)))


def mixture_gaussian_mean(head: torch.Tensor, num_mixtures: int) -> torch.Tensor:
    """E[Z] of the mixture head [..., 3M] → [...]."""
    log_w, means, _ = mixture_gaussian_params(head, num_mixtures)
    return (torch.exp(log_w) * means).sum(dim=-1)


class Critic(nn.Module):
    def __init__(
        self,
        obs_dim: int,
        action_dim: int,
        dist: DistConfig = DistConfig(),
        hidden_sizes: Sequence[int] = (256, 256, 256),
        final_init_scale: float = 3e-4,
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
            if dist.kind == "mixture_gaussian":
                with torch.no_grad():
                    self.out.bias.add_(mog_bias_offsets(dist))

    def forward(self, obs: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.pixels:
            obs = self.PixelEncoder_0(obs)
        x = torch.relu(dense(self.hidden_0, obs, dt))
        x = torch.cat([x, action.to(dt)], dim=-1)
        for i in range(1, self.num_hidden):
            x = torch.relu(dense(self.get_submodule(f"hidden_{i}"), x, dt))
        return dense(self.out, x, dt).float()


class StackedDense(nn.Module):
    """E Dense layers as one: ``kernel`` [E, in, out] and ``bias`` [E, out],
    the Flax layout with the stack axis first."""

    def __init__(self, kernel: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.kernel = nn.Parameter(kernel)
        self.bias = nn.Parameter(bias)

    def forward(self, x: torch.Tensor, dtype: torch.dtype, member: int | None = None):
        """x [B, in] (shared by the members) or [E, B, in] → [E, B, out];
        with ``member``, x [B, in] → that member's [B, out]. The bias is
        added as its own op after the product, rounded as
        :func:`~d4pg_tpu_torch.models.init.dense` rounds it."""
        kernel, bias = self.kernel, self.bias
        if member is None:
            bias = bias.unsqueeze(-2)
        else:
            kernel, bias = kernel[member], bias[member]
        return torch.matmul(x.to(dtype), kernel.to(dtype)) + bias.to(dtype)


class StackedCritic(nn.Module):
    """E critics stacked on a leading axis (twin critics, a REDQ ensemble).

    Built from E :class:`Critic` s, one per generator, each initialised as
    a single critic would be (the JAX package's E ``critic.init`` calls on
    split keys), then stacked. ``forward(obs, action)`` returns [E, B, A]
    logits; ``forward(obs, action, member=e)`` member e's [B, A] alone.
    """

    def __init__(self, members: Sequence[Critic]):
        super().__init__()
        first = members[0]
        self.num_members = len(members)
        self.num_hidden = first.num_hidden
        self.compute_dtype = first.compute_dtype
        self.pixels = first.pixels
        if self.pixels:
            self.PixelEncoder_0 = StackedPixelEncoder([m.PixelEncoder_0 for m in members])
        names = [f"hidden_{i}" for i in range(self.num_hidden)] + ["out"]
        for name in names:
            layers = [m.get_submodule(name) for m in members]
            self.add_module(name, StackedDense(
                torch.stack([layer.weight.detach().t() for layer in layers]),
                torch.stack([layer.bias.detach() for layer in layers]),
            ))

    def forward(
        self, obs: torch.Tensor, action: torch.Tensor, member: int | None = None
    ) -> torch.Tensor:
        dt = self.compute_dtype
        if self.pixels:  # [E, B, embed], or member's [B, embed]
            obs = self.PixelEncoder_0(obs, member)
        x = torch.relu(self.hidden_0(obs, dt, member))
        a = action.to(dt)
        x = torch.cat([x, a.expand(x.shape[:-1] + a.shape[-1:])], dim=-1)
        for i in range(1, self.num_hidden):
            x = torch.relu(self.get_submodule(f"hidden_{i}")(x, dt, member))
        return self.out(x, dt, member).float()
