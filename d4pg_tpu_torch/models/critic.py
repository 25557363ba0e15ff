"""Distributional critic (counterpart of ``d4pg_tpu/models/critic.py``).

State through the first layer, the action concatenated after it, the
remaining ReLU layers, then the categorical (C51) head, which emits float32
LOGITS with atoms in the last axis. Hidden layers are fan-in initialised,
the head at U[0, 3e-4). Only the categorical head is ported; the scalar and
mixture-of-Gaussians heads wait for ROADMAP A10.

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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
from torch import nn

from d4pg_tpu_torch.models.init import dense, fanin_uniform_, small_uniform_


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
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
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
        dt = self.compute_dtype
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
        x = torch.relu(self.hidden_0(obs, dt, member))
        a = action.to(dt)
        x = torch.cat([x, a.expand(x.shape[:-1] + a.shape[-1:])], dim=-1)
        for i in range(1, self.num_hidden):
            x = torch.relu(self.get_submodule(f"hidden_{i}")(x, dt, member))
        return self.out(x, dt, member).float()
