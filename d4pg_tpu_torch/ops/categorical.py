"""Categorical (C51) distributional Bellman math on tensors.

Counterpart of ``d4pg_tpu/ops/categorical.py``: the same support
bookkeeping, the same one-hot projection Φ(r + γ_eff·z) (the oracle the
CUDA kernels in :mod:`d4pg_tpu_torch.ops.cuda_projection` are held to),
expected value and the log-softmax cross-entropy. The critic emits logits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class CategoricalSupport(NamedTuple):
    """The fixed atom grid z of a categorical value distribution."""

    v_min: float
    v_max: float
    num_atoms: int

    @property
    def delta(self) -> float:
        return (self.v_max - self.v_min) / (self.num_atoms - 1)

    def atoms(self, device=None, dtype=torch.float32) -> torch.Tensor:
        return torch.linspace(
            self.v_min, self.v_max, self.num_atoms, device=device, dtype=dtype
        )


def make_support(v_min: float, v_max: float, num_atoms: int) -> CategoricalSupport:
    if num_atoms < 2:
        raise ValueError(f"num_atoms must be >= 2, got {num_atoms}")
    if not v_max > v_min:
        raise ValueError(f"need v_max > v_min, got [{v_min}, {v_max}]")
    return CategoricalSupport(float(v_min), float(v_max), int(num_atoms))


def categorical_projection(
    support: CategoricalSupport,
    target_probs: torch.Tensor,
    rewards: torch.Tensor,
    discounts: torch.Tensor,
) -> torch.Tensor:
    """m = Φ(r + d·z) by the floor/ceil split written as one-hot products.

    ``target_probs`` [B, A], ``rewards``/``discounts`` [B] (discount already
    folds in termination and the n-step exponent). Returns [B, A].
    """
    z = support.atoms(target_probs.device, target_probs.dtype)
    tz = rewards[:, None] + discounts[:, None] * z[None, :]
    tz = tz.clamp(support.v_min, support.v_max)
    b = (tz - support.v_min) / support.delta
    lower = torch.floor(b)
    upper = torch.ceil(b)
    # b exactly on an atom: both split weights vanish, so route the full
    # mass to that atom (the reference's l == u fixup).
    w_lower = torch.where(lower == upper, torch.ones_like(b), upper - b)
    w_upper = b - lower
    n = support.num_atoms
    onehot_l = F.one_hot(lower.long(), n).to(target_probs.dtype)
    onehot_u = F.one_hot(upper.long(), n).to(target_probs.dtype)
    weights = w_lower[..., None] * onehot_l + w_upper[..., None] * onehot_u
    return torch.einsum("ba,baj->bj", target_probs, weights)


def expected_value(support: CategoricalSupport, probs: torch.Tensor) -> torch.Tensor:
    """E[Z] = Σ p_i z_i along the last axis."""
    return probs @ support.atoms(probs.device, probs.dtype)


def categorical_td_loss(
    pred_logits: torch.Tensor,
    target_probs: torch.Tensor,
    weights: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy between a projected target and the predicted logits.

    Returns (scalar mean loss, [B] per-sample CE).
    """
    log_p = F.log_softmax(pred_logits, dim=-1)
    per_sample = -(target_probs * log_p).sum(-1)
    if weights is None:
        return per_sample.mean(), per_sample
    return (weights * per_sample).mean(), per_sample
