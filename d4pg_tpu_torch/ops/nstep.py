"""n-step return windows over trajectory chunks (counterpart of
``d4pg_tpu/ops/nstep.py``), batched over any leading axes."""

from __future__ import annotations

import torch


def nstep_returns(
    rewards: torch.Tensor,
    dones: torch.Tensor,
    gamma: float,
    n: int,
    truncations: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-timestep n-step discounted return windows along the LAST axis.

    For each t: R_t = Σ_{k<m_t} γᵏ r_{t+k}, where the window length
    m_t ≤ n stops at a termination (no bootstrap), at a truncation or at
    the chunk end (bootstrap kept: the episode continues elsewhere).

    Args:
      rewards, dones, truncations: [..., T] float tensors.

    Returns:
      (returns [..., T], boot_discounts [..., T], boot_offsets [..., T] int32):
      ``boot_discounts[t]`` multiplies the bootstrap distribution at
      ``s_{t + boot_offsets[t]}``; it is 0 when the window hit a terminal.
    """
    T = rewards.shape[-1]
    if truncations is None:
        truncations = torch.zeros_like(dones)
    t_idx = torch.arange(T, device=rewards.device)
    returns = torch.zeros_like(rewards)
    cont = torch.ones_like(rewards)      # window still accumulating at step k
    not_term = torch.ones_like(rewards)  # no terminal among consumed steps
    m = torch.zeros_like(rewards)        # consumed window length
    for k in range(n):
        in_range = (t_idx + k < T).to(rewards.dtype)
        r_k = torch.roll(rewards, -k, dims=-1)
        d_k = torch.roll(dones, -k, dims=-1)
        stop_k = (d_k + torch.roll(truncations, -k, dims=-1)).clamp(0.0, 1.0)
        take = cont * in_range
        returns = returns + take * (gamma**k) * r_k
        m = m + take
        not_term = not_term * (1.0 - take * d_k)
        cont = take * (1.0 - stop_k)
    boot_discounts = not_term * torch.pow(gamma, m)
    return returns, boot_discounts, m.to(torch.int32)
