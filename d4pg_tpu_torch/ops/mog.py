"""Mixture-of-Gaussians distributional Bellman operator (the port's own
copy of ``d4pg_tpu/ops/mog.py``).

The mixture head has no fixed support, so the Bellman target distribution

    T Z'(s, a) = r + γ_eff · Z'(s', μ'(s'))

is represented exactly by the affine component transform
``N(m_j, s_j) → N(r + d·m_j, d·s_j)`` and fitted by minimising the
cross-entropy ``H(T Z', Z_online)``, evaluated with Gauss-Hermite
quadrature per target component: deterministic, differentiable and exact
for integrands polynomial up to degree 2Q−1.

Terminal transitions (d = 0) collapse every component to the point mass
at ``r``; the std floor ``_STD_FLOOR`` keeps the quadrature finite there
(the loss then reduces to the NLL of ``r``).

Plain PyTorch: the JAX package computes this in XLA, outside any Pallas
kernel.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from d4pg_tpu_torch.models.critic import mixture_gaussian_params

_STD_FLOOR = 1e-3


@functools.lru_cache(maxsize=None)
def _hermite(q: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The Q Gauss-Hermite nodes and their weights λ/√π as float32 on
    ``device``, made once per (Q, device): the copy from the host
    synchronises, so a steady-state dispatch under
    ``set_sync_debug_mode("error")`` finds them made."""
    nodes, lam = np.polynomial.hermite.hermgauss(q)
    return (torch.as_tensor(nodes, dtype=torch.float32, device=device),
            torch.as_tensor(lam / np.sqrt(np.pi), dtype=torch.float32, device=device))


def mog_bellman_targets(
    target_head: torch.Tensor,
    reward: torch.Tensor,
    discount: torch.Tensor,
    num_mixtures: int,
    quadrature_points: int = 8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Quadrature representation of T Z' = r + γ_eff·Z'.

    Args:
      target_head: [B, 3M] raw mixture head of the TARGET critic at
        (s', μ'(s')).
      reward: [B] n-step return prefix.
      discount: [B] γ^m·(1−terminal).

    Returns:
      (y_nodes [B, M, Q], node_w [B, M, Q]): evaluation points of the
      target distribution and their probability weights (node_w sums to 1
      over (M, Q)), both detached: the target side carries no gradient.
    """
    log_wt, m_t, s_t = mixture_gaussian_params(target_head, num_mixtures)
    d = discount[:, None]
    m_proj = reward[:, None] + d * m_t                       # [B, M]
    s_proj = torch.clamp_min(d * s_t, _STD_FLOOR)            # [B, M]
    # ∫N(z; m, s)·f(z)dz ≈ Σ_q λ_q/√π · f(m + √2·s·x_q)
    nodes, lam = _hermite(quadrature_points, target_head.device)
    y_nodes = m_proj[..., None] + math.sqrt(2.0) * s_proj[..., None] * nodes
    node_w = torch.exp(log_wt)[..., None] * lam
    return y_nodes.detach(), node_w.detach()


def mog_log_prob(head: torch.Tensor, y: torch.Tensor, num_mixtures: int) -> torch.Tensor:
    """log p(y) under the mixture head, broadcast over the trailing axes
    of y: head [B, 3M], y [B, ...] → [B, ...]. A stacked head [E, B, 3M]
    gives every member's [E, B, ...] against the same y (the JAX vmap over
    members with y shared)."""
    log_w, means, stds = mixture_gaussian_params(head, num_mixtures)
    shape = head.shape[:-1] + (1,) * (y.ndim - 1) + (num_mixtures,)
    log_w, means, stds = (t.reshape(shape) for t in (log_w, means, stds))
    z = (y[..., None] - means) / stds
    log_comp = log_w - 0.5 * z**2 - torch.log(stds) - 0.5 * math.log(2.0 * math.pi)
    return torch.logsumexp(log_comp, dim=-1)


def mog_cross_entropy(
    online_head: torch.Tensor, y_nodes: torch.Tensor, node_w: torch.Tensor, num_mixtures: int
) -> torch.Tensor:
    """Per-sample H(T Z', Z_online) ≈ −Σ_{j,q} w_{jq}·log p_online(y_{jq}):
    [B], or [E, B] for a stacked head."""
    log_p = mog_log_prob(online_head, y_nodes, num_mixtures)  # [B, M, Q]
    return -(node_w * log_p).sum(dim=(-2, -1))
