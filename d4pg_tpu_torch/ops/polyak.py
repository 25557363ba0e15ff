"""Target-network updates (counterpart of ``d4pg_tpu/ops/polyak.py``)."""

from __future__ import annotations

import torch


@torch.no_grad()
def polyak_update(target: torch.nn.Module, online: torch.nn.Module, tau: float) -> None:
    """θ' ← θ' + τ(θ − θ') = (1−τ)θ' + τθ, IN PLACE on the target's
    parameters (one ``torch._foreach_lerp_`` over all of them). The JAX
    package returns a new pytree; updating in place saves a copy of every
    target parameter per step. tau=1.0 is the hard copy."""
    torch._foreach_lerp_(
        list(target.parameters()), list(online.parameters()), float(tau)
    )
