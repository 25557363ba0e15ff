"""Train state and algorithm configuration (counterpart of
``d4pg_tpu/agent/state.py``).

``D4PGConfig`` keeps the reference's field names and defaults for what
the port carries, except ``projection_backend``, whose ladder the port
names in its own words (see the field). Of the options it does not carry
yet it keeps the ones a user sets (twin/ensemble critics, the head kind,
bf16, pixels); :func:`check_supported` refuses any value but the default.

The JAX ``TrainState`` is an immutable pytree; here it is a small class
that owns the four networks and the two optimizers, updated in place by
:func:`d4pg_tpu_torch.agent.d4pg.train_step`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from d4pg_tpu_torch.models.critic import DistConfig


@dataclass(frozen=True)
class D4PGConfig:
    obs_dim: int = 3
    action_dim: int = 1
    hidden_sizes: tuple = (256, 256, 256)
    pixel_shape: tuple | None = None  # not ported: must stay None
    dist: DistConfig = field(default_factory=DistConfig)
    gamma: float = 0.99
    n_step: int = 1
    tau: float = 0.001
    lr_actor: float = 1e-4
    lr_critic: float = 1e-4
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    noise_kind: str = "gaussian"  # "gaussian" | "ou"
    noise_epsilon: float = 0.3
    noise_sigma: float = 1.0
    ou_theta: float = 0.15
    ou_sigma: float = 0.2
    ou_mu: float = 0.0
    noise_decay_steps: int = 0
    noise_scale_final: float = 0.1
    random_eps: float = 0.0
    action_l2: float = 0.0
    per_alpha: float = 0.6
    per_beta0: float = 0.4
    per_beta_steps: int = 100_000
    per_eps: float = 1e-6
    priority_kind: str = "ce"  # "ce" | "overlap"
    compute_dtype: str = "float32"
    # Categorical projection implementation:
    #   "fused"      — ONE kernel for projection + log-softmax CE + the
    #                  priority signals, forward and backward; m never
    #                  reaches device memory (the reference's "pallas_fused");
    #   "projection" — the projection-only kernel, then the CE in torch
    #                  (the reference's "pallas").
    # On CUDA tensors these run the hand-written kernels, on CPU tensors
    # their plain PyTorch versions.
    projection_backend: str = "fused"
    # not ported: must stay at these defaults (check_supported)
    twin_critic: bool = False
    critic_ensemble: int = 0


def check_supported(config: D4PGConfig) -> None:
    """Raise ``NotImplementedError`` for an option this slice of the port
    does not carry, naming the ROADMAP item it waits for."""
    gaps = [
        (config.twin_critic, "twin critics (ROADMAP A10)"),
        (config.critic_ensemble, "critic ensembles (ROADMAP A10)"),
        (config.dist.kind != "categorical", f"the {config.dist.kind!r} critic head (ROADMAP A10)"),
        (config.compute_dtype != "float32", f"compute_dtype={config.compute_dtype!r} (ROADMAP A3)"),
        (config.pixel_shape, "pixel observations (ROADMAP A10)"),
    ]
    for present, what in gaps:
        if present:
            raise NotImplementedError(f"{what} is not ported to d4pg_tpu_torch yet")
    if config.projection_backend not in ("fused", "projection"):
        raise ValueError(
            "projection_backend must be 'fused' or 'projection', got "
            f"{config.projection_backend!r}"
        )
    if config.priority_kind not in ("ce", "overlap"):
        raise ValueError(f"unknown priority_kind {config.priority_kind!r}")


class TrainState:
    """The learner's networks, targets and optimizers, plus the step count."""

    def __init__(self, actor, critic, target_actor, target_critic, actor_opt, critic_opt):
        self.actor = actor
        self.critic = critic
        self.target_actor = target_actor
        self.target_critic = target_critic
        self.actor_opt = actor_opt
        self.critic_opt = critic_opt
        self.step = 0
