"""Train state and algorithm configuration (counterpart of
``d4pg_tpu/agent/state.py``).

``D4PGConfig`` keeps the reference's field names and defaults for what
the port carries, except ``projection_backend``, whose ladder the port
names in its own words (see the field). :func:`check_supported` refuses
an unknown head, critic stack, compute dtype or projection, and a
``pixel_shape`` that does not match ``obs_dim``.

The JAX ``TrainState`` is an immutable pytree; here it is a small class
that owns the four networks and the two optimizers, updated in place by
:func:`d4pg_tpu_torch.agent.d4pg.train_step`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from d4pg_tpu_torch.models.critic import HEAD_KINDS, DistConfig


@dataclass(frozen=True)
class D4PGConfig:
    obs_dim: int = 3
    action_dim: int = 1
    hidden_sizes: tuple = (256, 256, 256)
    # (H, W, C) of a pixel env's frames, which travel flattened as obs_dim
    # = H·W·C floats in [0, 1]; the actor and the critic conv-encode them
    # (models/encoders.py) into encoder_embed_dim features. None: flat obs.
    pixel_shape: tuple | None = None
    encoder_embed_dim: int = 50
    # DrQ random shift of the pixel batches inside the train step
    # (ops/augment.py): each of obs and next_obs shifted by up to
    # ±augment_pad pixels, edges replicated. 0 disables.
    augment_pad: int = 4
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
    # "float32" | "bfloat16": bf16 activations through the actor and
    # critic trunks; master weights, Adam moments, Polyak targets and every
    # loss reduction stay float32 (the critic head returns float32)
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
    # Twin critics with a clipped-min target: two critics stacked on a
    # leading [2] axis, the Bellman backup taking, per sample, the whole
    # distribution of the target critic with the smaller mean; the actor
    # trains against critic 0 (TD3's convention).
    twin_critic: bool = False
    # A REDQ critic ensemble of E >= 2 stacked critics (0 disables): each
    # target is the per-sample argmin-mean member of a random subset of
    # ensemble_min_targets target critics, redrawn every grad step; the
    # actor ascends the ensemble mean. Exclusive with twin_critic.
    critic_ensemble: int = 0
    ensemble_min_targets: int = 2


def stacked_critics(config: D4PGConfig) -> int:
    """Leading critic-stack size: 2 (twin), E (ensemble), or 0 (single).

    Twin and ensemble are mutually exclusive — the ensemble subsumes the
    twin (E=2, M=2 is exactly clipped double-Q with a per-step subset
    redraw that happens to always pick both)."""
    if config.critic_ensemble:
        if config.twin_critic:
            raise ValueError(
                "critic_ensemble and twin_critic are mutually exclusive: "
                "an E=2, ensemble_min_targets=2 ensemble IS the twin"
            )
        if config.critic_ensemble < 2:
            raise ValueError(
                f"critic_ensemble must be >= 2 (got "
                f"{config.critic_ensemble}); 0 disables"
            )
        if not 1 <= config.ensemble_min_targets <= config.critic_ensemble:
            raise ValueError(
                f"ensemble_min_targets must be in [1, critic_ensemble="
                f"{config.critic_ensemble}], got {config.ensemble_min_targets}"
            )
        return config.critic_ensemble
    return 2 if config.twin_critic else 0


COMPUTE_DTYPES = ("float32", "bfloat16")


def check_supported(config: D4PGConfig) -> None:
    """Raise ``ValueError`` for an unknown head, an illegal critic stack,
    compute dtype or projection backend, or a ``pixel_shape`` that is not
    (H, W, C) with H·W·C = ``obs_dim``."""
    if config.pixel_shape:
        shape = tuple(config.pixel_shape)
        if len(shape) != 3 or shape[0] * shape[1] * shape[2] != config.obs_dim:
            raise ValueError(
                f"pixel_shape {shape} must be (H, W, C) with H*W*C == obs_dim "
                f"({config.obs_dim})"
            )
    if config.dist.kind not in HEAD_KINDS:
        raise ValueError(f"unknown critic head kind: {config.dist.kind}")
    stacked_critics(config)
    if config.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(
            f"compute_dtype must be one of {COMPUTE_DTYPES}, got {config.compute_dtype!r}"
        )
    if config.projection_backend not in ("fused", "projection"):
        raise ValueError(
            "projection_backend must be 'fused' or 'projection', got "
            f"{config.projection_backend!r}"
        )
    if config.priority_kind not in ("ce", "overlap"):
        raise ValueError(f"unknown priority_kind {config.priority_kind!r}")


class TrainState:
    """The learner's networks, targets and optimizers, plus the step count.

    ``stack`` records the critic configuration the state was built for
    (``twin_critic``, ``critic_ensemble``, ``compute_dtype``), which a
    checkpoint carries so that a resume under another one is refused.
    ``head`` records the critic head (kind, and M for the mixture head),
    which the checkpoint also carries: a MoG head of M = 17 is as wide as
    the 51-atom categorical one, so the ``out`` layer's shape cannot tell
    them apart. ``subset_gen`` is the device generator of the REDQ target
    subsets (``None`` without an ensemble) and ``augment_gen`` the device
    generator of the DrQ shift offsets (``None`` without pixels or with
    ``augment_pad`` 0): the two uses the JAX ``TrainState.key`` has here.
    Both are checkpointed, so a resumed run continues their streams."""

    def __init__(self, actor, critic, target_actor, target_critic, actor_opt, critic_opt,
                 stack=None, subset_gen=None, head=None, augment_gen=None):
        self.actor = actor
        self.critic = critic
        self.target_actor = target_actor
        self.target_critic = target_critic
        self.actor_opt = actor_opt
        self.critic_opt = critic_opt
        self.stack = dict(stack or STACK_DEFAULTS)
        self.subset_gen = subset_gen
        self.augment_gen = augment_gen
        self.head = dict(head or HEAD_DEFAULTS)
        self.step = 0


# The critic configuration of a state built before stacks existed.
STACK_DEFAULTS = {"twin_critic": False, "critic_ensemble": 0, "compute_dtype": "float32"}


def stack_of(config: D4PGConfig) -> dict:
    return {k: getattr(config, k) for k in STACK_DEFAULTS}


# The critic head of a state built before the other heads existed.
HEAD_DEFAULTS = {"critic_head": "categorical", "num_mixtures": 0}


def head_of(config: D4PGConfig) -> dict:
    """The head record: the kind, and M for the mixture head (else 0)."""
    mog = config.dist.kind == "mixture_gaussian"
    return {"critic_head": config.dist.kind, "num_mixtures": config.dist.num_mixtures if mog else 0}
