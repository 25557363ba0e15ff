from d4pg_tpu_torch.agent.d4pg import (
    act,
    act_deterministic,
    create_train_state,
    exploration_mixture,
    fused_train_scan,
    gather_batches,
    make_noise,
    make_optimizers,
    noisy_explore,
    support_of,
    train_step,
)
from d4pg_tpu_torch.agent.state import D4PGConfig, TrainState
from d4pg_tpu_torch.models.critic import DistConfig

__all__ = [
    "D4PGConfig",
    "DistConfig",
    "TrainState",
    "act",
    "act_deterministic",
    "create_train_state",
    "exploration_mixture",
    "fused_train_scan",
    "gather_batches",
    "make_noise",
    "make_optimizers",
    "noisy_explore",
    "support_of",
    "train_step",
]
