from d4pg_tpu_torch.models.actor import Actor
from d4pg_tpu_torch.models.critic import Critic, DistConfig, StackedCritic

__all__ = ["Actor", "Critic", "DistConfig", "StackedCritic"]
