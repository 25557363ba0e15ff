"""Experience storage. Exported here, the host side: the port's own
copies of the JAX package's uniform ring, PER buffer, NumPy segment trees
and schedules. The PER buffer's native C++ trees are
``replay.native`` (``tree_backend``, one of :data:`TREE_BACKENDS`),
built with g++ at first use. The device side is ``replay.device_ring``
(the ring mirrored onto the card) and ``replay.device_per`` (the device
PER sum tree)."""

from d4pg_tpu_torch.replay.per import TREE_BACKENDS, PrioritizedReplayBuffer, SampledIndices
from d4pg_tpu_torch.replay.schedules import linear_schedule, noise_scale_schedule
from d4pg_tpu_torch.replay.segment_tree import MinTree, SumTree
from d4pg_tpu_torch.replay.uniform import ReplayBuffer, Transition

__all__ = [
    "MinTree",
    "PrioritizedReplayBuffer",
    "ReplayBuffer",
    "SampledIndices",
    "SumTree",
    "TREE_BACKENDS",
    "Transition",
    "linear_schedule",
    "noise_scale_schedule",
]
