"""Batched torch environments. Only the pure Pendulum is ported so far
(ROADMAP A9 lists the rest)."""

from d4pg_tpu_torch.envs.api import Env, EnvState
from d4pg_tpu_torch.envs.pendulum import Pendulum

ENVS = {"pendulum": Pendulum}


def make_env(name: str):
    if name not in ENVS:
        raise NotImplementedError(
            f"env {name!r} is not ported to d4pg_tpu_torch yet (ROADMAP A9: "
            f"on-device envs; A5: host/gym envs); available: {sorted(ENVS)}"
        )
    return ENVS[name]()


__all__ = ["ENVS", "Env", "EnvState", "Pendulum", "make_env"]
