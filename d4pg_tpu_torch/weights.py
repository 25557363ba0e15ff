"""Carry Flax parameter trees across into the port's modules.

A Flax ``nn.Dense`` stores ``kernel`` as ``[in, out]`` and computes
``x @ kernel + bias``; ``nn.Linear`` stores ``weight`` as ``[out, in]`` and
computes ``x @ weight.T + bias``. So a kernel is transposed and a bias is
copied. The layers carry the same names on both sides (``hidden_<i>`` and
``out``), so a Flax tree maps onto a ``state_dict`` by name.

The trees come in as nested dicts of numpy arrays (``jax.device_get`` of a
Flax ``params`` collection, with or without the top-level ``"params"``
key); nothing here imports JAX.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _layers(params: Mapping) -> Mapping:
    return params["params"] if "params" in params else params


def flax_to_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """One Flax Dense-stack param tree → an ``nn.Module`` ``state_dict``."""
    sd = {}
    for name, layer in _layers(params).items():
        kernel = np.asarray(layer["kernel"], np.float32)
        sd[f"{name}.weight"] = torch.from_numpy(np.array(kernel.T, order="C"))
        sd[f"{name}.bias"] = torch.from_numpy(np.array(layer["bias"], np.float32))
    return sd


def from_jax_params(
    actor_params: Mapping, critic_params: Mapping
) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """(actor ``state_dict``, critic ``state_dict``) from Flax param trees."""
    return flax_to_state_dict(actor_params), flax_to_state_dict(critic_params)


def load_jax_params(
    state,
    actor_params: Mapping,
    critic_params: Mapping,
    target_actor_params: Mapping | None = None,
    target_critic_params: Mapping | None = None,
) -> None:
    """Load Flax trees into a :class:`~d4pg_tpu_torch.agent.state.TrainState`:
    the online networks and their targets. The targets take the same values
    as the online networks unless their own trees are given (a fresh JAX
    ``create_train_state`` hard-copies them, so both readings agree)."""
    actor_sd, critic_sd = from_jax_params(actor_params, critic_params)
    state.actor.load_state_dict(actor_sd)
    state.critic.load_state_dict(critic_sd)
    state.target_actor.load_state_dict(
        actor_sd if target_actor_params is None else flax_to_state_dict(target_actor_params)
    )
    state.target_critic.load_state_dict(
        critic_sd if target_critic_params is None else flax_to_state_dict(target_critic_params)
    )
