"""Carry Flax parameter trees across into the port's modules, and back.

A Flax ``nn.Dense`` stores ``kernel`` as ``[in, out]`` and computes
``x @ kernel + bias``; ``nn.Linear`` stores ``weight`` as ``[out, in]`` and
computes ``x @ weight.T + bias``. So a kernel is transposed and a bias is
copied. The layers carry the same names on both sides (``hidden_<i>`` and
``out``), so a Flax tree maps onto a ``state_dict`` by name. A stacked
critic's tree (twin, REDQ: every leaf with a leading [E] axis, kernels
[E, in, out]) maps onto a :class:`~d4pg_tpu_torch.models.StackedCritic`,
which keeps the Flax layout: its ``kernel`` and ``bias`` are copied as
they are.

The trees come in as nested dicts of numpy arrays (``jax.device_get`` of a
Flax ``params`` collection, with or without the top-level ``"params"``
key) and go out the same way (:func:`state_dict_to_flax`); nothing here
imports JAX.

``checkpoints/best_actor.npz``, the keep-best champion, is written in the
JAX package's layout: one ``leaf_<i:04d>`` array per leaf of the Flax
variables ``{"params": {...}}`` in ``jax.tree_util.tree_flatten`` order
(sorted dict keys, depth first), so either package loads the other's.
"""

from __future__ import annotations

import os
from typing import Mapping

import numpy as np
import torch


def _layers(params: Mapping) -> Mapping:
    return params["params"] if "params" in params else params


def flax_to_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """One Flax Dense-stack param tree → an ``nn.Module`` ``state_dict``:
    ``weight`` [out, in] per layer, or, for a stacked tree ([E, in, out]
    kernels), ``kernel`` and ``bias`` as they are."""
    sd = {}
    for name, layer in _layers(params).items():
        kernel = np.asarray(layer["kernel"], np.float32)
        if kernel.ndim == 3:
            sd[f"{name}.kernel"] = torch.from_numpy(np.array(kernel, order="C"))
        else:
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


def state_dict_to_flax(module: torch.nn.Module) -> dict:
    """A port module → its Flax variables ``{"params": {layer: {"bias",
    "kernel"}}}`` as float32 numpy arrays; ``weight`` s transposed back to
    ``[in, out]``, a stacked critic's ``kernel`` s as they are."""
    layers: dict = {}
    for key, t in module.state_dict().items():
        name, kind = key.rsplit(".", 1)
        arr = t.detach().float().cpu().numpy()
        if kind == "weight":
            layers.setdefault(name, {})["kernel"] = np.array(arr.T, order="C")
        else:
            layers.setdefault(name, {})[kind] = np.array(arr)
    return {"params": layers}


def to_jax_params(state) -> tuple[dict, dict]:
    """(actor, critic) Flax variables from a
    :class:`~d4pg_tpu_torch.agent.state.TrainState`'s online networks."""
    return state_dict_to_flax(state.actor), state_dict_to_flax(state.critic)


def flax_leaves(tree: Mapping) -> list:
    """The leaves of a nested dict in ``jax.tree_util.tree_flatten``
    order: sorted keys, depth first."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(flax_leaves(v) if isinstance(v, Mapping) else [v])
    return out


def _unflatten(template: Mapping, leaves) -> dict:
    return {
        k: _unflatten(template[k], leaves) if isinstance(template[k], Mapping) else next(leaves)
        for k in sorted(template)
    }


def best_actor_path(log_dir: str) -> str:
    return os.path.join(log_dir, "checkpoints", "best_actor.npz")


def save_best_actor(log_dir: str, actor: torch.nn.Module) -> None:
    """Write ``checkpoints/best_actor.npz`` in the JAX leaf layout,
    atomically (tmp file, then rename)."""
    path = best_actor_path(log_dir)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    leaves = flax_leaves(state_dict_to_flax(actor))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:  # a file object: savez appends no suffix
        np.savez(f, **{f"leaf_{i:04d}": leaf for i, leaf in enumerate(leaves)})
    os.replace(tmp, path)


def load_best_actor(log_dir: str, actor: torch.nn.Module) -> torch.nn.Module:
    """Load ``checkpoints/best_actor.npz`` (either package's) into
    ``actor`` IN PLACE and return it. The leaf count and every leaf's
    shape are checked against the actor's own, as the JAX
    ``load_best_actor`` checks them against its template: a file from a
    run with other ``--hidden-sizes`` raises ``ValueError``."""
    path = best_actor_path(log_dir)
    with np.load(path) as z:
        leaves = [z[k] for k in sorted(z.files)]
    template = state_dict_to_flax(actor)
    want = flax_leaves(template)
    if len(leaves) != len(want):
        raise ValueError(
            f"{path} has {len(leaves)} leaves, the actor implies {len(want)} — "
            "config/checkpoint mismatch"
        )
    for i, (saved, w) in enumerate(zip(leaves, want)):
        if saved.shape != w.shape:
            raise ValueError(
                f"{path} leaf {i} has shape {saved.shape}, the actor implies "
                f"{w.shape} — does --hidden-sizes match the trained run?"
            )
    actor.load_state_dict(flax_to_state_dict(_unflatten(template, iter(leaves))))
    return actor
