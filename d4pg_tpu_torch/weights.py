"""Carry Flax parameter trees across into the port's modules, and back.

A Flax ``nn.Dense`` stores ``kernel`` as ``[in, out]`` and computes
``x @ kernel + bias``; ``nn.Linear`` stores ``weight`` as ``[out, in]`` and
computes ``x @ weight.T + bias``. So a kernel is transposed and a bias is
copied. The layers carry the same names on both sides (``hidden_<i>`` and
``out``), so a Flax tree maps onto a ``state_dict`` by name. A pixel
network's ``PixelEncoder_0`` subtree maps the same way, its conv kernels
HWIO ↔ OIHW and its LayerNorm ``scale`` ↔ ``weight``. A stacked
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


def _leaf_to_torch(path: str, kind: str, arr: np.ndarray) -> tuple[str, np.ndarray]:
    """One Flax leaf of the layer at ``path`` → (the ``state_dict`` name of
    its tensor, the tensor's values). Single layers take torch layouts;
    a stacked layer (one more leading axis) keeps the Flax layout."""
    layer = path.rsplit(".", 1)[-1]
    if kind == "kernel":
        if layer.startswith("Conv_"):
            if arr.ndim == 4:  # HWIO -> OIHW
                return "weight", arr.transpose(3, 2, 0, 1)
            return "kernel", arr                    # [E, 3, 3, I, O]
        if arr.ndim == 2:  # [in, out] -> [out, in]
            return "weight", arr.T
        return "kernel", arr                        # [E, in, out]
    if kind == "scale":  # LayerNorm
        return ("weight" if arr.ndim == 1 else "scale"), arr
    return kind, arr


def flax_to_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """A Flax param tree (nested: an actor's or critic's ``hidden_<i>`` /
    ``out`` Dense layers, and with pixels the ``PixelEncoder_0`` subtree of
    ``Conv_<i>``, ``Dense_0`` and ``LayerNorm_0``) → an ``nn.Module``
    ``state_dict``: Dense kernels [in, out] → ``weight`` [out, in], conv
    kernels HWIO → ``weight`` OIHW, LayerNorm ``scale`` → ``weight``; a
    stacked tree's leaves (a leading [E] axis) keep the Flax layout under
    ``kernel`` / ``bias`` / ``scale``."""
    sd = {}

    def walk(tree: Mapping, prefix: str) -> None:
        for name, node in tree.items():
            path = f"{prefix}{name}"
            if any(isinstance(v, Mapping) for v in node.values()):
                walk(node, path + ".")
                continue
            for kind, leaf in node.items():
                key, arr = _leaf_to_torch(path, kind, np.asarray(leaf, np.float32))
                sd[f"{path}.{key}"] = torch.from_numpy(np.array(arr, order="C"))

    walk(_layers(params), "")
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
    """A port module → its Flax variables ``{"params": {...}}`` as float32
    numpy arrays, nested as the Flax tree (``PixelEncoder_0/Conv_0/kernel``):
    the inverse of :func:`flax_to_state_dict` (a ``weight`` is a Dense
    kernel transposed back, a conv kernel permuted back to HWIO, or a
    LayerNorm ``scale``, by its rank)."""
    tree: dict = {}
    for key, t in module.state_dict().items():
        *path, kind = key.split(".")
        arr = t.detach().float().cpu().numpy()
        if kind == "weight":  # LayerNorm [D], Dense [out, in] or conv OIHW
            kind = "scale" if arr.ndim == 1 else "kernel"
            arr = arr.T if arr.ndim == 2 else arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr
        node = tree
        for name in path:
            node = node.setdefault(name, {})
        node[kind] = np.array(arr, order="C")
    return {"params": tree}


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
    atomically (tmp file, then rename). A tp-sharded actor is gathered
    whole first."""
    if hasattr(actor, "gather_module"):
        actor = actor.gather_module()
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
