"""Policy bundles: everything inference needs, in one directory (the
port's counterpart of ``d4pg_tpu/serve/bundle.py``, in its file format).

A bundle decouples SERVING from TRAINING: the exporter
(``python -m d4pg_tpu_torch.train --export-bundle`` or
:func:`export_bundle`) packages the actor's parameters, the agent config
that shapes the network, the env's action bounds and the obs-normalizer
statistics into a self-describing directory, so the serving process
rebuilds the acting-time data path (normalize → actor → clip → affine to
env bounds) with no trainer, replay or env near it.

Layout::

    <bundle>/
      bundle.json        config + bounds + obs-norm stats + provenance
      actor_params.npz   the actor's Flax param leaves in tree_flatten
                         order (zero-padded ``leaf_%05d`` keys: sorted(files)
                         restores the order exactly)

Both files are the JAX package's: ``bundle.json``'s ``agent`` is the JAX
``D4PGConfig`` schema, field for field and in its order, and the leaves
are the Flax actor's (kernels ``[in, out]``, :mod:`d4pg_tpu_torch.weights`
carries them across). So the JAX package loads a bundle this module
writes, and this module loads one the JAX package writes.

Writes are atomic (params first, json second, each tmp+rename): a reader —
including the server's hot-reload watcher — never sees a json attesting
params that are not fully on disk. Hot reload keys on ``bundle.json``'s
mtime for exactly this reason: it is the LAST file the exporter moves into
place.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from d4pg_tpu_torch.agent.state import D4PGConfig
from d4pg_tpu_torch.models.actor import Actor
from d4pg_tpu_torch.models.critic import DistConfig
from d4pg_tpu_torch.weights import _unflatten, flax_leaves, flax_to_state_dict, state_dict_to_flax

BUNDLE_VERSION = 1
PARAMS_FILE = "actor_params.npz"
META_FILE = "bundle.json"

# The JAX ``D4PGConfig`` fields in their declaration order: the ``agent``
# schema of ``bundle.json``.
JAX_AGENT_FIELDS = (
    "obs_dim", "action_dim", "hidden_sizes", "pixel_shape", "encoder_embed_dim",
    "augment_pad", "dist", "gamma", "n_step", "tau", "lr_actor", "lr_critic", "adam_b1",
    "adam_b2", "noise_kind", "noise_epsilon", "noise_sigma", "ou_theta", "ou_sigma", "ou_mu",
    "noise_decay_steps", "noise_scale_final", "random_eps", "action_l2", "prioritized",
    "per_alpha", "per_beta0", "per_beta_steps", "per_eps", "priority_kind", "compute_dtype",
    "projection_backend", "twin_critic", "critic_ensemble", "ensemble_min_targets",
)
# Fields of the JAX schema the port's ``D4PGConfig`` does not carry, with
# the JAX defaults: the pixel encoder's two (pixels are ROADMAP A10 (c))
# and ``prioritized`` (a run option of the port's ``TrainConfig``). None
# of them shapes the actor.
JAX_ONLY_DEFAULTS = {"encoder_embed_dim": 50, "augment_pad": 4, "prioritized": True}
# The projection ladder in each package's words. The JAX ``"xla"`` rung has
# no port; the serving path never reads the field, and it reads as the
# port's default.
_PROJECTION_TO_JAX = {"fused": "pallas_fused", "projection": "pallas"}
_PROJECTION_FROM_JAX = {"pallas_fused": "fused", "pallas": "projection", "xla": "fused"}


def config_to_json(config: D4PGConfig, prioritized: bool = True) -> dict:
    """The JAX package's ``config_to_json``: its ``D4PGConfig`` as a dict,
    in its field order. ``prioritized`` comes from the run's config; the
    pixel encoder's fields take their JAX defaults."""
    mine = dataclasses.asdict(config)
    extra = dict(JAX_ONLY_DEFAULTS, prioritized=bool(prioritized))
    out = {}
    for name in JAX_AGENT_FIELDS:
        out[name] = extra[name] if name in extra else mine[name]
    out["projection_backend"] = _PROJECTION_TO_JAX.get(config.projection_backend,
                                                       config.projection_backend)
    return out


def config_from_json(d: dict) -> D4PGConfig:
    """Rebuild the agent config from the JAX schema. Unknown keys are a hard
    error: a bundle written by a newer schema must fail loudly, not
    silently drop a field that changes the network. A pixel bundle is
    refused."""
    d = dict(d)
    dist_d = d.pop("dist", None)
    known = {f.name for f in dataclasses.fields(D4PGConfig)} | set(JAX_ONLY_DEFAULTS)
    unknown = set(d) - known
    if unknown:
        raise ValueError(
            f"bundle agent config has unknown fields {sorted(unknown)}; "
            "re-export with this code or upgrade it"
        )
    if d.get("pixel_shape") is not None:
        raise NotImplementedError(
            f"bundle has pixel_shape {d['pixel_shape']}: pixel observations "
            "(ROADMAP A10 (c)) are not ported to d4pg_tpu_torch yet"
        )
    for name in JAX_ONLY_DEFAULTS:
        d.pop(name, None)
    if "hidden_sizes" in d:
        d["hidden_sizes"] = tuple(d["hidden_sizes"])
    if "projection_backend" in d:
        d["projection_backend"] = _PROJECTION_FROM_JAX.get(d["projection_backend"],
                                                           d["projection_backend"])
    dist = DistConfig(**dist_d) if dist_d is not None else DistConfig()
    return D4PGConfig(dist=dist, **d)


@dataclass
class PolicyBundle:
    """A loaded bundle: the inference-time contract."""

    config: D4PGConfig
    actor_params: dict                     # the actor's state_dict, CPU float32 tensors
    action_low: np.ndarray                 # [action_dim] env-scale bounds
    action_high: np.ndarray
    obs_norm: Optional[dict]               # {"count","mean","m2"} or None
    meta: dict                             # provenance (env, step, source, …)
    path: Optional[str] = None             # directory it was loaded from

    @property
    def obs_dim(self) -> int:
        return self.config.obs_dim

    @property
    def action_dim(self) -> int:
        return self.config.action_dim


def build_actor(config: D4PGConfig, device="cpu") -> Actor:
    """An uninitialised actor of the bundle's shapes and compute dtype on
    ``device`` (no parameter draw: it is built on the meta device, then
    given storage)."""
    dtype = torch.bfloat16 if config.compute_dtype == "bfloat16" else torch.float32
    with torch.device("meta"):
        actor = Actor(config.obs_dim, config.action_dim, tuple(config.hidden_sizes),
                      compute_dtype=dtype)
    return actor.to_empty(device=device).requires_grad_(False)


def actor_template(config: D4PGConfig) -> dict:
    """The Flax variables tree ``{"params": {...}}`` of the bundle's actor,
    with the shapes the config implies: the unflatten target of the saved
    leaves and their shape validator."""
    return state_dict_to_flax(build_actor(config))


def _as_module(config: D4PGConfig, actor_params) -> torch.nn.Module:
    if isinstance(actor_params, torch.nn.Module):
        return actor_params
    actor = build_actor(config)
    actor.load_state_dict(actor_params)
    return actor


def _save_leaves(path: str, leaves) -> None:
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **{f"leaf_{i:05d}": np.asarray(l) for i, l in enumerate(leaves)})
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def params_from_leaves(leaves, config: D4PGConfig, where: str = "bundle") -> dict:
    """The actor's ``state_dict`` from Flax leaves in tree_flatten order,
    after checking the leaf count and every shape against the actor the
    config builds (a silently mis-shaped load would serve garbage
    actions)."""
    template = actor_template(config)
    want = flax_leaves(template)
    if len(leaves) != len(want):
        raise ValueError(
            f"{where} has {len(leaves)} param leaves, config implies "
            f"{len(want)} — config/params mismatch"
        )
    for i, (saved, w) in enumerate(zip(leaves, want)):
        if tuple(saved.shape) != tuple(w.shape):
            raise ValueError(
                f"{where} param leaf {i} has shape {tuple(saved.shape)}, "
                f"config implies {tuple(w.shape)}"
            )
    return flax_to_state_dict(_unflatten(template, iter(leaves)))


def load_params(bundle_dir: str, config: D4PGConfig) -> dict:
    """The actor's ``state_dict`` from a bundle directory, validated
    against the config."""
    with np.load(os.path.join(bundle_dir, PARAMS_FILE)) as z:
        leaves = [z[k] for k in sorted(z.files)]
    return params_from_leaves(leaves, config)


def export_bundle(
    bundle_dir: str,
    config: D4PGConfig,
    actor_params,
    *,
    action_low=None,
    action_high=None,
    obs_norm_state: Optional[dict] = None,
    meta: Optional[dict] = None,
    prioritized: bool = True,
) -> str:
    """Write a serving bundle from an actor module or its ``state_dict``.
    Bounds default to the canonical (−1, 1) box, which every env of the
    port acts in."""
    os.makedirs(bundle_dir, exist_ok=True)
    low = np.full(config.action_dim, -1.0, np.float32) if action_low is None \
        else np.asarray(action_low, np.float32).reshape(config.action_dim)
    high = np.full(config.action_dim, 1.0, np.float32) if action_high is None \
        else np.asarray(action_high, np.float32).reshape(config.action_dim)
    if not np.all(high > low):
        raise ValueError("action_high must exceed action_low elementwise")
    leaves = flax_leaves(state_dict_to_flax(_as_module(config, actor_params)))
    # params FIRST, json second (write-ordering: the json is the attestation
    # a watcher reloads on)
    _save_leaves(os.path.join(bundle_dir, PARAMS_FILE), leaves)
    doc = {
        "bundle_version": BUNDLE_VERSION,
        "agent": config_to_json(config, prioritized),
        "action_low": low.tolist(),
        "action_high": high.tolist(),
        "obs_norm": obs_norm_state,
        "meta": meta or {},
    }
    meta_path = os.path.join(bundle_dir, META_FILE)
    fd, tmp = tempfile.mkstemp(dir=bundle_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")
        os.replace(tmp, meta_path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    return bundle_dir


def load_bundle(bundle_dir: str) -> PolicyBundle:
    meta_path = os.path.join(bundle_dir, META_FILE)
    with open(meta_path) as f:
        doc = json.load(f)
    if doc.get("bundle_version") != BUNDLE_VERSION:
        raise ValueError(
            f"bundle_version {doc.get('bundle_version')!r} unsupported "
            f"(this code reads {BUNDLE_VERSION})"
        )
    config = config_from_json(doc["agent"])
    params = load_params(bundle_dir, config)
    obs_norm = doc.get("obs_norm")
    if obs_norm is not None and len(obs_norm.get("mean", [])) != config.obs_dim:
        raise ValueError(
            f"obs_norm stats are {len(obs_norm.get('mean', []))}-dim, "
            f"config.obs_dim is {config.obs_dim}"
        )
    return PolicyBundle(
        config=config,
        actor_params=params,
        action_low=np.asarray(doc["action_low"], np.float32),
        action_high=np.asarray(doc["action_high"], np.float32),
        obs_norm=obs_norm,
        meta=doc.get("meta", {}),
        path=os.path.abspath(bundle_dir),
    )


def bundle_mtime(bundle_dir: str) -> Optional[float]:
    """mtime of the bundle's json attestation (the hot-reload watch key);
    None when absent."""
    try:
        return os.stat(os.path.join(bundle_dir, META_FILE)).st_mtime
    except FileNotFoundError:
        return None

