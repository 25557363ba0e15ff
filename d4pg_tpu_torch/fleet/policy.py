"""A serving bundle evaluated with numpy alone (the port's copy of
``d4pg_tpu/fleet/policy.py``).

An actor host must not load torch: it runs an env and numpy, and pays
for nothing else. So instead of ``serve.bundle.load_bundle`` (which
builds a torch actor), this module reads the same directory with numpy
and the stdlib:

- ``bundle.json``: the agent config, the bounds, the obs-norm statistics
  and the provenance (``meta.generation``, ``meta.stats_generation``);
- ``actor_params.npz``: the actor's Flax leaves under ``leaf_%05d`` keys
  in ``tree_flatten`` order, the layout the port's ``serve/bundle.py``
  writes and the JAX package's. For the MLP that order is fixed: Flax
  sorts dict keys, so each layer's ``(bias, kernel)`` pair comes in name
  order (``hidden_0 < hidden_1 < … < out``). The loader derives the
  layers from ``hidden_sizes`` and checks every leaf's shape against
  them: a scrambled order or a config that does not fit the params is a
  load error, never a policy that acts on garbage.

A pixel bundle's conv encoder (four 3x3 SAME convolutions, stride 2 then
1, each with a relu; a Dense to the embedding, a LayerNorm with epsilon
1e-6, tanh) is an im2col matmul a layer here. Its LayerNorm takes the
variance as the mean of ``(x − E[x])²``, as the JAX package's numpy
policy does, so the two give the same bits; the networks' own LayerNorm
(``models/encoders.py:layer_norm``, Flax's ``E[x²] − E[x]²``) agrees with
it to float32 rounding.

The forward is the acting path the server runs (normalize → [encode] →
MLP with relu → tanh) in float32.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np

# serve/bundle.py's layout constants, restated: that module builds torch
# actors and must not be imported here. tests/test_torch_fleet.py holds
# the two copies equal.
BUNDLE_VERSION = 1
PARAMS_FILE = "actor_params.npz"
META_FILE = "bundle.json"

ENCODER_FEATURES = (32, 32, 32, 32)  # the conv encoder's fixed widths


def _conv2d_same(x: np.ndarray, kernel: np.ndarray, bias: np.ndarray,
                 stride: int) -> np.ndarray:
    """NHWC convolution with SAME padding as one im2col matmul; the patch
    order (kh, kw, C) is the kernel's row-major flatten."""
    n, h, w, c = x.shape
    kh, kw, _, f = kernel.shape
    out_h, out_w = -(-h // stride), -(-w // stride)
    pad_h = max((out_h - 1) * stride + kh - h, 0)
    pad_w = max((out_w - 1) * stride + kw - w, 0)
    x = np.pad(
        x,
        ((0, 0), (pad_h // 2, pad_h - pad_h // 2),
         (pad_w // 2, pad_w - pad_w // 2), (0, 0)),
    )
    cols = np.empty((n, out_h, out_w, kh * kw * c), np.float32)
    for i in range(kh):
        for j in range(kw):
            cols[..., (i * kw + j) * c:(i * kw + j + 1) * c] = x[
                :, i:i + out_h * stride:stride, j:j + out_w * stride:stride, :
            ]
    return cols @ kernel.reshape(kh * kw * c, f) + bias


class _NumpyPixelEncoder:
    """The conv encoder in numpy: conv3x3 SAME (stride 2, then 1) + relu
    four times, flatten, Dense(embed), LayerNorm(1e-6), tanh."""

    def __init__(self, convs, dense, layer_norm, pixel_shape):
        self._convs = convs              # [(kernel [3, 3, in, out], bias)]
        self._dense = dense              # (kernel, bias)
        self._ln = layer_norm            # (bias, scale)
        self.pixel_shape = tuple(pixel_shape)

    def __call__(self, flat: np.ndarray) -> np.ndarray:
        x = np.asarray(flat, np.float32).reshape((-1,) + self.pixel_shape)
        for i, (kernel, bias) in enumerate(self._convs):
            x = _conv2d_same(x, kernel, bias, stride=2 if i == 0 else 1)
            np.maximum(x, 0.0, out=x)
        x = x.reshape(x.shape[0], -1)
        dk, db = self._dense
        x = x @ dk + db
        lb, ls = self._ln
        mean = x.mean(axis=-1, keepdims=True)
        var = ((x - mean) ** 2).mean(axis=-1, keepdims=True)
        x = (x - mean) / np.sqrt(var + 1e-6) * ls + lb
        return np.tanh(x)


class NumpyPolicy:
    """A loaded bundle in numpy. ``act`` maps ``[N, obs_dim]`` observations
    to actions in (−1, 1), the box host envs step in (the adapters apply
    the env's bounds themselves, so the bundle's bounds are provenance
    here)."""

    def __init__(
        self,
        *,
        layers: List[Tuple[np.ndarray, np.ndarray]],
        obs_dim: int,
        action_dim: int,
        n_step: int,
        gamma: float,
        env: Optional[str],
        generation: int,
        obs_norm: Optional[Tuple[np.ndarray, np.ndarray]],
        obs_clip: float = 5.0,
        mtime: Optional[float] = None,
        path: Optional[str] = None,
        encoder: Optional[_NumpyPixelEncoder] = None,
        stats_generation: int = 0,
    ):
        self._layers = layers            # [(kernel [in, out], bias [out])]
        self.obs_dim = obs_dim
        self.action_dim = action_dim
        self.n_step = n_step
        self.gamma = gamma
        self.env = env
        self.generation = generation
        self._obs_norm = obs_norm        # (mean f32, std f32 floored) or None
        self._obs_clip = obs_clip
        self.mtime = mtime               # bundle.json's mtime at the load
        self.path = path
        self._encoder = encoder          # pixel bundles only
        # the published statistics these obs-norm params came from: every
        # window is stamped with it, so the ingest can drop windows acted
        # under statistics it has moved past
        self.stats_generation = int(stats_generation)

    @property
    def pixel_shape(self) -> Optional[Tuple[int, ...]]:
        return None if self._encoder is None else self._encoder.pixel_shape

    @property
    def has_obs_norm(self) -> bool:
        return self._obs_norm is not None

    def retain_stats_from(self, old: "NumpyPolicy") -> None:
        """Chaos ``stale_stats``: keep this bundle's params but act on
        ``old``'s normalizer statistics and their generation, so the
        windows carry the stale generation they were acted under and the
        ingest drops them."""
        self._obs_norm = old._obs_norm
        self.stats_generation = old.stats_generation

    def act(self, obs: np.ndarray) -> np.ndarray:
        """The deterministic forward: ``[N, obs_dim]`` → ``[N, action_dim]``
        in (−1, 1)."""
        x = np.asarray(obs, np.float32)
        if self._obs_norm is not None:
            mean, std = self._obs_norm
            x = np.clip((x - mean) / std, -self._obs_clip, self._obs_clip)
        if self._encoder is not None:
            x = self._encoder(x)
        last = len(self._layers) - 1
        for i, (kernel, bias) in enumerate(self._layers):
            x = x @ kernel + bias
            if i < last:
                np.maximum(x, 0.0, out=x)
        return np.tanh(x)


def _derive_obs_norm(stats: Optional[dict], obs_dim: int, eps: float = 1e-2
                     ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(mean f32, std f32 floored at ``eps``) from saved Welford statistics,
    derived as the batcher and ``RunningObsNorm`` derive them."""
    if stats is None:
        return None
    count = float(stats["count"])
    mean = np.asarray(stats["mean"], np.float64)
    if mean.shape != (obs_dim,):
        raise ValueError(f"obs_norm stats are {mean.shape}-shaped, obs_dim is {obs_dim}")
    m2 = np.asarray(stats["m2"], np.float64)
    std = np.sqrt(np.maximum(m2 / count, 0.0)) if count > 0 else np.ones_like(mean)
    return mean.astype(np.float32), np.maximum(std, eps).astype(np.float32)


def _pixel_encoder(enc_leaves, agent: dict, pixel_shape) -> Tuple[_NumpyPixelEncoder, int]:
    """The encoder from its 12 leaves (sorted first: 'PixelEncoder_0' <
    'hidden_0' < 'out'; inside it 'Conv_*' < 'Dense_0' < 'LayerNorm_0',
    (bias, kernel) and (bias, scale) each), every shape checked; returns
    it and its embedding width."""
    embed = int(agent.get("encoder_embed_dim", 50))
    h, w, c = pixel_shape
    convs = []
    prev_c = c
    for i, feat in enumerate(ENCODER_FEATURES):
        bias, kernel = enc_leaves[2 * i], enc_leaves[2 * i + 1]
        if bias.shape != (feat,) or kernel.shape != (3, 3, prev_c, feat):
            raise ValueError(
                f"encoder conv {i}: bundle leaves are bias{bias.shape}"
                f" / kernel{kernel.shape}, config implies bias({feat},)"
                f" / kernel(3, 3, {prev_c}, {feat})"
            )
        convs.append((np.asarray(kernel, np.float32), np.asarray(bias, np.float32)))
        prev_c = feat
    flat = -(-h // 2) * -(-w // 2) * ENCODER_FEATURES[-1]
    d_bias, d_kernel = enc_leaves[8], enc_leaves[9]
    ln_bias, ln_scale = enc_leaves[10], enc_leaves[11]
    if d_bias.shape != (embed,) or d_kernel.shape != (flat, embed):
        raise ValueError(
            f"encoder dense: bundle leaves are bias{d_bias.shape} / "
            f"kernel{d_kernel.shape}, config implies bias({embed},) / "
            f"kernel({flat}, {embed})"
        )
    if ln_bias.shape != (embed,) or ln_scale.shape != (embed,):
        raise ValueError(
            f"encoder layernorm: bundle leaves are {ln_bias.shape} / "
            f"{ln_scale.shape}, config implies ({embed},) twice"
        )
    encoder = _NumpyPixelEncoder(
        convs,
        (np.asarray(d_kernel, np.float32), np.asarray(d_bias, np.float32)),
        (np.asarray(ln_bias, np.float32), np.asarray(ln_scale, np.float32)),
        pixel_shape,
    )
    return encoder, embed


def load_numpy_policy(bundle_dir: str) -> NumpyPolicy:
    """A serving bundle as a :class:`NumpyPolicy`, with no torch.

    ``ValueError`` on a bundle-version skew, more than 9 hidden layers, or
    leaves whose count or shapes the config does not imply, as
    ``serve.bundle.load_bundle`` refuses them.
    """
    meta_path = os.path.join(bundle_dir, META_FILE)
    mtime = os.stat(meta_path).st_mtime
    with open(meta_path) as f:
        doc = json.load(f)
    if doc.get("bundle_version") != BUNDLE_VERSION:
        raise ValueError(
            f"bundle_version {doc.get('bundle_version')!r} unsupported "
            f"(this code reads {BUNDLE_VERSION})"
        )
    agent = doc["agent"]
    obs_dim = int(agent["obs_dim"])
    action_dim = int(agent["action_dim"])
    pixel_shape = tuple(agent["pixel_shape"]) if agent.get("pixel_shape") else None
    hidden = [int(h) for h in agent.get("hidden_sizes", (256, 256, 256))]
    if len(hidden) > 9:
        # Flax sorts layer names as strings: hidden_10 would come before
        # hidden_2 and scramble the order this loader relies on
        raise ValueError(
            f"{len(hidden)} hidden layers: the numpy loader supports at "
            "most 9 (flax name-sort order becomes ambiguous past that)"
        )
    with np.load(os.path.join(bundle_dir, PARAMS_FILE)) as z:
        leaves = [z[k] for k in sorted(z.files)]
    encoder = None
    trunk_in = obs_dim
    if pixel_shape is not None:
        n_enc = 2 * len(ENCODER_FEATURES) + 4  # the convs, the Dense, the LayerNorm
        if len(leaves) < n_enc:
            raise ValueError(
                f"pixel bundle has {len(leaves)} param leaves, the conv "
                f"encoder alone needs {n_enc} — config/params mismatch"
            )
        encoder, trunk_in = _pixel_encoder(leaves[:n_enc], agent, pixel_shape)
        leaves = leaves[n_enc:]
    widths = hidden + [action_dim]
    if len(leaves) != 2 * len(widths):
        raise ValueError(
            f"bundle has {len(leaves)} trunk param leaves, config implies "
            f"{2 * len(widths)} (MLP {hidden} → {action_dim})"
        )
    layers: List[Tuple[np.ndarray, np.ndarray]] = []
    prev = trunk_in
    for i, width in enumerate(widths):
        bias, kernel = leaves[2 * i], leaves[2 * i + 1]
        if bias.shape != (width,) or kernel.shape != (prev, width):
            raise ValueError(
                f"layer {i}: bundle leaves are bias{bias.shape} / "
                f"kernel{kernel.shape}, config implies bias({width},) / "
                f"kernel({prev}, {width}) — config/params mismatch"
            )
        layers.append((np.asarray(kernel, np.float32), np.asarray(bias, np.float32)))
        prev = width
    meta = doc.get("meta") or {}
    obs_norm_doc = doc.get("obs_norm")
    return NumpyPolicy(
        layers=layers,
        obs_dim=obs_dim,
        action_dim=action_dim,
        n_step=int(agent.get("n_step", 1)),
        gamma=float(agent.get("gamma", 0.99)),
        env=meta.get("env"),
        generation=int(meta.get("generation", 0)),
        obs_norm=_derive_obs_norm(obs_norm_doc, obs_dim),
        mtime=mtime,
        path=os.path.abspath(bundle_dir),
        encoder=encoder,
        stats_generation=(
            int(meta.get("stats_generation", meta.get("generation", 0)))
            if obs_norm_doc is not None else 0
        ),
    )


def bundle_meta_mtime(bundle_dir: str) -> Optional[float]:
    """The mtime of ``bundle.json``, the hot-swap key (the exporter moves it
    into place last); None when it is absent."""
    try:
        return os.stat(os.path.join(bundle_dir, META_FILE)).st_mtime
    except FileNotFoundError:
        return None
