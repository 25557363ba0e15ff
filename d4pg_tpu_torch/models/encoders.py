"""The pixel encoder (counterpart of ``d4pg_tpu/models/encoders.py``).

A DrQ-style conv stack in front of the actor's and the critic's MLP
trunks: 4 convolutions of 3x3 with 32 channels, the first of stride 2 and
the rest of stride 1, each followed by a ReLU; the flatten; a Dense to
``embed_dim``; a LayerNorm; tanh. Observations arrive flattened,
``[..., H·W·C]`` floats in [0, 1] (the pipeline's pixel convention,
``envs/pixel_pendulum.py``), and are read as channels-last frames.

Three details keep it equal to the Flax module:

- padding is Flax's ``SAME``: per axis ``pad = max((out−1)·s + k − in, 0)``
  with ``out = ceil(in / s)``, ``lo = pad // 2`` and ``hi = pad − lo``. A
  stride-2 conv of an even size pads (0, 1), not (1, 1), so the frames are
  padded by :func:`same_pads` and convolved with ``padding=0``;
- the Dense reads the channels-last flatten ``(h, w, c)``: the conv stack
  runs in NCHW and is permuted back to NHWC before the flatten;
- the LayerNorm is Flax's: ``epsilon`` 1e-6, the statistics in float32
  with the variance as ``E[x²] − E[x]²`` clipped at 0, and the output
  ``(x − mean)·(rsqrt(var + eps)·scale) + bias`` (:func:`layer_norm`).

Under the bfloat16 compute dtype every conv and the Dense cast their input
and float32 master parameters to bfloat16 and add the bias after the
product, as a Flax ``Conv`` / ``Dense(dtype=bfloat16)`` does; the
LayerNorm computes in float32 and rounds its output to bfloat16; the
embedding comes back as float32.

:class:`PixelEncoder` holds one encoder's parameters in torch layouts
(``Conv_<i>.weight`` [O, I, 3, 3], ``Dense_0.weight`` [out, in],
``LayerNorm_0.weight``), named as the Flax module's submodules so a Flax
tree maps onto its ``state_dict`` (:mod:`d4pg_tpu_torch.weights`).
:class:`StackedPixelEncoder` holds E members' parameters stacked on a
leading axis in the Flax layouts (conv ``kernel`` [E, 3, 3, I, O], Dense
``kernel`` [E, in, out], LayerNorm ``scale`` [E, D]), the encoder part of
a :class:`~d4pg_tpu_torch.models.StackedCritic`; it runs the members one
after the other.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from d4pg_tpu_torch.models.init import lecun_normal_

FEATURES = (32, 32, 32, 32)
KERNEL = 3
LN_EPS = 1e-6  # Flax LayerNorm's epsilon (torch's default is 1e-5)


def conv_strides(n: int = len(FEATURES)) -> list:
    return [2 if i == 0 else 1 for i in range(n)]


def same_pad(size: int, stride: int, kernel: int = KERNEL) -> tuple:
    """(lo, hi) padding of one axis under XLA's ``SAME`` rule."""
    out = -(-size // stride)
    pad = max((out - 1) * stride + kernel - size, 0)
    return pad // 2, pad - pad // 2


def same_pads(h: int, w: int, stride: int) -> tuple:
    """``F.pad``'s (w_lo, w_hi, h_lo, h_hi) for an NCHW frame."""
    return same_pad(w, stride) + same_pad(h, stride)


def conv_out_hw(pixel_shape: Sequence[int]) -> tuple:
    """The (h, w) after the conv stack."""
    h, w = pixel_shape[0], pixel_shape[1]
    for s in conv_strides():
        h, w = -(-h // s), -(-w // s)
    return h, w


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Flax ``LayerNorm`` over the last axis, in float32 (see the module
    docstring); the caller casts the result to the compute dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    return (xf - mean) * (torch.rsqrt(var + LN_EPS) * scale) + bias


def encode(
    flat: torch.Tensor,
    pixel_shape: Sequence[int],
    convs: Sequence[tuple],
    dense_w: torch.Tensor,
    dense_b: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    dtype: torch.dtype,
) -> torch.Tensor:
    """One encoder's forward: ``flat`` [..., H·W·C] → [..., embed] float32.
    ``convs`` are (weight [O, I, 3, 3], bias [O]) pairs, ``dense_w`` is
    [in, out] (a Flax kernel; ``nn.Linear.weight.t()``)."""
    H, W, C = pixel_shape
    lead = flat.shape[:-1]
    x = flat.reshape(-1, H, W, C).permute(0, 3, 1, 2).to(dtype)
    for (w, b), s in zip(convs, conv_strides(len(convs))):
        x = F.pad(x, same_pads(x.shape[-2], x.shape[-1], s))
        if dtype == torch.float32:
            x = F.conv2d(x, w, b, stride=s)
        else:  # the product rounded, then the bias added in the compute dtype
            x = F.conv2d(x, w.to(dtype), stride=s) + b.to(dtype)[:, None, None]
        x = torch.relu(x)
    x = x.permute(0, 2, 3, 1).reshape(*lead, -1)
    if dtype == torch.float32:
        x = torch.addmm(dense_b, x.reshape(-1, x.shape[-1]), dense_w).reshape(*lead, -1)
    else:
        x = x @ dense_w.to(dtype) + dense_b.to(dtype)
    x = layer_norm(x, ln_scale, ln_bias).to(dtype)
    return torch.tanh(x).float()


class PixelEncoder(nn.Module):
    def __init__(
        self,
        pixel_shape: Sequence[int],
        embed_dim: int = 50,
        generator: torch.Generator | None = None,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.pixel_shape = tuple(int(d) for d in pixel_shape)
        self.compute_dtype = compute_dtype
        cin = self.pixel_shape[2]
        for i, feat in enumerate(FEATURES):
            self.add_module(f"Conv_{i}", nn.Conv2d(cin, feat, KERNEL))
            cin = feat
        h, w = conv_out_hw(self.pixel_shape)
        self.Dense_0 = nn.Linear(h * w * cin, embed_dim)
        self.LayerNorm_0 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        if generator is not None:
            for i in range(len(FEATURES)):
                conv = self.get_submodule(f"Conv_{i}")
                lecun_normal_(conv.weight, conv.in_channels * KERNEL * KERNEL, generator)
                nn.init.zeros_(conv.bias)
            lecun_normal_(self.Dense_0.weight, self.Dense_0.in_features, generator)
            nn.init.zeros_(self.Dense_0.bias)
            # Flax LayerNorm: scale ones, bias zeros (nn.LayerNorm's own init)

    def forward(self, flat: torch.Tensor) -> torch.Tensor:
        convs = [(c.weight, c.bias) for c in (self.get_submodule(f"Conv_{i}")
                                              for i in range(len(FEATURES)))]
        return encode(flat, self.pixel_shape, convs, self.Dense_0.weight.t(), self.Dense_0.bias,
                      self.LayerNorm_0.weight, self.LayerNorm_0.bias, self.compute_dtype)


class StackedConv(nn.Module):
    """E convs in the Flax layout: ``kernel`` [E, 3, 3, I, O], ``bias`` [E, O]."""

    def __init__(self, kernel: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.kernel = nn.Parameter(kernel)
        self.bias = nn.Parameter(bias)

    def member(self, e: int) -> tuple:
        return self.kernel[e].permute(3, 2, 0, 1), self.bias[e]


class StackedLayerNorm(nn.Module):
    """E LayerNorms in the Flax layout: ``scale`` and ``bias`` [E, D]."""

    def __init__(self, scale: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.scale = nn.Parameter(scale)
        self.bias = nn.Parameter(bias)


class StackedPixelEncoder(nn.Module):
    """The encoders of E stacked critics (see the module docstring),
    built from E :class:`PixelEncoder` s. ``forward(flat)`` → [E, ..., D];
    ``forward(flat, member=e)`` → member e's [..., D]."""

    def __init__(self, members: Sequence[PixelEncoder]):
        super().__init__()
        from d4pg_tpu_torch.models.critic import StackedDense

        first = members[0]
        self.pixel_shape = first.pixel_shape
        self.compute_dtype = first.compute_dtype
        self.num_members = len(members)
        for i in range(len(FEATURES)):
            convs = [m.get_submodule(f"Conv_{i}") for m in members]
            self.add_module(f"Conv_{i}", StackedConv(
                torch.stack([c.weight.detach().permute(2, 3, 1, 0) for c in convs]),
                torch.stack([c.bias.detach() for c in convs]),
            ))
        self.Dense_0 = StackedDense(
            torch.stack([m.Dense_0.weight.detach().t() for m in members]),
            torch.stack([m.Dense_0.bias.detach() for m in members]),
        )
        self.LayerNorm_0 = StackedLayerNorm(
            torch.stack([m.LayerNorm_0.weight.detach() for m in members]),
            torch.stack([m.LayerNorm_0.bias.detach() for m in members]),
        )

    def _member(self, flat: torch.Tensor, e: int) -> torch.Tensor:
        convs = [self.get_submodule(f"Conv_{i}").member(e) for i in range(len(FEATURES))]
        return encode(flat, self.pixel_shape, convs, self.Dense_0.kernel[e],
                      self.Dense_0.bias[e], self.LayerNorm_0.scale[e],
                      self.LayerNorm_0.bias[e], self.compute_dtype)

    def forward(self, flat: torch.Tensor, member: int | None = None) -> torch.Tensor:
        if member is not None:
            return self._member(flat, member)
        return torch.stack([self._member(flat, e) for e in range(self.num_members)])
