"""Parameter initializers (counterpart of ``d4pg_tpu/models/init.py``).

Both draw from an explicit ``torch.Generator``. They reproduce the
reference's distributions, including two of its details:

- ``fanin_uniform`` bounds a tensor by 1/√(its Flax shape[0]): for a Dense
  kernel [in, out] that is the fan-in, for a bias [out] it is the layer's
  OUTPUT width;
- the small output layers use Flax's ``uniform(scale)``, which draws from
  [0, scale), not (−scale, scale).

The pixel encoder's layers keep Flax's defaults (``nn.Conv`` and
``nn.Dense`` without initializers): ``lecun_normal`` kernels, a normal
truncated to ±2 standard deviations and rescaled to variance 1/fan_in, and
zero biases (:func:`lecun_normal_`).
"""

from __future__ import annotations

import math

import torch
from torch import nn

# The standard deviation of a unit normal truncated to [-2, 2]: Flax's
# variance_scaling divides by it so the truncated draw keeps its variance.
_TRUNC_STD = 0.87962566103423978


def _uniform_(t: torch.Tensor, low: float, high: float, generator: torch.Generator):
    with torch.no_grad():
        t.copy_(torch.rand(t.shape, generator=generator, dtype=t.dtype) * (high - low) + low)


def fanin_uniform_(layer: nn.Linear, generator: torch.Generator) -> None:
    """U(−1/√fan, +1/√fan) with Flax's fan: in_features for the weight,
    out_features for the bias."""
    bw = 1.0 / layer.in_features**0.5
    bb = 1.0 / layer.out_features**0.5
    _uniform_(layer.weight, -bw, bw, generator)
    _uniform_(layer.bias, -bb, bb, generator)


def small_uniform_(layer: nn.Linear, scale: float, generator: torch.Generator) -> None:
    """Flax ``nn.initializers.uniform(scale)`` on weight and bias: U[0, scale)."""
    _uniform_(layer.weight, 0.0, scale, generator)
    _uniform_(layer.bias, 0.0, scale, generator)


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """Flax ``lecun_normal()`` into ``t``: a normal truncated to [-2, 2]
    (drawn by inverting the CDF of a uniform, as JAX's
    ``truncated_normal`` draws it) times ``sqrt(1/fan_in) / 0.8796…``."""
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = torch.rand(t.shape, generator=generator, dtype=torch.float64)
    z = math.sqrt(2.0) * torch.erfinv(lo + u * (hi - lo))
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        t.copy_((z.clamp(-2.0, 2.0) * std).to(t.dtype))


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` in the compute dtype. float32 is ``nn.Linear`` itself.
    Under bfloat16 it is what a Flax ``Dense(dtype=bfloat16,
    param_dtype=float32)`` does: input, kernel and bias cast to bfloat16,
    the product rounded to bfloat16, then the bias added in bfloat16 as a
    separate op (``addmm`` would add it before the one rounding)."""
    if dtype == torch.float32:
        return layer(x)
    return x.to(dtype) @ layer.weight.to(dtype).t() + layer.bias.to(dtype)
