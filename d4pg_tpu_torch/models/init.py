"""Parameter initializers (counterpart of ``d4pg_tpu/models/init.py``).

Both draw from an explicit ``torch.Generator``. They reproduce the
reference's distributions, including two of its details:

- ``fanin_uniform`` bounds a tensor by 1/√(its Flax shape[0]): for a Dense
  kernel [in, out] that is the fan-in, for a bias [out] it is the layer's
  OUTPUT width;
- the small output layers use Flax's ``uniform(scale)``, which draws from
  [0, scale), not (−scale, scale).
"""

from __future__ import annotations

import torch
from torch import nn


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


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` in the compute dtype. float32 is ``nn.Linear`` itself.
    Under bfloat16 it is what a Flax ``Dense(dtype=bfloat16,
    param_dtype=float32)`` does: input, kernel and bias cast to bfloat16,
    the product rounded to bfloat16, then the bias added in bfloat16 as a
    separate op (``addmm`` would add it before the one rounding)."""
    if dtype == torch.float32:
        return layer(x)
    return x.to(dtype) @ layer.weight.to(dtype).t() + layer.bias.to(dtype)
