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
