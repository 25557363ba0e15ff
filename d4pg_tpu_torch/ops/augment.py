"""DrQ random shift of pixel batches (counterpart of
``d4pg_tpu/ops/augment.py``).

Each frame of a batch is shifted by its own offset in [−pad, pad] along
rows and columns, the pixels that leave the frame replaced by the edge
(pad mode "edge", then a crop at the offset). Like the JAX function it
works on the pipeline's flattened frames [B, H·W·C] as two clamped
gathers, one along the rows and one along the columns.

The JAX function draws the offsets from a key inside the step. Here the
caller draws them (:func:`draw_offsets`, from an explicit
``torch.Generator``) and passes them in, so the tests can feed the draws
the JAX package made. Plain PyTorch: the JAX package computes the shift
outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Sequence

import torch


def draw_offsets(batch: int, pad: int, generator: torch.Generator) -> torch.Tensor:
    """[B, 2] int64 offsets (rows, cols), uniform on [−pad, pad], on the
    generator's device: ``jax.random.randint(key, (B, 2), -pad, pad + 1)``."""
    return torch.randint(-pad, pad + 1, (batch, 2), generator=generator,
                         device=generator.device)


def random_shift(
    flat: torch.Tensor, offsets: torch.Tensor, pixel_shape: Sequence[int]
) -> torch.Tensor:
    """Shift each of the B flattened frames [B, H·W·C] by its ``offsets``
    row [dy, dx]: output pixel (h, w) reads input pixel
    (clip(h + dy, 0, H−1), clip(w + dx, 0, W−1))."""
    H, W, C = pixel_shape
    B = flat.shape[0]
    imgs = flat.reshape(B, H, W, C)
    dev = flat.device
    rows = (torch.arange(H, device=dev)[None, :] + offsets[:, 0:1]).clamp(0, H - 1)
    cols = (torch.arange(W, device=dev)[None, :] + offsets[:, 1:2]).clamp(0, W - 1)
    x = imgs.gather(1, rows[:, :, None, None].expand(B, H, W, C))
    x = x.gather(2, cols[:, None, :, None].expand(B, H, W, C))
    return x.reshape(B, H * W * C)
