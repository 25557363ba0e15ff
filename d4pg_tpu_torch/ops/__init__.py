"""Tensor ops of the port: categorical math, the CUDA projection kernels,
Polyak, noise and n-step returns. The device-PER descent kernel and the
fused loss + descent kernel live in ``ops.cuda_tree`` and
``ops.cuda_fused_step``."""

from d4pg_tpu_torch.ops.categorical import (
    CategoricalSupport,
    categorical_projection,
    categorical_td_loss,
    expected_value,
    make_support,
)
from d4pg_tpu_torch.ops.cuda_projection import (
    LAUNCHES,
    ce_and_overlap,
    fused_categorical_loss,
    project,
    reset_launch_counts,
)
from d4pg_tpu_torch.ops.noise import (
    GaussianNoiseState,
    OUNoiseState,
    gaussian_noise_init,
    gaussian_noise_reset,
    gaussian_noise_sample,
    ou_noise_init,
    ou_noise_reset,
    ou_noise_sample,
)
from d4pg_tpu_torch.ops.nstep import nstep_returns
from d4pg_tpu_torch.ops.polyak import polyak_update

__all__ = [
    "CategoricalSupport",
    "GaussianNoiseState",
    "LAUNCHES",
    "OUNoiseState",
    "categorical_projection",
    "categorical_td_loss",
    "ce_and_overlap",
    "expected_value",
    "fused_categorical_loss",
    "gaussian_noise_init",
    "gaussian_noise_reset",
    "gaussian_noise_sample",
    "make_support",
    "nstep_returns",
    "ou_noise_init",
    "ou_noise_reset",
    "ou_noise_sample",
    "polyak_update",
    "project",
    "reset_launch_counts",
]
