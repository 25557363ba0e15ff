"""PyTorch/CUDA port of the D4PG learner (``d4pg_tpu`` is the JAX reference).

The port imports torch and numpy only: nothing of JAX and nothing of
``d4pg_tpu``. Every entry point (``Trainer``, ``create_train_state``, the
``python -m d4pg_tpu_torch.train`` CLI) takes a ``device`` that defaults to
the CUDA card; :func:`resolve_device` raises when there is no card and the
caller did not ask for the CPU explicitly, so a run never drifts onto the
CPU by accident. The CPU path exists for the tests, which hold the port's
plain-PyTorch kernels against the JAX package.

Importing the package loads no torch: :func:`resolve_device` imports it
when called, so a host actor-pool worker that imports
``d4pg_tpu_torch.runtime.actor_pool`` stays free of it.
"""

from __future__ import annotations

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``None`` means the CUDA card.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and no card is present. On CUDA it also pins float32 matmuls
    and convolutions to full float32: TF32 keeps about three decimal
    digits, which would make the float32 parity against the reference
    meaningless (``allow_tf32`` is set False for both cuBLAS and cuDNN).
    And it makes cuBLAS accumulate bfloat16 products in float32, as XLA
    does (``allow_bf16_reduced_precision_reduction`` False): the bf16
    compute path rounds each product once, to bfloat16.
    """
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "d4pg_tpu_torch runs on a CUDA card by default and none is "
                "available; pass device='cpu' (CLI: --device cpu) to run the "
                "plain-PyTorch path on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
