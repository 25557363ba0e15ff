"""CUDA kernel B4: the categorical loss of one grad step plus the tree
descent for the next step's prefixes, in one launch.

Counterpart of ``d4pg_tpu/ops/pallas_fused_step.py``. Under stacked
critics (twin, REDQ) one launch takes the E x B logit rows of the members
and descends the B prefixes once: the JAX package's vmapped step runs the
same descent for every member and returns member 0's. The hand-written
kernel ``c51_fused_step`` (``csrc/fused_step.cu``) replaces the Pallas
``_fused_step_kernel`` behind ``fused_categorical_loss_descent``: its
loss blocks run kernel B1f's warp-per-row body, its count blocks run
kernel B3's count on the chunk offsets that the dispatch's one B3 call
returned. Both halves are the shared device bodies, so on the same inputs
ce/ov equal B1f's and the indices equal B3's, bit for bit.

:func:`fused_categorical_loss_descent` is the ``torch.autograd.Function``
around it; its backward is kernel B1b (``cuda_projection.fused_loss_bwd``),
as the Pallas VJP reuses ``_fused_loss_grad_kernel``: the descent takes no
gradient.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it runs :func:`fused_step_plain` (the plain fused loss and the
plain descent). The chunk offsets are checked on both devices, so a CPU
run catches what the card would refuse.
"""

from __future__ import annotations

import ctypes

import torch

from d4pg_tpu_torch.ops import _build
from d4pg_tpu_torch.ops import cuda_projection as cp
from d4pg_tpu_torch.ops import cuda_tree
from d4pg_tpu_torch.ops.categorical import CategoricalSupport

# Kernel launches of the wrapper; chip_smoke.py zeroes the count before
# driving the learner and reads it after.
LAUNCHES = {"fused_step": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "c51_fused_step": [
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _P, _I, _P, _I, _P, _P, _P,
    ],
}
_fns: dict = {}


def fused_step_plain(
    support: CategoricalSupport, q, p, r, d, next_prefixes, leaves
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(ce, ov) of :func:`cuda_projection.fused_loss_plain` and the int32
    indices of :func:`cuda_tree.find_prefix_plain`."""
    with torch.no_grad():
        ce, ov = cp.fused_loss_plain(support, q, p, r, d)
    return ce, ov, cuda_tree.find_prefix_plain(leaves, next_prefixes)


def fused_step_fwd(
    support: CategoricalSupport,
    q: torch.Tensor,
    p: torch.Tensor,
    r: torch.Tensor,
    d: torch.Tensor,
    next_prefixes: torch.Tensor,
    leaves: torch.Tensor,
    chunk_offsets: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(ce, ov, next_idx [B] int32): ce and ov ``q.shape[:-1]``, [B] or
    [E, B] for the stacked logits q [E, B, A] of E critics against the
    shared target p [B, A]; the descent runs once, for the B prefixes.
    ``chunk_offsets`` are those :func:`cuda_tree.find_prefix` returned for
    the same ``leaves`` ([num_chunks(L)] float32, contiguous, on the
    batch's device). CUDA tensors: the ``c51_fused_step`` kernel, one
    launch for all E members."""
    q, p = cp.as_f32(q), cp.as_f32(p)
    E, B, A, device = cp.validate_stacked(
        support, q, p, {"r": r, "d": d, "next_prefixes": next_prefixes}
    )
    cuda_tree._check_leaves(leaves)
    if leaves.device != device:
        raise ValueError(f"leaves are on {leaves.device}, the batch on {device}")
    L = leaves.numel()
    if chunk_offsets is None:
        raise ValueError(
            "the fused step needs the chunk offsets that cuda_tree.find_prefix "
            f"returned for these {L} leaves"
        )
    cp._check("chunk_offsets", chunk_offsets, (cuda_tree.num_chunks(L),), device)
    if device.type != "cuda":
        return fused_step_plain(support, q, p, r, d, next_prefixes, leaves)
    ce = torch.empty(q.shape[:-1], device=device, dtype=torch.float32)
    ov = torch.empty(q.shape[:-1], device=device, dtype=torch.float32)
    idx = torch.empty((B,), device=device, dtype=torch.int32)
    if B == 0:
        return ce, ov, idx
    if not _fns:
        _fns.update(_build.bind("fused_step", _SIGNATURES))
    _build.launch(
        _fns["c51_fused_step"], device, q.data_ptr(), p.data_ptr(), r.data_ptr(),
        d.data_ptr(), ce.data_ptr(), ov.data_ptr(), E, B, A, *cp._scalars(support),
        leaves.data_ptr(), L, chunk_offsets.data_ptr(), chunk_offsets.numel(),
        next_prefixes.data_ptr(), idx.data_ptr(),
    )
    LAUNCHES["fused_step"] += 1
    return ce, ov, idx


class _FusedStepLoss(torch.autograd.Function):
    """Forward: kernel B4. Backward: kernel B1b, which recomputes Φ, so the
    only saved tensors are the loss inputs; the indices take no gradient."""

    @staticmethod
    def forward(ctx, support, q, p, r, d, next_prefixes, leaves, chunk_offsets):
        ctx.support = support
        ctx.save_for_backward(q, p, r, d)
        ce, ov, idx = fused_step_fwd(support, q, p, r, d, next_prefixes, leaves, chunk_offsets)
        ctx.mark_non_differentiable(idx)
        return ce, ov, idx

    @staticmethod
    def backward(ctx, g_ce, g_ov, _g_idx):
        q, p, r, d = ctx.saved_tensors
        zeros = None
        if g_ce is None or g_ov is None:
            zeros = q.new_zeros(q.shape[:-1])
        dq = cp.fused_loss_bwd(
            ctx.support, q, p, r, d,
            (zeros if g_ce is None else g_ce).contiguous(),
            (zeros if g_ov is None else g_ov).contiguous(),
        )
        return None, dq, None, None, None, None, None, None


def fused_categorical_loss_descent(
    support: CategoricalSupport,
    pred_logits: torch.Tensor,
    target_probs: torch.Tensor,
    rewards: torch.Tensor,
    discounts: torch.Tensor,
    next_prefixes: torch.Tensor,
    leaves: torch.Tensor,
    chunk_offsets: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`cuda_projection.fused_categorical_loss` for this grad step,
    plus the descent of the NEXT step's prefixes over ``leaves``, given the
    ``chunk_offsets`` that :func:`cuda_tree.find_prefix` returned for them.

    ``pred_logits`` may be the stacked [E, B, A] logits of E critics: one
    launch computes every member's loss and the descent once.

    Returns (ce, overlap, next_idx [B] int32), ce and overlap
    ``pred_logits.shape[:-1]``; next_idx is ``min(count, L − 1)``, before
    the caller's fill clamp. Gradients flow to ``pred_logits`` only.
    """
    return _FusedStepLoss.apply(
        support,
        cp.as_f32(pred_logits).contiguous(),
        cp.as_f32(target_probs.detach()).contiguous(),
        rewards.detach().contiguous(),
        discounts.detach().contiguous(),
        next_prefixes.detach().contiguous(),
        leaves.detach(),
        chunk_offsets,
    )
