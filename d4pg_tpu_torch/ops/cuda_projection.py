"""CUDA kernels for the C51 projection and the fused projection + loss.

Counterpart of ``d4pg_tpu/ops/pallas_projection.py``. Three hand-written
CUDA kernels (``csrc/projection.cu``) replace its three Pallas kernels:

=====================  ====================================  ==============
wrapper                replaces                              launch counter
=====================  ====================================  ==============
:func:`project`        ``_projection_kernel``                ``"project"``
:func:`fused_loss_fwd` ``_fused_loss_kernel``                ``"fused_fwd"``
:func:`fused_loss_bwd` ``_fused_loss_grad_kernel``           ``"fused_bwd"``
=====================  ====================================  ==============

:func:`fused_categorical_loss` is the ``torch.autograd.Function`` whose
forward is the fused forward kernel and whose backward is the fused
backward kernel: the projected target distribution m never reaches device
memory, in either pass.

The two fused kernels take the E stacked members of a twin or REDQ critic
in one launch: logits ``q`` [E, B, A] (a 2-D ``q`` is E = 1) against the
members' shared target ``p`` [B, A], ``r``, ``d`` [B], as the JAX package
vmaps the single-critic loss over the stack with the target unbatched.
The wrappers cast bfloat16 logits and target probabilities to float32, as
the JAX wrappers cast every input (``pallas_projection.py:129,226``); the
kernels are float32 only.

Which implementation runs is decided by the tensors' device. On a CUDA
tensor a wrapper launches its kernel or raises; it never falls back. On a
CPU tensor it runs the plain PyTorch version beside it
(:func:`project_plain`, :func:`fused_loss_plain`,
:func:`fused_loss_bwd_plain`), which is what the CPU tests hold against the
JAX package and what ``chip_smoke.py`` holds each kernel against on the
card.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from d4pg_tpu_torch.ops import _build
from d4pg_tpu_torch.ops.categorical import CategoricalSupport

# Every kernel runs a warp per row whose lanes loop over ceil(A / 32) atoms,
# at most 32 a lane.
MAX_ATOMS = 1024

# Kernel launches per wrapper. Each wrapper adds one where it launches its
# kernel and nowhere else; chip_smoke.py zeroes them before driving the
# learner and reads them after.
LAUNCHES = {"project": 0, "fused_fwd": 0, "fused_bwd": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "c51_project": [_P, _P, _P, _P, _I, _I, _F, _F, _F, _P],
    "c51_fused_loss_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _P],
    "c51_fused_loss_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _P],
}
_fns: dict = {}


def _kernel(name: str):
    """The ctypes entry point, built and loaded at first use."""
    if not _fns:
        _fns.update(_build.bind("projection", _SIGNATURES))
    return _fns[name]


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _validate(support: CategoricalSupport, rows: dict, cols: dict):
    """Check every [B, A] row input and [B] column input; returns (B, A,
    device) for the kernel launch."""
    first = next(iter(rows.values()))
    if first.dim() != 2:
        raise ValueError(f"expected [B, A] inputs, got shape {tuple(first.shape)}")
    B, A = first.shape
    if A != support.num_atoms:
        raise ValueError(f"{A} atoms in the inputs, support has {support.num_atoms}")
    if first.is_cuda and A > MAX_ATOMS:
        raise ValueError(f"the CUDA kernels take at most {MAX_ATOMS} atoms, got {A}")
    for n, t in rows.items():
        _check(n, t, (B, A), first.device)
    for n, t in cols.items():
        _check(n, t, (B,), first.device)
    return B, A, first.device


def as_f32(t: torch.Tensor) -> torch.Tensor:
    """A bfloat16 input (the bf16 compute path's) as float32, the JAX
    wrappers' ``astype(jnp.float32)``; any other dtype is left for
    :func:`_check` to accept or refuse."""
    return t.float() if t.dtype == torch.bfloat16 else t


def validate_stacked(support: CategoricalSupport, q, p, cols: dict, stacked: dict | None = None):
    """Check stacked logits ``q`` [E, B, A] (or [B, A], E = 1), the shared
    target ``p`` [B, A], the [B] columns ``cols`` and the columns
    ``stacked`` shaped like ``q`` without its atoms; returns (E, B, A,
    device) for the kernel launch."""
    if q.dim() not in (2, 3):
        raise ValueError(f"expected [E, B, A] or [B, A] logits, got shape {tuple(q.shape)}")
    E = q.shape[0] if q.dim() == 3 else 1
    B, A = q.shape[-2:]
    if E < 1:
        raise ValueError("a stack of critics needs at least one member")
    _validate(support, {"p": p}, cols)
    if tuple(p.shape) != (B, A):
        raise ValueError(f"p has shape {tuple(p.shape)}, expected {(B, A)}")
    _check("q", q, tuple(q.shape), p.device)
    for n, t in (stacked or {}).items():
        _check(n, t, tuple(q.shape[:-1]), p.device)
    if E * B * A >= 2**31:
        raise ValueError(f"{E} x {B} x {A} logits exceed the kernels' int32 row index")
    return E, B, A, p.device


def _launch(name: str, counter: str, device: torch.device, B: int, *args) -> None:
    """Launch on ``device``'s current stream and count the launch; raise if
    CUDA refused it. An empty batch launches nothing and counts nothing."""
    if B == 0:
        return
    _build.launch(_kernel(name), device, *args)
    LAUNCHES[counter] += 1


def _scalars(support: CategoricalSupport):
    return support.v_min, support.v_max, support.delta


# ---------------------------------------------------------------- plain


def project_plain(
    support: CategoricalSupport, p: torch.Tensor, r: torch.Tensor, d: torch.Tensor
) -> torch.Tensor:
    """Φ(r + d·z) by the hat formula, vectorised as a [B, A, A] tensor:
    m[b, i] = Σ_j p[b, j]·max(0, 1 − |bfrac[b, j] − i|). bfrac is rounded
    step by step, and ATen divides a CUDA tensor by the scalar delta through
    its float32 reciprocal: the rounding of the kernels' ``c51::bfrac_at``."""
    A = support.num_atoms
    col = torch.arange(A, device=p.device, dtype=torch.float32)
    z = support.v_min + col * support.delta
    tz = (r[:, None] + d[:, None] * z).clamp(support.v_min, support.v_max)
    bfrac = (tz - support.v_min) / support.delta                    # [B, A_src]
    w = (1.0 - (bfrac[:, :, None] - col).abs()).clamp_min(0.0)      # [B, A_src, A_dst]
    return torch.einsum("bj,bji->bi", p, w)


def ce_and_overlap(m: torch.Tensor, q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row ce = −Σ m·log_softmax(q) and ov = |−Σ m·softmax(q)| for a
    projected target m and logits q."""
    logp = F.log_softmax(q, dim=-1)
    return -(m * logp).sum(-1), (-(m * logp.exp()).sum(-1)).abs()


def fused_loss_plain(
    support: CategoricalSupport,
    q: torch.Tensor,
    p: torch.Tensor,
    r: torch.Tensor,
    d: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`ce_and_overlap` of m = Φ(r + d·z), m held constant
    (differentiable w.r.t. q only). Stacked logits q [E, B, A] broadcast
    against the one m [B, A]."""
    return ce_and_overlap(project_plain(support, p, r, d).detach(), q)


def fused_loss_bwd_plain(
    support: CategoricalSupport, q, p, r, d, g_ce, g_ov
) -> torch.Tensor:
    """dq of ``g_ce·ce + g_ov·ov`` by autograd through :func:`fused_loss_plain`."""
    with torch.enable_grad():
        qv = q.detach().requires_grad_(True)
        ce, ov = fused_loss_plain(support, qv, p, r, d)
        (dq,) = torch.autograd.grad((ce, ov), qv, (g_ce, g_ov))
    return dq


# ------------------------------------------------------------- wrappers


def project(
    support: CategoricalSupport, p: torch.Tensor, r: torch.Tensor, d: torch.Tensor
) -> torch.Tensor:
    """Φ(r + d·z) → m [B, A]. CUDA tensors: the ``c51_project`` kernel."""
    p = as_f32(p)
    B, A, device = _validate(support, {"p": p}, {"r": r, "d": d})
    if device.type != "cuda":
        return project_plain(support, p, r, d)
    m = torch.empty((B, A), device=device, dtype=torch.float32)
    _launch(
        "c51_project", "project", device, B, p.data_ptr(), r.data_ptr(),
        d.data_ptr(), m.data_ptr(), B, A, *_scalars(support),
    )
    return m


def fused_loss_fwd(
    support: CategoricalSupport,
    q: torch.Tensor,
    p: torch.Tensor,
    r: torch.Tensor,
    d: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample (ce, ov), each ``q.shape[:-1]``: [B], or [E, B] for
    stacked logits [E, B, A] against the shared target p [B, A]. CUDA
    tensors: ``c51_fused_loss_fwd``, one launch for all E members."""
    q, p = as_f32(q), as_f32(p)
    E, B, A, device = validate_stacked(support, q, p, {"r": r, "d": d})
    if device.type != "cuda":
        with torch.no_grad():
            return fused_loss_plain(support, q, p, r, d)
    ce = torch.empty(q.shape[:-1], device=device, dtype=torch.float32)
    ov = torch.empty(q.shape[:-1], device=device, dtype=torch.float32)
    _launch(
        "c51_fused_loss_fwd", "fused_fwd", device, B, q.data_ptr(), p.data_ptr(),
        r.data_ptr(), d.data_ptr(), ce.data_ptr(), ov.data_ptr(), E, B, A,
        *_scalars(support),
    )
    return ce, ov


def fused_loss_bwd(
    support: CategoricalSupport, q, p, r, d, g_ce, g_ov
) -> torch.Tensor:
    """dq, shaped like q ([B, A] or stacked [E, B, A]), for cotangents
    (g_ce, g_ov) shaped like the forward's (ce, ov), Φ recomputed. CUDA
    tensors: ``c51_fused_loss_bwd``, one launch for all E members."""
    q, p = as_f32(q), as_f32(p)
    E, B, A, device = validate_stacked(
        support, q, p, {"r": r, "d": d}, {"g_ce": g_ce, "g_ov": g_ov}
    )
    if device.type != "cuda":
        return fused_loss_bwd_plain(support, q, p, r, d, g_ce, g_ov)
    dq = torch.empty(q.shape, device=device, dtype=torch.float32)
    _launch(
        "c51_fused_loss_bwd", "fused_bwd", device, B, q.data_ptr(), p.data_ptr(),
        r.data_ptr(), d.data_ptr(), g_ce.data_ptr(), g_ov.data_ptr(),
        dq.data_ptr(), E, B, A, *_scalars(support),
    )
    return dq


class _FusedCategoricalLoss(torch.autograd.Function):
    """Forward: the fused kernel. Backward: the fused gradient kernel, which
    recomputes Φ, so the only saved tensors are the inputs themselves."""

    @staticmethod
    def forward(ctx, support, q, p, r, d):
        ctx.support = support
        ctx.save_for_backward(q, p, r, d)
        return fused_loss_fwd(support, q, p, r, d)

    @staticmethod
    def backward(ctx, g_ce, g_ov):
        q, p, r, d = ctx.saved_tensors
        zeros = None
        if g_ce is None or g_ov is None:
            zeros = q.new_zeros(q.shape[:-1])
        dq = fused_loss_bwd(
            ctx.support, q, p, r, d,
            (zeros if g_ce is None else g_ce).contiguous(),
            (zeros if g_ov is None else g_ov).contiguous(),
        )
        return None, dq, None, None, None


def fused_categorical_loss(
    support: CategoricalSupport,
    pred_logits: torch.Tensor,
    target_probs: torch.Tensor,
    rewards: torch.Tensor,
    discounts: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused Φ-projection + categorical cross-entropy, per sample, for
    ``pred_logits`` [B, A] or the stacked members' [E, B, A] against one
    target (``target_probs`` [B, A], ``rewards``, ``discounts`` [B]).

    Equivalent to::

        m  = categorical_projection(support, target_probs, rewards, discounts)
        ce = -sum(m * log_softmax(pred_logits), -1)
        ov = abs(-sum(m * softmax(pred_logits), -1))

    with gradients to ``pred_logits`` only (the target side is detached).
    Returns (ce, ov), each ``pred_logits.shape[:-1]``, float32.
    """
    return _FusedCategoricalLoss.apply(
        support,
        as_f32(pred_logits).contiguous(),
        as_f32(target_probs.detach()).contiguous(),
        rewards.detach().contiguous(),
        discounts.detach().contiguous(),
    )
