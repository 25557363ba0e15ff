"""CUDA kernel B3: the device-PER prefix descent.

Counterpart of ``d4pg_tpu/ops/pallas_tree.py``. The hand-written kernel
``per_tree_find_prefix`` (``csrc/per_tree.cu``, design in
``csrc/per_tree.cuh``) replaces the Pallas ``_count_kernel`` /
``count_tile`` behind ``find_prefix_pallas``::

    idx = min(#{ i : cumsum(leaves)[i] <= prefix }, L - 1)

which is the segment tree's descent with its ``>=`` rule (a prefix on a
cumsum boundary selects the next leaf; zero-mass leaves are skipped).

:func:`find_prefix` returns the indices and the exclusive chunk offsets
(the leaf mass before each chunk of ``CHUNK`` leaves) that its count
blocks searched: the fused-descent megastep hands those to every kernel-B4
launch of the dispatch (``ops/cuda_fused_step.py``), whose count blocks
load them and run the same device code, so B4's indices equal B3's.

The kernel's first pass computes those offsets once, in its last block to
finish, which it finds by a ticket on a device counter: one persistent
int32 counter per (device, stream) (``_ticket``), reset to 0 by the kernel
itself at the end of every pass 1, so back-to-back calls and CUDA-graph
replays need no host step. Calls on one stream run in order, and calls on
two streams take two counters, so they may overlap. The counters are made
zeroed, ``_TICKETS_PER_BLOCK`` at a time, at a device's first call, which
must therefore not be inside a graph capture; a stream met later, inside a
capture too, takes a counter already made. A captured graph keeps the
counter of the stream it was captured on.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it runs :func:`find_prefix_plain`, which is what the CPU tests hold
against the JAX package's descent and what ``chip_smoke.py`` holds the
kernel against on the card. The two sum the leaves in different orders:
see ``csrc/per_tree.cuh`` for the stated tolerance at L = 2^20.
"""

from __future__ import annotations

import ctypes

import torch

from d4pg_tpu_torch.ops import _build

CHUNK = 1024  # leaves per chunk: per_tree::kChunk in csrc/per_tree.cuh
MAX_CHUNKS = 12288  # chunk offsets staged in 48 KB of shared memory

# Kernel launches per wrapper call (both passes are one call); chip_smoke.py
# zeroes the count before driving the learner and reads it after.
LAUNCHES = {"tree_count": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"per_tree_find_prefix": [_P, _I, _P, _P, _I, _P, _I, _P, _P, _P]}
_fns: dict = {}
_TICKETS_PER_BLOCK = 64
_tickets: dict = {}  # (device, stream handle) -> its int32 ticket counter (0 between calls)
_spare_tickets: dict = {}  # device -> zeroed counters not yet given to a stream


def num_chunks(L: int) -> int:
    return -(-L // CHUNK)


def chain_length(L: int) -> int:
    """The longest chain of float32 adds behind one of the kernel's cumsum
    values at ``L`` leaves (``csrc/per_tree.cuh``, "Numerics"): the chunk
    offset's, then the walk inside the chunk. A value is within
    ``chain_length(L) * 2**-24 * total`` of the exact sum."""
    return 2 * (-(-num_chunks(L) // 32)) + 5 + CHUNK // 32 + 5 + 1


def _ticket(device: torch.device) -> torch.Tensor:
    """The ticket counter of ``device``'s current stream. A new block of
    zeroed counters made inside a graph capture would live in the graph's
    memory pool and be zeroed only by a replay, so that is refused."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    t = _tickets.get(key)
    if t is None:
        spare = _spare_tickets.get(device)
        if not spare:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "call find_prefix once on this device before capturing it in a CUDA graph"
                )
            block = torch.zeros((_TICKETS_PER_BLOCK,), device=device, dtype=torch.int32)
            spare = _spare_tickets[device] = list(block.split(1))
        t = _tickets[key] = spare.pop()
    return t


def _check_leaves(leaves: torch.Tensor) -> None:
    if leaves.dim() != 1 or leaves.numel() < 1:
        raise ValueError(f"leaves must be a non-empty [L] vector, got {tuple(leaves.shape)}")
    if leaves.dtype != torch.float32:
        raise TypeError(f"leaves must be float32, got {leaves.dtype}")
    if not leaves.is_contiguous():
        raise ValueError("leaves must be contiguous")
    if leaves.is_cuda and num_chunks(leaves.numel()) > MAX_CHUNKS:
        raise ValueError(
            f"the CUDA descent takes at most {MAX_CHUNKS * CHUNK} leaves, got {leaves.numel()}"
        )


def _check_prefixes(prefixes: torch.Tensor, device: torch.device) -> None:
    if prefixes.device != device:
        raise ValueError(f"prefixes are on {prefixes.device}, leaves on {device}")
    if prefixes.dtype != torch.float32:
        raise TypeError(f"prefixes must be float32, got {prefixes.dtype}")


def find_prefix_plain(leaves: torch.Tensor, prefixes: torch.Tensor) -> torch.Tensor:
    """#{i : cumsum(leaves)[i] <= prefix} clamped to L − 1, as int32 of
    ``prefixes``' shape: ``searchsorted(cumsum, right=True)``."""
    cs = torch.cumsum(leaves, 0)
    idx = torch.searchsorted(cs, prefixes.reshape(-1).contiguous(), right=True)
    return idx.clamp_max(leaves.numel() - 1).to(torch.int32).reshape(prefixes.shape)


def chunk_offsets_plain(leaves: torch.Tensor) -> torch.Tensor:
    """The exclusive cumsum of the per-chunk leaf sums, [num_chunks(L)]
    float32: the leaf mass before each chunk of ``CHUNK`` leaves (a ragged
    last chunk sums what it has). The kernel sums in another order; the
    tolerance is stated in ``csrc/per_tree.cuh``."""
    L = leaves.numel()
    padded = torch.zeros(num_chunks(L) * CHUNK, dtype=leaves.dtype, device=leaves.device)
    padded[:L] = leaves
    sums = padded.reshape(-1, CHUNK).sum(1)
    return torch.cumsum(sums, 0) - sums


def find_prefix(
    leaves: torch.Tensor, prefixes: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Leaf indices (int32, ``prefixes``' shape) and the chunk offsets
    ([num_chunks(L)] float32) of ``leaves`` [L]. CUDA tensors: the
    ``per_tree_find_prefix`` kernel (one launch count per call), whose
    offsets are the ones its count searched; CPU tensors:
    :func:`find_prefix_plain` and :func:`chunk_offsets_plain`. An empty
    ``prefixes`` launches nothing and counts nothing (nor are the offsets
    written)."""
    _check_leaves(leaves)
    _check_prefixes(prefixes, leaves.device)
    if not leaves.is_cuda:
        return find_prefix_plain(leaves, prefixes), chunk_offsets_plain(leaves)
    L, nchunks = leaves.numel(), num_chunks(leaves.numel())
    flat = prefixes.reshape(-1).contiguous()
    idx = torch.empty(flat.shape, device=leaves.device, dtype=torch.int32)
    # one buffer: the offsets first (the allocator's alignment, so the count
    # blocks of B3 and B4 load them 16 bytes at a time), then the chunk
    # sums, scratch of pass 1
    work = torch.empty((2 * nchunks,), device=leaves.device, dtype=torch.float32)
    offsets, sums = work[:nchunks], work[nchunks:]
    if flat.numel():
        if not _fns:
            _fns.update(_build.bind("per_tree", _SIGNATURES))
        _build.launch(
            _fns["per_tree_find_prefix"], leaves.device, leaves.data_ptr(), L,
            sums.data_ptr(), offsets.data_ptr(), nchunks, flat.data_ptr(),
            flat.numel(), idx.data_ptr(), _ticket(leaves.device).data_ptr(),
        )
        LAUNCHES["tree_count"] += 1
    return idx.reshape(prefixes.shape), offsets
