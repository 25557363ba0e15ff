"""Transfer and sync guards for the steady-state dispatch (the torch
counterparts of ``d4pg_tpu/analysis/transfer.py``).

The discipline the JAX guards enforce holds for the port too: a
steady-state dispatch consumes only device-resident operands, and every
host-to-device copy is an explicit staging step outside it (the host
batch's ``to_device``/``H2DStream.put``, the ring flush, the hybrid
index copy, the batcher's input slot). JAX has a switch for that
(``jax.transfer_guard``), which acts where a host value meets the device:
at the operands of the jitted call (inside the jitted program nothing
transfers). torch has no such switch, so this module builds it from two
pieces, both at the dispatch's boundary:

- :func:`no_implicit_transfers` checks the dispatch's operands once, on
  entry: it walks the operand tree (tensors, lists, tuples, dicts,
  dataclasses, modules' parameters and buffers, and the attributes of
  plain objects such as the train state) and raises
  :class:`TransferGuardError` when CPU tensors sit among operands on
  another device. That covers a 0-d CPU tensor, which PyTorch hands to a
  CUDA kernel silently, and CPU indices meant for a device tensor. An
  optimizer's state is not walked: Adam keeps its step counts on the
  host by design and reads them there.
- :func:`sync_debug_error` and :func:`sync_guard` run a block under
  ``torch.cuda.set_sync_debug_mode("error")``, which makes a host
  synchronisation inside it raise: every device-to-host fetch
  (``.item()``, ``.tolist()``, ``.cpu()``, ``bool()`` of a device value)
  and every blocking host-to-device copy. ``set_sync_debug_mode`` is
  process wide: :func:`sync_debug_error` sets it and restores the mode it
  found (one thread at a time: the learner's dispatch), and
  :func:`sync_guard` counts the threads inside it (every resident serving
  policy's device thread enters it) and clears the mode when the last one
  leaves. ``Event.synchronize`` is not counted by it (the flusher's and
  the reply thread's waits).

:func:`no_transfers`, the megastep's zero-transfer budget, is the two
together. What they cannot see: a CPU tensor made inside the dispatch
and passed to a device op (its operands were checked, not every op's),
a ``non_blocking`` copy from the host inside the dispatch (it does not
synchronise), and the raw-pointer launches of the port's CUDA kernels
(``ops/cuda_*.py``). Checking every op instead (a ``TorchFunctionMode``
or a ``TorchDispatchMode``) costs a Python call per torch call: a
guarded learner on an H100 ran at 0.64-0.72x of its rate under the
function mode and at a fourth to a seventh under the dispatch mode, so
the guard stays at the boundary, where JAX's acts.

On the CPU there is no device and nothing transfers: the trainer and the
batcher push these guards only on the card. The tests drive the operand
check on the CPU with ``meta`` tensors standing in for the device.
"""

from __future__ import annotations

import contextlib
import dataclasses

from d4pg_tpu_torch.analysis import lockwitness

__all__ = [
    "TransferGuardError", "check_operands", "no_implicit_transfers", "no_transfers",
    "explicit_transfer", "sync_debug_error", "sync_guard",
]


class TransferGuardError(RuntimeError):
    """A host/device transfer the enclosing guard forbids."""


def _tensors(tree):
    """Every tensor of an operand tree, each object visited once."""
    import torch

    stack, seen = [tree], set()
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            yield x
        elif x is None or isinstance(x, (str, bytes, int, float, torch.Generator,
                                         torch.optim.Optimizer)) or id(x) in seen:
            continue
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, torch.nn.Module):
            seen.add(id(x))
            stack.extend(x.parameters())
            stack.extend(x.buffers())
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            seen.add(id(x))
            stack.extend(getattr(x, f.name) for f in dataclasses.fields(x))
        elif hasattr(x, "__dict__") and not isinstance(x, type):
            seen.add(id(x))
            stack.extend(vars(x).values())


def _describe(t) -> str:
    return f"{t.device.type} {str(t.dtype).replace('torch.', '')}{list(t.shape)}"


def check_operands(*operands) -> None:
    """Raise :class:`TransferGuardError` when the operands hold CPU
    tensors beside tensors on another device (each would be copied to the
    device implicitly, or read there as a host scalar)."""
    ts = list(_tensors(operands))
    host = [t for t in ts if t.device.type == "cpu"]
    if host and len(host) < len(ts):
        on = sorted({t.device.type for t in ts} - {"cpu"})
        raise TransferGuardError(
            f"implicit host-to-device transfer of {', '.join(_describe(t) for t in host)} "
            f"into a dispatch on {', '.join(on)}; copy it explicitly before the dispatch"
        )


@contextlib.contextmanager
def no_implicit_transfers(*operands, enabled: bool = True):
    """Context: the dispatch's operands are checked on entry
    (:func:`check_operands`); explicit copies inside stay allowed. No-op
    when ``enabled`` is False, so call sites can wrap unconditionally."""
    if enabled:
        check_operands(*operands)
    yield


@contextlib.contextmanager
def no_transfers(*operands, enabled: bool = True):
    """The zero-transfer budget of the steady-state dispatch: the operands
    checked on entry as in :func:`no_implicit_transfers`, and the block
    run under :func:`sync_debug_error` (on a card), so a device-to-host
    fetch or a blocking copy inside raises. State, ring, tree and
    generator are already on the device and nothing comes back but the
    dispatch's outputs, so the per-grad-step transfer count is zero. The
    explicit staging (the ring flush, the hybrid index copy) runs outside
    this scope. The first dispatch runs unguarded, as in the JAX trainer:
    it builds and loads the kernels."""
    import torch

    if not enabled:
        yield
        return
    check_operands(*operands)
    with sync_debug_error() if torch.cuda.is_available() else contextlib.nullcontext():
        yield


@contextlib.contextmanager
def explicit_transfer():
    """Escape hatch for a deliberate transfer inside a guarded region (a
    gloo collective syncs the host and copies through it by design): the
    sync guard is lifted for the block and the caller's mode restored."""
    import torch

    if not torch.cuda.is_available():
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


@contextlib.contextmanager
def sync_debug_error():
    """``torch.cuda.set_sync_debug_mode("error")`` for the block, the
    previous mode restored after it: a host synchronisation inside the
    block raises."""
    import torch

    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


# set_sync_debug_mode is process-wide, and every resident policy's device
# thread enters sync_guard: the mode stays "error" until the last thread
# inside leaves.
_GUARD_LOCK = lockwitness.named_lock("d4pg_tpu_torch.analysis.transfer:_GUARD_LOCK")
_GUARD_DEPTH = 0


@contextlib.contextmanager
def sync_guard():
    """Run the block under ``torch.cuda.set_sync_debug_mode("error")``,
    shared by concurrent threads: the first one in sets the mode, the
    last one out clears it."""
    import torch

    global _GUARD_DEPTH
    with _GUARD_LOCK:
        _GUARD_DEPTH += 1
        if _GUARD_DEPTH == 1:
            torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        with _GUARD_LOCK:
            _GUARD_DEPTH -= 1
            if _GUARD_DEPTH == 0:
                torch.cuda.set_sync_debug_mode(0)
