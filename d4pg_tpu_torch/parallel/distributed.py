"""Multi-process bring-up and the exact collectives the lanes need
(counterpart of ``d4pg_tpu/parallel/distributed.py``).

One rank per process over ``torch.distributed``. The process group is
given its address, world size and rank explicitly (``tcp://HOST:PORT``,
the CLI's ``--coordinator`` / ``--num-processes`` / ``--process-id``),
or reads them from a launcher's variables (``env://``: ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``; the CLI's ``--distributed``).
It has a timeout, so a missing peer fails the run instead of hanging it.

The default group is always ``gloo``: host integers, checkpoint gathers
and the bring-up's own exchange ride it. The lanes' gradient rows ride
``nccl`` when each rank computes on a card of its own, and the default
gloo group when ranks share a card (NCCL refuses two ranks on one GPU).
Which it is is not guessed from the world size or a launcher's variables:
at bring-up every rank reports its card's UUID over gloo, and NCCL is
chosen iff the UUIDs are distinct (:func:`choose_backend`). Gloo gathers
the CUDA rows themselves (it copies through the host inside;
``all_gather`` of CUDA tensors works on the card's torch build, checked
on an H100 before this module relied on it), so no tensor moves to the
CPU outside the collective.

Every collective here is a copy (``all_gather``), never a reduction, so
the lanes' arithmetic is the callers' (``parallel/dp.py``'s fixed-order
mean, exact min and max) and is the same in one process as in several.
Under ``torch.cuda.set_sync_debug_mode("error")`` (``--debug-guards``) a
collective on the multi-rank path runs with the guard lifted
(``analysis/transfer.py:explicit_transfer``): gloo syncs the host and
copies through it by design, so the guard covers the lanes' compute only.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch

from d4pg_tpu_torch.analysis.transfer import explicit_transfer

DEFAULT_TIMEOUT_S = 300.0

_GROUP = {"backend": None, "lanes": None}


def process_count() -> int:
    d = torch.distributed
    return d.get_world_size() if d.is_available() and d.is_initialized() else 1


def process_index() -> int:
    d = torch.distributed
    return d.get_rank() if d.is_available() and d.is_initialized() else 0


def backend() -> str | None:
    """The lanes' backend, ``None`` in a single-process run."""
    return _GROUP["backend"] if process_count() > 1 else None


def choose_backend(cards: list | None) -> str:
    """``nccl`` iff every rank computes on a card of its own: ``cards`` are
    the ranks' card identities (UUIDs), ``None`` on the CPU; else
    ``gloo``."""
    if cards is None or len(set(cards)) < len(cards):
        return "gloo"
    return "nccl"


def rank_card(rank: int, lanes_per_process: int) -> int:
    """The card a rank computes on: its first lane's, ``cuda:(p·L %
    cards)`` of this host's cards (``parallel/mesh.py``)."""
    return (rank * lanes_per_process) % max(torch.cuda.device_count(), 1)


def _card_uuid(card: int) -> str:
    return str(torch.cuda.get_device_properties(card).uuid)


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    autodetect: bool = False,
    device: str = "cuda",
    dp: int | None = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> dict:
    """Join the process group (a no-op for a single process) and return a
    summary for the ``[distributed]`` line. Call it before the
    ``Trainer`` is built. ``dp`` (the global dp lane count) places each
    rank on its first lane's card, which it makes the current device (its
    tp lanes share it)."""
    d = torch.distributed
    if coordinator_address is not None or (num_processes or 0) > 1:
        if coordinator_address is None:
            raise ValueError(
                f"--num-processes {num_processes} needs a coordinator: pass "
                "--coordinator HOST:PORT or set D4PG_COORDINATOR"
            )
        if num_processes is None or process_id is None:
            raise ValueError(
                f"--coordinator {coordinator_address} needs --num-processes and "
                "--process-id (or D4PG_NUM_PROCESSES and D4PG_PROCESS_ID)"
            )
        init = dict(init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                    rank=process_id)
    elif autodetect:
        init = dict(init_method="env://")
    else:
        init = None
    cuda = torch.device(device).type == "cuda"
    if init is not None and not d.is_initialized():
        d.init_process_group("gloo", timeout=datetime.timedelta(seconds=timeout_s), **init)
        world, rank = d.get_world_size(), d.get_rank()
        cards = None
        if cuda:
            card = rank_card(rank, max(1, (dp or world) // world))
            torch.cuda.set_device(card)
            cards = [None] * world
            d.all_gather_object(cards, _card_uuid(card))
        name = choose_backend(cards)
        _GROUP["backend"] = name
        _GROUP["lanes"] = d.new_group(backend="nccl") if name == "nccl" else None
    return {
        "process_index": process_index(),
        "process_count": process_count(),
        "local_device_count": torch.cuda.device_count() if cuda else 1,
        "backend": backend(),
    }


def shutdown() -> None:
    """Leave the process group (end of a CLI run)."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    _GROUP.update(backend=None, lanes=None)


def all_gather_lanes(rows: torch.Tensor) -> torch.Tensor:
    """``[L, ...]`` rows of this rank's lanes → ``[P·L, ...]`` rows of
    every lane, in lane order, on ``rows``' device. Exact (a copy). The
    identity in a single-process run."""
    world = process_count()
    if world == 1:
        return rows
    d = torch.distributed
    rows = rows.contiguous()
    with explicit_transfer():
        if _GROUP["backend"] == "nccl":
            out = torch.empty((world,) + tuple(rows.shape), dtype=rows.dtype, device=rows.device)
            d.all_gather_into_tensor(out, rows, group=_GROUP["lanes"])
            return out.reshape((-1,) + tuple(rows.shape[1:]))
        parts = [torch.empty_like(rows) for _ in range(world)]
        d.all_gather(parts, rows)
        return torch.cat(parts)


def host_allgather_i64(values) -> np.ndarray:
    """Exact all-gather of a small int64 vector across processes:
    ``[n] -> [process_count, n]``, row ``p`` = process ``p``'s values.
    Single-process returns ``values[None]``."""
    vals = np.asarray(values, dtype=np.int64).reshape(-1)
    world = process_count()
    if world == 1:
        return vals[None]
    t = torch.from_numpy(vals.copy())
    parts = [torch.empty_like(t) for _ in range(world)]
    torch.distributed.all_gather(parts, t)
    return torch.stack(parts).numpy()


def gather_global(local: np.ndarray) -> np.ndarray:
    """This process's ``[L, ...]`` lane slices → the ``[P·L, ...]`` whole
    on the host, in lane order (every process must call it; the identity
    single-process). The checkpoint path: one gather per save."""
    local = np.ascontiguousarray(local)
    world = process_count()
    if world == 1:
        return local
    t = torch.from_numpy(local)
    parts = [torch.empty_like(t) for _ in range(world)]
    torch.distributed.all_gather(parts, t)
    return torch.cat(parts).numpy()


def local_shard_span(mesh) -> tuple[int, int]:
    """The contiguous ``[lo, hi)`` range of lanes this process owns. The
    striped replay deal and the snapshot's global slot order rely on it,
    so it is asserted against the mesh's owners, not assumed."""
    mine = [d for d in range(mesh.dp) if mesh.owner(d) == mesh.process_index]
    if not mine:
        raise ValueError(f"process {mesh.process_index} owns no lane")
    lo, hi = mine[0], mine[-1] + 1
    if mine != list(range(lo, hi)):
        raise ValueError(f"process {mesh.process_index}'s lanes are not contiguous: {mine}")
    return lo, hi
