"""Device-resident replay: a ring on the card mirroring the host buffer.

Counterpart of ``d4pg_tpu/replay/device_ring.py`` (single device). The
host :class:`~d4pg_tpu_torch.replay.uniform.ReplayBuffer` stays the source
of truth for writes; this module mirrors its ring rows onto the device so
the megastep (``runtime/megastep.py``) gathers batches without a
host-to-device batch copy per grad step.

- :class:`DeviceRing`: the transition fields as ``[capacity, ...]``
  tensors on the device, plus ``size``, the fill count, as a 0-d int32
  device tensor (the megastep reads it there, never on the host);
- :func:`ingest_body`: scatters one chunk of rows into the ring at
  explicit slots, IN PLACE;
- :class:`DeviceRingSync`: the host-side flusher. It diffs the host
  buffer's monotone ``total_added`` counter and ships only the rows
  written since the last flush, in chunks of at most ``chunk_cap`` rows,
  through pinned memory and asynchronous copies; ``stage`` starts the
  next flush's first chunk early (``--ingest-prefetch``).

Chunks are exactly as long as the rows they carry: eager PyTorch has no
per-shape compile, so the fixed-shape padding the JAX ingest needs is not
used, and no pad row or pad slot exists to land. The sharded and
multi-host syncs wait for ROADMAP A7.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from d4pg_tpu_torch import resolve_device
from d4pg_tpu_torch.utils.h2d import H2DStream, to_device

FIELDS = ("obs", "action", "reward", "next_obs", "discount")


@dataclass
class DeviceRing:
    """Transition fields on the device; names match the batch-dict keys,
    so :func:`~d4pg_tpu_torch.agent.d4pg.gather_batches` reads it
    directly."""

    obs: torch.Tensor       # [C, O] f32
    action: torch.Tensor    # [C, A] f32
    reward: torch.Tensor    # [C]    f32
    next_obs: torch.Tensor  # [C, O] f32
    discount: torch.Tensor  # [C]    f32
    size: torch.Tensor      # 0-d int32, the filled-row count


def device_ring_init(capacity: int, obs_dim: int, action_dim: int, device=None) -> DeviceRing:
    """A zero ring on ``device`` (default: the CUDA card)."""
    device = resolve_device(device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return DeviceRing(
        obs=zeros(capacity, obs_dim),
        action=zeros(capacity, action_dim),
        reward=zeros(capacity),
        next_obs=zeros(capacity, obs_dim),
        discount=zeros(capacity),
        size=torch.zeros((), dtype=torch.int32, device=device),
    )


def ingest_body(ring: DeviceRing, chunk: dict, slots: torch.Tensor, new_size: int) -> DeviceRing:
    """Write the chunk's rows at ring ``slots`` (int64 [n], distinct) and
    set the fill count, IN PLACE; returns ``ring``."""
    for k in FIELDS:
        getattr(ring, k).index_copy_(0, slots, chunk[k])
    ring.size.fill_(new_size)
    return ring


@dataclass
class _StagedChunk:
    """The next flush's first chunk, copied ahead by :meth:`DeviceRingSync.stage`."""

    synced_at: int     # the sync's mirrored count when it was staged
    covers: int        # the mirrored count once it lands
    dev_chunk: dict    # FIELDS and "slots" (int64), on the device
    ready: object      # the copy-done event (None on the CPU)
    new_size: int
    nbytes: int


class DeviceRingSync:
    """Keeps a :class:`DeviceRing` mirroring a host ``ReplayBuffer``'s ring.

    ``flush(ring)`` ships every row written to the host buffer since the
    last flush (by its ``total_added`` counter): slot indices come from the
    host write head (write j landed at slot ``j % capacity``), rows from
    the buffer's own locked ``gather``. More than ``capacity`` pending
    writes collapse to one full-ring resync: the overwritten rows no longer
    exist to ship. Rows are copied to the ring's own device on the
    current stream, which scatters them next.
    ``tree_hook``, when set, is called with each chunk's device slot tensor
    (``DevicePerSync.on_chunk`` seeds the priority leaves of the same rows).

    ``stage(ring)`` (``--ingest-prefetch``) gathers the next flush's first
    chunk and starts its copy early, while a dispatch runs, on a copy
    stream of its own (:class:`~d4pg_tpu_torch.utils.h2d.H2DStream`); ``flush``
    scatters it first and ships the rows written since in its remainder
    loop, after it, so the last write to a slot wins.
    """

    def __init__(self, buffer, chunk_cap: int = 4096):
        self._buffer = buffer
        self.capacity = int(buffer.capacity)
        self.chunk_cap = int(min(chunk_cap, self.capacity))
        self._synced = 0  # host total_added already mirrored
        self.tree_hook = None
        self.bytes_ingested = 0
        self.chunks_ingested = 0
        self._staged: Optional[_StagedChunk] = None
        self._h2d: Optional[H2DStream] = None

    def pending(self) -> int:
        return min(self._buffer.total_added - self._synced, self.capacity)

    def _copier(self, ring: DeviceRing) -> H2DStream:
        device = ring.obs.device
        if self._h2d is None or self._h2d.device != device:
            self._h2d = H2DStream(device)
        return self._h2d

    def _gather(self, ring: DeviceRing, first: int, n: int, ahead: bool):
        """The rows of writes [first, first + n) and their slots, copy
        started on the current stream, or with ``ahead`` on the copy
        stream: ``(device chunk, ready event or None, bytes)``."""
        slots = (first + np.arange(n)) % self.capacity
        chunk = dict(self._buffer.gather(slots))  # locked: never a torn row
        chunk["slots"] = slots.astype(np.int64)
        nbytes = sum(v.nbytes for v in chunk.values())
        if ahead:
            return (*self._copier(ring).put(chunk), nbytes)
        return to_device(chunk, ring.obs.device), None, nbytes

    def _ingest(self, ring: DeviceRing, dev_chunk: dict, ready, new_size: int, nbytes: int) -> None:
        if ready is not None:
            self._h2d.consume(dev_chunk, ready)
        ingest_body(ring, dev_chunk, dev_chunk["slots"], new_size)
        if self.tree_hook is not None:
            self.tree_hook(dev_chunk["slots"])
        self.bytes_ingested += nbytes
        self.chunks_ingested += 1

    def stage(self, ring: DeviceRing) -> bool:
        """Gather at most ``chunk_cap`` pending rows and start their copy to
        the ring's device NOW, so that the copy overlaps the dispatch in
        flight instead of running in front of the next one. A no-op when a
        chunk is already staged or nothing is pending; returns True iff a
        chunk is staged on exit. The ring is not written until
        :meth:`flush`."""
        if self._staged is not None:
            return True
        total = self._buffer.total_added
        n_pending = min(total - self._synced, self.capacity)
        if n_pending <= 0:
            return False
        first = total - n_pending
        n = min(n_pending, self.chunk_cap)
        dev_chunk, ready, nbytes = self._gather(ring, first, n, ahead=True)
        covers = first + n
        self._staged = _StagedChunk(
            synced_at=self._synced, covers=covers, dev_chunk=dev_chunk, ready=ready,
            new_size=min(covers, self.capacity), nbytes=nbytes,
        )
        return True

    def flush(self, ring: DeviceRing) -> DeviceRing:
        """Mirror all pending host writes into ``ring``, IN PLACE; returns
        ``ring``."""
        staged, self._staged = self._staged, None
        if staged is not None and staged.synced_at == self._synced:
            # Its rows were current when staged; rows written (or
            # overwritten) since fall in [covers, total) and ship below, in
            # write order, so this scatter never shadows a newer row.
            self._ingest(ring, staged.dev_chunk, staged.ready, staged.new_size, staged.nbytes)
            self._synced = staged.covers
        total = self._buffer.total_added
        n_pending = min(total - self._synced, self.capacity)
        if n_pending <= 0:
            return ring
        first = total - n_pending
        new_size = min(total, self.capacity)
        for lo in range(0, n_pending, self.chunk_cap):
            n = min(self.chunk_cap, n_pending - lo)
            dev_chunk, ready, nbytes = self._gather(ring, first + lo, n, ahead=False)
            self._ingest(ring, dev_chunk, ready, new_size, nbytes)
        self._synced = total
        return ring
