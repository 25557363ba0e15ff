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
  through pinned memory and asynchronous copies.

Chunks are exactly as long as the rows they carry: eager PyTorch has no
per-shape compile, so the fixed-shape padding the JAX ingest needs is not
used, and no pad row or pad slot exists to land. ``stage()`` /
``--ingest-prefetch`` and the sharded and multi-host syncs wait for ROADMAP
A6 and A7.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from d4pg_tpu_torch import resolve_device

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


class DeviceRingSync:
    """Keeps a :class:`DeviceRing` mirroring a host ``ReplayBuffer``'s ring.

    ``flush(ring)`` ships every row written to the host buffer since the
    last flush (by its ``total_added`` counter): slot indices come from the
    host write head (write j landed at slot ``j % capacity``), rows from
    the buffer's own ``gather``. More than ``capacity`` pending writes
    collapse to one full-ring resync: the overwritten rows no longer exist
    to ship. Rows are staged to the ring's own device. ``tree_hook``, when
    set, is called with each chunk's device slot tensor
    (``DevicePerSync.on_chunk`` seeds the priority leaves of the same rows).
    """

    def __init__(self, buffer, chunk_cap: int = 4096):
        self._buffer = buffer
        self.capacity = int(buffer.capacity)
        self.chunk_cap = int(min(chunk_cap, self.capacity))
        self._synced = 0  # host total_added already mirrored
        self.tree_hook = None
        self.bytes_ingested = 0
        self.chunks_ingested = 0

    def pending(self) -> int:
        return min(self._buffer.total_added - self._synced, self.capacity)

    @staticmethod
    def _stage(arr: np.ndarray, device: torch.device) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if device.type == "cuda":
            # pinned staging, so the copy is asynchronous; PyTorch's host
            # allocator keeps the pinned block until the copy has run
            return t.pin_memory().to(device, non_blocking=True)
        return t

    def flush(self, ring: DeviceRing) -> DeviceRing:
        """Mirror all pending host writes into ``ring``, IN PLACE; returns
        ``ring``."""
        total = self._buffer.total_added
        n_pending = min(total - self._synced, self.capacity)
        if n_pending <= 0:
            return ring
        first = total - n_pending
        new_size = min(total, self.capacity)
        device = ring.obs.device
        for lo in range(0, n_pending, self.chunk_cap):
            n = min(self.chunk_cap, n_pending - lo)
            slots = (first + lo + np.arange(n)) % self.capacity
            chunk = self._buffer.gather(slots)
            dev_chunk = {k: self._stage(chunk[k], device) for k in FIELDS}
            slots_dev = self._stage(slots.astype(np.int64), device)
            ingest_body(ring, dev_chunk, slots_dev, new_size)
            if self.tree_hook is not None:
                self.tree_hook(slots_dev)
            self.bytes_ingested += sum(v.nbytes for v in chunk.values()) + 8 * n
            self.chunks_ingested += 1
        self._synced = total
        return ring
