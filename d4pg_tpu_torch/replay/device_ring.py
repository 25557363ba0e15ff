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
  explicit slots, IN PLACE; pad rows (slot ``capacity``) drop;
- :class:`DeviceRingSync`: the host-side flusher. It diffs the host
  buffer's monotone ``total_added`` counter and ships only the rows
  written since the last flush, in chunks of exactly ``chunk_cap`` rows
  (the tail padded, as the JAX ingest pads it), through pinned memory and
  asynchronous copies, into the ring through ONE compiled program
  (:attr:`DeviceRingSync.ingest_program`, ``utils/graphs.py``; a CUDA
  graph on the card) whose fill count is a device input, so the run
  builds exactly one specialization; ``stage`` starts the next flush's
  first chunk early (``--ingest-prefetch``).

Data parallelism (``--dp``, ``parallel/``) stripes the ring over the
lanes (:func:`striped_perm`): host slot ``j`` lives on lane ``j % dp`` at
row ``j // dp``, so every lane fills evenly from the first rows. Each lane
holds a :class:`DeviceRing` of ``capacity/dp`` rows on its device whose
``size`` is the GLOBAL fill count. :class:`ShardedDeviceRingSync` deals a
host buffer to this process's lanes, in one process through ONE compiled
program (:attr:`ShardedDeviceRingSync.ingest_program`) that writes a
lane's chunk, padded to ``chunk_local`` rows, the lane and the fill count
its device inputs (:func:`lane_ingest_body`); :class:`MultihostRingSync` does it
for a process that owns ``capacity/P`` of the rows in a buffer of its own,
agreeing the global fill count with the other processes at each flush,
and assembles (and deals back) a snapshot in global slot order, so a
checkpoint does not depend on the topology that wrote it. Its flushes
stay eager: their fill count is agreed across the processes on the host.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial
from typing import Mapping, Optional

import numpy as np
import torch

from d4pg_tpu_torch import resolve_device
from d4pg_tpu_torch.parallel.distributed import (
    gather_global,
    host_allgather_i64,
    local_shard_span,
)
from d4pg_tpu_torch.parallel.partition import dp_fields, ring_partition_specs
from d4pg_tpu_torch.utils import graphs
from d4pg_tpu_torch.utils.h2d import H2DStream, to_device

FIELDS = ("obs", "action", "reward", "next_obs", "discount")


def lane_fields(ring) -> tuple:
    """The fields of a ring (a :class:`DeviceRing`, or a mapping of its
    fields: a host buffer's arrays, a snapshot) that
    ``parallel/partition.py``'s ``RING_RULES`` shard over "dp": the rows
    the striped layout deals to the lanes. The fill count replicates."""
    if not isinstance(ring, Mapping):
        ring = {f.name: getattr(ring, f.name) for f in dataclasses.fields(ring)}
    sharded = dp_fields(ring_partition_specs(
        {k: v for k, v in ring.items() if k in FIELDS + ("size",)}))
    return tuple(k for k in FIELDS if k in sharded)


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


def ingest_body(ring: DeviceRing, chunk: dict, slots: torch.Tensor, new_size) -> DeviceRing:
    """Write the chunk's rows at ring ``slots`` (int64 [n], distinct) and
    set the fill count (an int, or a 0-d int32 device tensor), IN PLACE;
    returns ``ring``. A pad row carries slot ``capacity`` (the JAX
    ingest's out-of-bounds slot, dropped by its ``mode="drop"``
    scatter) and sits after the real rows: it writes the chunk's last real
    row again, at that row's slot, the same bytes to the same place, so it
    lands as nothing. No host value is read."""
    n = slots.shape[0]
    keep = slots < ring.obs.shape[0]
    last = (keep.sum() - 1).clamp_min(0)
    src = torch.where(keep, torch.arange(n, device=slots.device), last)
    target = slots.index_select(0, src)
    for k in FIELDS:
        getattr(ring, k).index_copy_(0, target, chunk[k].index_select(0, src))
    if isinstance(new_size, torch.Tensor):
        ring.size.copy_(new_size.reshape(()))
    else:
        ring.size.fill_(new_size)
    return ring


def lane_ingest_body(rings: list, chunk: dict, slots: torch.Tensor, lane: torch.Tensor,
                     new_size) -> None:
    """Write the chunk's rows into ``rings[lane]`` at lane rows ``slots``
    (int64 [n], distinct; pad rows carry the lane capacity and sit after
    the real rows) and set every lane's fill count to ``new_size``, IN
    PLACE. ``lane`` is a 0-d int64 device tensor, so one compiled program
    serves every lane: each lane's write takes the chunk's rows where it
    is ``lane`` and otherwise writes its own row 0 back onto itself, the
    same bytes to the same place, as :func:`ingest_body` lands a pad row.
    No host value is read."""
    for j, ring in enumerate(rings):
        cap = ring.obs.shape[0]
        mine = torch.where(lane == j, slots, torch.full_like(slots, cap))
        keep = mine < cap
        any_row = keep.any()
        last = (keep.sum() - 1).clamp_min(0)
        src = torch.where(keep, torch.arange(slots.shape[0], device=slots.device), last)
        target = torch.where(any_row, mine.index_select(0, src), torch.zeros_like(mine))
        for k in FIELDS:
            dst = getattr(ring, k)
            rows = torch.where(any_row, chunk[k].index_select(0, src), dst.index_select(0, target))
            dst.index_copy_(0, target, rows)
        if isinstance(new_size, torch.Tensor):
            ring.size.copy_(new_size.reshape(()))
        else:
            ring.size.fill_(new_size)


@dataclass
class _StagedChunk:
    """The next flush's first chunk, copied ahead by :meth:`DeviceRingSync.stage`."""

    synced_at: int     # the sync's mirrored count when it was staged
    covers: int        # the mirrored count once it lands
    dev_chunk: dict    # FIELDS, "slots" (int64) and "new_size" (0-d int32), on the device
    ready: object      # the copy-done event (None on the CPU)
    nbytes: int


def _ingest_state(ring: DeviceRing) -> list:
    return [getattr(ring, f.name) for f in dataclasses.fields(ring)]


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
    (``DevicePerSync.on_chunk`` seeds the priority leaves of the same rows;
    its pad slots drop there too).

    Every chunk is ``chunk_cap`` rows: the real rows, then pad rows (slot
    ``capacity``, gathered from host slot 0, as the JAX ingest pads them).
    The fill count travels with the chunk as a 0-d device input. So
    :attr:`ingest_program` keeps one specialization for the run whatever
    the flushes carry; it is bound to the first ring flushed, and a flush
    into another ring raises.

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
        self._ring: Optional[DeviceRing] = None  # bound at the first flush
        self.ingest_program = graphs.Program("ring_ingest", self._ingest_into_ring,
                                             state=lambda: _ingest_state(self._ring))

    def _ingest_into_ring(self, chunk: dict, new_size: torch.Tensor) -> None:
        ingest_body(self._ring, chunk, chunk["slots"], new_size)

    def _program(self, ring: DeviceRing) -> graphs.Program:
        """The ingest program, bound to ``ring`` at the first flush."""
        if self._ring is None:
            self._ring = ring
        elif ring is not self._ring:
            raise graphs.GraphBindingError(
                "DeviceRingSync mirrors one ring: its ingest program is bound to the first "
                "ring flushed")
        return self.ingest_program

    def pending(self) -> int:
        return min(self._buffer.total_added - self._synced, self.capacity)

    def _copier(self, ring: DeviceRing) -> H2DStream:
        device = ring.obs.device
        if self._h2d is None or self._h2d.device != device:
            self._h2d = H2DStream(device)
        return self._h2d

    def _gather(self, ring: DeviceRing, first: int, n: int, new_size: int, ahead: bool):
        """The rows of writes [first, first + n), padded to ``chunk_cap``
        rows, their slots and the fill count, copy started on the current
        stream, or with ``ahead`` on the copy stream: ``(device chunk,
        ready event or None, bytes)``."""
        slots = np.full(self.chunk_cap, self.capacity, np.int64)
        slots[:n] = (first + np.arange(n)) % self.capacity
        gidx = np.zeros(self.chunk_cap, np.int64)  # pad rows re-read slot 0
        gidx[:n] = slots[:n]
        chunk = dict(self._buffer.gather(gidx))  # locked: never a torn row
        chunk["slots"] = slots
        chunk["new_size"] = np.asarray(new_size, np.int32)
        nbytes = sum(v.nbytes for v in chunk.values())
        if ahead:
            return (*self._copier(ring).put(chunk), nbytes)
        return to_device(chunk, ring.obs.device), None, nbytes

    def _ingest(self, ring: DeviceRing, dev_chunk: dict, ready, nbytes: int) -> None:
        if ready is not None:
            self._h2d.consume(dev_chunk, ready)
        chunk = {k: v for k, v in dev_chunk.items() if k != "new_size"}
        self._program(ring)(chunk, dev_chunk["new_size"])
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
        covers = first + n
        dev_chunk, ready, nbytes = self._gather(ring, first, n, min(covers, self.capacity),
                                                ahead=True)
        self._staged = _StagedChunk(
            synced_at=self._synced, covers=covers, dev_chunk=dev_chunk, ready=ready,
            nbytes=nbytes,
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
            self._ingest(ring, staged.dev_chunk, staged.ready, staged.nbytes)
            self._synced = staged.covers
        total = self._buffer.total_added
        n_pending = min(total - self._synced, self.capacity)
        if n_pending <= 0:
            return ring
        first = total - n_pending
        new_size = min(total, self.capacity)
        for lo in range(0, n_pending, self.chunk_cap):
            n = min(self.chunk_cap, n_pending - lo)
            dev_chunk, ready, nbytes = self._gather(ring, first + lo, n, new_size, ahead=False)
            self._ingest(ring, dev_chunk, ready, nbytes)
        self._synced = total
        return ring


# --------------------------------------------------------- striped lanes
def striped_perm(capacity: int, n_shards: int) -> np.ndarray:
    """``[n_shards, capacity // n_shards]`` host slots per lane: lane ``d``
    row ``i`` holds host slot ``i * n_shards + d`` (the JAX layout)."""
    cl = capacity // n_shards
    return np.arange(cl)[None, :] * n_shards + np.arange(n_shards)[:, None]



def striped_lanes(buffer, n_shards: int, device=None) -> list:
    """The lane view of a host buffer: one :class:`DeviceRing` a lane with
    the rows :func:`striped_perm` deals it and the global fill count (the
    tests' construction of the JAX oracle's ring lanes)."""
    device = resolve_device(device)
    perm = striped_perm(int(buffer.capacity), n_shards)
    size = min(buffer.total_added, int(buffer.capacity))
    rows = lane_fields({k: getattr(buffer, k) for k in FIELDS})
    return [
        DeviceRing(**{k: torch.from_numpy(np.ascontiguousarray(getattr(buffer, k)[perm[d]]))
                      .to(device) for k in rows},
                   size=torch.tensor(size, dtype=torch.int32, device=device))
        for d in range(n_shards)
    ]


def lane_rings_init(capacity: int, obs_dim: int, action_dim: int, mesh) -> list:
    """Zero rings of ``capacity / dp`` rows for this process's lanes, each
    on its lane's device."""
    if capacity % mesh.dp:
        raise ValueError(f"sharded ring: capacity {capacity} not divisible by dp={mesh.dp}")
    return [device_ring_init(capacity // mesh.dp, obs_dim, action_dim, mesh.lane_device(d))
            for d in mesh.local_lanes]


class ShardedDeviceRingSync:
    """Mirrors a host buffer into this process's lane rings, striped.

    Single process (every lane local): the buffer is the whole replay and
    host slot ``j`` goes to lane ``j % dp``, row ``j // dp``. Each flush
    ships the pending rows of every lane, in write order, in chunks of at
    most ``chunk_local = chunk_cap / dp`` rows, and calls ``tree_hook(j,
    rows)`` with the local lane index and the lane rows it wrote
    (``DevicePerSync.on_lane_chunk`` seeds the same rows of that lane's
    subtree). Every lane's ``size`` is the global fill count.

    In one process every chunk is ``chunk_local`` rows (the real rows, then
    pad rows at lane row ``local_capacity``, gathered from the lane's first
    host slot) and goes through :attr:`ingest_program`
    (:func:`lane_ingest_body`), whose lane index and fill count are device
    inputs: one specialization for the run, bound to the first rings
    flushed. ``tree_hook`` then gets the padded slots, which the tree's
    seed drops. Several processes (:class:`MultihostRingSync`) ship their
    chunks unpadded and eagerly (``ingest_program`` None).

    The layout algebra (the JAX ``MultihostRingSync``'s): process ``p``
    owns lanes ``[p·L, (p+1)·L)`` and a buffer of ``capacity/P`` rows, its
    local slot ``m`` going to local lane ``m % L``, row ``m // L``; with
    P = 1 that is the deal above.
    """

    def __init__(self, buffer, mesh, chunk_cap: int = 4096):
        self._buffer = buffer
        self.mesh = mesh
        self.n_shards = mesh.dp
        self.n_processes = mesh.num_processes
        lo, hi = local_shard_span(mesh)
        self.shard_lo, self.local_shards = lo, hi - lo
        self.host_capacity = int(buffer.capacity)
        self.capacity = self.host_capacity * self.n_processes
        if self.capacity % self.n_shards:
            raise ValueError(
                f"sharded ring: capacity {self.capacity} not divisible by dp={self.n_shards}")
        self.local_capacity = self.capacity // self.n_shards
        self.chunk_local = int(min(max(1, chunk_cap // self.n_shards), self.local_capacity))
        self._synced = 0
        self._size = 0
        self.tree_hook = None
        self.bytes_ingested = 0
        self.chunks_ingested = 0
        self._rings: Optional[list] = None  # bound at the first flush
        self.ingest_program = None
        if self.n_processes == 1:
            self.ingest_program = graphs.Program(
                "ring_ingest", self._ingest_into_lane,
                state=lambda: [t for r in self._rings for t in _ingest_state(r)])

    def _ingest_into_lane(self, chunk: dict, lane: torch.Tensor, new_size: torch.Tensor) -> None:
        lane_ingest_body(self._rings, chunk, chunk["slots"], lane, new_size)

    def pending(self) -> int:
        return min(self._buffer.total_added - self._synced, self.host_capacity)

    def _fill_count(self, total: int) -> int:
        return min(total, self.capacity)

    def _ingest(self, ring: DeviceRing, j: int, rows: np.ndarray, new_size: int) -> None:
        L = self.local_shards
        if self.ingest_program is None:
            gidx, slots = rows * L + j, rows.astype(np.int64)
        else:
            # padded to chunk_local rows; a pad re-reads the lane's first slot
            gidx = np.full(self.chunk_local, j, np.int64)
            gidx[:len(rows)] = rows * L + j
            slots = np.full(self.chunk_local, self.local_capacity, np.int64)
            slots[:len(rows)] = rows
        chunk = dict(self._buffer.gather(gidx))  # locked
        chunk["slots"] = slots
        nbytes = sum(v.nbytes for v in chunk.values())
        dev = to_device(chunk, ring.obs.device)
        if self.ingest_program is None:
            ingest_body(ring, dev, dev["slots"], new_size)
        else:
            fill = partial(torch.full, (), device=ring.obs.device)
            self.ingest_program(dev, fill(j, dtype=torch.int64),
                                fill(new_size, dtype=torch.int32))
        if self.tree_hook is not None:
            self.tree_hook(j, dev["slots"])
        self.bytes_ingested += nbytes
        self.chunks_ingested += 1

    def _bind(self, rings: list) -> None:
        """Bind the ingest program to ``rings`` at the first flush."""
        if self._rings is None:
            self._rings = list(rings)
        elif len(rings) != len(self._rings) or any(
                a is not b for a, b in zip(rings, self._rings)):
            raise graphs.GraphBindingError(
                "ShardedDeviceRingSync mirrors one set of lane rings: its ingest program is "
                "bound to the first rings flushed")

    def flush(self, rings: list) -> list:
        """Mirror all pending host writes into ``rings`` (this process's
        lanes), IN PLACE; returns ``rings``."""
        total = self._buffer.total_added
        new_size = self._fill_count(total)  # collective on MultihostRingSync
        n_pending = min(total - self._synced, self.host_capacity)
        L = self.local_shards
        if self.ingest_program is not None:
            self._bind(rings)
        if n_pending > 0:
            pend = (total - n_pending + np.arange(n_pending)) % self.host_capacity
            for j, ring in enumerate(rings):
                rows = pend[pend % L == j] // L  # this lane's rows, in write order
                for lo in range(0, len(rows), self.chunk_local):
                    self._ingest(ring, j, rows[lo: lo + self.chunk_local], new_size)
        if new_size != self._size:
            for ring in rings:
                ring.size.fill_(new_size)
            self._size = new_size
        self._synced = total
        return rings


class MultihostRingSync(ShardedDeviceRingSync):
    """The sharded sync of a process that is one of several: its buffer
    holds ``capacity/P`` rows, fed by its own collection. Every flush is a
    collective: the processes agree the global fill count from their
    write cursors (:meth:`_gapless_total`, one :func:`host_allgather_i64`),
    so every process must flush equally often."""

    def _fill_count(self, total: int) -> int:
        totals = host_allgather_i64([total])[:, 0]
        return min(self._gapless_total(totals), self.capacity)

    def _gapless_total(self, totals: np.ndarray) -> int:
        """The largest global write count ``T`` whose first ``T``
        interleaved writes have all landed, from each process's local
        ``total_added``: process ``p``'s lane ``p·L + s`` has received
        ``ceil((t_p − s)/L)`` writes, and the gapless prefix ends at the
        first lane still short, ``min_d(writes_d·D + d)``. Exact under the
        lock-step deal; never counts a row some process has not written."""
        D, L = self.n_shards, self.local_shards
        best = None
        for p in range(self.n_processes):
            t = int(totals[p])
            for s in range(L):
                d = p * L + s
                cand = max(-(-(t - s) // L), 0) * D + d
                best = cand if best is None else min(best, cand)
        return int(best)

    def gather_snapshot(self, rings: list) -> dict:
        """The GLOBAL ring in the ``ReplayBuffer.snapshot`` layout (rows
        ``[0, size)`` in global slot order, ``pos``, ``size``), so any
        topology restores it. A collective: every process calls it, after
        a flush; process 0 writes the file."""
        T = self._gapless_total(host_allgather_i64([self._buffer.total_added])[:, 0])
        size = min(T, self.capacity)
        perm = striped_perm(self.capacity, self.n_shards).reshape(-1)
        out = {}
        for name in lane_fields(rings[0]):
            lanes = gather_global(np.stack([getattr(r, name).cpu().numpy() for r in rings]))
            host = np.empty((self.capacity,) + lanes.shape[2:], lanes.dtype)
            host[perm] = lanes.reshape((self.capacity,) + lanes.shape[2:])
            out[name] = host[:size]
        out["pos"] = np.asarray(T % self.capacity)
        out["size"] = np.asarray(size)
        return out

    def deal_snapshot(self, data) -> int:
        """Restore this process's share of a GLOBAL snapshot into its local
        buffer; returns its row count. Global total ``T`` puts ``t_p =
        (T//D)·L + clip(T%D − p·L, 0, L)`` writes on process ``p``, and its
        local slot ``m`` reads global slot ``(m//L)·D + p·L + m%L``. No
        collective; the next flush re-mirrors the restored rows."""
        size = int(np.asarray(data["size"]).item())
        pos = int(np.asarray(data["pos"]).item())
        T = pos + self.capacity if size == self.capacity else size
        D, L, base = self.n_shards, self.local_shards, self.shard_lo
        t_p = (T // D) * L + int(np.clip(T % D - base, 0, L))
        n_local = min(t_p, self.host_capacity)
        m = np.arange(n_local)
        j = (m // L) * D + base + (m % L)
        local = {name: np.asarray(data[name])[j] for name in lane_fields(data)}
        local["pos"] = np.asarray(t_p % self.host_capacity)
        local["size"] = np.asarray(n_local)
        buf = self._buffer
        with buf._lock:
            buf._restore_arrays(local)
            buf._total_added = t_p  # the exact cursor, as every process derives it
        self._synced = 0
        self._size = 0
        return n_local
