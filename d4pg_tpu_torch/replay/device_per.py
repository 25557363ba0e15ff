"""Device-resident PER: the priority sum tree lives on the card.

Counterpart of ``d4pg_tpu/replay/device_per.py`` for one lane (the sharded
lanes wait for ROADMAP A7), with the ``device_per.npz`` checkpoint sidecar
(:meth:`DevicePerSync.snapshot_host` / :meth:`DevicePerSync.restore_host`).
The tree is the host trees' flat layout (``replay/segment_tree.py``): ``sums``
is ``[2L]`` float32 with the root at index 1 and the α-exponentiated leaf
priorities at ``[L, 2L)``, ``L = next_pow2(capacity)``. Index 0 is unused
by the layout; the port routes pad writes there (the JAX scatters drop
them with ``mode="drop"``, which torch has not) and zeroes it again after
each write, so no pad ever reaches a real node.

The stratified descent, the IS weights and the post-step write-back all
run on the device inside the megastep (``runtime/megastep.py``), with no
host operand and no host synchronisation: nothing here reads a device
value on the host, except the checkpoint sidecar's snapshot (one copy per
checkpoint, never per step). Every write updates ``sums`` IN PLACE and
returns it (the JAX functions return a new array); ``max_priority`` is
updated in place by the megastep.

The descent is kernel B3 (``ops/cuda_tree.py``; its plain cumsum search on
CPU tensors). :func:`descend_prefix`, the log-depth gather walk of the JAX
package's ``"xla"`` reference, stays as the tests' oracle.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from d4pg_tpu_torch import resolve_device
from d4pg_tpu_torch.ops import cuda_tree


@dataclass
class DevicePerTree:
    """``sums`` [2L] float32 (root at 1, leaves at [L, 2L)) and
    ``max_priority``, the 0-d float32 running maximum of |priority| + ε
    that seeds newly ingested rows at ``max_priority**α``."""

    sums: torch.Tensor
    max_priority: torch.Tensor


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def tree_width(capacity: int) -> int:
    """Flat-array width of the tree: ``2 * next_pow2(capacity)``."""
    return 2 * next_pow2(capacity)


def device_per_init(capacity: int, max_priority: float = 1.0, device=None) -> DevicePerTree:
    """A zero-mass tree for a ``capacity``-row ring on ``device`` (default:
    the CUDA card)."""
    device = resolve_device(device)
    return DevicePerTree(
        sums=torch.zeros((tree_width(capacity),), dtype=torch.float32, device=device),
        max_priority=torch.tensor(max_priority, dtype=torch.float32, device=device),
    )


# ------------------------------------------------------------- tree writes
def repair_ancestors(sums: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Recompute every ancestor of the leaf positions ``pos`` ([n] int64;
    pad entries are 0), one gather + scatter per level, IN PLACE. A
    duplicate parent is written the same children-derived value by each of
    its entries, so the scatter is deterministic; pads stay at 0 all the
    way up and slot 0 is zeroed at the end."""
    depth = (sums.shape[0] // 2).bit_length() - 1
    for _ in range(depth):
        pos = pos // 2
        vals = sums.index_select(0, 2 * pos) + sums.index_select(0, 2 * pos + 1)
        sums.index_copy_(0, pos, vals)
    sums[:1].zero_()
    return sums


def set_leaves(
    sums: torch.Tensor, slots: torch.Tensor, values, capacity: int
) -> torch.Tensor:
    """Assign leaf values at ring ``slots`` and repair ancestors, IN PLACE.
    Pad entries (``slots >= capacity``, the JAX ring ingest's convention)
    land in slot 0 and are dropped. ``values`` is a number, a 0-d tensor
    (the max-priority ingest seed) or ``[n]``."""
    half = sums.shape[0] // 2
    slots = slots.reshape(-1).long()
    pos = torch.where(slots < capacity, slots + half, torch.zeros_like(slots))
    if isinstance(values, torch.Tensor):
        vals = values.to(torch.float32).expand(pos.shape).contiguous()
    else:  # a fill, not a host-to-device copy
        vals = torch.full(pos.shape, values, dtype=torch.float32, device=sums.device)
    sums.index_copy_(0, pos, vals)
    return repair_ancestors(sums, pos)


def update_leaves_last_wins(
    sums: torch.Tensor, idx: torch.Tensor, values: torch.Tensor, capacity: int
) -> torch.Tensor:
    """Leaf update with the host trees' duplicate semantics, IN PLACE: when
    a slot appears more than once in ``idx`` (one transition drawn into
    several rows of a [K, B] block) the LAST occurrence wins. A scatter-max
    of the positions picks each slot's last occurrence; the others become
    pads."""
    idx = idx.reshape(-1).long()
    vals = values.reshape(-1).to(torch.float32)
    order = torch.arange(idx.shape[0], device=idx.device)
    latest = torch.full((capacity,), -1, dtype=torch.long, device=idx.device)
    latest.scatter_reduce_(0, idx, order, reduce="amax")
    win = latest.index_select(0, idx) == order
    slots = torch.where(win, idx, torch.full_like(idx, capacity))
    return set_leaves(sums, slots, vals, capacity)


# ------------------------------------------------------------------ draws
def stratified_prefixes(
    u: torch.Tensor, k: int, batch: int, total: torch.Tensor
) -> torch.Tensor:
    """``[k, batch]`` prefix masses from uniforms ``u`` [k, batch] in [0, 1):
    one per equal-mass segment of ``[0, total)``, segment ``j`` dealt to
    block ``[j % k, j // k]`` (so batch i of a dispatch spreads over the
    WHOLE mass), clamped to ``nextafter(total, 0)`` so a prefix equal to
    the total never falls off the last nonzero leaf."""
    n = k * batch
    seg = torch.arange(n, dtype=torch.float32, device=u.device).reshape(batch, k).T
    # u first: the sum takes u's contiguous layout, not seg's transposed
    # one, so the kernels' wrappers (B3 once a dispatch, B4 each step) need
    # no copy of the prefixes to make them contiguous
    pre = (u + seg) * (total / n)
    return torch.minimum(pre, torch.nextafter(total, torch.zeros_like(total)))


def descend_prefix(sums: torch.Tensor, prefixes: torch.Tensor) -> torch.Tensor:
    """The log-depth gather descent (the JAX ``"xla"`` reference): for each
    prefix the leaf ``i`` with ``cumsum[0..i-1] <= prefix < cumsum[0..i]``,
    one vector gather per level, ``>=`` so zero-mass leaves are skipped and
    boundary prefixes select the next leaf. int32, ``prefixes``' shape."""
    half = sums.shape[0] // 2
    flat = prefixes.reshape(-1)
    idx = torch.ones(flat.shape, dtype=torch.long, device=sums.device)
    for _ in range(half.bit_length() - 1):
        left = sums.index_select(0, 2 * idx)
        go_right = flat >= left
        flat = flat - torch.where(go_right, left, torch.zeros_like(left))
        idx = 2 * idx + go_right.long()
    return (idx - half).to(torch.int32).reshape(prefixes.shape)


def find_leaves(sums: torch.Tensor, prefixes: torch.Tensor):
    """(raw leaf indices, chunk offsets) from kernel B3, whose chunk
    offsets a fused-descent dispatch hands to every B4 launch."""
    return cuda_tree.find_prefix(sums[sums.shape[0] // 2:], prefixes)


def clamp_to_fill(idx: torch.Tensor, filled: torch.Tensor) -> torch.Tensor:
    """``clip(idx, 0, max(filled − 1, 0))`` with ``filled`` a device
    scalar: the host ``_draw``'s ``size − 1`` guard, without a sync."""
    return torch.minimum(idx.clamp_min(0), (filled - 1).clamp_min(0).to(idx.dtype))


def lane_draw(sums: torch.Tensor, prefixes: torch.Tensor, filled: torch.Tensor):
    """The stratified draw for ``prefixes`` [k, batch]: ``(idx, p_leaf,
    total)`` — slot indices clamped to the fill count ``filled`` (0-d
    device int), their α-exponentiated leaf priorities, and the root mass."""
    half = sums.shape[0] // 2
    idx, _ = find_leaves(sums, prefixes)
    idx = clamp_to_fill(idx, filled)
    p_leaf = sums.index_select(0, half + idx.reshape(-1).long()).reshape(idx.shape)
    return idx, p_leaf, sums[1]


def lane_min_leaf(sums: torch.Tensor) -> torch.Tensor:
    """Minimum nonzero leaf priority (the host MinTree's root, on the fly:
    zero-mass leaves are unfilled rows or pow2 padding)."""
    leaves = sums[sums.shape[0] // 2:]
    return torch.where(leaves > 0, leaves, torch.full_like(leaves, float("inf"))).min()


def beta_at(step: int, beta0: float, beta_steps: int) -> float:
    """``linear_schedule(step, beta_steps, beta0, 1.0)`` in float32
    arithmetic, as the JAX device scalar computes it. ``step`` is the
    host's learner step count, so no device value is read."""
    frac = np.clip(np.float32(step) / np.float32(max(beta_steps, 1)), 0.0, 1.0)
    return float(np.float32(beta0) + np.float32(frac) * np.float32(1.0 - beta0))


def importance_weights(
    p_leaf: torch.Tensor, total: torch.Tensor, min_ratio: torch.Tensor,
    n_filled: torch.Tensor, beta: float,
) -> torch.Tensor:
    """Max-normalized IS weights ``(N·p)^{−β} / (N·min_ratio)^{−β}`` with
    ``p = p_leaf / total`` and N the fill count (the host formula term for
    term)."""
    n = n_filled.to(torch.float32)
    w = (p_leaf / total * n) ** (-beta)
    max_w = (min_ratio * n) ** (-beta)
    return w / max_w


def write_back_lane(
    sums: torch.Tensor, idx: torch.Tensor, priorities: torch.Tensor,
    alpha: float, eps: float, capacity: int,
):
    """Post-step write-back, IN PLACE: ``(|td| + ε)^α`` into the leaves
    (duplicates last-wins). Returns ``(sums, max(|td| + ε))`` for the
    max-priority update."""
    mag = priorities.abs() + eps
    update_leaves_last_wins(sums, idx, mag**alpha, capacity)
    return sums, mag.max()


def tree_ingest_lane_body(
    alpha: float, capacity: int, sums: torch.Tensor,
    max_priority: torch.Tensor, slots: torch.Tensor,
) -> torch.Tensor:
    """Seed newly mirrored ring rows at ``max_priority**α`` (the
    ``add_batch`` contract), IN PLACE; pad slots drop."""
    return set_leaves(sums, slots, max_priority**alpha, capacity)


class DevicePerSync:
    """The trainer-side holder of the device tree. It rides the ring
    sync's ``tree_hook``: every slot chunk the ring ingest ships is seeded
    into the tree at ``max_priority**α`` from the same device slot tensor,
    so a ring row and its priority leaf never desynchronize. The megastep
    updates ``self.tree`` in place."""

    def __init__(self, capacity: int, alpha: float, device=None, max_priority: float = 1.0):
        self.capacity = int(capacity)
        self.alpha = float(alpha)
        self.tree = device_per_init(self.capacity, max_priority, device)

    def on_chunk(self, slots: torch.Tensor) -> None:
        """The ring sync's tree_hook target: seed this chunk's rows."""
        tree_ingest_lane_body(
            self.alpha, self.capacity, self.tree.sums, self.tree.max_priority, slots
        )

    # ------------------------------------------------- snapshot / restore
    def snapshot_host(self) -> tuple[np.ndarray, float]:
        """The α-exponentiated leaf priorities in slot order (``[capacity]``
        float32) and the pre-α max priority: the checkpoint's priority
        sidecar. Reads the device (one copy of the leaves, one of the
        scalar), so it runs per checkpoint, never per step."""
        half = self.tree.sums.shape[0] // 2
        leaves = self.tree.sums[half: half + self.capacity].cpu().numpy()
        return leaves, float(self.tree.max_priority.cpu())

    def restore_host(self, pa_host: np.ndarray, max_priority: float) -> None:
        """Rebuild the tree from snapshotted α-exponentiated priorities
        (zeros stay zero-mass) on the tree's device. The level sums are the
        device repair's float32 pairwise adds, so the rebuilt tree equals
        the snapshotted one bit for bit. Replaces ``self.tree``: readers
        take ``self.tree`` at each use and hold no older tensor."""
        self.tree = tree_from_priorities(
            pa_host, self.capacity, max_priority, device=self.tree.sums.device
        )


def tree_from_priorities(
    pa_host: np.ndarray, capacity: int, max_priority: float = 1.0, device=None
) -> DevicePerTree:
    """A tree from host-order α-exponentiated priorities ``[capacity]``:
    numpy level-wise construction with the same float32 pairwise sums the
    device repair computes (the sidecar restore and the tests' seeding),
    on ``device`` (default: the CUDA card)."""
    device = resolve_device(device)
    pa_host = np.asarray(pa_host, np.float32)
    if pa_host.shape != (capacity,):
        raise ValueError(f"device PER tree: priorities shape {pa_host.shape} != ({capacity},)")
    width = tree_width(capacity)
    half = width // 2
    sums = np.zeros(width, np.float32)
    sums[half: half + capacity] = pa_host
    lo, hi = half, width
    while lo > 1:
        child = sums[lo:hi]
        lo, hi = lo // 2, lo
        sums[lo:hi] = child[0::2] + child[1::2]
    return DevicePerTree(
        sums=torch.from_numpy(sums).to(device),
        max_priority=torch.tensor(max_priority, dtype=torch.float32, device=device),
    )
