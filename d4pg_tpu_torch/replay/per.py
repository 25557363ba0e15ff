"""Prioritized experience replay with vectorized proportional sampling.

The port's own copy of ``d4pg_tpu/replay/per.py``, on either tree
backend (``tree_backend``: the native C++ trees of
:mod:`d4pg_tpu_torch.replay.native`, or the NumPy trees): new
samples enter at ``max_priority**alpha``, sampling is stratified and
proportional to priority mass, importance weights are ``(p·N)^{−β}``
normalized by the max weight (via the min tree), priorities update as
``(|td| + ε)^α``, and β anneals as a pure function of the learner step.

The draw consumes the seeded ``np.random.Generator`` exactly as the JAX
package does (one ``uniform`` over the n equal-mass strata of an n-row
draw), so the same adds, seed and priority updates give the same
indices, IS weights and rows in both packages and on both backends. The
base buffer's re-entrant lock also guards the trees: every insert, draw,
gather, write-back and snapshot takes it. Snapshots add the
α-exponentiated leaves (``tree_priorities``) and the pre-α
``max_priority`` to the uniform buffer's ``.npz`` keys, as the JAX
package's do.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from d4pg_tpu_torch.analysis.ledger import NULL_LEDGER
from d4pg_tpu_torch.replay.schedules import linear_schedule
from d4pg_tpu_torch.replay.segment_tree import MinTree, SumTree
from d4pg_tpu_torch.replay.uniform import ReplayBuffer, Transition


TREE_BACKENDS = ("auto", "native", "numpy")


def _deal_order(batch_size: int, k: int) -> np.ndarray:
    """``order[r]``: the draw that lands at flattened block position r when
    draw j is dealt to ``block[j % k, j // k]``."""
    return np.arange(batch_size * k).reshape(batch_size, k).T.reshape(-1)


class SampledIndices(NamedTuple):
    """Slot indices plus the write generations they were sampled at; a
    write-back for a slot recycled since then is dropped."""

    idx: np.ndarray  # [B] int
    gen: np.ndarray  # [B] int64


class PrioritizedReplayBuffer(ReplayBuffer):
    def __init__(
        self,
        capacity: int,
        obs_dim: int,
        action_dim: int,
        alpha: float = 0.6,
        beta0: float = 0.4,
        beta_steps: int = 100_000,
        eps: float = 1e-6,
        tree_backend: str = "auto",
        obs_dtype=np.float32,
        decode_on_sample: bool = True,
    ):
        super().__init__(capacity, obs_dim, action_dim, obs_dtype=obs_dtype,
                         decode_on_sample=decode_on_sample)
        if alpha < 0:
            raise ValueError(f"alpha must be >= 0, got {alpha}")
        if tree_backend not in TREE_BACKENDS:
            raise ValueError(f"tree_backend must be one of {TREE_BACKENDS}, got {tree_backend!r}")
        self.alpha = alpha
        self.beta0 = beta0
        self.beta_steps = beta_steps
        self.eps = eps
        self._use_native = False
        if tree_backend != "numpy":
            try:
                from d4pg_tpu_torch.replay.native import NativeMinTree, NativeSumTree

                self._sum = NativeSumTree(self.capacity)
                self._min = NativeMinTree(self.capacity)
                self._use_native = True
            except (OSError, RuntimeError) as e:  # no g++, a failed build or load
                if tree_backend == "native":
                    raise
                # "auto" degrades rather than dies, but never silently: a
                # 5-10x slower tree must not be a surprise
                print(
                    f"[replay] native tree backend unavailable ({e!r}); "
                    "falling back to NumPy trees"
                )
        if not self._use_native:
            self._sum = SumTree(self.capacity)
            self._min = MinTree(self.capacity)
        self._max_priority = 1.0
        # sample_block staging: STAGING_SLOTS preallocated buffer sets per
        # draw size, handed out round-robin (see _staging_slot)
        self._staging: dict = {}
        # Staging ledger (debug_guards): generation-tags the rotation, so
        # a slot rewritten while its consumer still holds it raises here
        self._ledger = NULL_LEDGER

    @property
    def tree_backend(self) -> str:
        """The backend in use: ``"native"`` or ``"numpy"``."""
        return "native" if self._use_native else "numpy"

    def add_batch(self, t: Transition) -> np.ndarray:
        with self._lock:
            idx = super().add_batch(t)
            p = self._max_priority**self.alpha
            self._sum.set(idx, np.full(idx.shape, p))
            self._min.set(idx, np.full(idx.shape, p))
        return idx

    def beta(self, step: int) -> float:
        return linear_schedule(step, self.beta_steps, self.beta0, 1.0)

    @staticmethod
    def _prefixes(total: float, n: int, rng: np.random.Generator) -> np.ndarray:
        """n stratified prefix masses: one uniform in each of n equal-mass
        strata, drawn by ONE ``rng.uniform`` call. This RNG use is the
        seeded-stream contract both backends and both packages share."""
        bounds = np.linspace(0.0, total, n + 1)
        prefixes = rng.uniform(bounds[:-1], bounds[1:])
        # a prefix equal to the total would fall off the last nonzero leaf
        return np.minimum(prefixes, np.nextafter(total, 0.0))

    def _draw(self, batch_size: int, rng: np.random.Generator, step: int):
        """One locked stratified draw: (idx, IS weights, generation stamps).
        ``batch_size`` may be K·B for a multi-batch draw."""
        with self._lock:
            total = self._sum.sum()
            prefixes = self._prefixes(total, batch_size, rng)
            idx = self._sum.find_prefixsum_idx(prefixes)
            idx = np.minimum(idx, self._size - 1)
            p = self._sum.get(idx) / total
            beta = self.beta(step)
            weights = (p * self._size) ** (-beta)
            min_p = self._min.min() / total
            max_w = (min_p * self._size) ** (-beta)
            weights = weights / max_w
            # the copy is the capture: a view would follow a later writer
            gen = self._gen[idx].copy()
        return idx, weights.astype(np.float32), gen

    def sample(self, batch_size: int, rng: np.random.Generator, step: int = 0):
        """Stratified proportional sample: a batch dict with the extra keys
        ``indices`` (for the priority write-back) and ``weights`` (IS
        weights, max-normalized)."""
        idx, weights, gen = self._draw(batch_size, rng, step)
        batch = dict(self.gather(idx))
        batch["indices"] = SampledIndices(idx, gen)
        batch["weights"] = weights
        return batch

    def sample_many(
        self, batch_size: int, k: int, rng: np.random.Generator, step: int = 0
    ) -> list[dict]:
        """K stratified batches from ONE K·B-wide draw and one gather. The
        K·B equal-mass strata are dealt round-robin (batch i takes draws i,
        i+k, i+2k, …), so each batch spreads over the whole priority mass.
        All K share one ``step`` (one β) and one generation capture."""
        idx, weights, gen = self._draw(batch_size * k, rng, step)
        flat = self.gather(idx)
        out = []
        for i in range(k):
            sl = slice(i, None, k)
            b = {key: v[sl] for key, v in flat.items()}
            b["indices"] = SampledIndices(idx[sl], gen[sl])
            b["weights"] = weights[sl]
            out.append(b)
        return out

    # Preallocated staging buffer sets per draw size that sample_block
    # hands out in turn: a block stays valid for STAGING_SLOTS - 1 more
    # calls of the same size.
    STAGING_SLOTS = 3

    def _staging_slot(self, n: int) -> tuple[dict, int]:
        """(slot, its position): the next staging buffer set for an n-row
        draw (allocated once per size, then reused round-robin), with its
        native call's pointers marshalled once."""
        entry = self._staging.get(n)
        if entry is None:
            obs_dim, act_dim = self.obs.shape[1], self.action.shape[1]
            # the staged observations' dtype: the stored bytes for the
            # uint8 wire, else float32 (decoded when stored as uint8)
            raw = self._quantized and not self._decode_on_sample
            obs_dtype = np.uint8 if raw else np.float32

            def mk():
                slot = {
                    "idx": np.empty(n, np.int64),
                    "gen": np.empty(n, np.int64),
                    "weights": np.empty(n, np.float32),
                    "obs": np.empty((n, obs_dim), obs_dtype),
                    "action": np.empty((n, act_dim), np.float32),
                    "reward": np.empty(n, np.float32),
                    "next_obs": np.empty((n, obs_dim), obs_dtype),
                    "discount": np.empty(n, np.float32),
                }
                if self._use_native:
                    from d4pg_tpu_torch.replay import native

                    slot["_call"] = native.SampleGatherCall(
                        self._sum, self._min, self.obs, self.action, self.reward,
                        self.next_obs, self.discount, self._gen, self._native_obs_mode(),
                        dict(slot),
                    )
                return slot

            entry = {
                "slots": [mk() for _ in range(self.STAGING_SLOTS)],
                "next": 0,
                # the ledger group precomputed: no per-call f-string
                "group": f"per.sample_block[n={n}]",
            }
            self._staging[n] = entry
        pos = entry["next"]
        # declared to the ledger BEFORE the fill: trips here, at the reuse
        # site, if a consumer still holds this slot
        self._ledger.write(entry["group"], pos)
        slot = entry["slots"][pos]
        entry["next"] = (pos + 1) % self.STAGING_SLOTS
        return slot, pos

    def set_ledger(self, ledger) -> None:
        """Attach a :class:`~d4pg_tpu_torch.analysis.ledger.StagingLedger`
        (``debug_guards``): :meth:`sample_block` then hands its caller a
        hold on the slot (``_staging_hold``), to release once nothing
        reads the block's views any more."""
        self._ledger = ledger if ledger is not None else NULL_LEDGER

    def _native_obs_mode(self) -> int:
        """``st_sample_gather``'s obs mode: float32 rows, uint8 rows decoded
        to float32/255, or uint8 rows copied raw (the uint8 wire)."""
        from d4pg_tpu_torch.replay import native

        if not self._quantized:
            return native.OBS_F32
        return native.OBS_U8_DECODE if self._decode_on_sample else native.OBS_U8_RAW

    def sample_block(
        self, batch_size: int, k: int, rng: np.random.Generator, step: int = 0
    ) -> dict:
        """K stratified batches as contiguous [K, B, ...] blocks from one
        backend call: the host half of a K-step dispatch.

        Native backend: ONE C call does the K·B descents, the IS weights,
        the generation capture and the row gather of every field straight
        into a staging slot, under the lock. NumPy backend: the same draws
        (the same single ``uniform`` of size K·B) through :meth:`_draw` and
        :meth:`gather`. Either way draw j lands at ``block[j % k, j // k]``,
        so batch i equals :meth:`sample_many`'s batch i, and ``k = 1``
        equals :meth:`sample` on the same generator state.

        The field arrays are views of a staging slot that is rewritten
        ``STAGING_SLOTS - 1`` same-size calls later; ``indices`` holds
        fresh copies that may be kept for a later write-back. Calls must be
        serialized by the caller (one slot per call, not per thread).
        """
        n = batch_size * k
        st, slot_pos = self._staging_slot(n)
        if self._use_native:
            with self._lock:
                prefixes = self._prefixes(self._sum.sum(), n, rng)
                st["_call"](prefixes, k, self._size, self.beta(step))
        else:
            idx, weights, gen = self._draw(n, rng, step)
            order = _deal_order(batch_size, k)
            idx = idx[order]
            st["idx"][:] = idx
            st["gen"][:] = gen[order]
            st["weights"][:] = weights[order]
            for key, v in self.gather(idx).items():
                st[key][...] = v
        block = lambda a: a.reshape((k, batch_size) + a.shape[1:])
        out = {key: block(st[key]) for key in ("obs", "action", "reward", "next_obs", "discount")}
        out["weights"] = block(st["weights"])
        out["indices"] = SampledIndices(block(st["idx"]).copy(), block(st["gen"]).copy())
        if self._ledger is not NULL_LEDGER:
            # The consumer's claim on this slot; the key is absent with
            # guards off, so the block is the same as without them.
            out["_staging_hold"] = self._ledger.hold(self._staging[n]["group"], slot_pos)
        return out

    def sample_block_indices(
        self, batch_size: int, k: int, rng: np.random.Generator, step: int = 0
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The index half of :meth:`sample_block`, with no row gather:
        ``(idx [K, B] int64, weights [K, B] f32, gen [K, B] int64)``, fresh
        arrays. The ``hybrid`` placement's data plane: the host tree
        descends, and the rows are gathered on the device from the ring.

        Same RNG use and same dealing as :meth:`sample_block`, so flipping
        the placement between ``host`` and ``hybrid`` moves no seeded
        run's index sequence."""
        n = batch_size * k
        idx, weights, gen = self._draw(n, rng, step)
        order = _deal_order(batch_size, k)
        block = lambda a: a[order].reshape(k, batch_size)
        return block(idx), block(weights), block(gen)

    def update_priorities(self, indices, priorities: np.ndarray) -> None:
        """(|priority| + ε)^α into both trees. ``indices`` is a raw index
        array or the :class:`SampledIndices` that a sample returned; with
        the latter, entries whose slot was recycled are dropped. Arrays of
        any shape ([K, B] blocks too) are flattened elementwise.

        Native backend: |td| + ε is formed outside the lock, and the
        generation filter, ^α, both trees and the max reduce are ONE C call
        under it."""
        pri = np.ascontiguousarray(np.abs(np.asarray(priorities, np.float64)).ravel() + self.eps)
        if isinstance(indices, SampledIndices):
            idx, sample_gen = indices.idx, indices.gen
        else:
            idx, sample_gen = indices, None
        idx = np.ascontiguousarray(np.asarray(idx, np.int64).ravel())
        if idx.size != pri.size:
            raise ValueError(f"{idx.size} indices for {pri.size} priorities")
        if sample_gen is not None:
            sample_gen = np.ascontiguousarray(np.asarray(sample_gen, np.int64).ravel())
        if self._use_native:
            from d4pg_tpu_torch.replay import native

            with self._lock:
                mx = native.update_priorities(
                    self._sum, self._min, idx, pri, sample_gen, self._gen, self.alpha
                )
                if mx > 0.0:  # 0.0: every entry was dropped as recycled
                    self._max_priority = max(self._max_priority, mx)
            return
        with self._lock:
            if sample_gen is not None:
                live = self._gen[idx] == sample_gen
                idx, pri = idx[live], pri[live]
                if idx.size == 0:
                    return
            pa = pri**self.alpha
            self._sum.set(idx, pa)
            self._min.set(idx, pa)
            self._max_priority = max(self._max_priority, float(pri.max()))

    def _snapshot_arrays(self) -> dict:
        data = super()._snapshot_arrays()
        n = self._size
        data["tree_priorities"] = self._sum.get(np.arange(n))  # α-exponentiated
        data["max_priority"] = np.asarray(self._max_priority)
        return data

    def _restore_arrays(self, data) -> int:
        """Rebuild whichever tree backend is in use from the snapshot."""
        n = super()._restore_arrays(data)
        idx = np.arange(n)
        if "tree_priorities" in data:
            pa = np.asarray(data["tree_priorities"], np.float64)
            self._max_priority = float(np.asarray(data["max_priority"]).item())
            # A zero leaf (a row snapshotted between its ring write and its
            # tree write) would poison the min tree (every IS weight
            # collapses) and never be repaired, since an unsampled row
            # gets no priority update: seed it as add_batch would have.
            pa = np.where(pa <= 0.0, self._max_priority**self.alpha, pa)
        else:  # a snapshot from a uniform buffer: every row at max priority
            pa = np.full(n, self._max_priority**self.alpha)
        self._sum.set(idx, pa)
        self._min.set(idx, pa)
        # Clear stale mass past the snapshot (restoring into a used
        # buffer): leftover leaves would draw prefixes that the idx clamp
        # folds onto row n-1.
        if n < self.capacity:
            tail = np.arange(n, self.capacity)
            self._sum.set(tail, np.zeros(tail.shape))
            self._min.set(tail, np.full(tail.shape, np.inf))
        return n
