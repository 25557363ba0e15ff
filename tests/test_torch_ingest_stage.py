"""The port's ``DeviceRingSync.stage`` + ``flush`` (``--ingest-prefetch``)
against the JAX package's ``DeviceRingSync``, on the CPU, from the same
host adds: the three cases of the reference's ``TestIngestStaging``
(``tests/test_fused_descent.py``).

Tolerances: none. Staging copies rows and scatters them at the same
slots, so the ring's rows and fill count are ``array_equal`` to the JAX
ring's, and the slots each side hands its ``tree_hook`` are equal, in
order, once the JAX side's padding (slot = capacity) is dropped.
"""

import jax
import numpy as np
import pytest
import torch

from d4pg_tpu.replay.device_ring import DeviceRingSync as JRingSync
from d4pg_tpu.replay.device_ring import device_ring_init as j_ring_init
from d4pg_tpu.replay.uniform import ReplayBuffer as JBuffer
from d4pg_tpu.replay.uniform import Transition as JTransition
from d4pg_tpu_torch.replay import ReplayBuffer, Transition
from d4pg_tpu_torch.replay.device_per import DevicePerSync
from d4pg_tpu_torch.replay.device_ring import DeviceRingSync, device_ring_init

CAP, CHUNK = 64, 16
FIELDS = ("obs", "action", "reward", "next_obs", "discount")


def _rows(n, seed):
    r = np.random.default_rng(seed)
    return (
        r.normal(size=(n, 3)).astype(np.float32),
        r.uniform(-1, 1, (n, 1)).astype(np.float32),
        r.uniform(-1, 0, n).astype(np.float32),
        r.normal(size=(n, 3)).astype(np.float32),
        np.full(n, 0.99, np.float32),
    )


class _Pair:
    """The same host buffer in each package, each mirrored by its own
    package's sync into its own ring; each tree_hook records its slots."""

    def __init__(self):
        self.jbuf, self.tbuf = JBuffer(CAP, 3, 1), ReplayBuffer(CAP, 3, 1)
        self.jsync = JRingSync(self.jbuf, chunk_cap=CHUNK)
        self.tsync = DeviceRingSync(self.tbuf, chunk_cap=CHUNK)
        self.jring = j_ring_init(CAP, 3, 1)
        self.tring = device_ring_init(CAP, 3, 1, device="cpu")
        self.jslots, self.tslots = [], []
        self.jsync.tree_hook = lambda s: self.jslots.append(np.asarray(jax.device_get(s)).copy())
        self.tsync.tree_hook = lambda s: self.tslots.append(s.numpy().copy())

    def add(self, n, seed):
        self.jbuf.add_batch(JTransition(*_rows(n, seed)))
        self.tbuf.add_batch(Transition(*_rows(n, seed)))

    def flush(self):
        self.jring = self.jsync.flush(self.jring)
        self.tsync.flush(self.tring)

    def assert_equal(self):
        j = jax.device_get(self.jring)
        assert int(self.tring.size) == int(j.size)
        for k in FIELDS:
            np.testing.assert_array_equal(getattr(self.tring, k).numpy(), np.asarray(getattr(j, k)), k)
        assert self.tsync._synced == self.jsync._synced
        assert self.tsync.chunks_ingested == self.jsync.chunks_ingested
        assert len(self.tslots) == len(self.jslots)
        for t, js in zip(self.tslots, self.jslots):
            # the same fixed [chunk_cap] blocks, pads (slot CAP) and all
            np.testing.assert_array_equal(t, js)


def test_stage_then_flush_equals_the_reference_plain_flush():
    """Staged on the port, plain on the JAX side: the same ring, the same
    tree-hook slots, the same chunk count."""
    p = _Pair()
    p.add(48, seed=5)
    assert p.tsync.stage(p.tring)
    assert int(p.tring.size) == 0  # staging writes nothing into the ring
    p.flush()
    assert p.tsync._synced == 48 and p.tsync.chunks_ingested == 3
    p.assert_equal()


def test_overwrites_between_stage_and_flush_across_the_wrap():
    """10 rows staged on both sides, then 70 writes wrap the 64-row ring
    and overwrite every staged slot before the flush: the remainder ships
    after the staged scatter, so the last write wins on both; a device PER
    tree hooked to the port's sync equals one seeded by a plain flush."""
    p = _Pair()
    p.add(48, seed=5)
    p.flush()
    p.add(10, seed=11)
    assert p.jsync.stage() and p.tsync.stage(p.tring)
    p.add(70, seed=12)
    p.flush()
    p.assert_equal()
    # the final ring is a from-scratch mirror of the final host buffer
    n = len(p.tbuf)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(p.tring, k).numpy()[:n], getattr(p.tbuf, k)[:n])

    trees = []
    for staged in (True, False):
        buf = ReplayBuffer(CAP, 3, 1)
        sync = DeviceRingSync(buf, chunk_cap=CHUNK)
        ring = device_ring_init(CAP, 3, 1, device="cpu")
        dps = DevicePerSync(CAP, 0.6, device="cpu")
        sync.tree_hook = dps.on_chunk
        buf.add_batch(Transition(*_rows(48, 5)))
        sync.flush(ring)
        buf.add_batch(Transition(*_rows(10, 11)))
        if staged:
            assert sync.stage(ring)
        buf.add_batch(Transition(*_rows(70, 12)))
        sync.flush(ring)
        trees.append((ring, dps.tree))
    (ra, ta), (rb, tb) = trees
    for k in FIELDS + ("size",):
        assert torch.equal(getattr(ra, k), getattr(rb, k)), k
    assert torch.equal(ta.sums, tb.sums) and torch.equal(ta.max_priority, tb.max_priority)


@pytest.mark.parametrize("pending", [10, 40])
def test_stage_is_a_noop_with_nothing_pending_and_is_consumed_once(pending):
    """Nothing pending: no chunk. Staged: idempotent until a flush consumes
    it, once; a staged chunk of CHUNK rows leaves the rest to the flush's
    remainder loop."""
    p = _Pair()
    assert not p.tsync.stage(p.tring) and not p.jsync.stage()
    p.add(pending, seed=3)
    assert p.tsync.stage(p.tring) and p.jsync.stage()
    staged = p.tsync._staged
    assert p.tsync.stage(p.tring) and p.tsync._staged is staged  # idempotent while staged
    p.flush()
    assert p.tsync._staged is None
    assert p.tsync.chunks_ingested == -(-pending // CHUNK)
    assert int(p.tring.size) == pending
    p.assert_equal()
    before = p.tsync.chunks_ingested
    assert p.tsync.flush(p.tring) is p.tring and p.tsync.chunks_ingested == before
    assert not p.tsync.stage(p.tring)
