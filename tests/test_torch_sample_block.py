"""The port's ``sample_block``, ``sample_block_indices`` and ``sample_many``
against the JAX package's, on both tree backends, on the CPU.

The same adds, the same priority updates and the same
``np.random.default_rng`` seed must give EQUAL indices, generation stamps,
IS weights and rows (``array_equal``, no tolerance): the port copies the
draw (one ``uniform`` of size K·B over the equal-mass strata, draw j dealt
to ``block[j % K, j // K]``) and, on the native backend, runs the same C
code as the JAX package. The seeded stream is also pinned by the JAX
package's frozen literal (``tests/test_data_plane.py``).
"""

import subprocess

import numpy as np
import pytest

from d4pg_tpu.replay.per import PrioritizedReplayBuffer as JPER
from d4pg_tpu.replay.uniform import Transition as JTransition
from d4pg_tpu.replay import native as jnative
from d4pg_tpu_torch.replay import PrioritizedReplayBuffer, SampledIndices, Transition
from d4pg_tpu_torch.replay import native

FIELDS = ("obs", "action", "reward", "next_obs", "discount")
CASES = [(1, 32, 0), (4, 16, 7), (8, 8, 123)]  # (K, B, step)


@pytest.fixture(autouse=True)
def _needs_gxx(request):
    """Skip a native case only where g++ cannot build the trees."""
    callspec = getattr(request.node, "callspec", None)
    if callspec is None or callspec.params.get("backend", "native") == "native":
        try:
            native.load_library()
            jnative.load_library()
        except (OSError, RuntimeError, subprocess.CalledProcessError) as e:
            pytest.skip(f"g++ cannot build the native trees here: {e}")


def _filled(backend, rows=200, capacity=256, seed=0):
    """The port's and the JAX package's PER on ``backend``, filled and
    re-prioritised alike."""
    ours = PrioritizedReplayBuffer(capacity, 3, 2, tree_backend=backend)
    ref = JPER(capacity, 3, 2, tree_backend=backend)
    rng = np.random.default_rng(seed)
    t = (
        rng.normal(size=(rows, 3)).astype(np.float32),
        rng.uniform(-1, 1, (rows, 2)).astype(np.float32),
        rng.normal(size=rows).astype(np.float32),
        rng.normal(size=(rows, 3)).astype(np.float32),
        np.full(rows, 0.99, np.float32),
    )
    ours.add_batch(Transition(*t))
    ref.add_batch(JTransition(*t))
    pri = np.random.default_rng(seed + 1).uniform(0.05, 4.0, rows)
    ours.update_priorities(np.arange(rows), pri)
    ref.update_priorities(np.arange(rows), pri)
    assert ours.tree_backend == backend
    return ours, ref


def _assert_block_equal(a, b):
    np.testing.assert_array_equal(a["indices"].idx, b["indices"].idx)
    np.testing.assert_array_equal(a["indices"].gen, b["indices"].gen)
    np.testing.assert_array_equal(a["weights"], b["weights"])
    assert a["weights"].dtype == b["weights"].dtype == np.float32
    for key in FIELDS:
        np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("k,b,step", CASES)
@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_sample_block_equals_the_reference(backend, k, b, step):
    ours, ref = _filled(backend)
    blk = ours.sample_block(b, k, np.random.default_rng(42), step=step)
    want = ref.sample_block(b, k, np.random.default_rng(42), step=step)
    assert blk["obs"].shape == (k, b, 3) and blk["indices"].idx.shape == (k, b)
    _assert_block_equal(blk, want)
    # the index half alone: the same draw, the same dealing, no rows
    idx, w, gen = ours.sample_block_indices(b, k, np.random.default_rng(42), step=step)
    j_idx, j_w, j_gen = ref.sample_block_indices(b, k, np.random.default_rng(42), step=step)
    np.testing.assert_array_equal(idx, blk["indices"].idx)
    np.testing.assert_array_equal(gen, blk["indices"].gen)
    np.testing.assert_array_equal(w, blk["weights"])
    for got, exp in ((idx, j_idx), (w, j_w), (gen, j_gen)):
        np.testing.assert_array_equal(got, exp)
    # batch i of the block is sample_many's batch i
    many = ours.sample_many(b, k, np.random.default_rng(42), step=step)
    j_many = ref.sample_many(b, k, np.random.default_rng(42), step=step)
    for i in range(k):
        np.testing.assert_array_equal(many[i]["indices"].idx, blk["indices"].idx[i])
        np.testing.assert_array_equal(many[i]["weights"], j_many[i]["weights"])
        for key in FIELDS:
            np.testing.assert_array_equal(many[i][key], blk[key][i])
            np.testing.assert_array_equal(many[i][key], j_many[i][key])


@pytest.mark.parametrize("k,b,step", CASES)
def test_native_and_numpy_backends_draw_the_same_block(k, b, step):
    nat, _ = _filled("native")
    num, _ = _filled("numpy")
    _assert_block_equal(
        nat.sample_block(b, k, np.random.default_rng(5), step=step),
        num.sample_block(b, k, np.random.default_rng(5), step=step),
    )


@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_sample_block_k1_and_sample_share_the_stream(backend):
    buf, _ = _filled(backend)
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    s = buf.sample(16, r1, step=3)
    blk = buf.sample_block(16, 1, r2, step=3)
    assert r1.bit_generator.state == r2.bit_generator.state
    assert isinstance(s["indices"], SampledIndices)
    np.testing.assert_array_equal(s["indices"].idx, blk["indices"].idx[0])
    np.testing.assert_array_equal(s["indices"].gen, blk["indices"].gen[0])
    np.testing.assert_array_equal(s["weights"], blk["weights"][0])
    for key in FIELDS:
        np.testing.assert_array_equal(s[key], blk[key][0])


@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_seeded_draw_stream_is_the_frozen_literal(backend):
    """The JAX package's frozen fixture: capacity 64, 40 equal-priority
    inserts, ``sample_block(B=4, K=2, default_rng(123), step=0)``."""
    buf = PrioritizedReplayBuffer(64, 1, 1, alpha=1.0, tree_backend=backend)
    buf.add_batch(Transition(
        np.arange(40, dtype=np.float32)[:, None], np.zeros((40, 1), np.float32),
        np.zeros(40, np.float32), np.zeros((40, 1), np.float32), np.ones(40, np.float32),
    ))
    blk = buf.sample_block(4, 2, np.random.default_rng(123), step=0)
    np.testing.assert_array_equal(blk["indices"].idx, [[3, 11, 20, 34], [5, 15, 29, 36]])
    # the rows are the indexed rows (obs holds the row number)
    np.testing.assert_array_equal(blk["obs"][..., 0], blk["indices"].idx)
    idx, _, _ = buf.sample_block_indices(4, 2, np.random.default_rng(123), step=0)
    np.testing.assert_array_equal(idx, [[3, 11, 20, 34], [5, 15, 29, 36]])


@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_staging_slots_rotate_and_indices_outlive_them(backend):
    """Fields are views of a staging slot reused STAGING_SLOTS calls later;
    the indices are fresh copies."""
    buf, _ = _filled(backend)
    rng = np.random.default_rng(0)
    blocks = [buf.sample_block(8, 2, rng, step=0) for _ in range(buf.STAGING_SLOTS + 1)]
    assert np.shares_memory(blocks[0]["obs"], blocks[-1]["obs"])
    assert not np.shares_memory(blocks[0]["obs"], blocks[1]["obs"])
    assert not np.shares_memory(blocks[0]["indices"].idx, blocks[-1]["indices"].idx)
    np.testing.assert_array_equal(blocks[-1]["obs"], buf.obs[blocks[-1]["indices"].idx])
