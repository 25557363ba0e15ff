"""The port's own NumPy replay against the JAX package's NumPy backend
(the native tree backend has its own files, ``test_torch_native_tree.py``
and ``test_torch_sample_block.py``).

The same adds, the same ``np.random.default_rng(seed)`` and the same
priority updates must give EQUAL indices and IS weights: the port copies
the draw, so there is no tolerance.
"""

import numpy as np
import pytest

from d4pg_tpu.replay.per import PrioritizedReplayBuffer as JPER
from d4pg_tpu.replay.schedules import linear_schedule as j_linear
from d4pg_tpu.replay.schedules import noise_scale_schedule as j_noise_scale
from d4pg_tpu.replay.segment_tree import MinTree as JMinTree
from d4pg_tpu.replay.segment_tree import SumTree as JSumTree
from d4pg_tpu.replay.uniform import ReplayBuffer as JReplay
from d4pg_tpu.replay.uniform import Transition as JTransition
from d4pg_tpu_torch.replay import (
    MinTree,
    PrioritizedReplayBuffer,
    ReplayBuffer,
    SampledIndices,
    SumTree,
    Transition,
    linear_schedule,
    noise_scale_schedule,
)


def _rows(rng, n, obs_dim=3, act_dim=1):
    return (
        rng.normal(size=(n, obs_dim)).astype(np.float32),
        rng.uniform(-1, 1, size=(n, act_dim)).astype(np.float32),
        rng.normal(size=n).astype(np.float32),
        rng.normal(size=(n, obs_dim)).astype(np.float32),
        rng.uniform(0, 1, size=n).astype(np.float32),
    )


@pytest.mark.parametrize("capacity", [100, 1000])
def test_per_index_stream_equals_reference(capacity):
    kw = dict(alpha=0.6, beta0=0.4, beta_steps=50, eps=1e-6)
    ours = PrioritizedReplayBuffer(capacity, 3, 1, tree_backend="numpy", **kw)
    ref = JPER(capacity, 3, 1, tree_backend="numpy", **kw)
    data_rng = np.random.default_rng(0)
    r_ours, r_ref = np.random.default_rng(42), np.random.default_rng(42)
    for step in range(40):
        rows = _rows(data_rng, 48)  # wraps the ring at capacity 100
        i_ours = ours.add_batch(Transition(*rows))
        i_ref = ref.add_batch(JTransition(*rows))
        np.testing.assert_array_equal(i_ours, i_ref)
        b_ours = ours.sample(32, r_ours, step=step)
        b_ref = ref.sample(32, r_ref, step=step)
        np.testing.assert_array_equal(b_ours["indices"].idx, b_ref["indices"].idx)
        np.testing.assert_array_equal(b_ours["indices"].gen, b_ref["indices"].gen)
        np.testing.assert_array_equal(b_ours["weights"], b_ref["weights"])
        for k in ("obs", "action", "reward", "next_obs", "discount"):
            np.testing.assert_array_equal(b_ours[k], b_ref[k])
        td = data_rng.gamma(2.0, size=32)
        if step % 3 == 0:  # raw indices as well as SampledIndices
            ours.update_priorities(b_ours["indices"].idx, td)
            ref.update_priorities(b_ref["indices"].idx, td)
        else:
            ours.update_priorities(b_ours["indices"], td)
            ref.update_priorities(b_ref["indices"], td)
    assert ours._max_priority == ref._max_priority
    np.testing.assert_array_equal(ours._sum.tree, ref._sum.tree)
    np.testing.assert_array_equal(ours._min.tree, ref._min.tree)


def test_recycled_slot_write_back_is_dropped():
    buf = PrioritizedReplayBuffer(8, 3, 1, tree_backend="numpy")
    rng = np.random.default_rng(0)
    buf.add_batch(Transition(*_rows(rng, 8)))
    b = buf.sample(4, np.random.default_rng(1))
    buf.add_batch(Transition(*_rows(rng, 8)))  # every slot recycled
    before = buf._sum.tree.copy()
    buf.update_priorities(b["indices"], np.full(4, 50.0))
    np.testing.assert_array_equal(buf._sum.tree, before)
    buf.update_priorities(b["indices"].idx, np.full(4, 50.0))  # raw: applied
    assert buf._max_priority == pytest.approx(50.0 + 1e-6)


def test_uniform_sample_equals_reference():
    ours, ref = ReplayBuffer(64, 3, 1), JReplay(64, 3, 1)
    rows = _rows(np.random.default_rng(0), 100)
    ours.add_batch(Transition(*rows))
    ref.add_batch(JTransition(*rows))
    assert len(ours) == len(ref) == 64
    a = ours.sample(16, np.random.default_rng(3))
    b = ref.sample(16, np.random.default_rng(3))
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])


def test_segment_trees_equal_reference():
    rng = np.random.default_rng(0)
    s, js, m, jm = SumTree(37), JSumTree(37), MinTree(37), JMinTree(37)
    for _ in range(5):
        idx = rng.integers(0, 37, 20)
        val = rng.uniform(0, 3, 20)
        for t in (s, js, m, jm):
            t.set(idx, val)
    np.testing.assert_array_equal(s.tree, js.tree)
    np.testing.assert_array_equal(m.tree, jm.tree)
    pre = rng.uniform(0, s.sum(), 64)
    np.testing.assert_array_equal(s.find_prefixsum_idx(pre), js.find_prefixsum_idx(pre))


def test_schedules_equal_reference():
    for step in (0, 10, 50, 100, 1000):
        assert linear_schedule(step, 100, 0.4, 1.0) == j_linear(step, 100, 0.4, 1.0)
        assert noise_scale_schedule(step, 100, 0.1) == j_noise_scale(step, 100, 0.1)
    assert noise_scale_schedule(5, 0, 0.1) == 1.0


def test_update_priorities_validates_sizes():
    buf = PrioritizedReplayBuffer(8, 3, 1)
    buf.add_batch(Transition(*_rows(np.random.default_rng(0), 4)))
    with pytest.raises(ValueError):
        buf.update_priorities(SampledIndices(np.arange(3), np.ones(3, np.int64)), np.ones(2))
