"""The port's native C++ segment trees (``d4pg_tpu_torch/csrc/sumtree.cpp``
through ``replay/native.py``) against the JAX package's build of the same
source and against both packages' NumPy trees, on the CPU.

Tolerances, with their reasons:

- set/get/sum/min/``find_prefixsum_idx``: exact. Both natives are the same
  C code in float64, and the NumPy trees repair each parent with the same
  single add or min of its two children;
- ``update_priorities``: rtol 1e-12, the JAX package's own tolerance for
  its native against its NumPy write-back (``tests/test_data_plane.py``);
  ``max_priority`` is exact;
- the threaded stress test: exact invariants (no lost insert, IS weights
  at most 1, internal nodes equal to a tree rebuilt from the leaves).

The file skips only when g++ cannot build the library, decided in a
fixture (not at import), so every test worker collects the same tests.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest

from d4pg_tpu.replay import MinTree as JMinTree
from d4pg_tpu.replay import SumTree as JSumTree
from d4pg_tpu.replay import native as jnative
from d4pg_tpu.replay.per import PrioritizedReplayBuffer as JPER
from d4pg_tpu.replay.uniform import Transition as JTransition
from d4pg_tpu_torch.replay import MinTree, PrioritizedReplayBuffer, SumTree, Transition
from d4pg_tpu_torch.replay import native


@pytest.fixture(autouse=True)
def _needs_gxx():
    try:
        native.load_library()
        jnative.load_library()
    except (OSError, RuntimeError, subprocess.CalledProcessError) as e:
        pytest.skip(f"g++ cannot build the native trees here: {e}")


def _rows(n, seed, obs_dim=3, act_dim=2):
    rng = np.random.default_rng(seed)
    return (
        rng.normal(size=(n, obs_dim)).astype(np.float32),
        rng.uniform(-1, 1, (n, act_dim)).astype(np.float32),
        rng.normal(size=n).astype(np.float32),
        rng.normal(size=(n, obs_dim)).astype(np.float32),
        np.full(n, 0.99, np.float32),
    )


@pytest.mark.parametrize("kind", ["sum", "min"])
def test_native_trees_equal_the_reference_native_and_numpy_trees(kind):
    cap = 1000  # not a power of two: every tree rounds up to 1024 leaves
    if kind == "sum":
        trees = [native.NativeSumTree(cap), jnative.NativeSumTree(cap), SumTree(cap), JSumTree(cap)]
    else:
        trees = [native.NativeMinTree(cap), jnative.NativeMinTree(cap), MinTree(cap), JMinTree(cap)]
    assert {t.capacity for t in trees} == {1024}
    rng = np.random.default_rng(0)
    for _ in range(30):
        idx = rng.integers(0, cap, size=64)
        vals = rng.uniform(0, 10, size=64)
        # NumPy fancy assignment leaves in-batch duplicate order undefined:
        # the same unique write to all four
        idx, keep = np.unique(idx, return_index=True)
        for t in trees:
            t.set(idx, vals[keep])
        probe = rng.integers(0, 1024, size=128)
        got = [np.asarray(t.get(probe)) for t in trees]
        for g in got[1:]:
            np.testing.assert_array_equal(got[0], g)
        roots = {t.sum() if kind == "sum" else t.min() for t in trees}
        assert len(roots) == 1, roots
        if kind == "sum":
            total = trees[0].sum()
            prefixes = np.sort(rng.uniform(0, total, size=256))
            found = [np.asarray(t.find_prefixsum_idx(prefixes)) for t in trees]
            for f in found[1:]:
                np.testing.assert_array_equal(found[0], f)
    # duplicates within one batch: the two natives run the same scalar loop
    # (last write wins)
    idx = np.array([3, 3, 7, 3])
    vals = np.array([1.0, 2.0, 5.0, 4.0])
    trees[0].set(idx, vals)
    trees[1].set(idx, vals)
    np.testing.assert_array_equal(trees[0].get([3, 7]), [4.0, 5.0])
    np.testing.assert_array_equal(trees[0].get(np.arange(1024)), trees[1].get(np.arange(1024)))


def test_native_trees_refuse_out_of_range_indices():
    t = native.NativeSumTree(16)
    with pytest.raises(IndexError):
        t.set([16], [1.0])
    with pytest.raises(IndexError):
        t.get([-1])


def _pair(backend, rows=200, capacity=256, seed=3, **kw):
    """The port's and the JAX package's PER, filled and re-prioritised
    alike, both on ``backend``."""
    ours = PrioritizedReplayBuffer(capacity, 3, 2, tree_backend=backend, **kw)
    ref = JPER(capacity, 3, 2, tree_backend=backend, **kw)
    rows_ = _rows(rows, seed)
    ours.add_batch(Transition(*rows_))
    ref.add_batch(JTransition(*rows_))
    pri = np.random.default_rng(seed + 1).uniform(0.05, 4.0, rows)
    ours.update_priorities(np.arange(rows), pri)
    ref.update_priorities(np.arange(rows), pri)
    return ours, ref


@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_update_priorities_equals_the_reference_on_blocks_with_duplicates(backend):
    ours, ref = _pair(backend)
    assert ours.tree_backend == backend
    rng = np.random.default_rng(9)
    for _ in range(3):
        idx = rng.integers(0, 200, size=(4, 16))  # [K, B], duplicates likely
        pri = rng.uniform(0.01, 7.0, size=(4, 16))
        ours.update_priorities(idx, pri)
        ref.update_priorities(idx, pri)
    leaves = np.arange(256)
    np.testing.assert_allclose(ours._sum.get(leaves), ref._sum.get(leaves), rtol=1e-12)
    np.testing.assert_allclose(ours._min.get(leaves), ref._min.get(leaves), rtol=1e-12)
    assert ours._min.min() == pytest.approx(ref._min.min(), rel=1e-12)
    assert ours._sum.sum() == pytest.approx(ref._sum.sum(), rel=1e-12)
    assert ours._max_priority == ref._max_priority


def test_native_update_priorities_drops_recycled_slots_like_the_reference():
    """A [K, B] block sampled, then every slot recycled while its dispatch
    is in flight: the generation filter drops the whole write-back on the
    port's native, the JAX package's native and the port's NumPy backend."""
    bufs = [
        PrioritizedReplayBuffer(8, 1, 1, tree_backend="native", eps=0.0, alpha=1.0),
        JPER(8, 1, 1, tree_backend="native", eps=0.0, alpha=1.0),
        PrioritizedReplayBuffer(8, 1, 1, tree_backend="numpy", eps=0.0, alpha=1.0),
    ]
    first, second = _rows(8, 0, 1, 1), _rows(8, 5, 1, 1)
    blocks = []
    for b, tr in zip(bufs, (Transition, JTransition, Transition)):
        b.add_batch(tr(*first))
        b.update_priorities(np.arange(8), np.linspace(0.5, 4.0, 8))
        blocks.append(b.sample_block(4, 2, np.random.default_rng(0), step=0)["indices"])
        b.add_batch(tr(*second))  # the whole ring recycled
    for b, blk in zip(bufs, blocks):
        b.update_priorities(blk, np.full((2, 4), 1e-6))
    leaves = np.arange(8)
    for b in bufs:
        # every update dropped: the leaves keep the fresh-insert seed
        np.testing.assert_allclose(b._sum.get(leaves), b._max_priority**b.alpha, rtol=1e-12)
        assert b._max_priority == 4.0
    # a raw index block applies unconditionally
    raw = blocks[0].idx
    for b in bufs:
        b.update_priorities(raw, np.full((2, 4), 9.0))
    got = [b._sum.get(leaves) for b in bufs]
    np.testing.assert_allclose(got[0], got[1], rtol=1e-12)
    np.testing.assert_allclose(got[0], got[2], rtol=1e-12)
    assert bufs[0]._max_priority == bufs[1]._max_priority == 9.0


def test_fresh_checkout_rebuilds_a_stale_library(tmp_path, monkeypatch):
    """A library no newer than the source (a fresh checkout's equal
    mtimes, or a foreign file) is rebuilt, not loaded: loading this one
    would raise."""
    src = tmp_path / "sumtree.cpp"
    shutil.copy(native._source_path(), src)
    bdir = tmp_path / "build"
    bdir.mkdir()
    so = bdir / "libsumtree.so"
    so.write_bytes(b"definitely not an ELF shared object")
    t = os.stat(src).st_mtime
    os.utime(so, (t, t))
    monkeypatch.setattr(native, "_source_path", lambda: str(src))
    monkeypatch.setattr(native, "_build_dir", lambda: str(bdir))
    monkeypatch.setattr(native, "_LIB", None)  # restored after the test
    lib = native.load_library()
    assert lib.st_root is not None
    assert so.stat().st_size > 1000
    assert not list(bdir.glob("*.tmp"))  # built aside, then renamed into place


def test_the_port_builds_its_own_copy_of_the_source():
    assert native._source_path().endswith(os.path.join("d4pg_tpu_torch", "csrc", "sumtree.cpp"))
    assert os.path.dirname(native._build_dir()).endswith("d4pg_tpu_torch")


def test_auto_falls_back_to_numpy_with_the_printed_line(monkeypatch, capsys):
    def broken():
        raise RuntimeError("g++ not found")

    monkeypatch.setattr(native, "load_library", broken)
    buf = PrioritizedReplayBuffer(64, 3, 2, tree_backend="auto")
    out = capsys.readouterr().out
    assert "[replay] native tree backend unavailable (RuntimeError('g++ not found'))" in out
    assert "falling back to NumPy trees" in out
    assert buf.tree_backend == "numpy" and isinstance(buf._sum, SumTree)
    # the fallback draws what an explicit NumPy buffer draws
    ref = PrioritizedReplayBuffer(64, 3, 2, tree_backend="numpy")
    for b in (buf, ref):
        b.add_batch(Transition(*_rows(40, 0)))
    a = buf.sample_block(8, 2, np.random.default_rng(1), step=0)
    b = ref.sample_block(8, 2, np.random.default_rng(1), step=0)
    np.testing.assert_array_equal(a["indices"].idx, b["indices"].idx)
    np.testing.assert_array_equal(a["obs"], b["obs"])
    # "native" never falls back: the failure reaches the caller
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        PrioritizedReplayBuffer(64, 3, 2, tree_backend="native")
    with pytest.raises(ValueError, match="tree_backend"):
        PrioritizedReplayBuffer(64, 3, 2, tree_backend="cuda")


@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_concurrent_inserts_draws_and_write_backs_keep_the_trees_whole(backend):
    """More threads than cores insert, draw and write back at once (ctypes
    releases the interpreter lock inside the C calls): with the buffer's
    lock no insert is lost (every write bumps one slot's generation and the
    lifetime count) and every internal node still equals the sum (min) of
    its leaves, as a tree rebuilt from the final leaves shows."""
    import sys
    import threading

    cap, ITERS = 512, 30
    n_threads = 2 * (os.cpu_count() or 2)
    buf = PrioritizedReplayBuffer(cap, 3, 2, tree_backend=backend)
    buf.add_batch(Transition(*_rows(cap, 0)))
    errors = []

    def work(seed):
        rng = np.random.default_rng(seed)
        try:
            for i in range(ITERS):
                if i % 3 == 0:
                    buf.add_batch(Transition(*_rows(16, seed * 100 + i)))
                blk = buf.sample_block(8, 2, rng, step=i)
                # IS weights are max-normalised: a draw that saw one tree
                # mid-update by another thread could exceed 1
                if blk["weights"].max() > 1.0 + 1e-6:
                    raise AssertionError(f"IS weight {blk['weights'].max()} > 1")
                buf.update_priorities(blk["indices"], rng.uniform(1e-3, 50.0, size=(2, 8)))
                buf.update_priorities(rng.integers(0, cap, 64), rng.uniform(1e-3, 50.0, 64))
        except Exception as e:  # reported by the main thread's assert
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(s,)) for s in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert buf.total_added == cap + n_threads * 16 * len(range(0, ITERS, 3))
    assert int(buf._gen.sum()) == buf.total_added
    leaves = np.asarray(buf._sum.get(np.arange(cap)))
    mins = np.asarray(buf._min.get(np.arange(cap)))
    ref_sum, ref_min = SumTree(cap), MinTree(cap)
    ref_sum.set(np.arange(cap), leaves)
    ref_min.set(np.arange(cap), mins)
    assert buf._sum.sum() == ref_sum.sum()
    assert buf._min.min() == ref_min.min()
    np.testing.assert_array_equal(buf._sum.find_prefixsum_idx(np.linspace(0, ref_sum.sum(), 64, endpoint=False)),
                                  ref_sum.find_prefixsum_idx(np.linspace(0, ref_sum.sum(), 64, endpoint=False)))
