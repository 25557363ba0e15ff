"""The port's device PER tree, descent and kernel B3/B4 plain versions
against ``d4pg_tpu.replay.device_per``, on the CPU.

The same numpy inputs go through both packages. The tree writes and the
log-depth descent do the same float32 operations in the same order as the
JAX functions, so trees and indices are compared EXACTLY. The IS weights
go through a float32 ``pow`` on each side (XLA's and ATen's), held to
rtol 2e-5; the write-back's ``(|td| + ε)^α`` likewise, to rtol 2e-6. The
JAX Pallas descent cannot run on the installed jax (ROADMAP C-i), so the
oracle for kernel B3's plain version is the JAX ``descend_prefix``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d4pg_tpu.ops.pallas_projection import fused_categorical_loss as j_fused_loss
from d4pg_tpu.replay import device_per as jdper
from d4pg_tpu_torch.ops import cuda_fused_step as cfs
from d4pg_tpu_torch.ops import cuda_projection as cp
from d4pg_tpu_torch.ops import cuda_tree
from d4pg_tpu_torch.ops.categorical import make_support
from d4pg_tpu_torch.replay import SumTree
from d4pg_tpu_torch.replay import device_per as dper

CAP, K, B, SIZE = 64, 3, 4, 48


def _j_tree(pri, cap=CAP):
    return jdper.set_leaves(
        jnp.zeros(jdper.tree_width(cap), jnp.float32),
        jnp.arange(len(pri), dtype=jnp.int32),
        jnp.asarray(pri, jnp.float32),
        cap,
    )


def _t_tree(pri, cap=CAP):
    return dper.set_leaves(
        torch.zeros(dper.tree_width(cap)),
        torch.arange(len(pri)),
        torch.from_numpy(np.asarray(pri, np.float32)),
        cap,
    )


@pytest.mark.parametrize("cap,n", [(64, 64), (48, 48), (64, 20)])
def test_set_leaves_and_repair_equal_the_reference(cap, n):
    pri = np.random.default_rng(cap + n).uniform(0.1, 3.0, n)
    j, t = np.asarray(_j_tree(pri, cap)), _t_tree(pri, cap).numpy()
    np.testing.assert_array_equal(t, j)  # leaves and every sum, rtol 0
    assert t[0] == 0.0 and t.shape == (dper.tree_width(cap),)


def test_repair_ancestors_with_pads_equals_the_reference():
    r = np.random.default_rng(4)
    base = r.uniform(0.1, 2.0, dper.tree_width(CAP)).astype(np.float32)
    base[0] = 0.0
    half = dper.tree_width(CAP) // 2
    leaf_pos = np.array([half + 3, half + 40, half + 3, half + 63])
    j_pos = np.concatenate([leaf_pos, [2 * half, 2 * half]])  # JAX pads: out of range
    t_pos = np.concatenate([leaf_pos, [0, 0]])                # port pads: slot 0
    j = jdper.repair_ancestors(jnp.asarray(base), jnp.asarray(j_pos, jnp.int32))
    t = dper.repair_ancestors(torch.from_numpy(base.copy()), torch.from_numpy(t_pos))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_update_duplicates_last_wins_like_the_reference():
    ones = np.ones(CAP)
    dup = np.array([3, 5, 3, 7, 3])
    vals = np.array([9.0, 2.0, 4.0, 6.0, 1.5], np.float32)
    j = jdper.update_leaves_last_wins(
        _j_tree(ones), jnp.asarray(dup, jnp.int32), jnp.asarray(vals), CAP
    )
    t = dper.update_leaves_last_wins(_t_tree(ones), torch.from_numpy(dup), torch.from_numpy(vals), CAP)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    half = dper.tree_width(CAP) // 2
    assert t[half + 3] == 1.5 and t[half + 5] == 2.0 and t[half + 7] == 6.0


def test_pad_slots_are_dropped():
    """All-pad and mixed slot chunks seed no phantom mass, not even into
    the pow2 padding leaves (48 rows, L = 64)."""
    t = dper.tree_ingest_lane_body(
        0.6, 48, torch.zeros(dper.tree_width(48)), torch.tensor(1.0), torch.full((16,), 48)
    )
    assert float(t.abs().sum()) == 0.0
    slots = np.array([0, 48, 5, 48, 47], np.int32)
    j = jdper.tree_ingest_lane_body(
        0.6, 48, jnp.zeros(dper.tree_width(48), jnp.float32), jnp.float32(2.0), jnp.asarray(slots)
    )
    t = dper.tree_ingest_lane_body(
        0.6, 48, torch.zeros(dper.tree_width(48)), torch.tensor(2.0), torch.from_numpy(slots)
    )
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert float(t[1]) == pytest.approx(3 * 2.0**0.6, rel=1e-6)


def test_descent_skips_zero_mass_leaves_on_boundaries():
    pri = np.array([2.0, 0.0, 3.0, 0.0])
    pre = np.array([0.0, 1.9, 2.0, 4.9], np.float32)
    tree = _t_tree(pri, 4)
    assert dper.descend_prefix(tree, torch.from_numpy(pre)).tolist() == [0, 0, 2, 2]
    leaves = tree[4:]
    assert cuda_tree.find_prefix_plain(leaves, torch.from_numpy(pre)).tolist() == [0, 0, 2, 2]
    assert np.asarray(jdper.descend_prefix(_j_tree(pri, 4), jnp.asarray(pre))).tolist() == [0, 0, 2, 2]


@pytest.mark.parametrize("cap,n", [(64, 64), (48, 48), (1000, 700)])
def test_descend_and_b3_plain_equal_the_reference_descent(cap, n):
    r = np.random.default_rng(cap)
    pri = r.uniform(0.1, 3.0, n)
    jt, tt = _j_tree(pri, cap), _t_tree(pri, cap)
    pre = r.uniform(0.0, float(jt[1]), (7, 37)).astype(np.float32)
    want = np.asarray(jdper.descend_prefix(jt, jnp.asarray(pre)))
    got_tree = dper.descend_prefix(tt, torch.from_numpy(pre))
    leaves = tt[tt.shape[0] // 2:]
    got_b3, offsets = cuda_tree.find_prefix(leaves, torch.from_numpy(pre))
    assert got_tree.dtype == got_b3.dtype == torch.int32
    assert offsets.dtype == torch.float32 and offsets.shape == (cuda_tree.num_chunks(len(leaves)),)
    assert torch.equal(offsets, cuda_tree.chunk_offsets_plain(leaves))
    np.testing.assert_array_equal(got_tree.numpy(), want)
    np.testing.assert_array_equal(got_b3.numpy(), want)


def test_stratified_prefixes_from_the_reference_uniforms():
    tree = _j_tree(np.random.default_rng(9).uniform(0.1, 3.0, SIZE))
    key = jax.random.fold_in(jax.random.PRNGKey(7), 0)
    want = np.asarray(jdper.stratified_prefixes(key, K, B, tree[1]))
    u = np.array(jax.random.uniform(key, (K, B), jnp.float32))
    got = dper.stratified_prefixes(torch.from_numpy(u), K, B, torch.tensor(float(tree[1])))
    np.testing.assert_array_equal(got.numpy(), want)
    # the nextafter clamp: u -> 1 puts the last segment's prefix at the total
    edge = dper.stratified_prefixes(torch.full((K, B), 1.0), K, B, torch.tensor(5.0))
    assert float(edge.max()) == float(np.nextafter(np.float32(5.0), np.float32(0.0)))


def test_stratified_prefixes_are_contiguous_row_by_row():
    """The megastep hands the whole [K, B] block to B3 and row t to B4 at
    step t; a wrapper given a non-contiguous input copies it first."""
    pre = dper.stratified_prefixes(torch.rand(K, B), K, B, torch.tensor(5.0))
    assert pre.is_contiguous() and all(pre[t].is_contiguous() for t in range(K))


def test_lane_draw_min_leaf_weights_and_beta_match_the_reference():
    pri = np.random.default_rng(11).uniform(0.1, 3.0, SIZE)
    jt, tt = _j_tree(pri), _t_tree(pri)
    key = jax.random.PRNGKey(3)
    j_idx, j_p, j_total = jdper.lane_draw(jt, key, K, B, jnp.int32(SIZE))
    pre = jdper.host_prefixes(key, K, B, float(jt[1]))
    filled = torch.tensor(SIZE, dtype=torch.int32)
    idx, p_leaf, total = dper.lane_draw(tt, torch.tensor(pre), filled)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(p_leaf.numpy(), np.asarray(j_p))
    walked = dper.clamp_to_fill(dper.descend_prefix(tt, torch.tensor(pre)), filled)
    np.testing.assert_array_equal(walked.numpy(), np.asarray(j_idx))
    assert float(total) == float(j_total)
    j_min = float(jdper.lane_min_leaf(jt))
    assert float(dper.lane_min_leaf(tt)) == j_min
    for step in (0, 7, 50_000, 100_000, 200_000):
        beta = dper.beta_at(step, 0.4, 100_000)
        assert beta == float(jdper.beta_at(jnp.int32(step), 0.4, 100_000))
        w_j = jdper.importance_weights(
            j_p, j_total, j_min / j_total, jnp.int32(SIZE), 1,
            jdper.beta_at(jnp.int32(step), 0.4, 100_000),
        )
        w_t = dper.importance_weights(p_leaf, total, dper.lane_min_leaf(tt) / total, filled, beta)
        np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=2e-5)


def test_write_back_matches_the_reference():
    pri = np.random.default_rng(12).uniform(0.1, 3.0, SIZE)
    jt, tt = _j_tree(pri), _t_tree(pri)
    idx = np.random.default_rng(13).integers(0, SIZE, (K, B)).astype(np.int32)
    idx[1, 2] = idx[0, 0]  # a slot drawn twice: last wins
    td = np.random.default_rng(14).normal(0, 1.5, (K, B)).astype(np.float32)
    jt2, j_mp = jdper.write_back_lane(jt, jnp.asarray(idx), jnp.asarray(td), 0.6, 1e-6, CAP)
    tt2, t_mp = dper.write_back_lane(tt, torch.from_numpy(idx), torch.from_numpy(td), 0.6, 1e-6, CAP)
    assert tt2 is tt  # in place
    np.testing.assert_allclose(tt2.numpy(), np.asarray(jt2), rtol=2e-6)
    assert float(t_mp) == float(j_mp)


def test_host_sum_tree_agrees_with_the_device_descent():
    """The port's f64 host SumTree and its f32 device tree descend the same
    prefixes to the same leaves."""
    pri = np.random.default_rng(15).uniform(0.1, 3.0, CAP)
    host = SumTree(CAP)
    host.set(np.arange(CAP), pri.astype(np.float32).astype(np.float64))
    tt = _t_tree(pri)
    pre = np.random.default_rng(16).uniform(0.0, float(tt[1]) * (1 - 1e-6), 256).astype(np.float32)
    want = host.find_prefixsum_idx(pre.astype(np.float64))
    np.testing.assert_array_equal(dper.descend_prefix(tt, torch.from_numpy(pre)).numpy(), want)
    np.testing.assert_array_equal(
        cuda_tree.find_prefix_plain(tt[CAP:], torch.from_numpy(pre)).numpy(), want
    )


def test_tree_from_priorities_equals_incremental_writes():
    pa = np.random.default_rng(17).uniform(0.1, 2.0, CAP).astype(np.float32)
    built = dper.tree_from_priorities(pa, CAP, max_priority=2.5, device="cpu")
    np.testing.assert_array_equal(built.sums.numpy(), _t_tree(pa).numpy())
    np.testing.assert_array_equal(
        built.sums.numpy(), np.asarray(jdper.tree_from_priorities(pa, CAP).sums[0])
    )
    assert float(built.max_priority) == 2.5


def _loss_inputs(Bn=40, A=11, seed=0):
    r = np.random.default_rng(seed)
    q = (2.0 * r.normal(size=(Bn, A))).astype(np.float32)
    lg = 2.0 * r.normal(size=(Bn, A))
    p = np.exp(lg - lg.max(-1, keepdims=True))
    p = (p / p.sum(-1, keepdims=True)).astype(np.float32)
    rew = r.uniform(-6, 6, Bn).astype(np.float32)
    disc = np.where(r.uniform(size=Bn) < 0.2, 0.0, 0.97).astype(np.float32)
    leaves = r.uniform(0.1, 3.0, 300).astype(np.float32)
    pre = r.uniform(0, leaves.sum(), Bn).astype(np.float32)
    return q, p, rew, disc, pre, leaves


def test_b4_plain_is_b1f_plus_b3_and_matches_the_reference():
    """Kernel B4's plain version: ce/ov EQUAL to B1f's plain version and
    idx to B3's; against the JAX Pallas fused loss (interpret mode) and the
    JAX descent at the ops tests' atol 1e-5 / exactly. Its gradient is
    B1b's, equal to the non-descent fused loss's."""
    q, p, rew, disc, pre, leaves = _loss_inputs()
    sup = make_support(-5.0, 5.0, 11)
    tq = torch.from_numpy(q).requires_grad_(True)
    offsets = cuda_tree.chunk_offsets_plain(torch.from_numpy(leaves))
    ce, ov, idx = cfs.fused_categorical_loss_descent(
        sup, tq, *map(torch.from_numpy, (p, rew, disc, pre, leaves)), offsets
    )
    ce1, ov1 = cp.fused_loss_fwd(sup, *map(torch.from_numpy, (q, p, rew, disc)))
    assert torch.equal(ce, ce1) and torch.equal(ov, ov1)
    assert torch.equal(idx, cuda_tree.find_prefix_plain(torch.from_numpy(leaves), torch.from_numpy(pre)))
    from d4pg_tpu.ops.categorical import make_support as j_support

    j_ce, j_ov = j_fused_loss(j_support(-5.0, 5.0, 11), *map(jnp.asarray, (q, p, rew, disc)), True)
    np.testing.assert_allclose(ce.detach().numpy(), np.asarray(j_ce), atol=1e-5)
    np.testing.assert_allclose(ov.detach().numpy(), np.asarray(j_ov), atol=1e-5)
    j_tree = jdper.tree_from_priorities(np.pad(leaves, (0, 212)), 512).sums[0]
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jdper.descend_prefix(j_tree, jnp.asarray(pre))))
    g = torch.from_numpy(np.random.default_rng(1).uniform(0.5, 1.5, len(q)).astype(np.float32))
    (dq,) = torch.autograd.grad((ce * g).sum() + ov.sum(), tq)
    tq2 = torch.from_numpy(q).requires_grad_(True)
    ce2, ov2 = cp.fused_categorical_loss(sup, tq2, *map(torch.from_numpy, (p, rew, disc)))
    (dq2,) = torch.autograd.grad((ce2 * g).sum() + ov2.sum(), tq2)
    assert torch.equal(dq, dq2)


def test_tree_and_fused_step_wrappers_count_no_launch_on_the_cpu():
    cuda_tree.reset_launch_counts()
    cfs.reset_launch_counts()
    q, p, rew, disc, pre, leaves = map(torch.from_numpy, _loss_inputs())
    _, offsets = cuda_tree.find_prefix(leaves, pre)
    cfs.fused_step_fwd(make_support(-5.0, 5.0, 11), q, p, rew, disc, pre, leaves, offsets)
    assert cuda_tree.LAUNCHES == {"tree_count": 0} and cfs.LAUNCHES == {"fused_step": 0}


@pytest.mark.parametrize("bad", ["dtype", "rank", "contiguous", "device_mix"])
def test_tree_wrapper_refuses_what_the_kernel_does_not_take(bad):
    leaves, pre = torch.rand(64), torch.rand(8)
    if bad == "dtype":
        leaves = leaves.double()
    elif bad == "rank":
        leaves = leaves[None]
    elif bad == "contiguous":
        leaves = torch.rand(128)[::2]
    elif bad == "device_mix":
        pre = pre.to("meta")
    with pytest.raises((TypeError, ValueError)):
        cuda_tree.find_prefix(leaves, pre)


def _j_chunk_offsets(pa, cap):
    """The exclusive cumsum, in float64, of the JAX device-PER tree's nodes
    at the level whose nodes each cover ``CHUNK`` leaves."""
    sums = np.asarray(jdper.tree_from_priorities(np.asarray(pa, np.float32), cap).sums[0])
    half = sums.shape[0] // 2
    level = sums[half // cuda_tree.CHUNK: 2 * half // cuda_tree.CHUNK].astype(np.float64)
    return np.cumsum(level) - level


@pytest.mark.parametrize("cap,fill", [(8192, 8192), (5000, 3100), (2048, 1500)])
def test_chunk_offsets_plain_equal_the_reference_tree_on_integer_leaves(cap, fill):
    """Integer leaves below 2^24 in total: every summation order is exact,
    so the plain offsets EQUAL the tree's level sums' exclusive cumsum."""
    pa = np.zeros(cap, np.float32)
    pa[:fill] = np.random.default_rng(cap).integers(0, 4, fill)
    leaves = _t_tree(pa, cap)[dper.tree_width(cap) // 2:]
    got = cuda_tree.chunk_offsets_plain(leaves)
    np.testing.assert_array_equal(got.numpy().astype(np.float64), _j_chunk_offsets(pa, cap))


@pytest.mark.parametrize("cap", [8192, 6000])
def test_chunk_offsets_plain_match_the_reference_tree_within_the_chain(cap):
    """Real-valued leaves: the plain offsets and the tree's pairwise level
    sums add in other orders; each is within the stated chain of float32
    adds of the exact value, so they differ by at most twice that."""
    pa = np.random.default_rng(cap).uniform(0.1, 3.0, cap).astype(np.float32)
    leaves = _t_tree(pa, cap)[dper.tree_width(cap) // 2:]
    got = cuda_tree.chunk_offsets_plain(leaves).numpy().astype(np.float64)
    want = _j_chunk_offsets(pa, cap)
    tol = 2 * cuda_tree.chain_length(len(leaves)) * 2.0**-24 * float(pa.astype(np.float64).sum())
    assert got.shape == want.shape and got[0] == want[0] == 0.0
    assert np.abs(got - want).max() <= tol


def test_chain_length_pins_the_kernel_summation_order():
    """The chain stated in csrc/per_tree.cuh: the chunk offsets' order (a
    lane's chunk sums in sequence, one warp scan, the lane's running prefix)
    and the walk inside a chunk. 107 adds at the 1M-row tree's 2^20 leaves;
    a single-chunk tree has the shortest."""
    assert cuda_tree.chain_length(2**20) == 107
    assert cuda_tree.chain_length(cuda_tree.CHUNK) == 45


def test_chunk_offsets_plain_on_a_ragged_last_chunk():
    leaves = torch.arange(2500, dtype=torch.float32) % 5
    got = cuda_tree.chunk_offsets_plain(leaves)
    c = leaves.double().cumsum(0)
    assert got.tolist() == [0.0, float(c[1023]), float(c[2047])]


@pytest.mark.parametrize("bad", ["none", "shape", "dtype", "contiguous", "device_mix"])
def test_fused_step_wrapper_refuses_bad_chunk_offsets(bad):
    """B4's wrapper checks the offsets before it branches on the device, so
    the CPU refuses what the card would."""
    q, p, rew, disc, pre, _ = map(torch.from_numpy, _loss_inputs())
    leaves = torch.from_numpy(np.random.default_rng(2).uniform(0.1, 3.0, 3000).astype(np.float32))
    offsets = cuda_tree.chunk_offsets_plain(leaves)  # 3 chunks
    cfs.fused_step_fwd(make_support(-5.0, 5.0, 11), q, p, rew, disc, pre, leaves, offsets)
    if bad == "none":
        offsets = None
    elif bad == "shape":
        offsets = torch.cat([offsets, offsets])
    elif bad == "dtype":
        offsets = offsets.double()
    elif bad == "contiguous":
        offsets = torch.stack([offsets, offsets], 1)[:, 0]
    elif bad == "device_mix":
        offsets = offsets.to("meta")
    with pytest.raises((TypeError, ValueError)):
        cfs.fused_step_fwd(make_support(-5.0, 5.0, 11), q, p, rew, disc, pre, leaves, offsets)
