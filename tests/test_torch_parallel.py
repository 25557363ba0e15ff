"""The port's data parallelism (``d4pg_tpu_torch/parallel``) against the
JAX package's, on the CPU, at 2x32 nets, 11 atoms, B = 16 and 2 lanes.

The JAX side is its single-device oracle form: ``train_step`` /
``fused_train_scan`` with ``sync_fn=partial(det_pmean, axis_name="dp",
size=2)`` under ``jax.vmap(axis_name="dp")`` over the two row shards (the
8-device mesh form is what JAX's own tests mark slow). Both sides start
from one JAX ``create_train_state`` carried across with ``weights.py``.

Tolerances, with their reasons:

- ``det_pmean`` and the layout functions: exact (the same fixed-order
  adds of the same float32 values; integer and copy arithmetic);
- the dp steps: ``test_torch_agent``'s — loss and priorities rtol 1e-4 /
  atol 1e-6 (the same float32 math summed in another order), q_mean and
  actor_loss atol 1e-3, params after the steps atol 10·lr and median
  lr/10 (Adam's near-sign first updates);
- hogwild against the JAX oracle: the dp steps' tolerances, and both Adam
  moment sets within 1e-4 of each tensor's largest magnitude; the other
  two hogwild checks are the port against itself: ``torch.equal``.
"""

from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d4pg_tpu.agent import D4PGConfig as JConfig
from d4pg_tpu.agent import create_train_state as j_create
from d4pg_tpu.agent.d4pg import fused_train_scan as j_fused_train_scan
from d4pg_tpu.agent.d4pg import train_step as j_train_step
from d4pg_tpu.config import TrainConfig as JTrainConfig
from d4pg_tpu.models.critic import DistConfig as JDist
from d4pg_tpu.parallel.dp import _pmean_floats as j_pmean_floats
from d4pg_tpu.parallel.dp import det_pmean as j_det_pmean
from d4pg_tpu.replay import device_ring as jring
from d4pg_tpu.replay.source import from_train_config, negotiate
from d4pg_tpu.replay.uniform import ReplayBuffer as JReplay
from d4pg_tpu.replay.uniform import Transition as JTransition
from d4pg_tpu_torch.agent import D4PGConfig, DistConfig, create_train_state
from d4pg_tpu_torch.agent.d4pg import fused_train_scan
from d4pg_tpu_torch.config import TrainConfig, check_placement
from d4pg_tpu_torch.parallel import distributed, dp
from d4pg_tpu_torch.parallel.mesh import make_mesh
from d4pg_tpu_torch.replay import ReplayBuffer, Transition
from d4pg_tpu_torch.replay import device_ring as tring
from d4pg_tpu_torch.weights import load_jax_params

LR = 1e-4
B, D = 16, 2


def _configs():
    common = dict(obs_dim=3, action_dim=1, hidden_sizes=(32, 32), tau=0.05, n_step=3,
                  lr_actor=LR, lr_critic=LR)
    jcfg = JConfig(dist=JDist(num_atoms=11, v_min=-10.0, v_max=0.0),
                   projection_backend="pallas_fused", **common)
    tcfg = D4PGConfig(dist=DistConfig(num_atoms=11, v_min=-10.0, v_max=0.0),
                      projection_backend="fused", **common)
    return jcfg, tcfg


def _pair(seed=0):
    jcfg, tcfg = _configs()
    jst = j_create(jcfg, jax.random.PRNGKey(seed))
    tst = create_train_state(tcfg, device="cpu")
    load_jax_params(tst, jax.device_get(jst.actor_params), jax.device_get(jst.critic_params))
    return jcfg, tcfg, jst, tst


def _batch(rng, lead=(), weights=True):
    shape = lead + (B,)
    b = {
        "obs": rng.normal(size=shape + (3,)).astype(np.float32),
        "action": rng.uniform(-1, 1, shape + (1,)).astype(np.float32),
        "reward": rng.uniform(-1, 0, shape).astype(np.float32),
        "next_obs": rng.normal(size=shape + (3,)).astype(np.float32),
        "discount": np.where(rng.uniform(size=shape) < 0.2, 0.0, 0.99**3).astype(np.float32),
    }
    if weights:
        b["weights"] = rng.uniform(0.2, 1.0, shape).astype(np.float32)
    return b


def _shards(b, axis):
    """[.., B, ..] → [2, .., B/2, ..]: the JAX oracle's lane axis in front."""
    return {k: jnp.asarray(np.stack(np.split(v, D, axis=axis))) for k, v in b.items()}


def _oracle(fn, jcfg):
    sync = partial(j_det_pmean, axis_name="dp", size=D)
    return jax.jit(jax.vmap(lambda st, b: fn(jcfg, st, b, sync_fn=sync),
                            in_axes=(None, 0), axis_name="dp"))


def _assert_params_close(tst, jst):
    for module, tree in ((tst.actor, jst.actor_params), (tst.critic, jst.critic_params),
                         (tst.target_actor, jst.target_actor_params),
                         (tst.target_critic, jst.target_critic_params)):
        layers = jax.device_get(tree)["params"]
        for name, prm in module.named_parameters():
            layer, kind = name.split(".")
            leaf = np.asarray(layers[layer]["kernel" if kind == "weight" else "bias"])
            diff = np.abs(prm.detach().numpy() - (leaf.T if kind == "weight" else leaf))
            assert diff.max() <= 10 * LR, (name, diff.max())
            assert np.median(diff) <= LR / 10, (name, np.median(diff))


def _assert_metrics_close(tm, jm):
    assert set(tm) == set(jm)
    for k in ("critic_loss", "priority_mean", "q_support_frac"):
        np.testing.assert_allclose(np.asarray(tm[k]), np.asarray(jm[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    for k in ("q_mean", "actor_loss"):
        np.testing.assert_allclose(np.asarray(tm[k]), np.asarray(jm[k]), atol=1e-3, err_msg=k)


# ---------------------------------------------------------------- det_pmean
@pytest.mark.parametrize("n", [2, 3])
def test_det_pmean_equals_the_reference(n):
    x = np.random.default_rng(n).normal(size=(n, 257)).astype(np.float32) * 1e3
    want = jax.vmap(lambda t: j_det_pmean(t, "dp", n), axis_name="dp")(jnp.asarray(x))
    got = dp.det_pmean(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[0])
    # the order is the program's: lane 0 + lane 1 + ... then / n
    acc = x[0]
    for i in range(1, n):
        acc = acc + x[i]
    np.testing.assert_array_equal(got.numpy(), acc / np.float32(n))


# ----------------------------------------------------------- dp train steps
@pytest.mark.parametrize("weights", [True, False], ids=["per", "uniform_no_weights"])
def test_dp_train_step_matches_the_reference_oracle(weights):
    jcfg, tcfg, jst, tst = _pair()
    jstep = _oracle(j_train_step, jcfg)
    step = dp.make_dp_train_step(tcfg, make_mesh(D, device="cpu"))
    rng = np.random.default_rng(1)
    for _ in range(3):
        b = _batch(rng, weights=weights)
        jout, jm, jpri = jstep(jst, _shards(b, 0))
        jst = jax.tree.map(lambda x: x[0], jout)
        _, tm, tpri = step(tst, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(tpri.numpy(), np.asarray(jpri).reshape(-1),
                                   rtol=1e-4, atol=1e-6)
        _assert_metrics_close(tm, jax.tree.map(lambda x: x[0], jm))
    assert tst.step == int(jst.step) == 3 and step.sync.calls == 9
    _assert_params_close(tst, jst)


def test_dp_fused_train_step_matches_the_reference_oracle():
    jcfg, tcfg, jst, tst = _pair(seed=2)
    jscan = _oracle(j_fused_train_scan, jcfg)
    scan = dp.make_dp_fused_train_step(tcfg, make_mesh(D, device="cpu"))
    b = _batch(np.random.default_rng(3), lead=(3,))
    jout, jm, jpri = jscan(jst, _shards(b, 1))
    jst = jax.tree.map(lambda x: x[0], jout)
    _, tm, tpri = scan(tst, {k: torch.from_numpy(v) for k, v in b.items()})
    # [2, K, B/2] lane-major → [K, B]
    np.testing.assert_allclose(tpri.numpy(), np.concatenate(list(np.asarray(jpri)), axis=1),
                               rtol=1e-4, atol=1e-6)
    _assert_metrics_close(tm, jax.tree.map(lambda x: x[0], jm))
    assert tm["critic_loss"].shape == (3,)
    _assert_params_close(tst, jst)


def test_dp_step_programs_match_the_reference_oracle():
    """The trainer's dp ``train_step`` (K = 1) and ``fused_step`` (K = 3)
    as compiled programs (``dp.lane_program`` over the eager steps), held
    against the same oracles at the same tolerances; the combines counted
    outside the bodies, one specialization each."""
    jcfg, tcfg, jst, tst = _pair()
    jstep = _oracle(j_train_step, jcfg)
    step = dp.make_dp_train_step(tcfg, make_mesh(D, device="cpu"))
    prog = dp.lane_program("train_step", lambda b: step(tst, b)[1:], lambda: [tst], [step.sync])
    rng = np.random.default_rng(1)
    for _ in range(3):
        b = _batch(rng)
        jout, jm, jpri = jstep(jst, _shards(b, 0))
        jst = jax.tree.map(lambda x: x[0], jout)
        k0 = tst.step
        tm, tpri = prog({k: torch.from_numpy(v) for k, v in b.items()})
        tst.step = k0 + 1
        np.testing.assert_allclose(tpri.numpy(), np.asarray(jpri).reshape(-1),
                                   rtol=1e-4, atol=1e-6)
        _assert_metrics_close(tm, jax.tree.map(lambda x: x[0], jm))
    assert tst.step == int(jst.step) == 3 and step.sync.calls == 9
    assert prog._cache_size() == 1
    _assert_params_close(tst, jst)

    jcfg, tcfg, jst, tst = _pair(seed=2)
    jscan = _oracle(j_fused_train_scan, jcfg)
    scan = dp.make_dp_fused_train_step(tcfg, make_mesh(D, device="cpu"))
    prog = dp.lane_program("fused_step", lambda b: scan(tst, b)[1:], lambda: [tst], [scan.sync])
    b = _batch(np.random.default_rng(3), lead=(3,))
    jout, jm, jpri = jscan(jst, _shards(b, 1))
    jst = jax.tree.map(lambda x: x[0], jout)
    tm, tpri = prog({k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(tpri.numpy(), np.concatenate(list(np.asarray(jpri)), axis=1),
                               rtol=1e-4, atol=1e-6)
    _assert_metrics_close(tm, jax.tree.map(lambda x: x[0], jm))
    assert scan.sync.calls == 9
    _assert_params_close(tst, jst)


def test_dp_batch_not_divisible_raises():
    _, tcfg, _, tst = _pair()
    step = dp.make_dp_train_step(tcfg, make_mesh(D, device="cpu"))
    b = {k: torch.from_numpy(v[:13]) for k, v in _batch(np.random.default_rng(0)).items()}
    with pytest.raises(ValueError, match="not divisible by dp=2"):
        step(tst, b)


# ------------------------------------------------------------------ hogwild
def _tensors(state):
    return [t.detach().clone() for t in dp.float_tensors(state)]


@pytest.mark.parametrize("k", [1, 2])
def test_hogwild_identical_shards_reduce_to_the_single_lane_step(k):
    _, tcfg = _configs()
    hog_state = create_train_state(tcfg, seed=5, device="cpu")
    single = create_train_state(tcfg, seed=5, device="cpu")
    shard = _batch(np.random.default_rng(7), lead=(k,))
    shard = {key: v[:, : B // D] for key, v in shard.items()}
    tiled = {key: torch.from_numpy(np.concatenate([v, v], axis=1)) for key, v in shard.items()}
    hog = dp.make_hogwild_dp_train_step(tcfg, make_mesh(D, device="cpu"))
    _, hm, hpri = hog(hog_state, tiled)
    _, sm, spri = fused_train_scan(tcfg, single, {key: torch.from_numpy(v)
                                                  for key, v in shard.items()})
    assert all(torch.equal(a, b) for a, b in zip(_tensors(hog_state), _tensors(single)))
    assert all(torch.equal(hm[key], sm[key]) for key in sm)
    assert torch.equal(hpri, torch.cat([spri, spri], dim=1))
    assert hog_state.step == single.step == k


def test_hogwild_diverging_shards_resync_to_the_fixed_order_mean():
    """Each lane's K steps on its own copy, then every float tensor (params,
    targets, both Adam moment sets) is the fixed-order mean of the copies;
    Adam's step count passes through; the copies are equal again."""
    _, tcfg = _configs()
    k = 3
    batches = {key: torch.from_numpy(v)
               for key, v in _batch(np.random.default_rng(9), lead=(k,)).items()}
    lanes = dp.split_lanes(batches, D, axis=1)
    copies = [create_train_state(tcfg, seed=4, device="cpu") for _ in range(D)]
    for st, lb in zip(copies, lanes):
        fused_train_scan(tcfg, st, lb)
    per_copy = [_tensors(st) for st in copies]
    want = [dp.det_mean_rows(torch.stack(ts)) for ts in zip(*per_copy)]
    state = create_train_state(tcfg, seed=4, device="cpu")
    hog = dp.make_hogwild_dp_train_step(tcfg, make_mesh(D, device="cpu"))
    hog(state, batches)
    assert all(torch.equal(a, b) for a, b in zip(_tensors(state), want))
    assert all(torch.equal(a, b) for a, b in zip(_tensors(hog.replicas[1]), want))
    # the moments moved apart and were averaged, not copied from lane 0
    assert not all(torch.equal(a, b) for a, b in zip(per_copy[0], want))
    steps = {int(s["step"]) for s in state.critic_opt.state.values()}
    assert steps == {k} and state.step == k


def test_hogwild_matches_the_reference_oracle():
    """``HogwildStep`` on diverging shards, K = 3, against the JAX
    ``make_hogwild_dp_train_step`` body in its oracle form: each lane's
    ``fused_train_scan`` with no sync, then ``_pmean_floats`` of the state
    and the metrics, under ``vmap(axis_name="dp")``. Params and targets at
    the dp steps' tolerance; both Adam moment sets within 1e-4 of each
    tensor's largest magnitude (the gradients' rtol); metrics and the
    [K, B] lane-major priorities at the dp steps'; the integer counters
    (Adam's count, the state's step) pass through as K."""
    jcfg, tcfg, jst, tst = _pair(seed=6)
    k = 3

    def j_hogwild(st, b):
        st, m, p = j_fused_train_scan(jcfg, st, b)
        return j_pmean_floats(st, "dp"), j_pmean_floats(m, "dp"), p

    b = _batch(np.random.default_rng(11), lead=(k,))
    jout, jm, jpri = jax.jit(jax.vmap(j_hogwild, in_axes=(None, 0), axis_name="dp"))(
        jst, _shards(b, 1))
    jst = jax.tree.map(lambda x: x[0], jout)
    hog = dp.make_hogwild_dp_train_step(tcfg, make_mesh(D, device="cpu"))
    _, tm, tpri = hog(tst, {key: torch.from_numpy(v) for key, v in b.items()})

    _assert_params_close(tst, jst)
    for module, opt, jopt in ((tst.critic, tst.critic_opt, jst.critic_opt_state),
                              (tst.actor, tst.actor_opt, jst.actor_opt_state)):
        adam = jax.device_get(jopt[0])
        assert int(adam.count) == k
        for name, prm in module.named_parameters():
            layer, kind = name.split(".")
            for moment, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
                leaf = np.asarray(tree["params"][layer]["kernel" if kind == "weight" else "bias"])
                leaf = leaf.T if kind == "weight" else leaf
                np.testing.assert_allclose(opt.state[prm][moment].numpy(), leaf, rtol=0,
                                           atol=1e-4 * np.abs(leaf).max(),
                                           err_msg=f"{name} {moment}")
            assert int(opt.state[prm]["step"]) == k
    assert tst.step == int(jst.step) == k
    # [2, K, B/2] lane-major → [K, B]
    np.testing.assert_allclose(tpri.numpy(), np.concatenate(list(np.asarray(jpri)), axis=1),
                               rtol=1e-4, atol=1e-6)
    _assert_metrics_close(tm, jax.tree.map(lambda x: x[0], jm))
    assert tm["critic_loss"].shape == (k,)


# ---------------------------------------------------------- layout algebra
@pytest.mark.parametrize("capacity,n", [(64, 2), (96, 4), (10, 1)])
def test_striped_perm_equals_the_reference(capacity, n):
    np.testing.assert_array_equal(tring.striped_perm(capacity, n), jring.striped_perm(capacity, n))


@pytest.mark.parametrize("P,L", [(2, 1), (2, 2), (3, 2)])
def test_gapless_total_equals_the_reference(P, L):
    layout = SimpleNamespace(n_shards=P * L, local_shards=L, n_processes=P)
    rng = np.random.default_rng(P * 10 + L)
    for _ in range(50):
        totals = rng.integers(0, 40, size=P)
        assert (tring.MultihostRingSync._gapless_total(layout, totals)
                == jring.MultihostRingSync._gapless_total(layout, totals))
    # lock-step deals give the true total
    for T in range(0, 30):
        totals = [(T // (P * L)) * L + int(np.clip(T % (P * L) - p * L, 0, L)) for p in range(P)]
        assert tring.MultihostRingSync._gapless_total(layout, np.asarray(totals)) == T


def _snapshot(n, capacity, seed):
    r = np.random.default_rng(seed)
    T = n
    size = min(T, capacity)
    return {"obs": r.normal(size=(size, 3)).astype(np.float32),
            "action": r.uniform(-1, 1, (size, 1)).astype(np.float32),
            "reward": r.normal(size=size).astype(np.float32),
            "next_obs": r.normal(size=(size, 3)).astype(np.float32),
            "discount": r.uniform(size=size).astype(np.float32),
            "pos": np.asarray(T % capacity), "size": np.asarray(size)}


@pytest.mark.parametrize("T", [37, 64, 90])
@pytest.mark.parametrize("P,L", [(2, 1), (2, 2)])
def test_snapshot_deal_equals_the_reference(T, P, L):
    capacity = 64
    data = _snapshot(T, capacity, T)
    for p in range(P):
        layout = dict(n_shards=P * L, local_shards=L, shard_lo=p * L, capacity=capacity,
                      host_capacity=capacity // P, _synced=0, _size=0)
        jbuf, tbuf = JReplay(capacity // P, 3, 1), ReplayBuffer(capacity // P, 3, 1)
        n_j = jring.MultihostRingSync.deal_snapshot(SimpleNamespace(_buffer=jbuf, **layout), data)
        n_t = tring.MultihostRingSync.deal_snapshot(SimpleNamespace(_buffer=tbuf, **layout), data)
        assert n_t == n_j
        assert tbuf.total_added == jbuf.total_added and len(tbuf) == len(jbuf)
        for k in ("obs", "action", "reward", "next_obs", "discount"):
            np.testing.assert_array_equal(getattr(tbuf, k), np.asarray(getattr(jbuf, k)))


def test_sharded_ring_sync_deals_the_striped_layout():
    mesh = make_mesh(D, device="cpu")
    buf = ReplayBuffer(64, 3, 1)
    rings = tring.lane_rings_init(64, 3, 1, mesh)
    sync = tring.ShardedDeviceRingSync(buf, mesh, chunk_cap=8)
    seeded = []
    sync.tree_hook = lambda j, rows: seeded.append((j, rows.clone()))
    r = np.random.default_rng(0)
    for n in (21, 30, 50):  # the last one wraps
        buf.add_batch(Transition(r.normal(size=(n, 3)), r.uniform(-1, 1, (n, 1)),
                                 r.normal(size=n), r.normal(size=(n, 3)), r.uniform(size=n)))
        sync.flush(rings)
        want = tring.striped_lanes(buf, D, device="cpu")
        for ring, w in zip(rings, want):
            for k in tring.FIELDS + ("size",):
                assert torch.equal(getattr(ring, k), getattr(w, k)), k
    assert int(rings[0].size) == 64 and sync.pending() == 0
    assert {j for j, _ in seeded} == {0, 1} and max(len(rows) for _, rows in seeded) <= 4


# ---------------------------------------------------------------- mesh
def test_mesh_lanes_owners_and_devices():
    m = make_mesh(4, device="cpu", num_processes=2, process_index=1)
    assert list(m.local_lanes) == [2, 3] and [m.owner(d) for d in range(4)] == [0, 0, 1, 1]
    assert distributed.local_shard_span(m) == (2, 4)
    assert all(d == torch.device("cpu") for d in m.devices)
    assert make_mesh(device="cpu").dp == 1
    tp = make_mesh(2, tp=2, device="cpu")
    assert (tp.shape, tp.grid) == ({"dp": 2, "tp": 2}, (torch.device("cpu"),) * 4)
    with pytest.raises(ValueError, match="tp_group_spans_ranks"):
        make_mesh(1, tp=2, device="cpu", num_processes=2, process_index=0)
    with pytest.raises(ValueError, match="divisible by --num-processes"):
        make_mesh(3, device="cpu", num_processes=2, process_index=0)


def test_single_process_collectives_are_the_identity():
    x = torch.arange(6.0).reshape(2, 3)
    assert distributed.all_gather_lanes(x) is x
    np.testing.assert_array_equal(distributed.host_allgather_i64([2**40, -3]), [[2**40, -3]])
    assert distributed.process_count() == 1 and distributed.backend() is None
    with pytest.raises(ValueError, match="needs a coordinator"):
        distributed.initialize_distributed(None, 2, 0, device="cpu")


def test_backend_rule_reads_each_ranks_card():
    """NCCL iff the ranks' cards (their UUIDs, gathered at bring-up) are
    distinct, whatever the world size or a launcher's variables say."""
    assert distributed.choose_backend(None) == "gloo"                 # the CPU
    assert distributed.choose_backend(["GPU-a", "GPU-a"]) == "gloo"   # two ranks, one card
    # a card each: two on one host, or two hosts of one card each
    assert distributed.choose_backend(["GPU-a", "GPU-b"]) == "nccl"
    assert distributed.choose_backend(["GPU-a", "GPU-b", "GPU-a"]) == "gloo"
    assert distributed.rank_card(3, 2) == 0   # no card here: every rank on card 0


# ------------------------------------------------------------ negotiation
VERDICTS = {
    "hybrid_single_device": dict(replay_placement="hybrid", dp=2),
    "sharded_megastep_dp_only": dict(replay_placement="device", dp=2, tp=2),
    "dp_hogwild_host_only": dict(replay_placement="device", dp=2, dp_hogwild=True,
                                 steps_per_dispatch=8),
    "batch_not_divisible": dict(replay_placement="device", dp=3),
    "capacity_not_divisible": dict(replay_placement="device", dp=2, replay_capacity=4097),
    "multihost_device_placement_only": dict(dp=2, num_processes=2),
    "multihost_requires_dp": dict(replay_placement="device", num_processes=2),
    "multihost_dp_not_divisible": dict(replay_placement="device", dp=3, num_processes=2,
                                       batch_size=258, replay_capacity=4098),
    "multihost_capacity_not_divisible": dict(replay_placement="device", dp=2, num_processes=2,
                                             replay_capacity=4097),
    "fused_descent_single_device": dict(replay_placement="device", dp=2, fused_descent=True),
    "dp_hogwild_requires_dp": dict(dp_hogwild=True, steps_per_dispatch=8),
    "dp_hogwild_needs_fused_window": dict(dp=2, dp_hogwild=True),
}


@pytest.mark.parametrize("code", sorted(VERDICTS))
def test_dp_refusals_name_the_reference_gap(code):
    kw = dict(dict(batch_size=256, replay_capacity=4096), **VERDICTS[code])
    jcfg = JTrainConfig(**kw, agent=JConfig(projection_backend="pallas_fused"))
    neg = negotiate(from_train_config(jcfg))
    assert not neg.ok and code in {g.code for g in neg.gaps}
    with pytest.raises(ValueError) as e:
        check_placement(TrainConfig(**kw))
    msg = str(e.value)
    for g in neg.gaps:
        assert f"{g.code}: {g.message}" in msg, (g.code, msg)


def test_ingest_prefetch_is_ignored_under_dp_as_the_reference_declares(capsys):
    from d4pg_tpu_torch.config import apply_declared_actions

    kw = dict(replay_placement="device", dp=2, ingest_prefetch=True)
    neg = negotiate(from_train_config(JTrainConfig(**kw)))
    assert neg.ok and "ingest_prefetch_ignored" in neg.actions
    cfg = apply_declared_actions(TrainConfig(**kw))
    assert not cfg.ingest_prefetch and "ignoring it" in capsys.readouterr().out
    assert apply_declared_actions(TrainConfig(replay_placement="device",
                                              ingest_prefetch=True)).ingest_prefetch


def test_dp_configs_the_reference_passes_pass():
    for kw in (dict(dp=2), dict(dp=2, steps_per_dispatch=8, dp_hogwild=True),
               dict(replay_placement="device", dp=2),
               dict(replay_placement="device", dp=2, num_processes=2)):
        kw = dict(dict(batch_size=256, replay_capacity=4096), **kw)
        assert negotiate(from_train_config(JTrainConfig(**kw))).ok
        check_placement(TrainConfig(**kw))
    for kw in (dict(tp=2), dict(dp=2, tp=2), dict(dp=2, tp=2, steps_per_dispatch=8,
                                                   dp_hogwild=True)):
        assert negotiate(from_train_config(JTrainConfig(**kw))).ok
        check_placement(TrainConfig(**kw))  # tensor parallelism is ported (A7 (b))
    kw = dict(dp=2, tp=2, replay_placement="device", prioritized=True)
    assert not negotiate(from_train_config(JTrainConfig(**kw))).ok
    with pytest.raises(ValueError, match="sharded_megastep_dp_only: the sharded megastep "
                                         r"mesh is dp-only \(tp=1\)"):
        check_placement(TrainConfig(**kw))
