"""The port's compiled programs (``d4pg_tpu_torch/utils/graphs.py``) on the
CPU, where each runs its body eagerly on its static buffers: the bindings a
CUDA graph depends on (inputs copied in, copies handed out, state read by
address) hold here too, and every learner program gives its plain body's
bits and the JAX package's numbers.

Tolerances: a program against its own body, exact (the same code on the
same inputs); against the JAX package, those of ``test_torch_megastep``
(tree and losses rtol 1e-3, params ten-step atol 10·lr) and
``test_torch_agent`` (one step's loss and priorities rtol 1e-4 / atol
1e-6; K chained steps' priorities rtol 1e-2 / atol 1e-3); β and the IS
weights, as in ``test_torch_device_per`` (β exact, weights rtol 2e-5).
"""

from __future__ import annotations

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d4pg_tpu.agent import D4PGConfig as JConfig
from d4pg_tpu.agent import create_train_state as j_create
from d4pg_tpu.agent import jit_train_step
from d4pg_tpu.agent.d4pg import fused_train_scan as j_scan
from d4pg_tpu.models.critic import DistConfig as JDist
from d4pg_tpu.replay import device_per as jdper
from d4pg_tpu.replay.device_ring import DeviceRingSync as JRingSync
from d4pg_tpu.replay.device_ring import device_ring_init as j_ring_init
from d4pg_tpu.replay.uniform import ReplayBuffer as JReplay
from d4pg_tpu.replay.uniform import Transition as JTransition
from d4pg_tpu.runtime import megastep as jmega
from d4pg_tpu_torch.agent.state import D4PGConfig
from d4pg_tpu_torch.config import TrainConfig
from d4pg_tpu_torch.replay import ReplayBuffer, Transition
from d4pg_tpu_torch.replay import device_per as dper
from d4pg_tpu_torch.replay.device_ring import DeviceRingSync, device_ring_init
from d4pg_tpu_torch.runtime import megastep
from d4pg_tpu_torch.runtime.checkpoint import load_state_into, state_dict_of
from d4pg_tpu_torch.utils import graphs
from d4pg_tpu_torch.weights import load_jax_params
from tests import test_torch_megastep as tm

K, B, DISPATCHES = tm.K, tm.B, 3


# ------------------------------------------------------------- the wrapper
def test_inputs_are_copied_in_and_outputs_handed_out_as_copies():
    prog = graphs.Program("f", lambda x: {"y": x * 2, "s": x.sum()}, device="cpu")
    a = prog(torch.arange(3.0))
    kept = a["y"].clone()
    b = prog(torch.full((3,), 5.0))
    assert torch.equal(a["y"], kept) and torch.equal(b["y"], torch.full((3,), 10.0))
    spec = next(iter(prog._specs.values()))
    assert a["y"].data_ptr() != spec.outputs[1].data_ptr()  # never the static output
    a["y"].add_(1)
    assert torch.equal(prog(torch.full((3,), 5.0))["y"], torch.full((3,), 10.0))


def test_one_specialization_a_signature_each_build_reported():
    seen = []
    graphs.add_build_listener(seen.append)
    try:
        prog = graphs.Program("g", lambda x: x + 1, device="cpu")
        for shape in ((3,), (3,), (4,), (4,), (2, 2)):
            prog(torch.zeros(shape))
        prog(torch.zeros(3, dtype=torch.float64))
    finally:
        graphs.remove_build_listener(seen.append)
    assert prog._cache_size() == 4 and seen == ["g"] * 4


def test_a_rebound_state_tensor_raises_and_an_in_place_write_does_not():
    w = torch.ones(3)
    holder = {"w": w}
    prog = graphs.Program("h", lambda x: x * holder["w"], device="cpu",
                          state=lambda: [holder["w"]])
    prog(torch.ones(3))
    holder["w"].copy_(torch.full((3,), 2.0))  # in place: the binding holds
    assert torch.equal(prog(torch.ones(3)), torch.full((3,), 2.0))
    holder["w"] = torch.full((3,), 3.0)  # rebound: a replay would read the old one
    with pytest.raises(graphs.GraphBindingError, match="rebound"):
        prog(torch.ones(3))


def test_a_scalar_bound_at_build_is_frozen_where_an_input_is_not():
    """Why β is an input: a float closed over at build never changes."""
    beta = {"v": 0.5}
    frozen = graphs.Program("frozen", lambda x, b=beta["v"]: x * b, device="cpu")
    live = graphs.Program("live", lambda x, b: x * b, device="cpu")
    for v in (0.5, 0.75, 1.0):
        beta["v"] = v
        assert float(frozen(torch.ones(()))) == 0.5
        assert float(live(torch.ones(()), torch.tensor(v))) == v


# --------------------------------------------------------- megastep tiers
def _port(tcfg, init, prioritized=True):
    st, ring, per = tm._port_side(tcfg, init, prioritized=prioritized)
    return st, ring, (per.tree if per is not None else None)


def _learner_bits(st, ring, tree) -> list:
    return [t.clone() for t in megastep.learner_tensors(st, ring, tree)]


def _beta(tcfg, st):
    return dper.beta_tensor(st.step, tcfg.per_beta0, tcfg.per_beta_steps, "cpu")


@pytest.mark.parametrize("tier", ["uniform", "kernel", "fused"])
def test_megastep_program_equals_its_body(tier):
    """The trainer's ``megastep`` program against the plain body, each from
    one init and one generator seed, over dispatches whose β anneals."""
    jcfg, tcfg = tm._configs()
    tcfg = dataclasses.replace(tcfg, per_beta_steps=2 * K)
    init = tm._params(j_create(jcfg, jax.random.PRNGKey(1)))
    per = tier != "uniform"
    (s0, r0, t0), (s1, r1, t1) = _port(tcfg, init, per), _port(tcfg, init, per)
    g0, g1 = torch.Generator().manual_seed(11), torch.Generator().manual_seed(11)
    prog = megastep.megastep_program(tcfg, K, B, s0, r0, t0, g0, fused=tier == "fused")
    body = {"uniform": megastep.megastep_uniform_body, "kernel": megastep.megastep_device_per_body,
            "fused": megastep.megastep_device_per_fused_body}[tier]
    for _ in range(DISPATCHES):
        step = s0.step
        m0 = prog(_beta(tcfg, s0)) if per else prog()
        s0.step = step + K
        if per:
            m1 = body(tcfg, K, B, s1, r1, t1, g1, beta=_beta(tcfg, s1))
        else:
            m1 = body(tcfg, K, B, s1, r1, g1)
        assert all(torch.equal(m0[k], m1[k]) for k in m1)
    assert s0.step == s1.step == K * DISPATCHES
    for a, b in zip(_learner_bits(s0, r0, t0), _learner_bits(s1, r1, t1)):
        assert torch.equal(a, b)
    assert torch.equal(g0.get_state(), g1.get_state())
    assert prog._cache_size() == 1


def test_hybrid_program_equals_its_body():
    jcfg, tcfg = tm._configs()
    init = tm._params(j_create(jcfg, jax.random.PRNGKey(1)))
    (s0, r0, _), (s1, r1, _) = _port(tcfg, init, False), _port(tcfg, init, False)
    prog = megastep.hybrid_program(tcfg, s0, r0)
    rng = np.random.default_rng(3)
    for _ in range(DISPATCHES):
        idx = torch.from_numpy(rng.integers(0, tm.SIZE, (K, B)).astype(np.int32))
        w = torch.from_numpy(rng.uniform(0.2, 1.0, (K, B)).astype(np.float32))
        step = s0.step
        m0, p0 = prog(idx, w)
        s0.step = step + K
        m1, p1 = megastep.megastep_hybrid_body(tcfg, s1, r1, idx, w)
        assert torch.equal(p0, p1) and all(torch.equal(m0[k], m1[k]) for k in m1)
    for a, b in zip(_learner_bits(s0, r0, None), _learner_bits(s1, r1, None)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("tier", ["kernel", "fused"])
def test_device_per_program_matches_the_reference(tier, j_per_run):
    """A megastep program fed the JAX package's prefixes and the trainer's
    β input lands on the JAX megastep's trajectory (test_torch_megastep's
    tolerances)."""
    init, prefixes, _, j_trees, jst, jm = j_per_run
    _, tcfg = tm._configs()
    st, ring, tree = _port(tcfg, init)
    body = {"kernel": megastep.megastep_device_per_body,
            "fused": megastep.megastep_device_per_fused_body}[tier]
    prog = graphs.Program(
        "megastep", lambda beta, pre: body(tcfg, K, B, st, ring, tree, None, prefixes=pre,
                                           beta=beta),
        device="cpu", state=lambda: megastep.learner_tensors(st, ring, tree))
    for pre, (j_sums, j_mp) in zip(prefixes, j_trees):
        step = st.step
        tmet = prog(_beta(tcfg, st), torch.tensor(pre))
        st.step = step + K
        np.testing.assert_allclose(tree.sums.numpy(), j_sums, rtol=1e-3)
        assert float(tree.max_priority) == pytest.approx(j_mp, rel=1e-3)
    tm._assert_state_close(st, jst)
    for k in ("critic_loss", "priority_mean"):
        np.testing.assert_allclose(float(tmet[k]), jm[k], rtol=1e-3, err_msg=k)


@pytest.fixture(scope="module")
def j_per_run():
    """The JAX device-PER megastep (XLA descent) over ``tm.DISPATCHES``
    dispatches, as ``test_torch_megastep`` runs it: the prefixes it drew,
    the tree after each, its final state and metrics."""
    jcfg, _ = tm._configs()
    st, ring, per = tm._j_setup(jcfg)
    init = tm._params(st)
    mega = jmega.make_megastep_device_per(jcfg, K, B, tree_backend="xla")
    key = jax.random.PRNGKey(7)
    tree = per.tree
    prefixes, trees = [], []
    for _ in range(tm.DISPATCHES):
        k_lane = jax.random.fold_in(jax.random.split(key)[1], jnp.int32(0))
        prefixes.append(jdper.host_prefixes(k_lane, K, B, float(tree.sums[0][1])))
        st, tree, key, metrics = mega(st, ring, tree, key)
        trees.append((np.asarray(tree.sums[0]), float(tree.max_priority)))
    return init, prefixes, None, trees, st, {k: float(v) for k, v in metrics.items()}


# ------------------------------------------------------------------- β
def _device_trainer(tmp_path, fused, beta_steps, **kw):
    from d4pg_tpu_torch.runtime.trainer import Trainer

    agent = D4PGConfig(hidden_sizes=(16, 16), per_beta_steps=beta_steps)
    cfg = TrainConfig(num_envs=2, batch_size=8, warmup_steps=64, total_steps=24,
                      eval_interval=1000, eval_episodes=1, replay_capacity=512,
                      log_dir=str(tmp_path), agent=agent, replay_placement="device",
                      prioritized=True, fused_descent=fused, steps_per_dispatch=4, **kw)
    return Trainer(cfg, device="cpu")


@pytest.mark.parametrize("fused", [False, True])
def test_beta_read_across_per_beta_steps_matches_the_jax_megastep(tmp_path, monkeypatch, fused):
    """Six dispatches of K = 4 with per_beta_steps 10: β, read where the
    megastep weighs its draws, is the JAX megastep's ``beta_at(state.step)``
    at every dispatch (0.4, 0.64, 0.88, then 1), and so are the weights.
    The same read off a program whose β was bound at build stays 0.4."""
    seen = []
    real = dper.importance_weights

    def recording(p_leaf, total, min_ratio, n_filled, beta, n_shards=1):
        w = real(p_leaf, total, min_ratio, n_filled, beta, n_shards)
        seen.append((float(beta), p_leaf.clone(), total.clone(), min_ratio.clone(),
                     n_filled.clone(), w.clone()))
        return w

    monkeypatch.setattr(dper, "importance_weights", recording)
    t = _device_trainer(tmp_path / "live", fused, 10)
    try:
        t.train()
    finally:
        t.close()
    per_dispatch = 4 if fused else 1  # the fused tier weighs each step's draw
    assert t.state.step == 24 and len(seen) == 6 * per_dispatch
    for d in range(6):
        want = float(jdper.beta_at(jnp.int32(4 * d), 0.4, 10))
        for beta, p_leaf, total, min_ratio, n, w in seen[d * per_dispatch:(d + 1) * per_dispatch]:
            assert beta == want
            jw = jdper.importance_weights(jnp.asarray(p_leaf.numpy()), jnp.asarray(total.numpy()),
                                          jnp.asarray(min_ratio.numpy()),
                                          jnp.asarray(n.numpy()), 1, jnp.float32(want))
            np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=2e-5)
    assert [seen[d * per_dispatch][0] for d in range(6)] == pytest.approx(
        [0.4, 0.64, 0.88, 1.0, 1.0, 1.0])

    # the mutation the input exists to prevent: β bound when the program
    # is built is read at every dispatch as its first value
    seen.clear()
    t = _device_trainer(tmp_path / "frozen", fused, 10)
    try:
        build_beta = dper.beta_tensor(0, 0.4, 10, "cpu")
        body = t._megastep_prog.body
        t._megastep_prog.body = lambda beta: body(build_beta)
        t.train()
    finally:
        t.close()
    assert seen and all(s[0] == pytest.approx(0.4) for s in seen)


# ------------------------------------------------------- host dispatches
def _host_trainer(tmp_path, k, **kw):
    from d4pg_tpu_torch.runtime.trainer import Trainer

    cfg = TrainConfig(num_envs=2, batch_size=8, warmup_steps=64, total_steps=2 * k,
                      eval_interval=1000, eval_episodes=1, replay_capacity=512,
                      log_dir=str(tmp_path), agent=D4PGConfig(hidden_sizes=(16, 16)),
                      steps_per_dispatch=k, prioritized=True, **kw)
    return Trainer(cfg, device="cpu")


def _j_config(tcfg):
    return JConfig(obs_dim=tcfg.obs_dim, action_dim=tcfg.action_dim,
                   hidden_sizes=tuple(tcfg.hidden_sizes),
                   dist=JDist(num_atoms=tcfg.dist.num_atoms, v_min=tcfg.dist.v_min,
                              v_max=tcfg.dist.v_max),
                   gamma=tcfg.gamma, n_step=tcfg.n_step, tau=tcfg.tau,
                   lr_actor=tcfg.lr_actor, lr_critic=tcfg.lr_critic,
                   projection_backend="pallas_fused")


@pytest.mark.parametrize("k", [1, 4])
def test_host_program_equals_its_body_and_the_reference(tmp_path, k):
    """The host placement's ``train_step`` (K = 1) and ``fused_step`` (K = 4)
    programs, from one JAX init on one sampled batch: the JAX step's loss
    and priorities, and the plain body's bits."""
    t = _host_trainer(tmp_path, k)
    try:
        t.warmup()
        jcfg = _j_config(t.config.agent)
        jst = j_create(jcfg, jax.random.PRNGKey(4))
        load_jax_params(t.state, *tm._params(jst))
        _, batch, _ = t._sample_staged(k)
        batch = {key: v.clone() for key, v in batch.items()}
        t._release_staging_holds(len(t._staging_holds))
        prog = t._train_step_prog if k == 1 else t._fused_step_prog
        snap = copy.deepcopy(state_dict_of(t.state))
        metrics, pri = t._run_program(prog, batch)
        after_prog = [x.clone() for x in megastep.learner_tensors(t.state)]
        load_state_into(t.state, snap)
        t.state.step = 0
        body = t._host_step_body if k == 1 else t._host_scan_body
        metrics_b, pri_b = body(batch)
        assert torch.equal(pri, pri_b) and all(torch.equal(metrics[m], metrics_b[m])
                                                for m in metrics)
        for a, b in zip(after_prog, megastep.learner_tensors(t.state)):
            assert torch.equal(a, b)
    finally:
        t.close()
    jb = {key: jnp.asarray(v.numpy()) for key, v in batch.items()}
    if k == 1:
        _, jm, jpri = jit_train_step(jcfg)(jst, jb)
        np.testing.assert_allclose(pri.numpy(), np.asarray(jpri), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(float(metrics["critic_loss"]), float(jm["critic_loss"]),
                                   rtol=1e-4, atol=1e-6)
    else:
        _, jm, jpri = jax.jit(lambda s, b: j_scan(jcfg, s, b))(jst, jb)
        np.testing.assert_allclose(pri.numpy(), np.asarray(jpri), rtol=1e-2, atol=1e-3)
        np.testing.assert_allclose(float(metrics["critic_loss"]),
                                   float(np.mean(jm["critic_loss"])), rtol=1e-3)


@pytest.mark.parametrize("k", [1, 4])
def test_priorities_handed_to_the_write_back_are_not_overwritten(tmp_path, k):
    """Every dispatch hands its own copy: none is a program's static output,
    and each still holds what was handed once later dispatches ran."""
    t = _host_trainer(tmp_path, k, async_priority_writeback=True)
    handed = []
    real = t._hand_off

    def recording(indices, priorities):
        handed.append((priorities, priorities.clone()))
        real(indices, priorities)

    t._hand_off = recording
    try:
        t.train(total_steps=6 * k)
    finally:
        t.close()
    prog = t._train_step_prog if k == 1 else t._fused_step_prog
    statics = {o.data_ptr() for s in prog._specs.values() for o in s.outputs}
    assert len(handed) == 6
    for tensor, at_hand_off in handed:
        assert tensor.data_ptr() not in statics
        assert torch.equal(tensor, at_hand_off)


# ------------------------------------------------------------- the ingest
def test_padded_ring_and_tree_ingest_equal_the_jax_make_ingest():
    """Each package's sync (chunk_cap 16, every chunk padded to 16) over one
    chunk sequence, partial chunks, the wrap and a full resync: the same
    ring and tree after every flush, one ingest specialization each."""
    cap, alpha = 64, 0.6
    jbuf, tbuf = JReplay(cap, 3, 1), ReplayBuffer(cap, 3, 1)
    jsync, tsync = JRingSync(jbuf, chunk_cap=16), DeviceRingSync(tbuf, chunk_cap=16)
    jper, tper = jdper.DevicePerSync(cap, alpha), dper.DevicePerSync(cap, alpha, device="cpu")
    jsync.tree_hook, tsync.tree_hook = jper.on_chunk, tper.on_chunk
    jring, tring = j_ring_init(cap, 3, 1), device_ring_init(cap, 3, 1, "cpu")
    for seed, n in enumerate((5, 16, 3, 40, 200)):
        rows = tm._rows(n, seed)
        jbuf.add_batch(JTransition(*rows))
        tbuf.add_batch(Transition(*rows))
        jring = jsync.flush(jring)
        tsync.flush(tring)
        j = jax.device_get(jring)
        for f in ("obs", "action", "reward", "next_obs", "discount"):
            np.testing.assert_array_equal(getattr(tring, f).numpy(), np.asarray(getattr(j, f)))
        assert int(tring.size) == int(j.size)
        np.testing.assert_array_equal(tper.tree.sums.numpy(), np.asarray(jper.tree.sums[0]))
        assert tsync.chunks_ingested == jsync.chunks_ingested
    assert tsync.ingest_program._cache_size() == 1
    assert tper.ingest_program._cache_size() == 1
    tbuf.add_batch(Transition(*tm._rows(1, 9)))
    with pytest.raises(graphs.GraphBindingError, match="one ring"):
        tsync.flush(device_ring_init(cap, 3, 1, "cpu"))


# ------------------------------------------------------------- restore
def _dispatch(t):
    step, agent = t.state.step, t.config.agent
    out = t._megastep_prog(dper.beta_tensor(step, agent.per_beta0, agent.per_beta_steps, "cpu"))
    t.state.step = step + t.config.steps_per_dispatch
    return out


def test_a_restore_then_a_dispatch_equals_the_uninterrupted_run(tmp_path):
    """Two trainers from one seed: one saves and dispatches on; the other
    dispatches once more, restores the save IN PLACE (state, Adam's
    moments, the device tree, the generator) and dispatches on. The
    programs' bindings hold and the bits agree."""
    runs = []
    for tag, detour in (("straight", 0), ("restored", 1)):
        t = _device_trainer(tmp_path / tag, True, 100)
        try:
            t.train(total_steps=8)
            saved = (copy.deepcopy(state_dict_of(t.state)), t._dev_per.snapshot_host(),
                     t._megastep_gen.get_state(), t.state.step)
            for _ in range(detour):
                _dispatch(t)
            if detour:
                sd, (pa, mp), gen, step = saved
                load_state_into(t.state, sd)
                t._dev_per.restore_host(pa, mp)
                t._megastep_gen.set_state(gen)
                t.state.step = step
            for _ in range(2):
                metrics = _dispatch(t)
            runs.append((_learner_bits(t.state, t._ring, t._dev_per.tree), metrics))
        finally:
            t.close()
    (a, ma), (b, mb) = runs
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(ma[k], mb[k]) for k in ma)


def test_a_replaced_optimizer_moment_raises_at_the_next_dispatch(tmp_path):
    t = _device_trainer(tmp_path, False, 100)
    try:
        t.train(total_steps=8)
        sd = copy.deepcopy(state_dict_of(t.state))
        t.state.critic_opt.load_state_dict(sd["critic_opt"])  # replaces every moment
        with pytest.raises(graphs.GraphBindingError, match="megastep: state tensor"):
            _dispatch(t)
        load_state_into(t.state, sd)  # a fresh in-place restore does not cure it:
        with pytest.raises(graphs.GraphBindingError):  # the tensors are new ones
            _dispatch(t)
    finally:
        t.close()
