"""The in-process lanes' compiled programs (``--dp`` / ``--tp`` in one
process) against their eager bodies, on the CPU, where each program runs
its body eagerly on its static buffers: the host dp steps (K = 1 and
K = 4), hogwild with its replicas, dp 2 x tp 2, ``auto_parallel_train_
step``, the sharded megastep (uniform and device PER), the sharded ring
and tree ingests, and the on-device lanes over one warmup and two
iterations. Each program and its body run from one snapshot of every
tensor the program binds and of its generators' states; the tensors,
generator states and outputs must be ``torch.equal``. Also: a rebound
lane tensor raises ``GraphBindingError``; a resume restores into the
bound tensors (a program's next call runs); each state given to
``auto_parallel_train_step`` has a program of its own.

The programs against the JAX package are in ``test_torch_parallel.py``,
``test_torch_sharded_megastep.py`` and ``test_torch_on_device_mesh.py``.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from d4pg_tpu_torch.agent import create_train_state
from d4pg_tpu_torch.agent.state import D4PGConfig
from d4pg_tpu_torch.config import TrainConfig
from d4pg_tpu_torch.envs import make_env
from d4pg_tpu_torch.parallel.mesh import make_mesh
from d4pg_tpu_torch.parallel.partition import auto_parallel_train_step
from d4pg_tpu_torch.replay import ReplayBuffer, Transition
from d4pg_tpu_torch.replay import device_per as dper
from d4pg_tpu_torch.replay.device_ring import (
    FIELDS,
    ShardedDeviceRingSync,
    lane_rings_init,
    striped_lanes,
)
from d4pg_tpu_torch.runtime import megastep
from d4pg_tpu_torch.runtime import on_device as od
from d4pg_tpu_torch.runtime.checkpoint import load_state_into, state_dict_of
from d4pg_tpu_torch.utils import graphs

D, K, B, HIDDEN = 2, 4, 8, (16, 16)


def _snapshot(prog) -> tuple:
    return ([t.clone() for t in prog.state()], [g.get_state() for g in prog.generators])


def _restore(prog, snap) -> None:
    tensors, gens = snap
    with torch.no_grad():
        for t, v in zip(prog.state(), tensors):
            t.copy_(v)
    for g, st in zip(prog.generators, gens):
        g.set_state(st)


def _equal(a, b) -> bool:
    """Two outputs' tensors equal (a body's None is a program's ())."""
    la, lb = (pytree.tree_leaves(() if x is None else x) for x in (a, b))
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _program_equals_body(prog, calls: list) -> list:
    """One call of ``prog`` (its build; a learner's Adam makes its
    moments), then ``calls`` through ``prog`` and from the same snapshot
    through its body; every bound tensor, generator state and output
    equal. Returns the program's outputs."""
    prog(*calls[0])
    snap = _snapshot(prog)
    outs = [prog(*c) for c in calls]
    after = _snapshot(prog)
    _restore(prog, snap)
    body_outs = [prog.body(*c) for c in calls]
    again = _snapshot(prog)
    assert len(after[0]) == len(again[0]) > 0
    differ = [i for i, (a, b) in enumerate(zip(after[0], again[0])) if not torch.equal(a, b)]
    assert not differ, f"{prog.name}: bound tensors {differ} differ"
    assert all(torch.equal(a, b) for a, b in zip(after[1], again[1]))
    assert all(_equal(a, b) for a, b in zip(outs, body_outs)), f"{prog.name}: outputs differ"
    return outs


def _batch(rng, k: int) -> dict:
    lead = (B,) if k == 1 else (k, B)
    return {
        "obs": torch.from_numpy(rng.normal(size=lead + (3,)).astype(np.float32)),
        "action": torch.from_numpy(rng.uniform(-1, 1, lead + (1,)).astype(np.float32)),
        "reward": torch.from_numpy(rng.uniform(-1, 0, lead).astype(np.float32)),
        "next_obs": torch.from_numpy(rng.normal(size=lead + (3,)).astype(np.float32)),
        "discount": torch.from_numpy(np.full(lead, 0.97, np.float32)),
        "weights": torch.from_numpy(rng.uniform(0.2, 1.0, lead).astype(np.float32)),
    }


def _trainer(tmp_path, **kw):
    from d4pg_tpu_torch.runtime.trainer import Trainer

    base = dict(num_envs=2, batch_size=B, warmup_steps=64, total_steps=2 * K,
                eval_interval=1000, eval_episodes=1, checkpoint_interval=1000,
                replay_capacity=512, log_dir=str(tmp_path), prioritized=True,
                agent=D4PGConfig(hidden_sizes=HIDDEN), dp=D, steps_per_dispatch=K)
    base.update(kw)
    return Trainer(TrainConfig(**base), device="cpu")


# ------------------------------------------------------ host dispatches
HOST = {
    "dp_k1": dict(steps_per_dispatch=1),
    "dp_k4": dict(),
    "hogwild_k4": dict(dp_hogwild=True),
    "dp2_tp2": dict(tp=2),
}


@pytest.mark.parametrize("case", sorted(HOST))
def test_host_lane_program_equals_its_body(tmp_path, case):
    """The trainer's dispatch program of each host ``--dp`` mode over three
    batches; the combines counted per call (3 a grad step, and with tp one
    a tp index for each network's gradients)."""
    t = _trainer(tmp_path, **HOST[case])
    try:
        k = t.config.steps_per_dispatch
        prog = t._train_step_prog if k == 1 else t._fused_step_prog
        assert isinstance(prog.program, graphs.Program)
        rng = np.random.default_rng(3)
        calls = [(_batch(rng, k),) for _ in range(3)]
        sync = prog.syncs[0]
        before = sync.calls
        _program_equals_body(prog, calls)
        per_call = prog.combines[0]
        assert sync.calls - before == 4 * per_call + 3 * per_call  # 4 program calls, 3 bodies
        if case == "hogwild_k4":
            assert per_call == 1 + len(prog.program.body(calls[0][0])[0])
            replicas = t._dp_fused.replicas
            assert len(replicas) == D and replicas[0] is t.state
        elif case == "dp2_tp2":
            assert per_call == k * (2 * 2 + 1) and getattr(t.state, "tp", None) == 2
        else:
            assert per_call == 3 * k
        assert prog._cache_size() == 1
    finally:
        t.close()


def test_trainer_lanes_count_their_combines_per_dispatch(tmp_path):
    t = _trainer(tmp_path)
    try:
        t.train()
        assert t._dispatches == 2 and t._dp_fused.sync.calls == 2 * 3 * K
        assert t._fused_step_prog._cache_size() == 1
    finally:
        t.close()


def test_a_rebound_hogwild_replica_raises_and_a_reload_does_not(tmp_path):
    t = _trainer(tmp_path, dp_hogwild=True)
    try:
        prog = t._fused_step_prog
        rng = np.random.default_rng(4)
        prog(_batch(rng, K))
        saved = copy.deepcopy(state_dict_of(t.state))
        load_state_into(t.state, saved)
        t._dp_fused.reload()  # a resume's copy into the replicas
        prog(_batch(rng, K))
        assert all(torch.equal(a, b) for a, b in zip(
            megastep.learner_tensors(t._dp_fused.replicas[1]), megastep.learner_tensors(t.state)))
        replica = t._dp_fused.replicas[1]
        moments = replica.critic_opt.state[next(replica.critic.parameters())]
        moments["exp_avg"] = moments["exp_avg"].clone()  # a new tensor: rebound
        with pytest.raises(graphs.GraphBindingError, match="fused_step: state tensor"):
            prog(_batch(rng, K))
    finally:
        t.close()


def test_a_tp_restore_copies_into_the_bound_shards(tmp_path):
    """``TPTrainState.load_whole`` (a ``--resume`` of ``--dp 2 --tp 2``)
    restores into the tensors the program bound: its next call runs and
    equals the eager body from the restored state."""
    t = _trainer(tmp_path, tp=2)
    try:
        prog = t._fused_step_prog
        rng = np.random.default_rng(5)
        prog(_batch(rng, K))
        saved = copy.deepcopy(state_dict_of(t.state))
        prog(_batch(rng, K))
        load_state_into(t.state, saved)
        _program_equals_body(prog, [(_batch(rng, K),)])
    finally:
        t.close()


def test_auto_parallel_step_keeps_a_program_for_each_state():
    cfg = D4PGConfig(obs_dim=3, action_dim=1, hidden_sizes=HIDDEN)
    mesh = make_mesh(D, 2, device="cpu", num_processes=1, process_index=0)
    step = auto_parallel_train_step(cfg, mesh)
    whole = create_train_state(cfg, seed=1, device="cpu")
    a, b = step.shard(copy.deepcopy(whole)), step.shard(copy.deepcopy(whole))
    rng = np.random.default_rng(6)
    batch = _batch(rng, 1)
    _, ma, pa = step(a, batch)
    assert len(step.programs) == 1 and step.programs[0][0] is a and a.step == 1
    (_, prog), = step.programs
    _program_equals_body(prog, [(_batch(rng, 1),), (_batch(rng, 1),)])
    _, mb, pb = step(b, batch)
    assert len(step.programs) == 2 and step.programs[1][0] is b
    assert step.programs[1][1] is not prog
    assert torch.equal(pa, pb) and _equal(ma, mb)  # b from the same whole state
    assert all(p._cache_size() == 1 for _, p in step.programs)


# --------------------------------------------------- sharded megastep
@pytest.mark.parametrize("prioritized", [False, True], ids=["uniform", "per"])
def test_sharded_megastep_program_equals_its_body(tmp_path, prioritized):
    t = _trainer(tmp_path, replay_placement="device", prioritized=prioritized)
    try:
        t.warmup()
        t._ring_sync.flush(t._ring)
        prog = t._megastep_prog
        agent = t.config.agent

        def beta(i):
            return (dper.beta_tensor(i * K, agent.per_beta0, agent.per_beta_steps, "cpu"),) \
                if prioritized else ()

        outs = _program_equals_body(prog, [beta(i) for i in range(3)])
        assert all(torch.isfinite(v).all() for o in outs for v in o.values())
        assert prog.combines == [3 * K] and prog._cache_size() == 1
        t._ring[1].obs = t._ring[1].obs.clone()  # rebound: a replay would read the old one
        with pytest.raises(graphs.GraphBindingError, match="megastep: state tensor"):
            prog(*beta(3))
    finally:
        t.close()


# -------------------------------------------------------- the ingests
def _rows(n, seed):
    r = np.random.default_rng(seed)
    return (r.normal(size=(n, 3)).astype(np.float32), r.uniform(-1, 1, (n, 1)).astype(np.float32),
            r.uniform(-1, 0, n).astype(np.float32), r.normal(size=(n, 3)).astype(np.float32),
            np.full(n, 0.97, np.float32))


def test_sharded_ingests_mirror_the_striped_lanes_through_their_programs():
    """Partial chunks, chunks of both lanes, the wrap and a full resync,
    each chunk padded to ``chunk_local`` rows: after every flush each lane
    ring is the host buffer's striped lane and each subtree the seed of
    the same rows; one specialization each; each program equals its body
    on a fresh chunk."""
    cap, alpha = 64, 0.6
    mesh = make_mesh(D, device="cpu", num_processes=1, process_index=0)
    buf = ReplayBuffer(cap, 3, 1)
    sync = ShardedDeviceRingSync(buf, mesh, chunk_cap=16)
    per = dper.DevicePerSync(cap, alpha, mesh=mesh)
    sync.tree_hook = per.on_lane_chunk
    rings = lane_rings_init(cap, 3, 1, mesh)
    for seed, n in enumerate((5, 16, 3, 40, 200)):
        buf.add_batch(Transition(*_rows(n, seed)))
        sync.flush(rings)
        want = striped_lanes(buf, D, "cpu")
        for ring, lane in zip(rings, want):
            for f in FIELDS + ("size",):
                assert torch.equal(getattr(ring, f), getattr(lane, f)), f
        filled = min(buf.total_added, cap)
        for d, tree in enumerate(per.trees):
            rows = (filled - d + D - 1) // D
            pa = np.zeros(cap // D, np.float32)
            pa[:rows] = 1.0  # max_priority**α of a fresh tree
            assert torch.equal(tree.sums, dper.tree_from_priorities(pa, cap // D,
                                                                   device="cpu").sums)
    assert sync.chunk_local == 8
    assert sync.ingest_program._cache_size() == 1 and per.ingest_program._cache_size() == 1
    slots = torch.tensor([3, 0, 5, 8, 8, 8, 8, 8])  # 8 = the lane capacity: pads
    chunk = {f: getattr(rings[0], f)[:8].flip(0).clone() for f in FIELDS}
    chunk["slots"] = slots
    for lane in (1, 0):
        lane_t = torch.tensor(lane)
        size = torch.tensor(60, dtype=torch.int32)
        _program_equals_body(sync.ingest_program, [(chunk, lane_t, size)])
        _program_equals_body(per.ingest_program, [(slots, lane_t)])
    with pytest.raises(graphs.GraphBindingError, match="one set of lane rings"):
        buf.add_batch(Transition(*_rows(1, 9)))
        sync.flush(lane_rings_init(cap, 3, 1, mesh))


# ------------------------------------------------------ on-device lanes
@pytest.mark.parametrize("prioritized", [False, True], ids=["uniform", "per"])
def test_on_device_lane_programs_equal_the_eager_bodies(prioritized):
    """``LanesLoop``'s five programs against its eager bodies and against
    the eager mesh loop of ``make_on_device_trainer``, from one state and
    one seed: one warmup and two iterations, every carry tensor, generator
    state and metric equal."""
    cfg = D4PGConfig(obs_dim=3, action_dim=1, hidden_sizes=HIDDEN)
    env = make_env("pendulum")
    mesh = make_mesh(D, device="cpu", num_processes=1, process_index=0)
    kw = dict(num_envs=4, segment_len=8, replay_capacity=128, batch_size=B,
              train_steps_per_iter=K, prioritized=prioritized)
    st = create_train_state(cfg, 0, "cpu")
    loop = od.make_lanes_loop(cfg, env, mesh, **kw)
    runs = []
    for arm in ("programs", "bodies"):
        carry = loop.init(copy.deepcopy(st), 3)
        progs = loop.programs(carry) if arm == "programs" else None
        if progs:
            progs.warmup(3.0)
            metrics = [progs.iterate(1.0) for _ in range(2)]
        else:
            loop.warmup(carry, 3.0)
            metrics = [loop.iterate(carry, 1.0)[1] for _ in range(2)]
        runs.append((carry, metrics, progs))
    (pc, pm, progs), (bc, bm, _) = runs
    init, warm, it = od.make_on_device_trainer(cfg, env, device="cpu", mesh=mesh, **kw)
    ec, em = warm(init(copy.deepcopy(st), 3), 3.0), []
    for _ in range(2):  # the eager loop returns a new carry
        ec, m = it(ec, 1.0)
        em.append(m)
    assert pc.state.step == bc.state.step == ec.state.step == 2 * K
    assert all(torch.equal(a, b) for a, b in zip(od.carry_tensors(pc), od.carry_tensors(bc)))
    assert all(torch.equal(a, b) for a, b in zip(
        [g.get_state() for g in od.carry_generators(pc)],
        [g.get_state() for g in od.carry_generators(bc)]))
    assert all(_equal(a, b) for a, b in zip(pm, bm)) and all(_equal(a, b) for a, b in zip(pm, em))
    for a, b in zip(megastep.learner_tensors(pc.state), megastep.learner_tensors(ec.state)):
        assert torch.equal(a, b)
    for ra, rb in zip(pc.replay, ec.replay):
        assert all(torch.equal(getattr(ra, f), getattr(rb, f)) for f in od.RING_FIELDS)
    assert all(p._cache_size() == 1 for p in progs.all())
    assert loop.sync.calls == 2 * 2 * (3 * K + 1)  # both arms: 3 a grad step, 1 proxy
