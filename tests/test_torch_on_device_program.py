"""The ``--on-device`` iteration and its evaluator as compiled programs
(``runtime/on_device.py:OnDevicePrograms``, ``runtime/evaluator.py:
GreedyEval``) on the CPU, where each program runs its body eagerly on its
static buffers: the bindings a CUDA graph depends on (inputs copied in,
state read by address, in-place updates) hold here too.

- Several iterations through the programs ``torch.equal`` to the eager
  bodies from the same carry, on Pendulum and HalfCheetah, uniform and
  PER: every tensor of the carry (learner and Adam, envs, ring, scratch),
  the generators and the metrics.
- The ring's ``pos`` wraps past its capacity on the device, and the run's
  host mirrors agree with it.
- A warmup at noise 3.0, then iterations at other scales, hold one
  specialization a program, and read each scale (the eager bodies at the
  same scales agree).
- β read across ``per_beta_steps`` is the JAX iterate's
  ``linear_schedule(state.step)`` in float32 at every iteration, and the
  IS weights its arithmetic's (``test_torch_on_device``'s, on the same
  draws); a β bound when the program is built stays at β0.
- The compiled evaluator equals the eager ``evaluate``.
- A restore in place, then an iteration, equals the uninterrupted run; a
  ``--resume`` leg builds its programs after the restore.
- A rebound ring tensor raises ``GraphBindingError``.

Tolerances: a program against its own body, exact; β exact against the
JAX float32 arithmetic; the weights rtol 1e-5 (``test_torch_on_device``'s).
"""

from __future__ import annotations

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d4pg_tpu.agent import D4PGConfig as JConfig
from d4pg_tpu.models.critic import DistConfig as JDist
from d4pg_tpu_torch.agent import D4PGConfig, DistConfig, create_train_state
from d4pg_tpu_torch.config import TrainConfig
from d4pg_tpu_torch.envs import make_env
from d4pg_tpu_torch.runtime import on_device as od
from d4pg_tpu_torch.runtime.checkpoint import load_state_into, state_dict_of
from d4pg_tpu_torch.runtime.evaluator import GreedyEval, evaluate
from d4pg_tpu_torch.utils import graphs
from tests import test_torch_on_device as tod

N_ENVS, SEG, K, B = 2, 32, 12, 8   # K = 12: two train_block calls of 6
CAP = 2 * N_ENVS * SEG             # two segments: the third wraps


def _config(env, prioritized_beta_steps=100_000):
    return D4PGConfig(obs_dim=env.observation_dim, action_dim=env.action_dim,
                      hidden_sizes=(16, 16), n_step=3, tau=0.05,
                      dist=DistConfig(num_atoms=11, v_min=-50.0, v_max=50.0),
                      per_beta_steps=prioritized_beta_steps)


def _loop(env_name, prioritized=True, beta_steps=100_000, k=K):
    env = make_env(env_name, max_episode_steps=50)
    cfg = _config(env, beta_steps)
    loop = od.make_on_device_loop(cfg, env, num_envs=N_ENVS, segment_len=SEG,
                                  replay_capacity=CAP, batch_size=B, train_steps_per_iter=k,
                                  prioritized=prioritized, device="cpu")
    return loop, loop.init(create_train_state(cfg, 1, "cpu"), 2)


def _bits(carry):
    return ([t.clone() for t in od.carry_tensors(carry)],
            [g.get_state() for g in od.carry_generators(carry)], carry.state.step)


def _assert_equal(a, b):
    (ta, ga, sa), (tb, gb, sb) = a, b
    assert len(ta) == len(tb)
    differ = [i for i, (x, y) in enumerate(zip(ta, tb)) if not torch.equal(x, y)]
    assert not differ, differ
    assert all(torch.equal(x, y) for x, y in zip(ga, gb)) and sa == sb


def _metrics_equal(ma, mb):
    return set(ma) == set(mb) and all(torch.equal(ma[k], mb[k]) for k in ma)


@pytest.mark.parametrize("env_name,prioritized", [("pendulum", True), ("pendulum", False),
                                                  ("halfcheetah", True)],
                         ids=["pendulum_per", "pendulum_uniform", "halfcheetah_per"])
def test_program_iterations_equal_the_eager_bodies(env_name, prioritized):
    """A warmup segment and three iterations: through the programs, and
    through the eager bodies from the same carry."""
    loop_a, carry_a = _loop(env_name, prioritized)
    loop_b, carry_b = _loop(env_name, prioritized)
    _assert_equal(_bits(carry_a), _bits(carry_b))
    progs = loop_a.programs(carry_a)
    progs.warmup(3.0)
    loop_b.warmup(carry_b, 3.0)
    for scale in (1.0, 0.7, 0.4):
        ma = progs.iterate(scale)
        _, mb = loop_b.iterate(carry_b, scale)
        assert _metrics_equal(ma, mb)
        _assert_equal(_bits(carry_a), _bits(carry_b))
    assert carry_a.state.step == 3 * K
    assert all(p._cache_size() == 1 for p in progs.all())
    assert all(np.isfinite(float(v)) for v in ma.values())


def test_stepwise_collection_equals_the_rollout():
    """``SegmentCollector.step`` over a segment, in place, gives the
    trajectory, the n-step rows and the final states of one ``rollout``."""
    loop, carry = _loop("pendulum")
    col = loop.collector
    gen = torch.Generator().manual_seed(5)
    start = (copy.deepcopy(carry.env_states), carry.obs.clone(), copy.deepcopy(carry.noise_states))
    env_states, obs, noise, flat, traj = col(carry.state.actor, *start, gen, 1.0)
    gen.manual_seed(5)
    scale = loop.scale_tensor(1.0)
    for t in loop.steps:
        col.step(carry.state.actor, carry.env_states, carry.obs, carry.noise_states, gen, scale,
                 carry.buffers.traj, t)
    for x, y in zip(traj, carry.buffers.traj):
        assert torch.equal(x, y)
    got = col.collapse(carry.buffers.traj)
    assert all(torch.equal(flat[k], got[k]) for k in flat)
    assert torch.equal(obs, carry.obs) and torch.equal(env_states.physics,
                                                       carry.env_states.physics)
    assert torch.equal(noise.epsilon, carry.noise_states.epsilon)


def test_ring_pos_wraps_past_capacity_and_the_mirrors_follow(tmp_path):
    cfg = TrainConfig(env="pendulum", num_envs=N_ENVS, batch_size=B, warmup_steps=1,
                      replay_capacity=CAP, total_steps=2 * 64, eval_interval=10**6,
                      eval_episodes=1, max_episode_steps=50,
                      agent=D4PGConfig(hidden_sizes=(16, 16)), log_dir=str(tmp_path))
    run = od.OnDeviceRun(cfg, device="cpu")
    ring = run.carry.replay
    seen = []
    for _ in range(3):  # 64 rows a segment into 128: the third wraps to slot 0
        run.segment(3.0)
        seen.append((int(ring.pos), int(ring.size), run.ring_pos, run.ring_size))
    assert seen == [(64, 64, 64, 64), (0, 128, 0, 128), (64, 128, 64, 128)]
    first = run.carry.buffers.traj.obs.reshape(-1, 3)  # the third segment's rows
    assert torch.equal(ring.obs[:64], first) and run.replay_size() == CAP
    run.iteration(1.0)
    assert (int(ring.pos), int(ring.size)) == (run.ring_pos, run.ring_size) == (0, CAP)
    assert run.rows_appended == 4 * 64


def test_warmup_at_three_then_other_scales_hold_one_specialization():
    loop_a, carry_a = _loop("pendulum")
    loop_b, carry_b = _loop("pendulum")
    progs = loop_a.programs(carry_a)
    progs.warmup(3.0)
    loop_b.warmup(carry_b, 3.0)
    actions_at_3 = carry_a.buffers.traj.action.clone()
    for scale in (1.0, 0.0):
        progs.iterate(scale)
        loop_b.iterate(carry_b, scale)
        _assert_equal(_bits(carry_a), _bits(carry_b))
    assert {p.name: p._cache_size() for p in progs.all()} == dict.fromkeys(
        ["collect_step", "ring_append", "train_draw", "train_block", "train_finish"], 1)
    # a segment at scale 0 takes the greedy actor's actions, so the scale
    # was read, not the warmup's 3.0
    progs.warmup(0.0)
    traj = carry_a.buffers.traj
    with torch.no_grad():  # step by step: the collection's row blocks
        greedy = torch.stack([carry_a.state.actor(traj.obs[:, t]) for t in range(SEG)], 1)
    assert torch.equal(traj.action, greedy.clamp(-1.0, 1.0))
    assert not torch.equal(actions_at_3, traj.action)


def _j_config(tcfg):
    return JConfig(obs_dim=tcfg.obs_dim, action_dim=tcfg.action_dim,
                   hidden_sizes=tuple(tcfg.hidden_sizes),
                   dist=JDist(num_atoms=tcfg.dist.num_atoms, v_min=tcfg.dist.v_min,
                              v_max=tcfg.dist.v_max),
                   per_beta0=tcfg.per_beta0, per_beta_steps=tcfg.per_beta_steps)


def _jax_beta(cfg, step):
    """The JAX iterate's β at ``state.step`` (``runtime/on_device.py``),
    float32."""
    frac = jnp.clip(jnp.int32(step).astype(jnp.float32) / max(cfg.per_beta_steps, 1), 0.0, 1.0)
    return float(cfg.per_beta0 + frac * (1.0 - cfg.per_beta0))


def test_beta_read_across_per_beta_steps_matches_the_jax_iterate(monkeypatch):
    """Five iterations of K = 12 with per_beta_steps 30: β where the draw
    weighs its rows is the JAX iterate's at every iteration's start step
    (0.4, 0.64, 0.88, then 1), and the weights its arithmetic's on the
    same priorities and uniform numbers. The same read off a program
    whose β was bound at build stays 0.4."""
    seen = []
    real = od.per_draw

    def recording(config, priority, size, u, step=0, beta=None):
        idx, w = real(config, priority, size, u, step, beta)
        seen.append((float(beta), priority.clone(), int(size), u.clone(), idx, w))
        return idx, w

    monkeypatch.setattr(od, "per_draw", recording)
    loop, carry = _loop("pendulum", beta_steps=30)
    progs = loop.programs(carry)
    progs.warmup(3.0)
    for _ in range(5):
        progs.iterate(1.0)
    jcfg = _j_config(loop.config)
    assert len(seen) == 5 and [s[0] for s in seen] == pytest.approx([0.4, 0.64, 0.88, 1.0, 1.0])
    for i, (beta, prio, size, u, idx, w) in enumerate(seen):
        assert beta == _jax_beta(jcfg, i * K)
        jidx, jw = tod._jax_per(jcfg, jnp.asarray(prio.numpy()), size, jnp.asarray(u.numpy()),
                                i * K)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-5)

    # the mutation the input exists to prevent: β bound at build
    seen.clear()
    loop, carry = _loop("pendulum", beta_steps=30)
    progs = loop.programs(carry)
    body, build_beta = progs.train_draw.body, loop.beta(0)
    progs.train_draw.body = lambda beta: body(build_beta)
    progs.warmup(3.0)
    for _ in range(3):
        progs.iterate(1.0)
    assert [s[0] for s in seen] == pytest.approx([0.4] * 3)


@pytest.mark.parametrize("env_name", ["pendulum", "halfcheetah"])
def test_compiled_eval_equals_eager_evaluate(env_name):
    loop, carry = _loop(env_name)
    loop.warmup(carry, 3.0)
    loop.iterate(carry, 1.0)  # a trained actor
    actor, env = carry.state.actor, loop.env
    want = evaluate(loop.config, env, actor, torch.Generator().manual_seed(9), 3, max_steps=40)
    gen = torch.Generator()
    ev = GreedyEval(loop.config, env, actor, gen, 3, max_steps=40, compiled=True)
    eager = GreedyEval(loop.config, env, actor, torch.Generator().manual_seed(9), 3,
                       max_steps=40)
    eager.run()
    for _ in range(2):
        gen.manual_seed(9)
        assert ev.run() == want
        assert torch.equal(ev.returns, eager.returns)
    assert ev.reset._cache_size() == ev.step._cache_size() == 1


def test_a_restore_in_place_then_an_iteration_equals_the_uninterrupted_run():
    """Two carries from one seed: one saves after its first iteration and
    iterates on; the other iterates once more, restores the save IN PLACE
    (the learner state and Adam by ``load_state_into``, the envs, ring and
    scratch by ``copy_``, the generators, the host step) and iterates on.
    The programs' bindings hold and the bits agree."""
    runs = []
    for detour in (0, 1):
        loop, carry = _loop("pendulum")
        progs = loop.programs(carry)
        progs.warmup(3.0)
        progs.iterate(1.0)
        saved = (copy.deepcopy(state_dict_of(carry.state)), _bits(carry))
        for _ in range(detour):
            progs.iterate(0.5)
        if detour:
            sd, (tensors, gens, step) = saved
            load_state_into(carry.state, sd)
            with torch.no_grad():
                for t, v in zip(od.carry_tensors(carry), tensors):
                    t.copy_(v)
            for g, st in zip(od.carry_generators(carry), gens):
                g.set_state(st)
            carry.state.step = step
        metrics = progs.iterate(1.0)
        runs.append((_bits(carry), metrics))
    (a, ma), (b, mb) = runs
    _assert_equal(a, b)
    assert _metrics_equal(ma, mb)


def test_a_resumed_run_builds_its_programs_after_the_restore(tmp_path):
    cfg = TrainConfig(env="pendulum", num_envs=N_ENVS, batch_size=B, warmup_steps=64,
                      replay_capacity=4096, total_steps=64, eval_interval=64, eval_episodes=1,
                      checkpoint_interval=64, agent=D4PGConfig(hidden_sizes=(16, 16)),
                      log_dir=str(tmp_path))
    first = od.OnDeviceRun(cfg, device="cpu")
    first.run()
    want = state_dict_of(first.carry.state)
    resumed = od.OnDeviceRun(TrainConfig(**{**cfg.__dict__, "resume": True}), device="cpu")
    got = state_dict_of(resumed.carry.state)
    for key in ("actor", "critic", "target_actor", "target_critic"):
        assert all(torch.equal(want[key][n], got[key][n]) for n in want[key]), key
    assert resumed.grad_steps == 64
    row = resumed.run()
    assert resumed.grad_steps == 128 and np.isfinite(row["critic_loss"])
    assert all(p._cache_size() == 1 for p in resumed.programs.all())


@pytest.mark.parametrize("field", ["priority", "pos", "obs"])
def test_a_rebound_ring_tensor_raises(field):
    loop, carry = _loop("pendulum")
    progs = loop.programs(carry)
    progs.warmup(3.0)
    progs.iterate(1.0)
    setattr(carry.replay, field, getattr(carry.replay, field).clone())
    with pytest.raises(graphs.GraphBindingError, match="rebound"):
        progs.iterate(1.0)


@pytest.mark.parametrize("n", [7, 1024, 1025, 5000, 99_840, 2**20])
def test_ordered_cumsum_is_a_cumsum_in_a_fixed_order(n):
    """The card's PER draw scans the priorities in two levels of rows (a
    1-D ``torch.cumsum`` there is CUB's scan, whose float order varies
    from call to call): the same bits on every call, within float32
    rounding of a float64 cumsum, and the same draws as the plain one on
    these inputs away from a boundary."""
    g = torch.Generator().manual_seed(n)
    x = torch.rand(n, generator=g) * (torch.rand(n, generator=g) > 0.3)
    got = od.ordered_cumsum(x)
    assert got.shape == x.shape and torch.equal(got, od.ordered_cumsum(x.clone()))
    want = torch.cumsum(x.double(), 0)
    assert float((got.double() - want).abs().max()) <= 1e-6 * float(want[-1])
    u = torch.rand(256, generator=g) * float(want[-1])
    # a boundary within the float32 rounding of either sum may fall either way
    tol = 2e-6 * float(want[-1])
    near = (want[torch.searchsorted(want, u.double()).clamp(max=n - 1)] - u).abs() < tol
    near |= (want[(torch.searchsorted(want, u.double()) - 1).clamp(min=0)] - u).abs() < tol
    idx = torch.searchsorted(got, u)
    assert torch.equal(idx[~near], torch.searchsorted(want, u.double())[~near])


def test_a_capture_holds_off_garbage_collection():
    """A capture runs after a full collection with the collector off, so
    no unreachable graph is destroyed on the capturing thread."""
    import gc

    assert gc.isenabled()
    with graphs._no_collection():
        assert not gc.isenabled()
    assert gc.isenabled()
