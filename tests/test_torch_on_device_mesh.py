"""The port's on-device loop on dp lanes (``runtime/on_device.py`` with a
mesh, ``--on-device --dp D``) against the JAX package's loop under
``shard_map`` over a ``make_mesh(dp=2)`` of the virtual CPU devices.

One warmup and one train iteration of each package's loop at a small
width, uniform and PER, from one JAX ``create_train_state`` and the same
env states. Each lane's exploration noise and train draws are computed
here from the JAX carry's key, folded with the lane index as the JAX
``_fold_local`` folds it, and fed to the port's lane: the rollout's
noise through a per-lane ``noise_fns``, the draws through
``iterate_fn(draws=)``. The JAX side runs its fused Pallas loss in
interpret mode; the port runs its kernels' plain versions.

Tolerances (``test_torch_on_device``'s): ring rows atol 1e-5 and rtol
1e-5; priorities and ``max_priority`` rtol 1e-3; parameters atol 10·lr,
median lr/10; metrics rtol 1e-3. The lane sizes, write positions and
the draws are exact. The CLI run and the two gloo ranks are the port
against itself: ``replay_size`` is the lanes' sum, and two ranks are
``torch.equal`` to one process with the same lanes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d4pg_tpu.agent import D4PGConfig as JConfig
from d4pg_tpu.agent import create_train_state as j_create
from d4pg_tpu.envs.pendulum import Pendulum as JPendulum
from d4pg_tpu.models.critic import DistConfig as JDist
from d4pg_tpu.ops.noise import gaussian_noise_init as j_noise_init
from d4pg_tpu.parallel import make_mesh as j_make_mesh
from d4pg_tpu.runtime import on_device as jod
from d4pg_tpu_torch.agent import D4PGConfig, DistConfig, create_train_state
from d4pg_tpu_torch.agent.d4pg import make_noise
from d4pg_tpu_torch.envs import EnvState, Pendulum
from d4pg_tpu_torch.parallel.mesh import make_mesh
from d4pg_tpu_torch.runtime import on_device as od
from d4pg_tpu_torch.tools import dp_ranks
from d4pg_tpu_torch.weights import load_jax_params

D, N_ENVS, SEG, CAP, K, B, LR = 2, 4, 8, 128, 3, 8, 1e-4
N_LANE, CAP_LANE, B_LANE = N_ENVS // D, CAP // D, B // D
HIDDEN = (16, 16)
RANKS_TIMEOUT_S = 120.0


def _configs():
    common = dict(obs_dim=3, action_dim=1, hidden_sizes=HIDDEN, tau=0.05, n_step=3,
                  lr_actor=LR, lr_critic=LR)
    jcfg = JConfig(dist=JDist(num_atoms=11, v_min=-50.0, v_max=0.0),
                   projection_backend="pallas_fused", **common)
    tcfg = D4PGConfig(dist=DistConfig(num_atoms=11, v_min=-50.0, v_max=0.0),
                      projection_backend="fused", **common)
    return jcfg, tcfg


def _lane_noise(k_roll, cfg, lane):
    """Lane ``lane``'s rollout noise: the JAX collector's draws from
    ``fold_in(k_roll, lane)`` over its N/D envs (``envs/rollouts.py``)."""
    base = j_noise_init(cfg.noise_epsilon)
    k = jax.random.fold_in(k_roll, lane)

    def env_noise(key):
        key, _ = jax.random.split(key)
        act = jax.vmap(lambda s: jax.random.split(s)[0])(jax.random.split(key, SEG))
        return jax.vmap(lambda a: base.epsilon * cfg.noise_sigma * jax.random.normal(a, (1,)))(act)

    return np.asarray(jax.vmap(env_noise)(jax.random.split(k, N_LANE)))  # [N/D, T, A]


def _fed_noise(blocks):
    """Noise functions that hand out ``blocks`` ([N/D, T, A] each) step by step."""
    steps = [torch.tensor(b[:, t]) for b in blocks for t in range(b.shape[1])]
    init, _, reset = make_noise(D4PGConfig(), (N_LANE,))

    def sample(state, generator, shape):
        return steps.pop(0), state

    return init, sample, reset


def _lane_rows(x, lane, n):
    return np.asarray(x)[lane * n:(lane + 1) * n]


@pytest.fixture(scope="module", params=[False, True], ids=["uniform", "per"])
def mesh_pair(request):
    prioritized = request.param
    jcfg, tcfg = _configs()
    jcfg = dataclasses.replace(jcfg, prioritized=prioritized)
    init_fn, warmup_fn, iterate_fn = jod.make_on_device_trainer(
        jcfg, JPendulum(), num_envs=N_ENVS, segment_len=SEG, replay_capacity=CAP,
        batch_size=B, train_steps_per_iter=K, mesh=j_make_mesh(dp=D))
    jst = j_create(jcfg, jax.random.PRNGKey(1))
    carry = init_fn(jst, jax.random.PRNGKey(2))
    init_params = [jax.device_get(p) for p in (jst.actor_params, jst.critic_params)]
    env_states, obs = carry[1], carry[2]
    _, k_roll_w = jax.random.split(carry[5])
    carry = warmup_fn(carry, 3.0)
    _, k_roll_i, k_train = jax.random.split(carry[5], 3)
    draws = []
    for lane in range(D):
        k = jax.random.fold_in(k_train, lane)
        if prioritized:
            draws.append(torch.from_numpy(np.array(jax.random.uniform(k, (K, B_LANE)))))
        else:  # after the iterate's own segment landed in the lane's ring
            size = 2 * N_LANE * SEG
            draws.append(torch.from_numpy(
                np.array(jax.random.randint(k, (K, B_LANE), 0, size)).astype(np.int64)))
    carry, jm = iterate_fn(carry, 1.0)
    noise = [_fed_noise([_lane_noise(k_roll_w, jcfg, lane), _lane_noise(k_roll_i, jcfg, lane)])
             for lane in range(D)]

    mesh = make_mesh(D, device="cpu", num_processes=1, process_index=0)
    t_init, t_warm, t_iter = od.make_on_device_trainer(
        tcfg, Pendulum(), num_envs=N_ENVS, segment_len=SEG, replay_capacity=CAP,
        batch_size=B, train_steps_per_iter=K, prioritized=prioritized, device="cpu",
        mesh=mesh, noise_fns=noise)
    tst = create_train_state(tcfg, device="cpu")
    load_jax_params(tst, *init_params)
    tc = t_init(tst, 0)
    tc_env = [EnvState(torch.tensor(_lane_rows(env_states.physics, j, N_LANE)),
                       torch.tensor(_lane_rows(env_states.t, j, N_LANE))) for j in range(D)]
    tc_obs = [torch.tensor(_lane_rows(obs, j, N_LANE)) for j in range(D)]
    tc = tc._replace(env_states=[EnvState(e.physics.clone(), e.t.clone()) for e in tc_env],
                     obs=[o.clone() for o in tc_obs])
    tc = t_warm(tc, 3.0)
    tc, tm = t_iter(tc, 1.0, draws=draws)
    # the same through the lanes' compiled programs (LanesLoop), the same
    # noise and draws fed in (the draw program's body given them)
    noise = [_fed_noise([_lane_noise(k_roll_w, jcfg, lane), _lane_noise(k_roll_i, jcfg, lane)])
             for lane in range(D)]
    loop = od.make_lanes_loop(tcfg, Pendulum(), mesh, num_envs=N_ENVS, segment_len=SEG,
                              replay_capacity=CAP, batch_size=B, train_steps_per_iter=K,
                              prioritized=prioritized, noise_fns=noise)
    pst = create_train_state(tcfg, device="cpu")
    load_jax_params(pst, *init_params)
    pc = loop.init(pst, 0)
    for j in range(D):
        pc.env_states[j].physics.copy_(tc_env[j].physics)
        pc.env_states[j].t.copy_(tc_env[j].t)
        pc.obs[j].copy_(tc_obs[j])
    progs = loop.programs(pc)
    progs.train_draw.body = lambda *beta: loop.draw(pc, *beta, draws=draws)
    progs.warmup(3.0)
    pm = progs.iterate(1.0)
    return (carry, {k: float(v) for k, v in jm.items()}, tc, {k: float(v) for k, v in tm.items()},
            (pc, pm, progs))


def test_lanes_fill_the_same_ring_shards(mesh_pair):
    jc, _, tc, _, _ = mesh_pair
    jr = jc[4]
    assert len(tc.replay) == D
    for lane, tr in enumerate(tc.replay):
        assert (tr.size, tr.pos) == (int(jr.size), int(jr.pos)) == (2 * N_LANE * SEG,) * 2
        for k in ("obs", "action", "reward", "next_obs", "discount"):
            np.testing.assert_allclose(getattr(tr, k).numpy(),
                                       _lane_rows(getattr(jr, k), lane, CAP_LANE),
                                       atol=1e-5, rtol=1e-5, err_msg=f"{k} lane {lane}")
        np.testing.assert_allclose(tc.obs[lane].numpy(), _lane_rows(jc[2], lane, N_LANE),
                                   atol=1e-5)
        np.testing.assert_array_equal(tc.env_states[lane].t.numpy(),
                                      _lane_rows(jc[1].t, lane, N_LANE))


def test_lanes_train_to_the_same_state(mesh_pair):
    jc, jm, tc, tm, _ = mesh_pair
    jst, tst = jc[0], tc.state
    assert tst.step == int(jst.step) == K
    for module, tree in ((tst.actor, jst.actor_params), (tst.critic, jst.critic_params),
                         (tst.target_actor, jst.target_actor_params),
                         (tst.target_critic, jst.target_critic_params)):
        layers = jax.device_get(tree)["params"]
        for name, prm in module.named_parameters():
            layer, kind = name.split(".")
            leaf = np.asarray(layers[layer]["kernel" if kind == "weight" else "bias"])
            diff = np.abs(prm.detach().numpy() - (leaf.T if kind == "weight" else leaf))
            assert diff.max() <= 10 * LR and np.median(diff) <= LR / 10, name
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-3, atol=1e-6, err_msg=k)
    for lane, tr in enumerate(tc.replay):
        np.testing.assert_allclose(tr.priority.numpy(),
                                   _lane_rows(jc[4].priority, lane, CAP_LANE), rtol=1e-3)
        # the replicated scalar: the exact max over the lanes
        np.testing.assert_allclose(float(tr.max_priority), float(jc[4].max_priority),
                                   rtol=1e-3)
    assert len({float(tr.max_priority) for tr in tc.replay}) == 1


def test_lane_programs_equal_the_eager_lanes_and_the_reference(mesh_pair):
    """The lanes' five compiled programs (``LanesLoop``, one warmup and one
    iteration, the JAX noise and draws fed in) give the eager mesh loop's
    bits, so the reference tolerances above hold for them too."""
    jc, jm, tc, tm, (pc, pm, progs) = mesh_pair
    assert pc.state.step == tc.state.step == K
    from d4pg_tpu_torch.runtime import megastep

    for a, b in zip(megastep.learner_tensors(pc.state), megastep.learner_tensors(tc.state)):
        assert torch.equal(a, b)
    for lane in range(D):
        for f in od.RING_FIELDS:
            assert torch.equal(getattr(pc.replay[lane], f), getattr(tc.replay[lane], f)), f
        assert torch.equal(pc.obs[lane], tc.obs[lane])
    assert {k: float(v) for k, v in pm.items()} == tm
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), jm[k], rtol=1e-3, atol=1e-6, err_msg=k)
    assert all(p._cache_size() == 1 for p in progs.all())


def test_lane_generators_differ_and_are_seeded_by_lane():
    _, tcfg = _configs()
    mesh = make_mesh(D, device="cpu", num_processes=1, process_index=0)
    init_fn, warm, _ = od.make_on_device_trainer(
        tcfg, Pendulum(), num_envs=N_ENVS, segment_len=SEG, replay_capacity=CAP,
        batch_size=B, train_steps_per_iter=K, device="cpu", mesh=mesh)
    a, b = (warm(init_fn(create_train_state(tcfg, device="cpu"), 7), 3.0) for _ in range(2))
    for lane in range(D):  # seeded from (seed, stream, lane): the same twice
        assert torch.equal(a.replay[lane].obs, b.replay[lane].obs)
    assert not torch.equal(a.replay[0].obs, a.replay[1].obs)  # each lane its own stream
    assert not torch.equal(a.obs[0], a.obs[1])


def test_cli_runs_on_device_on_two_lanes(tmp_path):
    from d4pg_tpu_torch.train import main

    final = main(["--device", "cpu", "--on-device", "--env", "pendulum", "--dp", "2",
                  "--hidden-sizes", "16,16", "--num-envs", "2", "--bsize", "16",
                  "--warmup", "64", "--rmsize", "4096", "--total-steps", "128",
                  "--eval-interval", "64", "--eval-episodes", "1", "--tp", "2",
                  "--log-dir", str(tmp_path)])
    # one iteration = 2 envs x 32 steps = 64 grad steps; the warmup's 64
    # rows and two iterations' 128, over both lanes
    assert final["replay_size"] == 192 and final["env_steps"] == 192
    assert np.isfinite(final["critic_loss"])
    assert (tmp_path / "checkpoints" / "128").is_dir()


def test_two_gloo_ranks_equal_one_process_with_the_same_lanes():
    """``--on-device --dp 2`` as two spawned gloo ranks, one lane each,
    against one process with both lanes: the state, each lane's ring and
    the metrics torch.equal."""
    _, tcfg = _configs()
    kw = dict(agent_cfg=tcfg, env_name="pendulum", num_envs=N_ENVS, capacity=CAP * 2,
              batch=B, k=K, iterations=2)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as each rank runs: CPU GEMM bits depend on the split
    try:
        one = dp_ranks.run_on_device_lanes(
            make_mesh(D, device="cpu", num_processes=1, process_index=0), **kw)
    finally:
        torch.set_num_threads(threads)
    ranks = dp_ranks.spawn_ranks(2, D, "cpu", timeout_s=RANKS_TIMEOUT_S, leg="on_device", **kw)
    assert dp_ranks.compare_leg(one, ranks) == dict(state=True, step=True, metrics=True,
                                                    rings=True)
    # a lane ring of CAP rows took 3 segments of N/D envs x 32 steps: it wrapped
    assert one["step"] == 2 * K and one["sizes"] == [min(3 * N_LANE * 32, CAP)] * D
