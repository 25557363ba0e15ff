"""The port's batched Pendulum, goal point mass, rollouts and n-step
collapse against the JAX package, on the CPU.

Tolerances: atol 1e-5 on a Pendulum step (the same float32 formulas; sin,
cos and the remainder may differ in the last ulp between the two
libraries) and 1e-5 on n-step returns (sums of three float32 terms); 1e-6 on a
point-mass step (products and clips of float32 values), its sparse reward
and termination exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d4pg_tpu.envs.api import EnvState as JEnvState
from d4pg_tpu.envs.pendulum import Pendulum as JPendulum
from d4pg_tpu.envs.pointmass_goal import PointMassGoal as JPointMassGoal
from d4pg_tpu.ops.nstep import nstep_returns as j_nstep
from d4pg_tpu_torch.agent import D4PGConfig, make_noise
from d4pg_tpu_torch.envs import EnvState, Pendulum, PointMassGoal, make_env
from d4pg_tpu_torch.envs.rollouts import Trajectory, rollout
from d4pg_tpu_torch.runtime.collect import collapse_nstep, make_segment_collector


def test_pendulum_step_matches_reference():
    rng = np.random.default_rng(0)
    N = 64
    physics = np.stack([rng.uniform(-6, 6, N), rng.uniform(-10, 10, N)], -1).astype(np.float32)
    t = rng.integers(190, 200, size=N).astype(np.int32)   # some steps truncate
    action = rng.uniform(-1.5, 1.5, size=(N, 1)).astype(np.float32)  # some clip
    jenv, tenv = JPendulum(), Pendulum()

    def jstep(ph, tt, a):
        return jenv.step(JEnvState(physics=ph, t=tt, key=jax.random.PRNGKey(0)), a)

    js, jo, jr, jterm, jtrunc = jax.vmap(jstep)(jnp.asarray(physics), jnp.asarray(t), jnp.asarray(action))
    ts, to, tr, tterm, ttrunc = tenv.step(
        EnvState(torch.from_numpy(physics), torch.from_numpy(t)), torch.from_numpy(action)
    )
    np.testing.assert_allclose(ts.physics.numpy(), np.asarray(js.physics), atol=1e-5)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-4, rtol=1e-6)
    np.testing.assert_array_equal(ts.t.numpy(), np.asarray(js.t))
    np.testing.assert_array_equal(ttrunc.numpy(), np.asarray(jtrunc))
    np.testing.assert_array_equal(tterm.numpy(), np.asarray(jterm))
    assert ttrunc.sum() > 0


def test_pendulum_reset_distribution_and_obs():
    env = Pendulum()
    state, obs = env.reset(4096, torch.Generator().manual_seed(0))
    th, thd = state.physics[:, 0], state.physics[:, 1]
    assert th.abs().max() <= np.pi and thd.abs().max() <= 1.0
    assert th.min() < -3.0 and th.max() > 3.0 and thd.min() < -0.95 and thd.max() > 0.95
    torch.testing.assert_close(obs, torch.stack([th.cos(), th.sin(), thd], -1))
    assert (state.t == 0).all() and obs.shape == (4096, 3)
    # the same statistics as the reference's reset
    keys = jax.random.split(jax.random.PRNGKey(0), 4096)
    jphys = np.asarray(jax.vmap(JPendulum().reset)(keys)[0].physics)
    np.testing.assert_allclose(state.physics.numpy().mean(0), jphys.mean(0), atol=0.15)
    np.testing.assert_allclose(state.physics.numpy().std(0), jphys.std(0), atol=0.1)


def test_make_env_refuses_unported_envs():
    """A gym id waits for the host env adapters (ROADMAP A5 (d));
    ``pixel_pendulum`` is ported (A10 (c))."""
    assert isinstance(make_env("pendulum"), Pendulum)
    assert make_env("pixel_pendulum").pixel_shape == (48, 48, 2)
    with pytest.raises(NotImplementedError, match=r"A5 \(d\)"):
        make_env("Pendulum-v1")


def test_pointmass_goal_step_matches_reference():
    rng = np.random.default_rng(3)
    N = 64
    pos = rng.uniform(-1, 1, (N, 2))
    goal = pos + rng.normal(0, 0.1, (N, 2))  # some rows reach the goal
    goal[::4] = rng.uniform(-1, 1, (N // 4, 2))
    physics = np.concatenate([pos, rng.uniform(-2.5, 2.5, (N, 2)), goal], -1).astype(np.float32)
    t = rng.integers(45, 50, size=N).astype(np.int32)   # some steps truncate
    action = rng.uniform(-1.5, 1.5, size=(N, 2)).astype(np.float32)  # some clip
    jenv, tenv = JPointMassGoal(), PointMassGoal()

    def jstep(ph, tt, a):
        return jenv.step(JEnvState(physics=ph, t=tt, key=jax.random.PRNGKey(0)), a)

    js, jo, jr, jterm, jtrunc = jax.vmap(jstep)(jnp.asarray(physics), jnp.asarray(t), jnp.asarray(action))
    ts, to, tr, tterm, ttrunc = tenv.step(
        EnvState(torch.from_numpy(physics), torch.from_numpy(t)), torch.from_numpy(action)
    )
    np.testing.assert_allclose(ts.physics.numpy(), np.asarray(js.physics), atol=1e-6)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tterm.numpy(), np.asarray(jterm))
    np.testing.assert_array_equal(ttrunc.numpy(), np.asarray(jtrunc))
    assert 0 < tterm.sum() < N and ttrunc.sum() > 0
    gobs = tenv.goal_obs(ts)
    jg = jax.vmap(lambda ph: jenv.goal_obs(JEnvState(physics=ph, t=0, key=None)))(js.physics)
    for a, b in zip(gobs, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    np.testing.assert_array_equal(
        tenv.compute_reward(gobs.achieved_goal, gobs.desired_goal).numpy(),
        np.asarray(jenv.compute_reward(jg.achieved_goal, jg.desired_goal)),
    )


def test_pointmass_goal_reset_and_reset_where():
    env = PointMassGoal()
    gen = torch.Generator().manual_seed(0)
    state, obs = env.reset(4096, gen)
    assert obs.shape == (4096, 6) and env.flat_obs_dim == 6
    torch.testing.assert_close(obs, state.physics)
    assert (state.physics[:, 2:4] == 0).all() and state.physics.abs().max() <= 1.0
    keys = jax.random.split(jax.random.PRNGKey(0), 4096)
    jphys = np.asarray(jax.vmap(JPointMassGoal().reset)(keys)[0].physics)
    np.testing.assert_allclose(state.physics.numpy().mean(0), jphys.mean(0), atol=0.05)
    np.testing.assert_allclose(state.physics.numpy().std(0), jphys.std(0), atol=0.05)
    done = torch.zeros(4096)
    done[:2] = 1.0
    s2, o2 = env.reset_where(EnvState(state.physics, state.t + 5), obs, done, gen)
    assert s2.t[:2].tolist() == [0, 0] and (s2.t[2:] == 5).all()
    torch.testing.assert_close(o2[2:], obs[2:])
    assert make_env("pointmass_goal").reports_success


def test_rollout_auto_resets_and_threads_noise_state():
    env = Pendulum()
    env.max_episode_steps = 5
    cfg = D4PGConfig(noise_kind="ou")
    gen = torch.Generator().manual_seed(0)
    init, sample, reset = make_noise(cfg, (3,))
    state, obs = env.reset(3, gen)

    def policy(o, g, nstate):
        n, nstate = sample(nstate, g, (o.shape[0], 1))
        return n.clamp(-1, 1), nstate

    state, obs, nstate, traj = rollout(env, policy, gen, 12, state, obs, init(), reset)
    assert traj.obs.shape == (3, 12, 3) and traj.reward.shape == (3, 12)
    # truncation every 5 steps; the next step's obs is a fresh reset
    np.testing.assert_array_equal(traj.truncated[0].numpy(), [0, 0, 0, 0, 1] * 2 + [0, 0])
    assert not torch.allclose(traj.obs[:, 5], traj.next_obs[:, 4])
    torch.testing.assert_close(traj.obs[:, 1:5], traj.next_obs[:, 0:4])
    assert state.t.tolist() == [2, 2, 2]
    # OU state was reset to x0 = 0 at each episode end, then evolved 2 steps
    assert nstate.x.abs().max() < 0.1 and nstate.x.abs().max() > 0


def _fixed_trajectory(N=3, T=16, seed=0):
    rng = np.random.default_rng(seed)
    rew = rng.normal(size=(N, T)).astype(np.float32)
    term = np.zeros((N, T), np.float32)
    trunc = np.zeros((N, T), np.float32)
    term[0, 5] = 1.0
    term[1, T - 2] = 1.0
    trunc[1, 3] = 1.0
    trunc[2, 7] = 1.0
    term[2, 8] = 1.0
    obs = rng.normal(size=(N, T, 3)).astype(np.float32)
    nxt = rng.normal(size=(N, T, 3)).astype(np.float32)
    act = rng.uniform(-1, 1, size=(N, T, 1)).astype(np.float32)
    return obs, act, rew, nxt, term, trunc


def _jax_collapse(gamma, n, obs, act, rew, nxt, term, trunc):
    """``runtime/collect.py``'s collapse (lines 84-101) over the reference
    nstep_returns, written out here because the JAX package nests it."""
    def collapse(rew, term, trunc, tr_obs, tr_act, tr_next):
        rets, boots, offs = j_nstep(rew, term, gamma, n, truncations=trunc)
        idx = jnp.clip(jnp.arange(rew.shape[0]) + offs - 1, 0, rew.shape[0] - 1)
        return {"obs": tr_obs, "action": tr_act, "reward": rets,
                "next_obs": tr_next[idx], "discount": boots}

    flat = jax.vmap(collapse)(*map(jnp.asarray, (rew, term, trunc, obs, act, nxt)))
    return {k: np.asarray(v).reshape((-1,) + v.shape[2:]) for k, v in flat.items()}


@pytest.mark.parametrize("n", [1, 3, 5])
def test_nstep_collapse_matches_reference(n):
    obs, act, rew, nxt, term, trunc = _fixed_trajectory()
    want = _jax_collapse(0.99, n, obs, act, rew, nxt, term, trunc)
    traj = Trajectory(*(torch.from_numpy(a) for a in (obs, act, rew, nxt, term, trunc)))
    got = collapse_nstep(traj, 0.99, n)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-5, err_msg=k)
    # the exact gamma^m bootstrap at the segment edge: the last step's window is 1
    assert got["discount"].numpy().reshape(3, -1)[2, -1] == np.float32(0.99)


def test_segment_collector_yields_flat_nstep_block():
    env = Pendulum()
    cfg = D4PGConfig(hidden_sizes=(8,), n_step=3)
    from d4pg_tpu_torch.models import Actor

    actor = Actor(3, 1, (8,), generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    noise = make_noise(cfg, (4,))
    collect = make_segment_collector(cfg, env, 4, 6, noise)
    state, obs = env.reset(4, gen)
    state, obs2, nstate, flat, traj = collect(actor, state, obs, noise[0](), gen, 1.0)
    assert {k: tuple(v.shape) for k, v in flat.items()} == {
        "obs": (24, 3), "action": (24, 1), "reward": (24,), "next_obs": (24, 3), "discount": (24,)
    }
    assert flat["action"].abs().max() <= 1.0
    torch.testing.assert_close(flat["obs"][:6], traj.obs[0])
    np.testing.assert_allclose(
        flat["discount"].numpy().reshape(4, 6)[0], [0.99**3] * 4 + [0.99**2, 0.99], rtol=1e-6
    )
    assert state.t.tolist() == [6] * 4


def test_evaluate_reports_success_only_for_goal_envs():
    """``success_rate`` (episodes that terminated before truncation) only
    where termination means the goal was reached, as the JAX evaluator."""
    from d4pg_tpu_torch.runtime.evaluator import evaluate

    class Toward(torch.nn.Module):
        """Accelerate toward the goal: most episodes reach it."""

        out = torch.nn.Linear(1, 1)

        def forward(self, obs):
            return (obs[:, 4:6] - obs[:, :2]).clamp(-1, 1) - 0.5 * obs[:, 2:4]

    cfg = D4PGConfig(obs_dim=6, action_dim=2)
    ev = evaluate(cfg, PointMassGoal(), Toward(), torch.Generator().manual_seed(0), 16)
    assert 0.5 < ev["success_rate"] <= 1.0 and -50.0 <= ev["eval_return_mean"] < 0.0

    class Idle(torch.nn.Module):
        out = torch.nn.Linear(1, 1)

        def forward(self, obs):
            return torch.zeros(obs.shape[0], 1)

    ev = evaluate(D4PGConfig(), Pendulum(), Idle(), torch.Generator().manual_seed(0), 2, max_steps=5)
    assert "success_rate" not in ev
