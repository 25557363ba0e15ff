"""The port's planar locomotion envs (``d4pg_tpu_torch/envs/locomotion.py``)
against the JAX package's, on the CPU.

One ``step`` of HalfCheetah, Hopper and Walker2d from injected,
numpy-seeded states and fixed actions (some outside the (−1, 1) box), with
rows in ground contact, a row at its last step before truncation, an
unhealthy row (Hopper and Walker2d) and a row whose state is not finite
(the blow-up guard): obs, reward, terminated, truncated and the physics
state. The JAX step is jitted once per env (a module-scoped fixture).

Tolerances: a control step is 4 (Hopper, Walker2d) or 20 (HalfCheetah)
substeps of stiff penalty contacts, which amplify the ulp differences of
the two engines' summation orders: q atol 1e-5, q̇ and the observation
(which carries q̇) atol 5e-4, reward atol 1e-4 (measured: up to 6e-5 on
q̇ and 4e-6 on the reward); terminated and truncated exactly.
"""

import jax
import numpy as np
import pytest
import torch

from d4pg_tpu.envs import locomotion as jl
from d4pg_tpu.envs.api import EnvState as JEnvState
from d4pg_tpu_torch.envs import EnvState, HalfCheetah, Hopper, Walker2d, make_env
from d4pg_tpu_torch.envs import planar as tp

ENVS = {"halfcheetah": (HalfCheetah, jl.HalfCheetah), "hopper": (Hopper, jl.Hopper),
        "walker2d": (Walker2d, jl.Walker2d)}
Q_ATOL, QD_ATOL, R_ATOL = 1e-5, 5e-4, 1e-4


@pytest.fixture(scope="module")
def jax_step():
    cache = {}

    def get(name):
        if name not in cache:
            env = ENVS[name][1]()

            def one(q, qd, t, a):
                return env.step(JEnvState(physics=(q, qd), t=t, key=jax.random.PRNGKey(0)), a)

            cache[name] = jax.jit(jax.vmap(one))
        return cache[name]

    return get


def _rows(env, seed):
    """(q, q̇, t, action): rows 0-2 in ground contact, 3 airborne, 4
    unhealthy (pitched past Hopper's 0.2 / Walker2d's 1.0), 5 at its last
    step before truncation, 6 with a NaN velocity."""
    rng = np.random.default_rng(seed)
    m, nq, N = env.model, env.nq, 7
    q = np.tile(m.qpos0, (N, 1)) + rng.uniform(-0.1, 0.1, (N, nq))
    qd = rng.normal(0.0, 0.5, (N, nq))
    for r in range(3):
        pts = tp.contact_points(m, torch.tensor(q[r:r + 1], dtype=torch.float32))[0]
        q[r, 1] -= (pts[:, 1].numpy() - m.con_radius).min() + 0.005 * (r + 1)
    q[3, 1] += 0.3
    q[4, 2] = 1.2
    qd[6, 3] = np.nan
    t = np.full(N, 7, np.int32)
    t[5] = env.max_episode_steps - 1
    a = rng.uniform(-1.3, 1.3, (N, env.action_dim))
    return q.astype(np.float32), qd.astype(np.float32), t, a.astype(np.float32)


@pytest.mark.parametrize("name", sorted(ENVS))
def test_step_matches_the_reference(name, jax_step):
    env = ENVS[name][0]()
    q, qd, t, a = _rows(env, seed=len(name))
    js, jo, jr, jterm, jtrunc = jax_step(name)(q, qd, t, a)
    state = EnvState(torch.from_numpy(np.concatenate([q, qd], -1)), torch.from_numpy(t))
    ts, to, tr, tterm, ttrunc = env.step(state, torch.from_numpy(a))
    ok = np.arange(7) != 6  # the NaN row's physics is NaN on both sides
    np.testing.assert_allclose(ts.physics[ok, :env.nq].numpy(), np.asarray(js.physics[0])[ok], atol=Q_ATOL)
    np.testing.assert_allclose(ts.physics[ok, env.nq:].numpy(), np.asarray(js.physics[1])[ok], atol=QD_ATOL)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=QD_ATOL)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=R_ATOL)
    np.testing.assert_array_equal(tterm.numpy(), np.asarray(jterm))
    np.testing.assert_array_equal(ttrunc.numpy(), np.asarray(jtrunc))
    np.testing.assert_array_equal(ts.t.numpy(), t + 1)
    # the guard: the non-finite row terminates with reward 0 and finite obs
    assert tterm[6] == 1.0 and tr[6] == 0.0 and torch.isfinite(to[6]).all()
    assert ttrunc[5] == 1.0
    assert tterm[4] == (0.0 if name == "halfcheetah" else 1.0)


@pytest.mark.parametrize("name", sorted(ENVS))
def test_reset_matches_the_reference_distribution(name):
    env, jenv = ENVS[name][0](), ENVS[name][1]()
    state, obs = env.reset(4096, torch.Generator().manual_seed(0))
    assert obs.shape == (4096, env.observation_dim) and (state.t == 0).all()
    keys = jax.random.split(jax.random.PRNGKey(0), 4096)
    jstate, jobs = jax.vmap(jenv.reset)(keys)
    jphys = np.concatenate([np.asarray(jstate.physics[0]), np.asarray(jstate.physics[1])], -1)
    s = env.reset_noise_scale
    np.testing.assert_allclose(state.physics.numpy().mean(0), jphys.mean(0), atol=0.1 * s)
    np.testing.assert_allclose(state.physics.numpy().std(0), jphys.std(0), rtol=0.1)
    np.testing.assert_allclose(obs.numpy().mean(0), np.asarray(jobs).mean(0), atol=0.1 * s)


def test_reset_where_resets_only_done_rows():
    env = HalfCheetah()
    gen = torch.Generator().manual_seed(1)
    state, obs = env.reset(4, gen)
    state = EnvState(state.physics + 1.0, state.t + 3)
    done = torch.tensor([1.0, 0.0, 0.0, 1.0])
    state2, obs2 = env.reset_where(state, obs + 1.0, done, gen)
    assert state2.t.tolist() == [0, 3, 3, 0]
    torch.testing.assert_close(state2.physics[1:3], state.physics[1:3])
    torch.testing.assert_close(obs2[1:3], obs[1:3] + 1.0)
    assert (state2.physics[[0, 3], :9] - torch.tensor(env.model.qpos0, dtype=torch.float32)).abs().max() <= 0.1


def test_make_env_builds_the_locomotion_envs():
    for name, (cls, _) in ENVS.items():
        env = make_env(name, max_episode_steps=50)
        assert isinstance(env, cls) and env.max_episode_steps == 50
    assert make_env("halfcheetah").max_episode_steps == 1000
    with pytest.raises(ValueError, match="--action-repeat is only supported for dmc:/dmc_pixels: envs"):
        make_env("halfcheetah", action_repeat=2)


def test_halfcheetah_substeps_and_obs_layout():
    env = HalfCheetah()
    assert (env.n_substeps, env.substep_dt, env.control_dt) == (20, 0.0025, 0.05)
    state, obs = env.reset(3, torch.Generator().manual_seed(2))
    q, qd = state.physics[:, :9], state.physics[:, 9:]
    torch.testing.assert_close(obs, torch.cat([q[:, 1:], qd], -1))
    # a zero action for one step is forward velocity alone
    s2, _, r, term, trunc = env.step(state, torch.zeros(3, 6))
    torch.testing.assert_close(r, (s2.physics[:, 0] - q[:, 0]) / 0.05)
    assert term.sum() == 0 and trunc.sum() == 0
