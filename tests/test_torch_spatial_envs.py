"""The port's Humanoid and Ant (``d4pg_tpu_torch/envs/locomotion.py``) and
their presets, against the JAX package's, on the CPU
(``tests/test_torch_spatial_loop.py`` holds the on-device loop and the
CLI on them).

- One ``step`` of each env from injected, numpy-seeded states and fixed
  actions (some outside the (−1, 1) box): rows in ground contact, an
  airborne row, a row above the healthy height, a row at its last step
  before truncation, and the blow-up guard's rows (a NaN quaternion
  entry, a velocity of 2e4, one of 9e3); obs, reward, terminated,
  truncated and the physics state. The JAX step is jitted once per env,
  at 64 rows.
- ``chip_smoke.py``'s 64 Ant states rolled 16 control steps in both
  packages: the same rows blow up and terminate at every step.
- The reset's layout (obs = q[2:] ++ v, unit root quaternion) and its
  distribution against the JAX reset's; ``reset_where``.
- The control cost on ctrl = clip(a)·ctrl_hi, Ant's torso-x reward and
  Humanoid's model-COM reward (``tests/test_spatial.py``'s checks), and a
  passive Humanoid drop that stays finite and settles on the ground.
- The presets (``--env humanoid`` / ``ant`` resolve the JAX trainer's
  support; an explicit ``--v-min`` / ``--v-max`` still wins), the
  refusal of gym ids; the 3D envs, the snapshot tool and
  ``chip_smoke.py`` import no mujoco, gymnasium or JAX.

Tolerances: a control step is 10 (Humanoid) or 20 (Ant) substeps of stiff
penalty contacts, which amplify the ulp differences of the two engines'
summation orders: q atol 1e-5, v and the observation (which carries v)
atol 5e-3 (``tests/test_torch_spatial.py`` measures each float32 engine
~1e-3 from a float64 run on a deep contact row), reward atol 1e-3 (the
forward velocity divides the COM's q difference by the 0.015 s control
dt); terminated and truncated exactly.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from d4pg_tpu.envs import locomotion as jl
from d4pg_tpu.envs.api import EnvState as JEnvState
from d4pg_tpu_torch.envs import Ant, EnvState, Humanoid, make_env
from d4pg_tpu_torch.envs import spatial as ts

ENVS = {"humanoid": (Humanoid, jl.Humanoid), "ant": (Ant, jl.Ant)}
Q_ATOL, V_ATOL, R_ATOL = 1e-5, 5e-3, 1e-3
ROWS = 64   # the JAX step's batch: chip_smoke.py's 64 Ant states
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's steps here are small batched products: one thread each.
    Under xdist, MKL's eight threads a worker spin against the other
    workers' (the 225-step drop below: 4 s on one thread, 113 s in the
    suite on eight)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_step():
    """name -> the JAX env's step, vmapped and jitted once at ``ROWS`` rows
    (fewer rows are padded with copies of row 0 and cut back), so each
    env compiles once in this file."""
    cache = {}

    def get(name):
        if name not in cache:
            env = ENVS[name][1]()

            def one(q, v, t, a):
                return env.step(JEnvState(physics=(q, v), t=t, key=jax.random.PRNGKey(0)), a)

            fn = jax.jit(jax.vmap(one))

            def padded(*rows):
                n = len(rows[0])
                out = fn(*(np.concatenate([x, np.repeat(x[:1], ROWS - n, 0)]) for x in rows))
                return jax.tree_util.tree_map(lambda x: x[:n], out)

            cache[name] = padded
        return cache[name]

    return get


def _rows(env, seed):
    """(q, v, t, action): rows 0-2 in ground contact, 3 airborne, 4 above
    the healthy height, 5 at its last step before truncation, 6 with a NaN
    quaternion entry, 7 with a velocity of 2e4, 8 with one of 9e3."""
    rng = np.random.default_rng(seed)
    m, N = env.model, 9
    q = np.tile(m.qpos0, (N, 1))
    q[:, 7:] += rng.uniform(-0.1, 0.1, (N, m.nq - 7))
    quat = np.array([1.0, 0.0, 0.0, 0.0]) + rng.uniform(-0.05, 0.05, (N, 4))
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    v = rng.normal(0.0, 0.3, (N, m.nv))
    for r in range(3):
        pts = ts.contact_points(m, torch.tensor(q[r:r + 1], dtype=torch.float32))[0]
        q[r, 2] -= (pts[:, 2].numpy() - m.con_radius).min() + 0.002 * (r + 1)
    q[3, 2] = env.healthy_z[1] - 0.05
    q[4, 2] = env.healthy_z[1] + 0.1
    q[6, 3] = np.nan
    v[7, 0] = 2e4
    v[8, 0] = 9e3
    t = np.full(N, 7, np.int32)
    t[5] = env.max_episode_steps - 1
    a = rng.uniform(-1.3, 1.3, (N, env.action_dim))
    return q.astype(np.float32), v.astype(np.float32), t, a.astype(np.float32)


@pytest.mark.parametrize("name", sorted(ENVS))
def test_step_matches_the_reference(name, jax_step):
    env = ENVS[name][0]()
    q, v, t, a = _rows(env, seed=len(name))
    js, jo, jr, jterm, jtrunc = jax_step(name)(q, v, t, a)
    state = EnvState(torch.from_numpy(np.concatenate([q, v], -1)), torch.from_numpy(t))
    ts_, to, tr, tterm, ttrunc = env.step(state, torch.from_numpy(a))
    ok = np.arange(9) < 6  # the guard's rows blow up on both sides
    np.testing.assert_allclose(ts_.physics[ok, :env.nq].numpy(), np.asarray(js.physics[0])[ok],
                               atol=Q_ATOL)
    np.testing.assert_allclose(ts_.physics[ok, env.nq:].numpy(), np.asarray(js.physics[1])[ok],
                               atol=V_ATOL)
    np.testing.assert_allclose(to[ok].numpy(), np.asarray(jo)[ok], atol=V_ATOL)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=R_ATOL)
    np.testing.assert_array_equal(tterm.numpy(), np.asarray(jterm))
    np.testing.assert_array_equal(ttrunc.numpy(), np.asarray(jtrunc))
    np.testing.assert_array_equal(ts_.t.numpy(), t + 1)
    assert to.shape == (9, env.observation_dim) and ts_.physics.shape == (9, env.nq + env.nv)
    # the rows do what they are for: contacts push on 0-2, row 4 is out
    # of the healthy band, row 5 truncates, the guard's rows terminate with reward 0 and
    # finite obs, and the sub-threshold row's reward is bounded
    pen = env.model.con_radius - ts.contact_points(env.model, torch.from_numpy(q[:4]))[..., 2].numpy()
    assert (pen[:3] > 0).any(axis=1).all() and not (pen[3] > 0).any()
    assert tterm[:4].sum() == 0 and tterm[4] == 1.0 and ttrunc[5] == 1.0
    assert (tterm[6:8] == 1.0).all() and (tr[6:8] == 0.0).all() and torch.isfinite(to).all()
    assert abs(float(tr[8])) <= 1e3


@pytest.mark.parametrize("name", sorted(ENVS))
def test_reset_matches_the_reference_distribution(name):
    env, jenv = ENVS[name][0](), ENVS[name][1]()
    state, obs = env.reset(4096, torch.Generator().manual_seed(0))
    q, v = state.physics[:, :env.nq], state.physics[:, env.nq:]
    assert obs.shape == (4096, env.observation_dim) and (state.t == 0).all()
    torch.testing.assert_close(obs, torch.cat([q[:, 2:], v], -1))
    torch.testing.assert_close(torch.linalg.vector_norm(q[:, 3:7], dim=-1), torch.ones(4096))
    keys = jax.random.split(jax.random.PRNGKey(0), 4096)
    jstate, jobs = jax.vmap(jenv.reset)(keys)
    jphys = np.concatenate([np.asarray(jstate.physics[0]), np.asarray(jstate.physics[1])], -1)
    s = env.reset_noise_scale
    np.testing.assert_allclose(state.physics.numpy().mean(0), jphys.mean(0), atol=0.1 * s)
    np.testing.assert_allclose(state.physics.numpy().std(0), jphys.std(0), rtol=0.1, atol=1e-3 * s)
    np.testing.assert_allclose(obs.numpy().mean(0), np.asarray(jobs).mean(0), atol=0.1 * s)


def test_reset_where_resets_only_done_rows():
    env = Humanoid()
    gen = torch.Generator().manual_seed(1)
    state, obs = env.reset(4, gen)
    state = EnvState(state.physics + 1.0, state.t + 3)
    state2, obs2 = env.reset_where(state, obs + 1.0, torch.tensor([1.0, 0.0, 0.0, 1.0]), gen)
    assert state2.t.tolist() == [0, 3, 3, 0]
    torch.testing.assert_close(state2.physics[1:3], state.physics[1:3])
    torch.testing.assert_close(obs2[1:3], obs[1:3] + 1.0)
    q0 = torch.tensor(env.model.qpos0, dtype=torch.float32)
    assert (state2.physics[[0, 3], :24] - q0).abs().max() <= 0.02


def test_ctrl_is_scaled_by_ctrl_hi_and_the_forward_rewards():
    """The control cost of a full-scale Humanoid action is 0.1·17·0.4² =
    0.272; Humanoid's forward velocity is the model COM's, Ant's the
    torso's (Ant-v5's get_body_com("torso"))."""
    env = Humanoid()
    state, _ = env.reset(2, torch.Generator().manual_seed(0))
    s2, _, r, term, _ = env.step(state, torch.full((2, 17), 3.0))  # clipped to 1
    mass = torch.tensor(env.model.mass, dtype=torch.float32)

    def com_x(q):
        return (mass * ts.body_coms(env.model, q)[0][..., 0]).sum(-1) / mass.sum()

    x_vel = (com_x(s2.physics[:, :24]) - com_x(state.physics[:, :24])) / env.control_dt
    torch.testing.assert_close(r, 1.25 * x_vel - 0.1 * 17 * 0.16 + 5.0, rtol=1e-5, atol=1e-5)
    assert (term == 0).all()
    ant = Ant()
    q = torch.tensor(ant.model.qpos0, dtype=torch.float32)[None].clone()
    q[0, 7:15] = torch.tensor([0.9, 1.2, 0.0, 0.1, 0.0, -0.1, 0.0, 0.1])
    coms = ts.body_coms(ant.model, q)[0]
    model_x = (torch.tensor(ant.model.mass, dtype=torch.float32) * coms[0, :, 0]).sum() / float(
        ant.model.mass.sum())
    assert abs(float(ant._forward_x(q)[0] - coms[0, 0, 0])) < 1e-6
    assert abs(float(model_x - coms[0, 0, 0])) > 1e-3
    qh = torch.tensor(env.model.qpos0, dtype=torch.float32)[None]
    assert abs(float(env._forward_x(qh)[0] - com_x(qh)[0])) < 1e-6


def test_passive_humanoid_drop_stays_finite_and_settles():
    """The passive Humanoid falls from the XML pose and comes to rest on the
    ground: no sinking through, no explosion (tests/test_spatial.py's check
    on the JAX engine, here 225 control steps of 4 envs)."""
    env = Humanoid()
    m = env.model
    q = torch.tensor(np.tile(m.qpos0, (4, 1)), dtype=torch.float32)
    q[:, 0] += torch.arange(4.0)
    v = torch.zeros(4, m.nv)
    for _ in range(225):
        q, v = ts.step_physics(m, q, v, torch.zeros(4, 17), env.n_substeps, env.substep_dt)
    assert torch.isfinite(q).all() and torch.isfinite(v).all()
    assert (q[:, 2] > 0.05).all() and (q[:, 2] < 1.0).all()   # fallen, above the floor
    assert v.abs().max() < 0.5                                   # at rest
    gaps = ts.contact_points(m, q)[..., 2] - torch.tensor(m.con_radius, dtype=torch.float32)
    assert gaps.min() > -0.02                                    # < 2 cm penetration
    torch.testing.assert_close(torch.linalg.vector_norm(q[:, 3:7], dim=-1), torch.ones(4))


def test_ant_rollout_blows_up_and_terminates_where_the_reference_does(jax_step):
    """``chip_smoke.py``'s Ant states rolled in both packages: 64 seeded
    resets, 15 control steps under uniform actions in (−1, 1) with the done
    rows reset, then one under actions in (−1.2, 1.2). The JAX state rolls
    on its own; the port's reset rows are fed to both. At every step the
    rows that blow up (non-finite, or |v| ≥ 1e4: the guard's test) and the
    rows that terminate or truncate are the same in both packages, so the
    blow-ups under random actions (several a step here) are the JAX
    engine's, mirrored, not the port's."""
    env, n = Ant(), ROWS
    step = jax_step("ant")
    gen = torch.Generator().manual_seed(0)
    state, obs = env.reset(n, gen)
    jq, jv = (x.numpy() for x in env._split(state.physics))
    jt = state.t.numpy()
    blowups = 0
    for k in range(16):
        lim = 1.0 if k < 15 else 1.2
        a = 2.0 * lim * torch.rand((n, env.action_dim), generator=gen) - lim
        state, obs, _, term, trunc = env.step(state, a)
        js, _, _, jterm, jtrunc = step(jq, jv, jt, a.numpy())
        jq, jv = np.asarray(js.physics[0]), np.asarray(js.physics[1])
        q, v = env._split(state.physics)
        sane = (torch.isfinite(state.physics).all(-1) & (v.abs().amax(-1) < 1e4)).numpy()
        jsane = np.isfinite(jq).all(-1) & np.isfinite(jv).all(-1) & (np.abs(jv).max(-1) < 1e4)
        np.testing.assert_array_equal(np.flatnonzero(~sane), np.flatnonzero(~jsane),
                                      err_msg=f"blown-up rows at step {k}")
        np.testing.assert_array_equal(term.numpy(), np.asarray(jterm), err_msg=f"step {k}")
        np.testing.assert_array_equal(trunc.numpy(), np.asarray(jtrunc), err_msg=f"step {k}")
        blowups += int((~sane).sum())
        done = torch.maximum(term, trunc)
        state, obs = env.reset_where(state, obs, done, gen)
        d = done.numpy()[:, None] > 0
        rq, rv = env._split(state.physics)
        jq, jv = np.where(d, rq.numpy(), jq), np.where(d, rv.numpy(), jv)
        jt = state.t.numpy()
    assert blowups > 0


def test_make_env_and_presets():
    from d4pg_tpu.config import ENV_PRESETS as J_PRESETS
    from d4pg_tpu_torch.config import ENV_PRESETS, TrainConfig, apply_env_preset, cli_support

    for name, (cls, _) in ENVS.items():
        env = make_env(name, max_episode_steps=50)
        assert isinstance(env, cls) and env.max_episode_steps == 50
        assert make_env(name).max_episode_steps == 1000
        assert ENV_PRESETS[name] == J_PRESETS[name]
        a = apply_env_preset(TrainConfig(env=name)).agent
        assert (a.obs_dim, a.action_dim) == (env.observation_dim, env.action_dim)
    assert cli_support("humanoid", None, None) == (0.0, 1500.0)
    assert cli_support("ant", None, -5.0) == (0.0, -5.0)
    assert cli_support("humanoid", -10.0, 2000.0) == (-10.0, 2000.0)
    with pytest.raises(ValueError, match="--action-repeat is only supported"):
        make_env("humanoid", action_repeat=2)
    # the gym ids build the host adapters (ROADMAP A5 (d)), whose dims the
    # config takes from the env; an id with no preset needs the env
    from d4pg_tpu_torch.envs.gym_adapter import GymAdapter

    for gym_id in ("Humanoid-v5", "Ant-v5"):
        env = make_env(gym_id)
        assert isinstance(env, GymAdapter)
        a = apply_env_preset(TrainConfig(env=gym_id), env).agent
        assert (a.obs_dim, a.action_dim) == (env.observation_dim, env.action_dim)
        env.close()
    assert apply_env_preset(TrainConfig(env="Humanoid-v5")).agent.obs_dim == 348
    with pytest.raises(NotImplementedError, match="no preset"):
        apply_env_preset(TrainConfig(env="Ant-v5"))


@pytest.mark.parametrize("argv", [
    ["--env", "humanoid"], ["--env", "ant"], ["--env", "humanoid", "--v-max", "2000"],
    ["--env", "ant", "--v-min", "-50"], ["--env", "humanoid", "--v-min", "0", "--v-max", "1500"],
], ids=["humanoid", "ant", "humanoid_vmax", "ant_vmin", "humanoid_recipe"])
def test_resolved_support_matches_the_jax_trainer(argv, tmp_path):
    """C-1's rule on the new presets: the port's ``Trainer`` ends with the
    JAX trainer's ``_reconcile_config(config_from_args(argv), env)``."""
    import types

    import train as jtrain
    from d4pg_tpu.runtime.trainer import _reconcile_config
    from d4pg_tpu_torch.runtime.trainer import Trainer
    from d4pg_tpu_torch.train import build_parser, config_from_args

    small = ["--hidden-sizes", "8", "--rmsize", "256", "--num-envs", "2",
             "--log-dir", str(tmp_path)]
    jcfg = jtrain.config_from_args(jtrain.build_parser().parse_args(argv))
    t = Trainer(config_from_args(build_parser().parse_args(argv + small)), device="cpu")
    t.close()
    a = t.config.agent
    env = types.SimpleNamespace(observation_dim=a.obs_dim, action_dim=a.action_dim,
                                max_episode_steps=t.config.max_episode_steps)
    jd = _reconcile_config(jcfg, env).agent.dist
    assert (a.dist.v_min, a.dist.v_max) == (jd.v_min, jd.v_max)


def test_spatial_envs_import_no_mujoco_gymnasium_or_jax():
    """The 3D envs load the committed snapshots: a run needs neither
    package (only tools/extract_spatial.py does, inside its function), and
    nothing of JAX."""
    code = (
        "import sys, torch\n"
        "import chip_smoke\n"
        "from d4pg_tpu_torch.envs import make_env\n"
        "import d4pg_tpu_torch.tools.extract_spatial\n"
        "for name in ('humanoid', 'ant'):\n"
        "    env = make_env(name)\n"
        "    state, obs = env.reset(2, torch.Generator().manual_seed(0))\n"
        "    env.step(state, torch.zeros(2, env.action_dim))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('mujoco', 'gymnasium', 'jax', 'jaxlib', 'd4pg_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
