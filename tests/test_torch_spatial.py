"""The port's 3D spatial engine (``d4pg_tpu_torch/envs/spatial.py``) and
its model snapshots against the JAX package's, on the CPU.

- Each committed snapshot ``envs/assets/<asset>.npz`` (Humanoid, Ant)
  equals, field by field, dtype and value, what
  ``d4pg_tpu.envs.spatial.extract_spatial_model`` returns for the
  installed gymnasium asset (and so does the port's own extraction).
- ``fk``, ``body_coms``, ``com_velocities``, ``contact_points``,
  ``lift_velocity``, ``kinetic_energy``, ``mass_matrix``, ``bias_force``,
  ``_applied_force``, ``forward_dynamics``, ``integrate_qpos`` and one
  control step of ``step_physics`` of the port's closed form equal the JAX
  package's autodiff ones at injected numpy-seeded rows: airborne rows,
  rows lowered into ground contact, rows past a limited joint's upper and
  lower limits, and a row whose root quaternion is turned far from the
  identity. Each asset's JAX functions are jitted once, vmapped over the
  rows (a module-scoped fixture); the JAX control step is
  ``step_physics``'s scan body (v̇, v, then ``integrate_qpos``) run once a
  substep from that one executable, so nothing compiles twice.
- M and c also equal MuJoCo's own ``mj_fullM`` and ``mj_rne``, and the
  COMs its ``xipos``, at the JAX package's bounds (tests/test_spatial.py).

Tolerances (float32 on both sides, different summation orders):
positions atol 1e-6 (metres of order 1, after up to nine composed
rotations); velocities, M and c within 1e-6 of their largest entry;
the applied forces and v̇, which carry the 60 000 N/m contact stiffness
and M's solve, within 1e-5 of their largest entry. One control step
(10 substeps for Humanoid, 20 for Ant, stiff penalty contacts): q atol
1e-5 (``tests/test_torch_locomotion.py``'s), v atol 5e-3, ten times that
file's 5e-4: on the deepest contact row each float32 engine lies about
1e-3 from a float64 run of the port's closed form (the test holds both
within half the tolerance of it; measured: the JAX engine 1.14e-3 on
Humanoid's row 4, the port 1.11e-3 on Ant's row 2, the other rows
within 5e-5), so two float32 engines may differ by twice that.
Against MuJoCo (float64): M atol and rtol 2e-4, c atol 2e-2 and rtol
1e-3, COMs atol 1e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

mujoco = pytest.importorskip("mujoco")

from d4pg_tpu.envs import spatial as js  # noqa: E402
from d4pg_tpu.envs.locomotion import Ant as JAnt, Humanoid as JHumanoid, _gym_xml  # noqa: E402
from d4pg_tpu_torch.envs import spatial as ts  # noqa: E402

ASSETS = ["humanoid.xml", "ant.xml"]
JENVS = {"humanoid.xml": JHumanoid, "ant.xml": JAnt}
POS_ATOL = 1e-6
LIN_RTOL = 1e-6      # of the largest entry: velocities, M, c
FORCE_RTOL = 1e-5    # of the largest entry: applied forces, v̇
Q_ATOL, V_ATOL = 1e-5, 5e-3   # one control step (see the docstring)


def _rows(model, seed=0):
    """Injected (q, v, ctrl) rows: 0-1 airborne, 2-4 in ground contact (the
    root lowered below the lowest sphere's contact height), 5 past the last
    limited joint's upper limit, 6 past its lower limit, 7 with the root
    turned 2.5 rad about a random axis."""
    rng = np.random.default_rng(seed)
    nq, nv, nu, N = model.nq, model.nv, len(model.gear), 8
    q = np.tile(model.qpos0, (N, 1))
    q[:, 7:] += rng.uniform(-0.3, 0.3, (N, nq - 7))
    quat = np.array([1.0, 0.0, 0.0, 0.0]) + rng.uniform(-0.2, 0.2, (N, 4))
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    quat[7] = np.concatenate([[np.cos(1.25)], np.sin(1.25) * axis])
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    q[:, :2] += rng.uniform(-1.0, 1.0, (N, 2))
    q[:, 2] = 3.0
    for r in (2, 3, 4):
        pts = ts.contact_points(model, torch.tensor(q[r:r + 1], dtype=torch.float32))[0]
        gap = (pts[:, 2].numpy() - model.con_radius).min()
        q[r, 2] -= gap + 0.005 * (r - 1)
    j = np.flatnonzero(model.limited)[-1]
    qa = model.jnt_qposadr[j]
    q[5, qa] = model.range_hi[j] + 0.05
    q[6, qa] = model.range_lo[j] - 0.05
    v = rng.normal(0.0, 1.0, (N, nv))
    ctrl = rng.uniform(-1.0, 1.0, (N, nu)) * model.ctrl_hi
    return q.astype(np.float32), v.astype(np.float32), ctrl.astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's engine on the CPU runs small batched products: one
    thread each. Under xdist, MKL's eight threads a worker spin against
    the other workers' (tests/test_torch_spatial_envs.py's drop: 4 s on
    one thread, 113 s in the suite on eight)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_dynamics():
    """asset -> (JAX model, JAX env, one jitted vmapped function of
    (q, v, ctrl): every compared function and one substep), built once."""
    cache = {}

    def get(asset):
        if asset not in cache:
            m = js.extract_spatial_model(_gym_xml(asset))
            env = JENVS[asset]()

            def one(q, v, c):
                return (
                    js.fk(m, q), js.body_coms(m, q), js.com_velocities(m, q, v),
                    js.contact_points(m, q), js.lift_velocity(m, q, v),
                    js.kinetic_energy(m, q, v), js.mass_matrix(m, q), js.bias_force(m, q, v),
                    js._applied_force(m, q, v, c), js.forward_dynamics(m, q, v, c),
                    js.integrate_qpos(m, q, v, env.substep_dt),
                )

            def substep(q, v, c):  # step_physics's scan body, on one executable
                out = one(q, v, c)
                v1 = v + env.substep_dt * out[9]
                return out, js.integrate_qpos(m, q, v1, env.substep_dt), v1

            cache[asset] = (m, env, jax.jit(jax.vmap(substep)))
        return cache[asset]

    return get


@pytest.mark.parametrize("asset", ASSETS)
def test_snapshot_equals_the_reference_extraction(asset):
    want = js.extract_spatial_model(_gym_xml(asset))
    got = ts.load_model(asset)
    ours = ts.extract_spatial_model(_gym_xml(asset))
    assert got._fields == want._fields
    for name in want._fields:
        w = np.asarray(getattr(want, name))
        for side in (got, ours):
            g = np.asarray(getattr(side, name))
            assert g.dtype == w.dtype and g.shape == w.shape, name
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert os.path.exists(os.path.join(ts.ASSETS, os.path.splitext(asset)[0] + ".npz"))


@pytest.mark.parametrize("asset,sizes", [
    ("humanoid.xml", (13, 18, 24, 23, 17, 29, 0.003)),
    ("ant.xml", (13, 9, 15, 14, 8, 25, 0.01)),
])
def test_snapshot_sizes(asset, sizes):
    m = ts.load_model(asset)
    assert (len(m.parent), len(m.jnt_body), m.nq, m.nv, len(m.gear), len(m.con_body),
            m.timestep) == sizes
    assert all(isinstance(getattr(m, k), float) for k in ts.SCALARS)
    assert isinstance(m.nq, int) and isinstance(m.nv, int)


def test_quaternion_helpers_match_the_reference():
    rng = np.random.default_rng(1)
    a, b = (rng.normal(size=(16, 4)).astype(np.float32) for _ in range(2))
    phi = (rng.normal(size=(16, 3)) * np.array([[1.0]] * 15 + [[0.0]])).astype(np.float32)
    ta, tb, tphi = map(torch.from_numpy, (a, b, phi))
    want = jax.vmap(js.quat_mul)(a, b), jax.vmap(js.quat_to_mat)(a), jax.vmap(js._quat_exp)(phi)
    got = ts.quat_mul(ta, tb), ts.quat_to_mat(ta), ts._quat_exp(tphi)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-6)
    # exp(0) is the identity exactly (the 1e-30 guard and the sinc limit)
    assert ts._quat_exp(tphi)[15].tolist() == [1.0, 0.0, 0.0, 0.0]


def _rel(got, want, rtol, what):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (what, err, np.abs(want).max())


@pytest.mark.parametrize("asset", ASSETS)
def test_dynamics_match_the_reference(asset, jax_dynamics):
    jm, jenv, fn = jax_dynamics(asset)
    m = ts.load_model(asset)
    q, v, ctrl = _rows(m)
    ((jo, jR), (jc, jcR), (jcd, jw), jcp, jlift, jT, jM, jb, ja, jf, jint), jq1, jv1 = fn(q, v, ctrl)
    for _ in range(jenv.n_substeps - 1):
        _, jq1, jv1 = fn(jq1, jv1, ctrl)
    Q, V, C = map(torch.from_numpy, (q, v, ctrl))
    origins, rots = ts.fk(m, Q)
    coms, com_rots = ts.body_coms(m, Q)
    for got, want, what in [(origins, jo, "fk origins"), (rots, jR, "fk rotations"),
                            (coms, jc, "COMs"), (com_rots, jcR, "COM rotations"),
                            (ts.contact_points(m, Q), jcp, "contact points"),
                            (ts.integrate_qpos(m, Q, V, jenv.substep_dt), jint, "integrate_qpos")]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=POS_ATOL, err_msg=what)
    dcoms, omega = ts.com_velocities(m, Q, V)
    _rel(dcoms, jcd, LIN_RTOL, "COM velocities")
    _rel(omega, jw, LIN_RTOL, "body angular velocities")
    _rel(ts.lift_velocity(m, Q, V), jlift, LIN_RTOL, "lift")
    _rel(ts.kinetic_energy(m, Q, V), jT, LIN_RTOL, "T")
    _rel(ts.mass_matrix(m, Q), jM, LIN_RTOL, "M")
    _rel(ts.bias_force(m, Q, V), jb, LIN_RTOL, "c")
    _rel(ts._applied_force(m, Q, V, C), ja, FORCE_RTOL, "applied")
    _rel(ts.forward_dynamics(m, Q, V, C), jf, FORCE_RTOL, "vdot")
    q1, v1 = ts.step_physics(m, Q, V, C, jenv.n_substeps, jenv.substep_dt)
    np.testing.assert_allclose(q1.numpy(), np.asarray(jq1), atol=Q_ATOL, err_msg="step q")
    np.testing.assert_allclose(v1.numpy(), np.asarray(jv1), atol=V_ATOL, err_msg="step v")
    # the step's v tolerance: each float32 engine lies within half of it
    # from a float64 run of the port's closed form
    _, v64 = ts.step_physics(m, Q.double(), V.double(), C.double(), jenv.n_substeps,
                             jenv.substep_dt)
    for side, got in (("port", v1.numpy()), ("jax", np.asarray(jv1))):
        assert np.abs(got - v64.numpy()).max() <= V_ATOL / 2, side
    # the injected rows do what they are for: contacts push, limits bite,
    # row 7's root is turned far, and the quaternions stay unit
    pen = m.con_radius - ts.contact_points(m, Q)[..., 2].numpy()
    assert (pen[2:5] > 0).any(axis=1).all() and not (pen[[0, 1, 5, 6, 7]] > 0).any()
    j = np.flatnonzero(m.limited)[-1]
    qa = m.jnt_qposadr[j]
    assert q[5, qa] > m.range_hi[j] and q[6, qa] < m.range_lo[j]
    assert abs(q[7, 3]) < 0.4
    np.testing.assert_allclose(np.linalg.norm(q1[:, 3:7].numpy(), axis=1), 1.0, atol=1e-6)


@pytest.mark.parametrize("asset", ASSETS)
def test_mass_matrix_bias_and_coms_match_mujoco(asset):
    mjm = mujoco.MjModel.from_xml_path(_gym_xml(asset))
    d = mujoco.MjData(mjm)
    m = ts.load_model(asset)
    q, v, _ = _rows(m, seed=3)
    rows = [0, 1, 5, 7]  # airborne: rigid-body terms only
    Q, V = map(torch.from_numpy, (q[rows], v[rows]))
    M, c = ts.mass_matrix(m, Q).numpy(), ts.bias_force(m, Q, V).numpy()
    coms = ts.body_coms(m, Q)[0].numpy()
    for i, r in enumerate(rows):
        d.qpos[:], d.qvel[:] = q[r], v[r]
        mujoco.mj_forward(mjm, d)
        full = np.zeros((mjm.nv, mjm.nv))
        mujoco.mj_fullM(mjm, d, full)
        bias = np.zeros(mjm.nv)
        mujoco.mj_rne(mjm, d, 0, bias)
        np.testing.assert_allclose(M[i], full, atol=2e-4, rtol=2e-4, err_msg="M vs mj_fullM")
        np.testing.assert_allclose(c[i], bias, atol=2e-2, rtol=1e-3, err_msg="c vs mj_rne")
        np.testing.assert_allclose(coms[i], d.xipos[1:], atol=1e-5, err_msg="COMs vs xipos")


def test_energy_and_substep_are_consistent():
    """T = ½ vᵀMv > 0, and one substep of step_physics is semi-implicit
    Euler on forward_dynamics followed by integrate_qpos."""
    m = ts.load_model("humanoid.xml")
    q, v, ctrl = map(torch.from_numpy, _rows(m, seed=5))
    T = ts.kinetic_energy(m, q, v)
    M = ts.mass_matrix(m, q)
    torch.testing.assert_close(T, 0.5 * torch.einsum("ni,nij,nj->n", v, M, v), rtol=1e-5, atol=1e-5)
    assert (T > 0).all()
    dt = 0.0015
    q1, v1 = ts.step_physics(m, q, v, ctrl, 1, dt)
    v_want = v + dt * ts.forward_dynamics(m, q, v, ctrl)
    torch.testing.assert_close(v1, v_want)
    torch.testing.assert_close(q1, ts.integrate_qpos(m, q, v_want, dt))


def test_a_free_joint_must_lead_its_body():
    m = ts.load_model("ant.xml")
    bad = m._replace(jnt_body=np.array([0, 0] + list(m.jnt_body[2:]), m.jnt_body.dtype),
                     jnt_type=np.array([1, 0] + list(m.jnt_type[2:]), m.jnt_type.dtype))
    with pytest.raises(ValueError, match="a free joint must be its body's first"):
        ts.fk(bad, torch.zeros(1, m.nq))


def test_sinc_is_the_normalised_sinc_on_both_sides():
    """The reference the tests read: jnp.sinc is the normalised sinc, as
    torch.sinc is (the quaternion exponential relies on both)."""
    x = np.linspace(-2.0, 2.0, 9, dtype=np.float32)
    np.testing.assert_allclose(np.asarray(jnp.sinc(x)), torch.sinc(torch.from_numpy(x)).numpy(),
                               atol=1e-7)
