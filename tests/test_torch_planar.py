"""The port's planar engine (``d4pg_tpu_torch/envs/planar.py``) and its
model snapshots against the JAX package's, on the CPU.

- Each committed snapshot ``envs/assets/<asset>.npz`` equals, field by
  field, dtype and value, what ``d4pg_tpu.envs.planar.extract_planar_model``
  returns for the installed gymnasium asset (and so does the port's own
  extraction).
- FK, COMs, contact points, M, c, the applied forces and q̈ of the port's
  closed form equal the JAX package's autodiff ones at injected
  numpy-seeded states: airborne rows, rows in ground contact, and rows past
  a joint's upper and lower limits. Each JAX function is jitted once per
  asset (a module-scoped fixture); eager JAX would cost seconds per call.
- M and c of the port also equal MuJoCo's own ``mj_fullM`` and ``mj_rne``
  (the JAX package's correctness bar, tests/test_planar.py).

Tolerances (float32 on both sides, different summation orders):
positions and angles atol 1e-6 (metres and radians of order 1); M and c
within 1e-6 of their largest entry (about 8 ulps); the applied forces and
q̈, which carry the 60 000 N/m contact stiffness, within 1e-5 of their
largest entry. Against MuJoCo (float64) the JAX package's own bounds
(tests/test_planar.py): M atol and rtol 2e-4, c atol 5e-3 and rtol 1e-3.
"""

import os

import jax
import numpy as np
import pytest
import torch

mujoco = pytest.importorskip("mujoco")

from d4pg_tpu.envs import planar as jp  # noqa: E402
from d4pg_tpu.envs.locomotion import _gym_xml  # noqa: E402
from d4pg_tpu_torch.envs import planar as tp  # noqa: E402

ASSETS = ["half_cheetah.xml", "hopper.xml", "walker2d.xml"]
POS_ATOL = 1e-6
MC_RTOL = 1e-6       # of the largest entry: M, c
FORCE_RTOL = 1e-5    # of the largest entry: applied forces, q̈


def _states(model, seed=0):
    """Injected (q, q̇, τ) rows: 0-1 airborne, 2-4 in ground contact (the
    root lowered below the lowest sphere's contact height), 5 past the
    last limited joint's upper limit, 6 past its lower limit."""
    rng = np.random.default_rng(seed)
    nq, nu, N = len(model.qpos0), len(model.gear), 7
    q = np.tile(model.qpos0, (N, 1)) + rng.uniform(-0.3, 0.3, (N, nq))
    q[:2, 1] += 0.5
    qd = rng.normal(0.0, 1.0, (N, nq))
    for r in (2, 3, 4):
        pts = tp.contact_points(model, torch.tensor(q[r:r + 1], dtype=torch.float32))[0]
        gap = (pts[:, 1].numpy() - model.con_radius).min()
        q[r, 1] -= gap + 0.01 * (r - 1)
    j = np.flatnonzero(model.limited)[-1]
    q[5, j] = model.range_hi[j] + 0.05
    q[6, j] = model.range_lo[j] - 0.05
    tau = rng.uniform(-1.0, 1.0, (N, nu))
    return q.astype(np.float32), qd.astype(np.float32), tau.astype(np.float32)


@pytest.fixture(scope="module")
def jax_dynamics():
    """asset -> one jitted, vmapped JAX function of (q, q̇, τ), built once."""
    cache = {}

    def get(asset):
        if asset not in cache:
            m = jp.extract_planar_model(_gym_xml(asset))

            def one(q, qd, tau):
                return (
                    jp.fk(m, q), jp.body_coms(m, q), jp.contact_points(m, q),
                    jp.mass_matrix(m, q), jp.bias_force(m, q, qd),
                    jp._applied_force(m, q, qd, tau), jp.forward_dynamics(m, q, qd, tau),
                )

            cache[asset] = (m, jax.jit(jax.vmap(one)))
        return cache[asset]

    return get


@pytest.mark.parametrize("asset", ASSETS)
def test_snapshot_equals_the_reference_extraction(asset):
    want = jp.extract_planar_model(_gym_xml(asset))
    got = tp.load_model(asset)
    ours = tp.extract_planar_model(_gym_xml(asset))
    assert got._fields == want._fields
    for name in want._fields:
        w = np.asarray(getattr(want, name))
        for side in (got, ours):
            g = np.asarray(getattr(side, name))
            assert g.dtype == w.dtype and g.shape == w.shape, name
            np.testing.assert_array_equal(g, w, err_msg=name)
    path = os.path.join(tp.ASSETS, os.path.splitext(asset)[0] + ".npz")
    assert os.path.exists(path)


def test_halfcheetah_snapshot_sizes():
    m = tp.load_model("half_cheetah.xml")
    assert (len(m.parent), len(m.jnt_body), len(m.gear), len(m.con_body)) == (7, 9, 6, 16)
    assert all(isinstance(getattr(m, k), float) for k in tp.SCALARS) and len(tp.SCALARS) == 7


def _rel(got, want, rtol, what):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (what, err, np.abs(want).max())


@pytest.mark.parametrize("asset", ASSETS)
def test_dynamics_match_the_reference(asset, jax_dynamics):
    jm, fn = jax_dynamics(asset)
    m = tp.load_model(asset)
    q, qd, tau = _states(m)
    (jo, jth), (jc, jbth), jcp, jM, jb, ja, jf = fn(q, qd, tau)
    Q, QD, TAU = map(torch.from_numpy, (q, qd, tau))
    origins, thetas = tp.fk(m, Q)
    coms, body_th = tp.body_coms(m, Q)
    for got, want, what in [(origins, jo, "fk origins"), (thetas, jth, "fk angles"),
                            (coms, jc, "COMs"), (body_th, jbth, "COM angles"),
                            (tp.contact_points(m, Q), jcp, "contact points")]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=POS_ATOL, err_msg=what)
    _rel(tp.mass_matrix(m, Q), jM, MC_RTOL, "M")
    _rel(tp.bias_force(m, Q, QD), jb, MC_RTOL, "c")
    _rel(tp._applied_force(m, Q, QD, TAU), ja, FORCE_RTOL, "applied")
    _rel(tp.forward_dynamics(m, Q, QD, TAU), jf, FORCE_RTOL, "qdd")
    # the injected rows do what they are for: contacts push, limits bite
    pen = m.con_radius - tp.contact_points(m, Q)[..., 1].numpy()
    assert (pen[2:5] > 0).any(axis=1).all() and not (pen[:2] > 0).any()
    j = np.flatnonzero(m.limited)[-1]
    assert q[5, j] > m.range_hi[j] and q[6, j] < m.range_lo[j]


@pytest.mark.parametrize("asset", ASSETS)
def test_mass_matrix_and_bias_match_mujoco(asset):
    mjm = mujoco.MjModel.from_xml_path(_gym_xml(asset))
    d = mujoco.MjData(mjm)
    m = tp.load_model(asset)
    q, qd, _ = _states(m, seed=3)
    Q, QD = map(torch.from_numpy, (q, qd))
    M, c = tp.mass_matrix(m, Q).numpy(), tp.bias_force(m, Q, QD).numpy()
    for r in range(2):  # airborne rows: rigid-body terms only
        d.qpos[:], d.qvel[:] = q[r], qd[r]
        mujoco.mj_forward(mjm, d)
        full = np.zeros((mjm.nv, mjm.nv))
        mujoco.mj_fullM(mjm, d, full)
        bias = np.zeros(mjm.nv)
        mujoco.mj_rne(mjm, d, 0, bias)
        np.testing.assert_allclose(M[r], full, atol=2e-4, rtol=2e-4, err_msg="M vs mj_fullM")
        np.testing.assert_allclose(c[r], bias, atol=5e-3, rtol=1e-3, err_msg="c vs mj_rne")


def test_energy_and_step_are_consistent():
    """T = ½ q̇ᵀMq̇ > 0, V matches the COM heights, and a substep of
    step_physics is semi-implicit Euler on forward_dynamics."""
    m = tp.load_model("half_cheetah.xml")
    q, qd, tau = map(torch.from_numpy, _states(m, seed=5))
    T = tp.kinetic_energy(m, q, qd)
    assert (T > 0).all()
    coms, _ = tp.body_coms(m, q)
    V = tp.potential_energy(m, q)
    torch.testing.assert_close(V, m.gravity * (coms[..., 1] * torch.tensor(m.mass, dtype=torch.float32)).sum(-1))
    dt = 0.0025
    q1, qd1 = tp.step_physics(m, q, qd, tau, 1, dt)
    qdd = tp.forward_dynamics(m, q, qd, tau)
    torch.testing.assert_close(qd1, qd + dt * qdd)
    torch.testing.assert_close(q1, q + dt * (qd + dt * qdd))
