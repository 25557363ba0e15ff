"""Planar articulated-body physics on the device, batched over N envs
(counterpart of ``d4pg_tpu/envs/planar.py``).

The model is a planar kinematic tree (x-z plane, rotations about +y):
bodies, slide and hinge joints, actuators and contact spheres, read from a
gymnasium MJCF by :func:`extract_planar_model`. The envs never compile the
MJCF at run time: they load the committed snapshot of its data
(``envs/assets/<asset>.npz``, written by ``d4pg_tpu_torch/tools/
extract_planar.py``) with :func:`load_model`, so no machine needs
``mujoco`` or ``gymnasium`` to run them.

The JAX package derives the dynamics from the Lagrangian by autodiff:
``M = ∂²T/∂q̇²`` with ``jax.hessian``, the bias force from ``jacfwd`` of
``∂T/∂q̇`` and ``J_cᵀf`` with ``jax.vjp``. T is exactly quadratic in q̇,
so the same quantities follow in closed form from the Jacobian of the
forward kinematics, which is what this module computes:

- every point of the tree (a body's origin, its COM, a contact sphere) is
  a signed sum of *elements* ``e_k = R(φ_k)·v_k·m_k``: a constant vector
  ``v_k`` turned by an angle ``φ_k`` that is linear in ``q − qpos0``, with
  ``m_k`` either 1 or the displacement of one slide joint. The element
  table is built once from the model (:class:`_Plan`);
- ``∂e_k/∂q_j = S·e_k·A[j, k] + R(φ_k)·v_k·[j = slide_k]`` with
  ``S = dR/dφ·R⁻¹ = [[0, 1], [−1, 0]]``, and the velocity-product term
  ``(∂²e_k/∂q²)[q̇, q̇] = −e_k·ω_k² + 2·ω_k·ṁ_k·S·R(φ_k)·v_k``;
- ``M = Σ_b m_b·J_bᵀJ_b + Σ_b I_b·a_b·a_bᵀ + diag(armature)`` over the
  body COM Jacobians J_b and the (constant) angle rows a_b, and the bias
  ``c = Σ_b m_b·J_bᵀ·(J̇_b·q̇) + g·Σ_b m_b·J_b[z]``, which equal the
  Euler-Lagrange terms of the JAX version;
- contacts: penalty normal force and tanh-regularised Coulomb friction
  at every contact sphere, mapped through ``J_cᵀ``, as in the JAX version.

Every function takes a batch: q and q̇ are [N, NJ], tau [N, NU]. The
solve uses ``torch.linalg.solve_ex(..., check_errors=False)``, which does
not read back from the device (``torch.linalg.solve`` checks for
singularity and does). Integration is semi-implicit Euler over a Python
loop of substeps (the JAX ``lax.scan``).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Tuple

import numpy as np
import torch

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")


class PlanarModel(NamedTuple):
    """Static description of a planar kinematic tree (x-z plane, rotations
    about +y); the fields of ``d4pg_tpu/envs/planar.py:PlanarModel``, as
    numpy arrays and floats."""

    # tree structure (movable bodies only; index 0 = first child of world)
    parent: np.ndarray        # [NB] int, -1 = world
    body_pos: np.ndarray      # [NB, 2] frame offset in parent frame (x, z)
    # joints, in MuJoCo joint order (= qpos order)
    jnt_body: np.ndarray      # [NJ] int body index
    jnt_type: np.ndarray      # [NJ] 0 = slide, 1 = hinge
    jnt_axis: np.ndarray      # [NJ, 2] slide axis in joint frame (slides)
    jnt_sign: np.ndarray      # [NJ] hinge sign (axis·ŷ)
    jnt_pos: np.ndarray       # [NJ, 2] hinge anchor in body frame
    qpos0: np.ndarray         # [NJ] joint reference: displacement is q − qpos0
    # per-body mass properties
    mass: np.ndarray          # [NB]
    ipos: np.ndarray          # [NB, 2] COM in body frame
    inertia_y: np.ndarray     # [NB] ŷᵀ I ŷ (planar rotational inertia)
    # per-dof passive/actuation parameters
    armature: np.ndarray      # [NJ]
    damping: np.ndarray       # [NJ]
    stiffness: np.ndarray     # [NJ] spring toward spring_ref
    spring_ref: np.ndarray    # [NJ]
    limited: np.ndarray       # [NJ] bool
    range_lo: np.ndarray      # [NJ]
    range_hi: np.ndarray      # [NJ]
    gear: np.ndarray          # [NU] actuator gear
    act_dof: np.ndarray       # [NU] int dof driven by each actuator
    # contact spheres (capsule endpoints)
    con_body: np.ndarray      # [NC] int body index
    con_pos: np.ndarray       # [NC, 2] point in body frame
    con_radius: np.ndarray    # [NC]
    friction: np.ndarray      # [NC] sliding friction coefficient
    # world / integration
    gravity: float
    timestep: float           # physics dt (MuJoCo opt.timestep)
    # contact penalty parameters (the JAX package's calibrated defaults)
    contact_stiffness: float
    contact_damping: float
    slip_vel: float           # tanh friction regularization scale [m/s]
    limit_stiffness: float    # one-sided joint-limit spring
    limit_damping: float


SCALARS = (
    "gravity", "timestep", "contact_stiffness", "contact_damping", "slip_vel",
    "limit_stiffness", "limit_damping",
)


def _quat_y_angle(q: np.ndarray) -> float:
    """Rotation angle about +y of a (w,x,y,z) quaternion that is a pure
    y-rotation (all planar-model geom/body quats are)."""
    return 2.0 * np.arctan2(q[2], q[0])


def extract_planar_model(
    xml_path: str,
    contact_stiffness: float = 60_000.0,
    contact_damping: float = 350.0,
    slip_vel: float = 0.05,
    limit_stiffness: float = 400.0,
    limit_damping: float = 4.0,
) -> PlanarModel:
    """Build a :class:`PlanarModel` from a planar MJCF via the host MuJoCo
    compiler (model data only). Needs ``mujoco``; the envs do not call
    this, they load the snapshot (:func:`load_model`).

    Requires every hinge axis ∥ ±y, every slide axis in the x-z plane, and
    capsule/sphere collision geoms (true for gym's halfcheetah, hopper,
    walker2d)."""
    import mujoco

    m = mujoco.MjModel.from_xml_path(xml_path)
    nb = m.nbody - 1  # drop world

    def b2i(mj_body: int) -> int:
        return mj_body - 1

    parent = np.array([b2i(m.body_parentid[b + 1]) for b in range(nb)])
    body_pos = np.array([[m.body_pos[b + 1][0], m.body_pos[b + 1][2]] for b in range(nb)])
    mass = np.array([m.body_mass[b + 1] for b in range(nb)])
    ipos = np.array([[m.body_ipos[b + 1][0], m.body_ipos[b + 1][2]] for b in range(nb)])
    inertia_y = np.empty(nb)
    for b in range(nb):
        quat = m.body_iquat[b + 1]
        R = np.zeros((3, 3))
        mujoco.mju_quat2Mat(R.reshape(-1), quat)
        I_world = R @ np.diag(m.body_inertia[b + 1]) @ R.T
        inertia_y[b] = I_world[1, 1]

    nj = m.njnt
    jnt_body = np.array([b2i(m.jnt_bodyid[j]) for j in range(nj)])
    jnt_type = np.empty(nj, np.int64)
    jnt_axis = np.zeros((nj, 2))
    jnt_sign = np.ones(nj)
    jnt_pos = np.array([[m.jnt_pos[j][0], m.jnt_pos[j][2]] for j in range(nj)])
    for j in range(nj):
        ax = m.jnt_axis[j]
        if m.jnt_type[j] == mujoco.mjtJoint.mjJNT_SLIDE:
            if abs(ax[1]) > 1e-9:
                raise ValueError(f"slide joint {j} axis {ax} leaves the x-z plane")
            jnt_type[j] = 0
            jnt_axis[j] = [ax[0], ax[2]]
        elif m.jnt_type[j] == mujoco.mjtJoint.mjJNT_HINGE:
            if abs(ax[0]) > 1e-9 or abs(ax[2]) > 1e-9:
                raise ValueError(f"hinge joint {j} axis {ax} is not ±y")
            jnt_type[j] = 1
            jnt_sign[j] = np.sign(ax[1])
        else:
            raise ValueError(f"joint {j}: only slide/hinge supported")

    con_body, con_pos, con_radius, friction = [], [], [], []
    for g in range(m.ngeom):
        b = m.geom_bodyid[g]
        if b == 0:  # world geoms = the floor plane itself
            continue
        gtype = m.geom_type[g]
        gpos = np.array([m.geom_pos[g][0], m.geom_pos[g][2]])
        if gtype == mujoco.mjtGeom.mjGEOM_CAPSULE:
            alpha = _quat_y_angle(m.geom_quat[g])
            # capsule local axis is z; under R_y(α): ẑ → (sin α, cos α)
            axis2 = np.array([np.sin(alpha), np.cos(alpha)])
            half = m.geom_size[g][1]
            ends = [gpos - half * axis2, gpos + half * axis2]
        elif gtype == mujoco.mjtGeom.mjGEOM_SPHERE:
            ends = [gpos]
        else:
            raise ValueError(f"geom {g}: only capsule/sphere collide in planar")
        for e in ends:
            con_body.append(b2i(b))
            con_pos.append(e)
            con_radius.append(m.geom_size[g][0])
            friction.append(m.geom_friction[g][0])

    nu = m.nu
    gear = np.array([m.actuator_gear[u][0] for u in range(nu)])
    act_dof = np.array([m.actuator_trnid[u][0] for u in range(nu)])

    return PlanarModel(
        parent=parent,
        body_pos=body_pos,
        jnt_body=jnt_body,
        jnt_type=jnt_type,
        jnt_axis=jnt_axis,
        jnt_sign=jnt_sign,
        jnt_pos=jnt_pos,
        qpos0=np.array(m.qpos0),
        mass=mass,
        ipos=ipos,
        inertia_y=inertia_y,
        armature=np.array(m.dof_armature),
        damping=np.array(m.dof_damping),
        stiffness=np.array([m.jnt_stiffness[j] for j in range(nj)]),
        spring_ref=np.array([m.qpos_spring[j] for j in range(nj)]),
        limited=np.array([bool(m.jnt_limited[j]) for j in range(nj)]),
        range_lo=np.array([m.jnt_range[j][0] for j in range(nj)]),
        range_hi=np.array([m.jnt_range[j][1] for j in range(nj)]),
        gear=gear,
        act_dof=act_dof,
        con_body=np.array(con_body),
        con_pos=np.array(con_pos),
        con_radius=np.array(con_radius),
        friction=np.array(friction),
        gravity=float(-m.opt.gravity[2]),
        timestep=float(m.opt.timestep),
        contact_stiffness=contact_stiffness,
        contact_damping=contact_damping,
        slip_vel=slip_vel,
        limit_stiffness=limit_stiffness,
        limit_damping=limit_damping,
    )


def save_model(model: PlanarModel, path: str) -> None:
    """Write every field of ``model`` to one ``.npz`` (arrays as they are,
    the scalars as 0-d float64 arrays)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:  # a file object: savez appends no suffix
        np.savez(f, **{k: np.asarray(v) for k, v in model._asdict().items()})
    os.replace(tmp, path)


def load_model(asset: str) -> PlanarModel:
    """The committed snapshot of ``asset`` (e.g. ``half_cheetah.xml``):
    ``envs/assets/half_cheetah.npz``."""
    path = os.path.join(ASSETS, os.path.splitext(asset)[0] + ".npz")
    with np.load(path) as z:
        fields = {k: z[k] for k in PlanarModel._fields}
    for k in SCALARS:
        fields[k] = float(fields[k])
    return PlanarModel(**fields)


class _Plan:
    """The model's element table and constants on one device.

    An element is ``R(dq·A[:, k])·V[k]·mult_k``; ``mult_k`` is 1, or
    ``dq[slide[k]]`` for the slide joint that placed it. Each point of the
    tree is a signed sum of elements: ``C_origin`` for the body origins,
    ``C_point`` for the body COMs followed by the contact spheres."""

    def __init__(self, model: PlanarModel, device, dtype=torch.float32):
        nb, nj = len(model.parent), len(model.jnt_body)
        angles, vecs, slides = [], [], []

        def element(a, v, slide=-1):
            angles.append(a.copy())
            vecs.append(np.asarray(v, np.float64))
            slides.append(slide)
            return len(vecs) - 1

        joints_of = [[] for _ in range(nb)]
        for j in range(nj):
            joints_of[int(model.jnt_body[j])].append(j)
        origin_terms, body_angle = [None] * nb, [None] * nb
        for b in range(nb):
            p = int(model.parent[b])
            terms = [] if p < 0 else list(origin_terms[p])
            a = np.zeros(nj) if p < 0 else body_angle[p].copy()
            terms.append((1.0, element(a, model.body_pos[b])))
            for j in joints_of[b]:
                if int(model.jnt_type[j]) == 0:  # slide along the axis
                    terms.append((1.0, element(a, model.jnt_axis[j], j)))
                else:  # hinge about its anchor jnt_pos
                    terms.append((1.0, element(a, model.jnt_pos[j])))
                    a = a.copy()
                    a[j] += model.jnt_sign[j]
                    terms.append((-1.0, element(a, model.jnt_pos[j])))
            origin_terms[b], body_angle[b] = terms, a
        point_terms = [
            origin_terms[b] + [(1.0, element(body_angle[b], model.ipos[b]))]
            for b in range(nb)
        ]
        for c in range(len(model.con_body)):
            b = int(model.con_body[c])
            point_terms.append(
                origin_terms[b] + [(1.0, element(body_angle[b], model.con_pos[c]))]
            )
        E = len(vecs)

        def coef(term_lists):
            C = np.zeros((len(term_lists), E))
            for i, terms in enumerate(term_lists):
                for sgn, k in terms:
                    C[i, k] += sgn
            return C

        slide = np.array(slides)
        sel = np.zeros((E, nj))  # one-hot of each element's slide joint
        sel[slide >= 0, slide[slide >= 0]] = 1.0
        body_A = np.stack(body_angle, axis=1)  # [NJ, NB]
        rot_M = (body_A * model.inertia_y) @ body_A.T + np.diag(model.armature)
        gear = np.zeros((len(model.gear), nj))
        gear[np.arange(len(model.gear)), model.act_dof] = model.gear

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=device)

        self.nb, self.nc = nb, len(model.con_body)
        self.qpos0 = t(model.qpos0)
        self.A = t(np.stack(angles, axis=1))          # [NJ, E]
        self.V = t(np.stack(vecs))                    # [E, 2]
        # column NJ of the padded dq is 1: non-slide elements multiply by 1
        self.mult_idx = torch.as_tensor(np.where(slide >= 0, slide, nj), device=device)
        self.sel = t(sel)                             # [E, NJ]
        self.C_origin = t(coef(origin_terms))         # [NB, E]
        self.C_point = t(coef(point_terms))           # [NB + NC, E]
        self.body_A = t(body_A)                       # [NJ, NB]
        self.mass = t(model.mass)
        self.rot_M = t(rot_M)                         # [NJ, NJ], q-independent
        self.gear = t(gear)                           # [NU, NJ]
        self.stiffness = t(model.stiffness)
        self.spring_ref = t(model.spring_ref)
        self.damping = t(model.damping)
        self.limited = t(model.limited.astype(np.float64))
        self.range_lo = t(model.range_lo)
        self.range_hi = t(model.range_hi)
        self.con_radius = t(model.con_radius)
        self.friction = t(model.friction)


_PLANS: dict = {}


def _plan(model: PlanarModel, device) -> _Plan:
    """The :class:`_Plan` of ``model`` on ``device``, built on first use
    (its constants are copied to the device then, never inside a step)."""
    key = (id(model), torch.device(device))
    hit = _PLANS.get(key)
    if hit is None or hit[0] is not model:
        hit = (model, _Plan(model, device))
        _PLANS[key] = hit
    return hit[1]


def _S(x: torch.Tensor) -> torch.Tensor:
    """S·(x, z) = (z, −x): the derivative of a rotation about +y, R'R⁻¹."""
    return torch.stack([x[..., 1], -x[..., 0]], dim=-1)


class _Kin(NamedTuple):
    e: torch.Tensor       # [N, E, 2] elements
    rv: torch.Tensor      # [N, E, 2] R(φ)·V (the element before its slide multiplier)
    dq: torch.Tensor      # [N, NJ] q − qpos0


def _elements(plan: _Plan, q: torch.Tensor) -> _Kin:
    dq = q - plan.qpos0
    phi = dq @ plan.A
    c, s = torch.cos(phi), torch.sin(phi)
    vx, vz = plan.V[:, 0], plan.V[:, 1]
    rv = torch.stack([c * vx + s * vz, c * vz - s * vx], dim=-1)
    padded = torch.cat([dq, torch.ones_like(dq[:, :1])], dim=-1)
    e = rv * padded[:, plan.mult_idx, None]
    return _Kin(e, rv, dq)


def _point_jacobians(plan: _Plan, kin: _Kin) -> torch.Tensor:
    """[N, NB + NC, 2, NJ]: ∂(COMs, contact points)/∂q."""
    Je = _S(kin.e)[..., None] * plan.A.T[:, None, :] + kin.rv[..., None] * plan.sel[:, None, :]
    return torch.einsum("pe,nexj->npxj", plan.C_point, Je)


def fk(model: PlanarModel, q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kinematics: world origins [N, NB, 2] and angles [N, NB]."""
    plan = _plan(model, q.device)
    kin = _elements(plan, q)
    return torch.einsum("be,nex->nbx", plan.C_origin, kin.e), kin.dq @ plan.body_A


def body_coms(model: PlanarModel, q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """World COM positions [N, NB, 2] and body angles [N, NB]."""
    plan = _plan(model, q.device)
    kin = _elements(plan, q)
    coms = torch.einsum("be,nex->nbx", plan.C_point[: plan.nb], kin.e)
    return coms, kin.dq @ plan.body_A


def contact_points(model: PlanarModel, q: torch.Tensor) -> torch.Tensor:
    """World positions [N, NC, 2] of all contact spheres."""
    plan = _plan(model, q.device)
    kin = _elements(plan, q)
    return torch.einsum("ce,nex->ncx", plan.C_point[plan.nb:], kin.e)


def _mass_matrix(plan: _Plan, J: torch.Tensor) -> torch.Tensor:
    Jb = J[:, : plan.nb]
    return torch.einsum("b,nbxi,nbxj->nij", plan.mass, Jb, Jb) + plan.rot_M


def kinetic_energy(model: PlanarModel, q: torch.Tensor, qd: torch.Tensor) -> torch.Tensor:
    """T(q, q̇) = ½ q̇ᵀ M(q) q̇ [N] (armature included)."""
    M = mass_matrix(model, q)
    return 0.5 * torch.einsum("ni,nij,nj->n", qd, M, qd)


def potential_energy(model: PlanarModel, q: torch.Tensor) -> torch.Tensor:
    coms, _ = body_coms(model, q)
    plan = _plan(model, q.device)
    return model.gravity * (coms[..., 1] * plan.mass).sum(-1)


def mass_matrix(model: PlanarModel, q: torch.Tensor) -> torch.Tensor:
    """M(q) [N, NJ, NJ] = ∂²T/∂q̇² (matches mj_fullM)."""
    plan = _plan(model, q.device)
    return _mass_matrix(plan, _point_jacobians(plan, _elements(plan, q)))


def _bias(plan: _Plan, model: PlanarModel, kin: _Kin, J: torch.Tensor, qd: torch.Tensor):
    """c(q, q̇) [N, NJ]: Coriolis/centrifugal plus gravity."""
    omega = qd @ plan.A                                     # [N, E] φ̇
    mdot = qd @ plan.sel.T                                  # [N, E] ṁ (0 off slides)
    acc_e = -kin.e * (omega**2)[..., None] + (2.0 * omega * mdot)[..., None] * _S(kin.rv)
    acc = torch.einsum("be,nex->nbx", plan.C_point[: plan.nb], acc_e)  # J̇q̇ per COM
    Jb = J[:, : plan.nb]
    c = torch.einsum("b,nbxj,nbx->nj", plan.mass, Jb, acc)
    return c + model.gravity * torch.einsum("b,nbj->nj", plan.mass, Jb[:, :, 1])


def bias_force(model: PlanarModel, q: torch.Tensor, qd: torch.Tensor) -> torch.Tensor:
    """c(q, q̇) with M(q)q̈ + c(q, q̇) = τ_applied (matches mj_rne, flg_acc=0)."""
    plan = _plan(model, q.device)
    kin = _elements(plan, q)
    return _bias(plan, model, kin, _point_jacobians(plan, kin), qd)


def _applied(plan: _Plan, model: PlanarModel, kin: _Kin, J: torch.Tensor, q, qd, tau):
    # actuation (gear·ctrl onto the actuated dofs)
    f = tau @ plan.gear
    # passive joint spring + damper (MuJoCo qfrc_passive)
    f = f - plan.stiffness * (q - plan.spring_ref) - plan.damping * qd
    # joint limits: stiff one-sided spring, damped only when moving outward
    over = torch.clamp_min(q - plan.range_hi, 0.0)
    under = torch.clamp_min(plan.range_lo - q, 0.0)
    f = f - plan.limited * model.limit_stiffness * (over - under)
    outside = ((over > 0) | (under > 0)).to(q.dtype)
    f = f - plan.limited * model.limit_damping * qd * outside
    # ground contact: penalty normal + regularized Coulomb friction at every
    # contact sphere, mapped to generalized coords through J_cᵀ
    Jc = J[:, plan.nb:]
    points = torch.einsum("ce,nex->ncx", plan.C_point[plan.nb:], kin.e)
    vels = torch.einsum("ncxj,nj->ncx", Jc, qd)
    pen = torch.clamp_min(plan.con_radius - points[..., 1], 0.0)  # −(gap to z=0)
    active = (pen > 0.0).to(q.dtype)
    fn = torch.clamp_min(
        model.contact_stiffness * pen - model.contact_damping * vels[..., 1] * active, 0.0
    )
    ft = -plan.friction * fn * torch.tanh(vels[..., 0] / model.slip_vel)
    return f + torch.einsum("ncxj,ncx->nj", Jc, torch.stack([ft, fn], dim=-1))


def _applied_force(
    model: PlanarModel, q: torch.Tensor, qd: torch.Tensor, tau: torch.Tensor
) -> torch.Tensor:
    """All generalized forces except bias [N, NJ]: actuation, passive
    spring/damper, joint-limit penalty, ground contact."""
    plan = _plan(model, q.device)
    kin = _elements(plan, q)
    return _applied(plan, model, kin, _point_jacobians(plan, kin), q, qd, tau)


def forward_dynamics(
    model: PlanarModel, q: torch.Tensor, qd: torch.Tensor, tau: torch.Tensor
) -> torch.Tensor:
    """q̈ = M(q)⁻¹ (f_applied − c(q, q̇)) [N, NJ], one batched solve that
    does not read back from the device."""
    plan = _plan(model, q.device)
    kin = _elements(plan, q)
    J = _point_jacobians(plan, kin)
    rhs = _applied(plan, model, kin, J, q, qd, tau) - _bias(plan, model, kin, J, qd)
    return torch.linalg.solve_ex(_mass_matrix(plan, J), rhs, check_errors=False)[0]


def step_physics(
    model: PlanarModel,
    q: torch.Tensor,
    qd: torch.Tensor,
    tau: torch.Tensor,
    n_substeps: int,
    substep_dt: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Semi-implicit Euler over ``n_substeps`` substeps (torque held)."""
    for _ in range(n_substeps):
        qdd = forward_dynamics(model, q, qd, tau)
        qd = qd + substep_dt * qdd
        q = q + substep_dt * qd
    return q, qd
