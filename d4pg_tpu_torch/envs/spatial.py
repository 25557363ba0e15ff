"""3D articulated-body physics on the device, batched over N envs
(counterpart of ``d4pg_tpu/envs/spatial.py``).

The model is a kinematic tree of bodies with free, hinge and slide joints,
actuators and contact spheres, read from a gymnasium MJCF by
:func:`extract_spatial_model`. The envs never compile the MJCF at run
time: they load the committed snapshot of its data (``envs/assets/
<asset>.npz``, written by ``d4pg_tpu_torch/tools/extract_spatial.py``)
with :func:`load_model`, so no machine needs ``mujoco`` or ``gymnasium``
to run them.

Conventions are MuJoCo's and the JAX package's: ``q`` [N, nq] holds a
free joint as world position + wxyz quaternion, ``v`` [N, nv] holds it as
world-frame linear velocity + BODY-frame angular velocity, and the tangent
lift maps ω to quaternion rates as ½·u ⊗ (0, ω). A free joint sets its
body's frame from ``q`` directly (the parent frame and ``body_pos`` are
ignored); several joints on one body compose in joint order.

The JAX package gets the dynamics from autodiff (``M = jax.hessian(T)``,
the bias from a ``jvp`` along the flow and a ``vjp``, the contact forces
through a ``vjp`` of the lifted point velocities). T is quadratic in v, so
the same quantities follow in closed form from the motion axes of the
dofs, which is what this module computes (spatial-vector algebra, all
bodies at once):

- FK: the tree is split into *links*, one per scalar joint, one per free
  joint and one per body without joints; each link's local transform is a
  4x4 homogeneous matrix that is linear in (sin Δq, 1 − cos Δq, Δq) for a
  hinge or a slide and in (position, u⊗u) for a free joint. The world
  transforms follow by pointer jumping over the link tree
  (⌈log₂ depth⌉ batched products, not one product a body);
- each dof d has a world motion axis S_d = (ω_d, v0_d): a hinge turns
  about its world axis through its world anchor, a slide (and a free
  joint's linear dof) translates, a free joint's angular dof turns about
  the body's own axis through its origin. ``ML[l, d]`` = 1 when dof d
  moves link l, so link velocities are ``V = ML·(v·S)`` and a point x of
  link l moves at ``ω_l × x + v0_l``;
- ``M = Σ_b m_b·J_bᵀJ_b + J_ωbᵀ·I_b·J_ωb + diag(armature)`` over the COM
  Jacobians J_b (world) and the angular Jacobians J_ωb (body frame);
- the bias is Newton–Euler at v̇ = 0: each dof's axis moves with its
  link, ``Ṡ_d = V_link(d) ×ₘ S_d``, so the link accelerations are
  ``ML·(v·Ṡ)``; per-body wrenches ``f = m·(c̈ + g ẑ)``, ``τ = I·ω̇ +
  ω × Iω`` pull back through ``S_dᵀ`` over the bodies each dof moves,
  and so do the contact forces. This is ``mj_rne(flg_acc=0)``;
- contacts: penalty spheres against the ground plane with isotropic
  tanh-regularised Coulomb friction, as in the JAX version (the documented
  deviations: penalty contacts, no self-collision).

Every function runs in its inputs' dtype (float32 in the envs; the tests
also take a float64 run as a reference). The solve uses
``torch.linalg.solve_ex(..., check_errors=False)``, which does not read
back from the device; on the card under the cuSOLVER/cuBLAS preference
(:func:`_capturable_solve`), since ATen's default picks MAGMA's batched
LU for these sizes (nv > 16 over more than 16 rows), which cannot be
captured in a CUDA graph (the on-device loop's programs). Integration is semi-implicit Euler
over a Python loop of substeps (the JAX ``lax.scan``); each quaternion is
rebuilt as ``u ⊗ exp(dt·ω)`` and renormalised.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Tuple

import numpy as np
import torch

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")

# joint type codes (the JAX package's, not MuJoCo's)
FREE, HINGE, SLIDE = 0, 1, 2


class SpatialModel(NamedTuple):
    """Static description of a 3D kinematic tree; the fields of
    ``d4pg_tpu/envs/spatial.py:SpatialModel``, as numpy arrays, ints and
    floats."""

    # tree structure (movable bodies only; index 0 = first child of world)
    parent: np.ndarray        # [NB] int, -1 = world
    body_pos: np.ndarray      # [NB, 3] frame offset in parent frame
    body_quat: np.ndarray     # [NB, 4] frame rotation in parent frame (wxyz)
    # joints, in MuJoCo joint order
    jnt_body: np.ndarray      # [NJ] int body index
    jnt_type: np.ndarray      # [NJ] FREE | HINGE | SLIDE
    jnt_axis: np.ndarray      # [NJ, 3] hinge/slide axis in body frame (unit)
    jnt_pos: np.ndarray       # [NJ, 3] hinge anchor in body frame
    jnt_qposadr: np.ndarray   # [NJ] int index into qpos
    jnt_dofadr: np.ndarray    # [NJ] int index into qvel
    qpos0: np.ndarray         # [NQ] joint reference (XML pose)
    nq: int
    nv: int
    # per-body mass properties
    mass: np.ndarray          # [NB]
    ipos: np.ndarray          # [NB, 3] COM in body frame
    inertia: np.ndarray       # [NB, 3, 3] inertia about the COM, body frame
    # per-dof / per-joint passive+actuation parameters
    armature: np.ndarray      # [NV]
    damping: np.ndarray       # [NV]
    stiffness: np.ndarray     # [NJ] spring toward spring_ref (scalar joints)
    spring_ref: np.ndarray    # [NJ]
    limited: np.ndarray       # [NJ] bool (scalar joints only)
    range_lo: np.ndarray      # [NJ]
    range_hi: np.ndarray      # [NJ]
    gear: np.ndarray          # [NU] actuator gear
    act_dof: np.ndarray       # [NU] int dof driven by each actuator
    ctrl_hi: np.ndarray       # [NU] ctrlrange upper bound (actions scale by it)
    # contact spheres (capsule endpoints + sphere geoms)
    con_body: np.ndarray      # [NC] int body index
    con_pos: np.ndarray       # [NC, 3] point in body frame
    con_radius: np.ndarray    # [NC]
    friction: np.ndarray      # [NC] sliding friction coefficient
    # world / integration
    gravity: float
    timestep: float
    # contact penalty parameters (the JAX package's calibrated defaults)
    contact_stiffness: float
    contact_damping: float
    slip_vel: float
    limit_stiffness: float
    limit_damping: float


SCALARS = (
    "gravity", "timestep", "contact_stiffness", "contact_damping", "slip_vel",
    "limit_stiffness", "limit_damping",
)
INTS = ("nq", "nv")


def extract_spatial_model(
    xml_path: str,
    contact_stiffness: float = 60_000.0,
    contact_damping: float = 350.0,
    slip_vel: float = 0.05,
    limit_stiffness: float = 400.0,
    limit_damping: float = 4.0,
) -> SpatialModel:
    """Build a :class:`SpatialModel` from a free/hinge/slide MJCF via the
    host MuJoCo compiler (model data only). Needs ``mujoco``; the envs do
    not call this, they load the snapshot (:func:`load_model`)."""
    import mujoco

    m = mujoco.MjModel.from_xml_path(xml_path)
    nb = m.nbody - 1  # drop world

    def b2i(mj_body: int) -> int:
        return mj_body - 1

    parent = np.array([b2i(m.body_parentid[b + 1]) for b in range(nb)])
    body_pos = np.array([m.body_pos[b + 1] for b in range(nb)])
    body_quat = np.array([m.body_quat[b + 1] for b in range(nb)])
    mass = np.array([m.body_mass[b + 1] for b in range(nb)])
    ipos = np.array([m.body_ipos[b + 1] for b in range(nb)])
    inertia = np.empty((nb, 3, 3))
    for b in range(nb):
        R = np.zeros(9)
        mujoco.mju_quat2Mat(R, m.body_iquat[b + 1])
        R = R.reshape(3, 3)
        inertia[b] = R @ np.diag(m.body_inertia[b + 1]) @ R.T

    nj = m.njnt
    jnt_body = np.array([b2i(m.jnt_bodyid[j]) for j in range(nj)])
    jnt_type = np.empty(nj, np.int64)
    for j in range(nj):
        t = m.jnt_type[j]
        if t == mujoco.mjtJoint.mjJNT_FREE:
            jnt_type[j] = FREE
        elif t == mujoco.mjtJoint.mjJNT_HINGE:
            jnt_type[j] = HINGE
        elif t == mujoco.mjtJoint.mjJNT_SLIDE:
            jnt_type[j] = SLIDE
        else:
            raise ValueError(f"joint {j}: ball joints not supported yet")

    con_body, con_pos, con_radius, friction = [], [], [], []
    for g in range(m.ngeom):
        b = m.geom_bodyid[g]
        if b == 0:
            continue
        gtype = m.geom_type[g]
        gpos = np.array(m.geom_pos[g])
        if gtype == mujoco.mjtGeom.mjGEOM_CAPSULE:
            R = np.zeros(9)
            mujoco.mju_quat2Mat(R, m.geom_quat[g])
            axis = R.reshape(3, 3)[:, 2]  # capsule local axis is z
            half = m.geom_size[g][1]
            ends = [gpos - half * axis, gpos + half * axis]
        elif gtype == mujoco.mjtGeom.mjGEOM_SPHERE:
            ends = [gpos]
        else:
            raise ValueError(f"geom {g}: only capsule/sphere collide in spatial")
        for e in ends:
            con_body.append(b2i(b))
            con_pos.append(e)
            con_radius.append(m.geom_size[g][0])
            friction.append(m.geom_friction[g][0])

    nu = m.nu
    act_jnt = [m.actuator_trnid[u][0] for u in range(nu)]

    return SpatialModel(
        parent=parent,
        body_pos=body_pos,
        body_quat=body_quat,
        jnt_body=jnt_body,
        jnt_type=jnt_type,
        jnt_axis=np.array(m.jnt_axis),
        jnt_pos=np.array(m.jnt_pos),
        jnt_qposadr=np.array(m.jnt_qposadr),
        jnt_dofadr=np.array(m.jnt_dofadr),
        qpos0=np.array(m.qpos0),
        nq=int(m.nq),
        nv=int(m.nv),
        mass=mass,
        ipos=ipos,
        inertia=inertia,
        armature=np.array(m.dof_armature),
        damping=np.array(m.dof_damping),
        stiffness=np.array(m.jnt_stiffness),
        spring_ref=np.array(
            [m.qpos_spring[m.jnt_qposadr[j]] for j in range(nj)]
        ),
        limited=np.array([bool(m.jnt_limited[j]) for j in range(nj)]),
        range_lo=np.array(m.jnt_range[:, 0]),
        range_hi=np.array(m.jnt_range[:, 1]),
        gear=np.array([m.actuator_gear[u][0] for u in range(nu)]),
        act_dof=np.array([m.jnt_dofadr[j] for j in act_jnt]),
        ctrl_hi=np.array(
            [
                m.actuator_ctrlrange[u][1]
                if m.actuator_ctrllimited[u]
                else 1.0
                for u in range(nu)
            ]
        ),
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


def save_model(model: SpatialModel, path: str) -> None:
    """Write every field of ``model`` to one ``.npz`` (arrays as they are,
    the ints and floats as 0-d arrays)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:  # a file object: savez appends no suffix
        np.savez(f, **{k: np.asarray(v) for k, v in model._asdict().items()})
    os.replace(tmp, path)


def load_model(asset: str) -> SpatialModel:
    """The committed snapshot of ``asset`` (e.g. ``humanoid.xml``):
    ``envs/assets/humanoid.npz``."""
    path = os.path.join(ASSETS, os.path.splitext(asset)[0] + ".npz")
    with np.load(path) as z:
        fields = {k: z[k] for k in SpatialModel._fields}
    for k in SCALARS:
        fields[k] = float(fields[k])
    for k in INTS:
        fields[k] = int(fields[k])
    return SpatialModel(**fields)


# ---------------------------------------------------------------------------
# SO(3) helpers (wxyz quaternions, matching MuJoCo), on [..., 4] batches
# ---------------------------------------------------------------------------


def _np_quat_mul(a, b):
    w1, v1, w2, v2 = a[0], a[1:], b[0], b[1:]
    return np.concatenate([[w1 * w2 - v1 @ v2], w1 * v2 + w2 * v1 + np.cross(v1, v2)])


def _np_quat_to_mat(u):
    w, x, y, z = u
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


_E4 = np.eye(4)
# (a ⊗ b)_i = Σ_jk QMUL[i, j, k]·a_j·b_k
QMUL = np.stack([np.stack([_np_quat_mul(_E4[j], _E4[k]) for k in range(4)], -1)
                 for j in range(4)], 1)
# quat_to_mat(u) = I + Σ_ab QMAT[:, :, a, b]·u_a·u_b (the symmetric part of
# the quadratic form of the formula, by polarisation)
QMAT = np.zeros((3, 3, 4, 4))
for _a in range(4):
    for _b in range(4):
        _f = (_np_quat_to_mat(_E4[_a] + _E4[_b]) - _np_quat_to_mat(_E4[_a])
              - _np_quat_to_mat(_E4[_b]) + np.eye(3))
        QMAT[:, :, _a, _b] = 0.5 * _f if _a != _b else _np_quat_to_mat(_E4[_a]) - np.eye(3)

_QUAT_CONSTS = {"QMUL": QMUL, "QMAT": QMAT}
_CONST: dict = {}


def _const(name: str, like: torch.Tensor) -> torch.Tensor:
    """``QMUL`` or ``QMAT`` on ``like``'s device and dtype, made once."""
    key = (name, like.device, like.dtype)
    if key not in _CONST:
        _CONST[key] = torch.as_tensor(_QUAT_CONSTS[name], dtype=like.dtype, device=like.device)
    return _CONST[key]


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of wxyz quaternions [..., 4]."""
    left = torch.einsum("...j,ijk->...ik", a, _const("QMUL", a))
    return (left @ b[..., None])[..., 0]


def quat_to_mat(u: torch.Tensor) -> torch.Tensor:
    """[..., 4] → [..., 3, 3], the JAX package's formula (exact for unit u)."""
    uu = u[..., :, None] * u[..., None, :]
    return torch.eye(3, dtype=u.dtype, device=u.device) + torch.einsum(
        "...ab,ijab->...ij", uu, _const("QMAT", u))


def _quat_exp(phi: torch.Tensor) -> torch.Tensor:
    """exp map: rotation vectors [..., 3] → unit quaternions (safe at ‖φ‖ → 0)."""
    half = 0.5 * torch.sqrt((phi**2).sum(-1, keepdim=True) + 1e-30)
    # sin(half)/half via the normalised sinc keeps the φ → 0 limit exact
    return torch.cat([torch.cos(half), 0.5 * phi * torch.sinc(half / torch.pi)], -1)


def _skew(k: np.ndarray) -> np.ndarray:
    return np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]])


def _homog(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, t
    return T


# ---------------------------------------------------------------------------
# The plan: the model's link tree and constants on one device
# ---------------------------------------------------------------------------


class _Plan:
    """The model's link tree, dof axes and constants on one device.

    Links, in slot order: one per scalar (hinge/slide) joint in joint
    order, one per free joint, one per body without joints, then the world
    (the identity, its own ancestor). A link's frame is the frame after its
    joint; a body's frame is its last link's."""

    def __init__(self, model: SpatialModel, device, dtype=torch.float32):
        nb, nj, nv = len(model.parent), len(model.jnt_body), int(model.nv)
        jtype = [int(t) for t in model.jnt_type]
        scalar = [j for j in range(nj) if jtype[j] != FREE]
        free = [j for j in range(nj) if jtype[j] == FREE]
        joints_of = [[] for _ in range(nb)]
        for j in range(nj):
            joints_of[int(model.jnt_body[j])].append(j)
        jointless = [b for b in range(nb) if not joints_of[b]]
        slot_of_joint = {j: i for i, j in enumerate(scalar)}
        slot_of_joint.update({j: len(scalar) + i for i, j in enumerate(free)})
        slot_of_body0 = {b: len(scalar) + len(free) + i for i, b in enumerate(jointless)}
        L = len(scalar) + len(free) + len(jointless)  # the world's slot

        parent_slot = np.full(L + 1, L)
        pre = {}                 # slot -> the constant 4x4 applied before the joint
        body_slot = [0] * nb
        for b in range(nb):
            p = int(model.parent[b])
            prev = L if p < 0 else body_slot[p]
            offset = _homog(_np_quat_to_mat(model.body_quat[b]), model.body_pos[b])
            if not joints_of[b]:
                s = slot_of_body0[b]
                parent_slot[s], pre[s] = prev, offset
                prev = s
            for i, j in enumerate(joints_of[b]):
                s = slot_of_joint[j]
                if jtype[j] == FREE:
                    if i:
                        raise ValueError(f"joint {j}: a free joint must be its body's first")
                    parent_slot[s] = L  # the free joint sets the frame from q
                else:
                    parent_slot[s], pre[s] = prev, offset if i == 0 else np.eye(4)
                prev = s
            body_slot[b] = prev

        # scalar links: T = pre·(I + sin Δq·B1 + (1 − cos Δq)·B2 + Δq·B3)
        s_C0 = np.zeros((len(scalar), 4, 4))
        s_Cb = np.zeros((len(scalar), 3, 4, 4))
        for i, j in enumerate(scalar):
            k, p = np.asarray(model.jnt_axis[j], np.float64), np.asarray(model.jnt_pos[j], np.float64)
            B = np.zeros((3, 4, 4))
            if jtype[j] == HINGE:  # Trans(p)·Rot(k, Δq)·Trans(−p)
                K = _skew(k)
                B[0, :3, :3], B[0, :3, 3] = K, -K @ p
                B[1, :3, :3], B[1, :3, 3] = K @ K, -(K @ K) @ p
            else:
                B[2, :3, 3] = k
            s_C0[i] = pre[i]
            s_Cb[i] = pre[i] @ B
        # free links: T = E + Σ pos_i·F_i + Σ u_a·u_b·F_ab
        f_B = np.zeros((19, 4, 4))
        for i in range(3):
            f_B[i, i, 3] = 1.0
        for a in range(4):
            for b in range(4):
                f_B[3 + 4 * a + b, :3, :3] = QMAT[:, :, a, b]
        # jointless bodies' constant links, then the world
        const = np.stack([pre[slot_of_body0[b]] for b in jointless] + [np.eye(4)])

        # pointer jumping: round r composes each link with its 2^r-th ancestor
        rounds, anc = [], parent_slot.copy()
        while (anc[:L] != L).any():
            rounds.append(anc.copy())
            anc = anc[anc]

        # dofs: the link each one's axis is fixed in, its axis α and anchor π
        # there, whether it turns, and the link whose subtree it moves
        dof_frame = np.zeros(nv, np.int64)
        dof_ap = np.zeros((nv, 4, 2))
        dof_ap[:, 3, 1] = 1.0
        rot = np.zeros(nv, bool)
        dof_joint_slot = np.zeros(nv, np.int64)
        for j in range(nj):
            da, s = int(model.jnt_dofadr[j]), slot_of_joint[j]
            if jtype[j] == FREE:
                for i in range(3):
                    dof_frame[da + i], dof_ap[da + i, i, 0] = L, 1.0       # world x, y, z
                    dof_frame[da + 3 + i], dof_ap[da + 3 + i, i, 0] = s, 1.0  # body axes
                    rot[da + 3 + i] = True
                dof_joint_slot[da:da + 6] = s
            else:
                dof_frame[da], dof_joint_slot[da] = s, s
                dof_ap[da, :3, 0] = model.jnt_axis[j]
                if jtype[j] == HINGE:
                    dof_ap[da, :3, 1] = model.jnt_pos[j]
                    rot[da] = True
        # ML[l, d] = 1 when dof d's joint link is link l or an ancestor of it
        anc_of = np.zeros((L + 1, L + 1), bool)
        for s in range(L):
            a = s
            while a != L:
                anc_of[s, a] = True
                a = parent_slot[a]
        ML = anc_of[:, dof_joint_slot].astype(np.float64)        # [L+1, NV]

        point_slot = np.array([body_slot[b] for b in range(nb)]
                              + [body_slot[int(b)] for b in model.con_body], np.int64)
        point_loc = np.concatenate([model.ipos, model.con_pos], 0)
        point_loc = np.concatenate([point_loc, np.ones((len(point_loc), 1))], 1)

        # the q and v layout of the joints
        nq = int(model.nq)
        lin_src = np.zeros(nq, np.int64)   # q slot <- v index (quaternion slots rebuilt)
        f_pos, f_quat, f_ang = [], [], []
        for j in range(nj):
            qa, da = int(model.jnt_qposadr[j]), int(model.jnt_dofadr[j])
            if jtype[j] == FREE:
                lin_src[qa:qa + 3] = np.arange(da, da + 3)
                f_pos += range(qa, qa + 3)
                f_quat += range(qa + 3, qa + 7)
                f_ang += range(da + 3, da + 6)
            else:
                lin_src[qa] = da

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=device)

        def ix(x):
            return torch.as_tensor(np.asarray(x, np.int64), device=device)

        self.nb, self.nf = nb, len(free)
        self.s_qadr = ix([model.jnt_qposadr[j] for j in scalar])
        self.s_dadr = ix([model.jnt_dofadr[j] for j in scalar])
        self.s_qpos0 = t([model.qpos0[model.jnt_qposadr[j]] for j in scalar])
        self.s_C0, self.s_Cb = t(s_C0), t(s_Cb)
        self.f_pos, self.f_quat, self.f_ang = ix(f_pos), ix(f_quat), ix(f_ang)
        self.f_B, self.eye4 = t(f_B), t(np.eye(4))
        self.const = t(const)                                   # [NK + 1, 4, 4]
        self.rounds = [ix(r) for r in rounds]
        self.body_slot = ix(body_slot)
        self.point_slot = ix(point_slot)                        # [NB + NC]
        self.point_loc = t(point_loc)                           # [NB + NC, 4]
        self.dof_frame = ix(dof_frame)
        self.dof_ap = t(dof_ap)                                 # [NV, 4, 2]
        self.rot = torch.as_tensor(rot, device=device)[:, None]  # [NV, 1] bool
        self.ML = t(ML)                                         # [L+1, NV]
        self.MP = t(ML[point_slot])                             # [NB + NC, NV]
        self.lin_src = ix(lin_src)
        self.mass = t(model.mass)
        self.inertia = t(model.inertia)
        self.armature = t(np.diag(model.armature))
        self.damping = t(model.damping)
        self.gravity = t([0.0, 0.0, model.gravity])
        self.act_dof = ix(model.act_dof)
        self.gear = t(model.gear)
        self.stiffness = t(model.stiffness[scalar])
        self.spring_ref = t(model.spring_ref[scalar])
        self.limited = t(np.asarray(model.limited[scalar], np.float64))
        self.range_lo = t(model.range_lo[scalar])
        self.range_hi = t(model.range_hi[scalar])
        self.con_radius = t(model.con_radius)
        self.friction = t(model.friction)


_PLANS: dict = {}


def _plan(model: SpatialModel, like: torch.Tensor) -> _Plan:
    """The :class:`_Plan` of ``model`` on ``like``'s device and dtype, built
    on first use (its constants are copied to the device then, never
    inside a step)."""
    key = (id(model), like.device, like.dtype)
    hit = _PLANS.get(key)
    if hit is None or hit[0] is not model:
        hit = (model, _Plan(model, like.device, like.dtype))
        _PLANS[key] = hit
    return hit[1]


# ---------------------------------------------------------------------------
# Kinematics
# ---------------------------------------------------------------------------


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def _world(plan: _Plan, q: torch.Tensor) -> torch.Tensor:
    """[N, L+1, 4, 4]: every link's world transform (the world last)."""
    n = q.shape[0]
    dq = q[:, plan.s_qadr] - plan.s_qpos0
    coef = torch.stack([torch.sin(dq), 1.0 - torch.cos(dq), dq], -1)   # [N, NS, 3]
    parts = [plan.s_C0 + torch.einsum("njk,jkab->njab", coef, plan.s_Cb)]
    if plan.nf:
        pos = q[:, plan.f_pos].view(n, plan.nf, 3)
        u = q[:, plan.f_quat].view(n, plan.nf, 4)
        feat = torch.cat([pos, (u[..., :, None] * u[..., None, :]).flatten(-2)], -1)
        parts.append(plan.eye4 + torch.einsum("nfk,kab->nfab", feat, plan.f_B))
    parts.append(plan.const.expand(n, -1, -1, -1))
    T = torch.cat(parts, 1)
    for anc in plan.rounds:
        T = T[:, anc] @ T
    return T


class _Kin(NamedTuple):
    T: torch.Tensor       # [N, L+1, 4, 4] link world transforms
    Tp: torch.Tensor      # [N, NB + NC, 4, 4] the transforms of the points' links
    x: torch.Tensor       # [N, NB + NC, 3] COMs, then contact points (world)
    w: torch.Tensor       # [N, NV, 3] ω_d: the dof's angular axis (0 for slides)
    S: torch.Tensor       # [N, NV, 6] (ω_d, v0_d), v0_d the motion of the world origin


def _kin(plan: _Plan, q: torch.Tensor) -> _Kin:
    T = _world(plan, q)
    Tp = T[:, plan.point_slot]
    x = (Tp @ plan.point_loc[:, :, None])[..., :3, 0]
    ap = torch.einsum("ndab,dbc->ndac", T[:, plan.dof_frame], plan.dof_ap)
    a, p = ap[..., :3, 0], ap[..., :3, 1]
    w = a * plan.rot
    # a turning dof moves the origin at p × ω; a sliding one along its axis
    v0 = torch.where(plan.rot, _cross(p, a), a)
    return _Kin(T, Tp, x, w, torch.cat([w, v0], -1))


def _velocities(plan: _Plan, kin: _Kin, v: torch.Tensor):
    """Link spatial velocities [N, L+1, 6] and the points' [N, NB + NC, 3]."""
    V = torch.einsum("ld,ndk->nlk", plan.ML, v[..., None] * kin.S)
    Vp = V[:, plan.point_slot]
    xd = _cross(Vp[..., :3], kin.x) + Vp[..., 3:]
    return V, Vp, xd


def lift_velocity(model: SpatialModel, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Tangent lift q̇ = L(q)·v [N, nq]: q̇ = v on scalar joints and a free
    joint's position, q̇_quat = ½·u ⊗ (0, ω_body)."""
    plan = _plan(model, q)
    out = v[:, plan.lin_src]
    if plan.nf:
        n = q.shape[0]
        u = q[:, plan.f_quat].view(n, plan.nf, 4)
        w = v[:, plan.f_ang].view(n, plan.nf, 3)
        qd = 0.5 * quat_mul(u, torch.cat([torch.zeros_like(w[..., :1]), w], -1))
        out = out.index_copy(1, plan.f_quat, qd.reshape(n, -1))
    return out


def fk(model: SpatialModel, q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kinematics: world origins [N, NB, 3] and rotations [N, NB, 3, 3]."""
    plan = _plan(model, q)
    Tb = _world(plan, q)[:, plan.body_slot]
    return Tb[..., :3, 3], Tb[..., :3, :3]


def body_coms(model: SpatialModel, q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """World COM positions [N, NB, 3] and rotations [N, NB, 3, 3]."""
    plan = _plan(model, q)
    T = _world(plan, q)
    Tb = T[:, plan.body_slot]
    coms = (Tb @ plan.point_loc[: plan.nb, :, None])[..., :3, 0]
    return coms, Tb[..., :3, :3]


def contact_points(model: SpatialModel, q: torch.Tensor) -> torch.Tensor:
    """World positions [N, NC, 3] of all contact spheres."""
    plan = _plan(model, q)
    T = _world(plan, q)
    Tc = T[:, plan.point_slot[plan.nb:]]
    return (Tc @ plan.point_loc[plan.nb:, :, None])[..., :3, 0]


def _body_frame(kin: _Kin, plan: _Plan, *world_vecs: torch.Tensor) -> torch.Tensor:
    """Rᵀ·u for world vectors u [N, NB, 3] of each body: [N, NB, len, 3]."""
    Rb = kin.Tp[:, : plan.nb, :3, :3]
    return torch.einsum("nbji,nbkj->nbki", Rb, torch.stack(world_vecs, -2))


def com_velocities(model: SpatialModel, q: torch.Tensor, v: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ċom [N, NB, 3] world, ω [N, NB, 3] BODY frame), linear in v."""
    plan = _plan(model, q)
    kin = _kin(plan, q)
    _, Vp, xd = _velocities(plan, kin, v)
    omega = _body_frame(kin, plan, Vp[:, : plan.nb, :3])[:, :, 0]
    return xd[:, : plan.nb], omega


def kinetic_energy(model: SpatialModel, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """T(q, v) [N] incl. rotor armature, quadratic in v."""
    plan = _plan(model, q)
    dcoms, omega = com_velocities(model, q, v)
    T = 0.5 * (plan.mass * (dcoms**2).sum(-1)).sum(-1)
    T = T + 0.5 * torch.einsum("nbi,bij,nbj->n", omega, plan.inertia, omega)
    return T + 0.5 * (torch.diagonal(plan.armature) * v**2).sum(-1)


# ---------------------------------------------------------------------------
# Dynamics
# ---------------------------------------------------------------------------


def _mass_matrix(plan: _Plan, kin: _Kin) -> torch.Tensor:
    MB = plan.MP[: plan.nb, :, None]                                     # [NB, NV, 1]
    c = kin.x[:, : plan.nb]
    Jc = MB * (_cross(kin.w[:, None], c[:, :, None]) + kin.S[:, None, :, 3:])   # [N, NB, NV, 3]
    Rb = kin.Tp[:, : plan.nb, :3, :3]
    Jw = MB * torch.einsum("nbji,ndj->nbdi", Rb, kin.w)                  # body frame
    IJw = torch.einsum("bij,nbdj->nbdi", plan.inertia, Jw)
    left = torch.cat([plan.mass[:, None, None] * Jc, IJw], 1)
    return torch.einsum("nbdi,nbei->nde", left, torch.cat([Jc, Jw], 1)) + plan.armature


def mass_matrix(model: SpatialModel, q: torch.Tensor) -> torch.Tensor:
    """M(q) [N, nv, nv] = ∂²T/∂v² (matches mj_fullM)."""
    plan = _plan(model, q)
    return _mass_matrix(plan, _kin(plan, q))


def _pull_back(plan: _Plan, kin: _Kin, M: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Σ_i M[i, d]·S_d·W_i [N, NV] for world wrenches W [N, I, 6] (moment
    about the origin, force) at items whose dof masks are M [I, NV]."""
    return (kin.S * torch.einsum("id,nik->ndk", M, W)).sum(-1)


def _bias_wrench(plan: _Plan, kin: _Kin, V: torch.Tensor, Vp: torch.Tensor,
                 xd: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[N, NB, 6]: each body's Newton–Euler wrench at v̇ = 0 (gravity
    included), as (moment about the world origin, force)."""
    nb = plan.nb
    # each dof's axis moves with its link: Ṡ_d = V_link(d) ×ₘ S_d, the
    # spatial cross (ω × a, ω × b + v × a) of V = (ω, v) and S = (a, b)
    Vd = V[:, plan.dof_frame].unflatten(-1, (2, 1, 3))
    r = _cross(Vd, kin.S.unflatten(-1, (1, 2, 3)))                        # [N, NV, 2, 2, 3]
    Sdot = torch.cat([r[:, :, 0, 0], r[:, :, 0, 1] + r[:, :, 1, 0]], -1)
    A = torch.einsum("bd,ndk->nbk", plan.MP[:nb], v[..., None] * Sdot)    # [N, NB, 6]
    c, cd = kin.x[:, :nb], xd[:, :nb]
    w = Vp[:, :nb, :3]
    acc = _cross(A[..., :3], c) + _cross(w, cd) + A[..., 3:]             # c̈ at v̇ = 0
    f = plan.mass[:, None] * (acc + plan.gravity)
    wb = _body_frame(kin, plan, w, A[..., :3])                           # ω, ω̇ (body)
    Iw = torch.einsum("bij,nbkj->nbki", plan.inertia, wb)
    tau = Iw[:, :, 1] + _cross(wb[:, :, 0], Iw[:, :, 0])
    Rb = kin.Tp[:, :nb, :3, :3]
    moment = _cross(c, f) + (Rb @ tau[..., None])[..., 0]
    return torch.cat([moment, f], -1)


def bias_force(model: SpatialModel, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """c(q, v) [N, nv] with M(q)v̇ + c(q, v) = τ_applied: Coriolis,
    centrifugal, gyroscopic and gravity (matches mj_rne, flg_acc=0)."""
    plan = _plan(model, q)
    kin = _kin(plan, q)
    V, Vp, xd = _velocities(plan, kin, v)
    return _pull_back(plan, kin, plan.MP[: plan.nb], _bias_wrench(plan, kin, V, Vp, xd, v))


def _contact_wrench(plan: _Plan, model: SpatialModel, kin: _Kin, xd: torch.Tensor) -> torch.Tensor:
    """[N, NC, 6]: penalty normal + regularised isotropic Coulomb friction
    at every contact sphere, as (moment about the world origin, force)."""
    x, vel = kin.x[:, plan.nb:], xd[:, plan.nb:]
    pen = torch.clamp_min(plan.con_radius - x[..., 2], 0.0)  # −(signed gap to z = 0)
    active = (pen > 0.0).to(x.dtype)
    fn = torch.clamp_min(
        model.contact_stiffness * pen - model.contact_damping * vel[..., 2] * active, 0.0)
    vt = vel[..., :2]
    speed = torch.sqrt((vt**2).sum(-1) + 1e-12)
    ft = -(plan.friction * fn * torch.tanh(speed / model.slip_vel) / speed)[..., None] * vt
    f = torch.cat([ft, fn[..., None]], -1)
    return torch.cat([_cross(x, f), f], -1)


def _joint_force(plan: _Plan, model: SpatialModel, q, v, ctrl) -> torch.Tensor:
    """Actuation, passive damping, springs and joint limits [N, nv]."""
    f = torch.zeros_like(v).index_add(1, plan.act_dof, plan.gear * ctrl)
    f = f - plan.damping * v
    # springs and limits act on scalar joints only (free dofs have none)
    qj, vj = q[:, plan.s_qadr], v[:, plan.s_dadr]
    fj = -plan.stiffness * (qj - plan.spring_ref)
    over = torch.clamp_min(qj - plan.range_hi, 0.0)
    under = torch.clamp_min(plan.range_lo - qj, 0.0)
    fj = fj - plan.limited * model.limit_stiffness * (over - under)
    outside = ((over > 0) | (under > 0)).to(q.dtype)
    fj = fj - plan.limited * model.limit_damping * vj * outside
    return f.index_add(1, plan.s_dadr, fj)


def _applied_force(model: SpatialModel, q: torch.Tensor, v: torch.Tensor,
                   ctrl: torch.Tensor) -> torch.Tensor:
    """All generalized forces except bias [N, nv]: actuation, passive
    spring/damper, joint-limit penalty, ground contact. ``ctrl`` is in
    actuator units (callers scale canonical (−1, 1) actions by ctrl_hi)."""
    plan = _plan(model, q)
    kin = _kin(plan, q)
    _, _, xd = _velocities(plan, kin, v)
    W = _contact_wrench(plan, model, kin, xd)
    return _joint_force(plan, model, q, v, ctrl) + _pull_back(plan, kin, plan.MP[plan.nb:], W)


def forward_dynamics(model: SpatialModel, q: torch.Tensor, v: torch.Tensor,
                     ctrl: torch.Tensor) -> torch.Tensor:
    """v̇ = M(q)⁻¹ (f_applied − c(q, v)) [N, nv], one batched solve that
    does not read back from the device."""
    plan = _plan(model, q)
    kin = _kin(plan, q)
    V, Vp, xd = _velocities(plan, kin, v)
    # contact wrenches push, the bias wrenches pull: one pull-back for both
    W = torch.cat([-_bias_wrench(plan, kin, V, Vp, xd, v),
                   _contact_wrench(plan, model, kin, xd)], 1)
    rhs = _joint_force(plan, model, q, v, ctrl) + _pull_back(plan, kin, plan.MP, W)
    return _capturable_solve(_mass_matrix(plan, kin), rhs)


def _capturable_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``solve_ex`` of A x = b without a read back. On the card ATen's
    linear-algebra preference is cuSOLVER for the call (batched cuBLAS LU
    for these sizes, cuSOLVER's for one row), whose kernels a CUDA graph
    captures, and is restored after it; the CPU is unaffected."""
    if A.device.type != "cuda":
        return torch.linalg.solve_ex(A, b, check_errors=False)[0]
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        return torch.linalg.solve_ex(A, b, check_errors=False)[0]
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


def integrate_qpos(model: SpatialModel, q: torch.Tensor, v: torch.Tensor,
                   dt: float) -> torch.Tensor:
    """q ← q ⊕ dt·v: linear dofs add, free-joint quaternions follow the
    exact exponential map (renormalised)."""
    plan = _plan(model, q)
    q2 = q + dt * v[:, plan.lin_src]
    if plan.nf:
        n = q.shape[0]
        u = q[:, plan.f_quat].view(n, plan.nf, 4)
        u2 = quat_mul(u, _quat_exp(dt * v[:, plan.f_ang].view(n, plan.nf, 3)))
        u2 = u2 / torch.linalg.vector_norm(u2, dim=-1, keepdim=True)
        q2 = q2.index_copy(1, plan.f_quat, u2.reshape(n, -1))
    return q2


def step_physics(
    model: SpatialModel,
    q: torch.Tensor,
    v: torch.Tensor,
    ctrl: torch.Tensor,
    n_substeps: int,
    substep_dt: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Semi-implicit Euler over ``n_substeps`` substeps (control held)."""
    for _ in range(n_substeps):
        vdot = forward_dynamics(model, q, v, ctrl)
        v = v + substep_dt * vdot
        q = integrate_qpos(model, q, v, substep_dt)
    return q, v
