"""The scalar structure-of-arrays (SoA) physics program.

Port of ``ppi_tpu/envs/physics/engine_soa.py``. Every per-sample quantity is
a Python tuple of scalars: rotations are 9 scalars, the mass matrix an
nq x nq list, the linear solve unrolled Gauss-Jordan. The program is written
once over ``scalar_math`` and so runs on three kinds of scalar (see that
module): Python floats for the folded model constants, ``(N,)`` torch
tensors for the eager plain version, and symbols for the generated CUDA
body of the rollout kernel. The static topology prunes structurally zero
Jacobian and mass-matrix terms while the program runs, as in the JAX trace.
"""

import copy
import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from ppi_tpu_torch.envs.physics import scalar_math as sm
from ppi_tpu_torch.envs.physics.engine import HINGE, ArticulatedModel

Vec3 = Tuple  # (x, y, z) scalars
Mat3 = Tuple  # 9 scalars, row-major


# ---- scalar linear algebra -------------------------------------------------

def v3_add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def v3_sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def v3_scale(s, a):
    return (s * a[0], s * a[1], s * a[2])


def v3_dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def v3_cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def m3_vec(m: Mat3, v: Vec3) -> Vec3:
    return (m[0] * v[0] + m[1] * v[1] + m[2] * v[2],
            m[3] * v[0] + m[4] * v[1] + m[5] * v[2],
            m[6] * v[0] + m[7] * v[1] + m[8] * v[2])


def m3_mul(a: Mat3, b: Mat3) -> Mat3:
    return (
        a[0] * b[0] + a[1] * b[3] + a[2] * b[6],
        a[0] * b[1] + a[1] * b[4] + a[2] * b[7],
        a[0] * b[2] + a[1] * b[5] + a[2] * b[8],
        a[3] * b[0] + a[4] * b[3] + a[5] * b[6],
        a[3] * b[1] + a[4] * b[4] + a[5] * b[7],
        a[3] * b[2] + a[4] * b[5] + a[5] * b[8],
        a[6] * b[0] + a[7] * b[3] + a[8] * b[6],
        a[6] * b[1] + a[7] * b[4] + a[8] * b[7],
        a[6] * b[2] + a[7] * b[5] + a[8] * b[8],
    )


def m3_T(a: Mat3) -> Mat3:
    return (a[0], a[3], a[6], a[1], a[4], a[7], a[2], a[5], a[8])


def rodrigues_soa(axis: Vec3, angle) -> Mat3:
    """R = I + sin K + (1-cos) K^2 with K = [axis]_x, fully unrolled."""
    x, y, z = axis
    s, c = sm.sin(angle), sm.cos(angle)
    t = 1.0 - c
    return (
        c + x * x * t, x * y * t - z * s, x * z * t + y * s,
        y * x * t + z * s, c + y * y * t, y * z * t - x * s,
        z * x * t - y * s, z * y * t + x * s, c + z * z * t,
    )


# ---- model access (constants folded when the program runs) ------------------

def _const_v3(row) -> Vec3:
    return (float(row[0]), float(row[1]), float(row[2]))


def _const_m3(arr) -> Mat3:
    return tuple(float(v) for v in np.asarray(arr).reshape(9))


class SoaModel:
    """Every parameter of an ArticulatedModel as Python floats and ints."""

    def __init__(self, model: ArticulatedModel):
        self.parents = model.parents
        self.joint_types = model.joint_types
        nb = model.nq
        self.offset_pos = [_const_v3(model.offset_pos[b]) for b in range(nb)]
        self.offset_rot = [_const_m3(model.offset_rot[b]) for b in range(nb)]
        self.axis = [_const_v3(model.axis[b]) for b in range(nb)]
        self.mass = [float(v) for v in model.mass]
        self.com = [_const_v3(model.com[b]) for b in range(nb)]
        self.inertia = [_const_m3(model.inertia[b]) for b in range(nb)]
        self.damping = [float(v) for v in model.damping]
        self.friction_loss = [float(v) for v in model.friction_loss]
        self.armature = [float(v) for v in model.armature]
        self.spring_k = [float(v) for v in model.spring_k]
        self.spring_ref = [float(v) for v in model.spring_ref]
        self.q_limit = [(float(r[0]), float(r[1])) for r in model.q_limit]
        self.limit_k = [float(v) for v in model.limit_k]
        self.sphere_body = [int(v) for v in model.sphere_body]
        self.sphere_pos = [_const_v3(model.sphere_pos[s])
                           for s in range(len(self.sphere_body))]
        self.sphere_radius = [float(v) for v in model.sphere_radius]
        self.plane_normal = [_const_v3(r) for r in model.plane_normal]
        self.plane_offset = [float(v) for v in model.plane_offset]
        self.pair_sphere_plane = [tuple(int(v) for v in r)
                                  for r in model.pair_sphere_plane]
        self.pair_sphere_sphere = [tuple(int(v) for v in r)
                                   for r in model.pair_sphere_sphere]
        self.pair_sphere_segment = [tuple(int(v) for v in r)
                                    for r in model.pair_sphere_segment]
        self.gravity = _const_v3(model.gravity)
        self.contact_stiffness = float(model.contact_stiffness)
        self.contact_damping = float(model.contact_damping)
        self.friction_mu = float(model.friction_mu)
        self.friction_vel_k = float(model.friction_vel_k)
        self.nq = nb
        anc = []
        for b in range(nb):
            row = set()
            j = b
            while j >= 0:
                row.add(j)
                j = self.parents[j]
            anc.append(row)
        self.ancestors = anc

    @property
    def identity3(self) -> Mat3:
        return (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)

    def with_body_offset(self, body: int, pos) -> "SoaModel":
        """Shallow copy with body ``body``'s joint-origin offset replaced.

        ``pos`` may hold tensors or symbols: the offset then becomes a
        per-episode runtime input (the sampled door frame). Only generic
        arithmetic reads ``offset_pos``, so nothing else changes."""
        m2 = copy.copy(self)
        m2.offset_pos = list(self.offset_pos)
        m2.offset_pos[body] = (pos[0], pos[1], pos[2])
        return m2


# ---- kinematics -------------------------------------------------------------

def fk_body_soa(m: SoaModel, b: int, r_p: Mat3, p_p: Vec3, offset: Vec3,
                q_b):
    """Body b's world (rot, joint origin, world axis, com) from its
    parent's rot and origin, its joint-origin ``offset`` and coordinate."""
    r_joint = m3_mul(r_p, m.offset_rot[b])
    p_joint = v3_add(p_p, m3_vec(r_p, offset))
    a_world = m3_vec(r_joint, m.axis[b])
    if m.joint_types[b] == HINGE:
        r_b = m3_mul(r_joint, rodrigues_soa(m.axis[b], q_b))
        p_b = p_joint
    else:
        r_b = r_joint
        p_b = v3_add(p_joint, v3_scale(q_b, a_world))
    return r_b, p_b, a_world, v3_add(p_b, m3_vec(r_b, m.com[b]))


def fk_soa(m: SoaModel, q: Sequence):
    """Per-body world (rot, joint origin, world axis, com). All tuples."""
    rots, poss, axes, coms = [], [], [], []
    for b in range(m.nq):
        p = m.parents[b]
        r_p = rots[p] if p >= 0 else m.identity3
        p_p = poss[p] if p >= 0 else (0.0, 0.0, 0.0)
        with sm.owner(("body", b)):
            r_b, p_b, a_world, com = fk_body_soa(m, b, r_p, p_p,
                                                 m.offset_pos[b], q[b])
        rots.append(r_b)
        poss.append(p_b)
        axes.append(a_world)
        coms.append(com)
    return rots, poss, axes, coms


def jacobian_column(m: SoaModel, j: int, axis: Vec3, origin: Vec3,
                    com: Vec3):
    """(jv, jw) of joint j (world ``axis`` and ``origin``) at a body's
    ``com``; jw is None (zero) for a slide."""
    if m.joint_types[j] == HINGE:
        return v3_cross(axis, v3_sub(com, origin)), axis
    return axis, None


def _jacobians(m: SoaModel, poss, axes, coms):
    """jv[b][j], jw[b][j] as vec3 or None (static sparsity)."""
    jv = [[None] * m.nq for _ in range(m.nq)]
    jw = [[None] * m.nq for _ in range(m.nq)]
    for b in range(m.nq):
        with sm.owner(("body", b)):
            for j in m.ancestors[b]:
                jv[b][j], jw[b][j] = jacobian_column(m, j, axes[j], poss[j],
                                                     coms[b])
    return jv, jw


# ---- contacts ---------------------------------------------------------------

def _contact_force_soa(m: SoaModel, delta, rel_vel: Vec3, normal: Vec3):
    v_n = v3_dot(rel_vel, normal)
    fn = sm.maximum(m.contact_stiffness * delta - m.contact_damping * v_n,
                    0.0)
    fn = sm.where(sm.gt(delta, 0.0), fn, 0.0)
    v_t = v3_sub(rel_vel, v3_scale(v_n, normal))
    vt_norm = sm.sqrt(v3_dot(v_t, v_t)) + 1e-9
    ft = sm.minimum(m.friction_vel_k * vt_norm, m.friction_mu * fn)
    return v3_sub(v3_scale(fn, normal), v3_scale(ft / vt_norm, v_t))


def plane_contact_soa(m: SoaModel, si: int, pi: int, p: Vec3, v: Vec3):
    """The force on sphere si (at ``p``, moving at ``v``) from plane pi."""
    n = m.plane_normal[pi]
    dist = v3_dot(p, n) - m.plane_offset[pi]
    delta = m.sphere_radius[si] - dist
    return _contact_force_soa(m, delta, v, n)


def sphere_contact_soa(m: SoaModel, ai: int, bi: int, pa: Vec3, pb: Vec3,
                       va: Vec3, vb: Vec3):
    """The force on sphere ai from sphere bi (bi takes its negative)."""
    diff = v3_sub(pa, pb)
    dist = sm.sqrt(v3_dot(diff, diff)) + 1e-9
    n = v3_scale(1.0 / dist, diff)
    delta = m.sphere_radius[ai] + m.sphere_radius[bi] - dist
    rel = v3_sub(va, vb)
    return _contact_force_soa(m, delta, rel, n)


def segment_contact_soa(m: SoaModel, si: int, ea: int, eb: int, a: Vec3,
                        b: Vec3, p: Vec3, va: Vec3, vb: Vec3, vp: Vec3):
    """(f, t): the force on sphere si (at ``p``) from the capsule segment
    between spheres ea and eb (at ``a``, ``b``), and the closest point's
    parameter t along it (the ends take (1 - t) f and t f)."""
    ab = v3_sub(b, a)
    t = sm.clip(v3_dot(v3_sub(p, a), ab) / (v3_dot(ab, ab) + 1e-9),
                0.0, 1.0)
    closest = v3_add(a, v3_scale(t, ab))
    diff = v3_sub(p, closest)
    dist = sm.sqrt(v3_dot(diff, diff)) + 1e-9
    n = v3_scale(1.0 / dist, diff)
    seg_r = 0.5 * (m.sphere_radius[ea] + m.sphere_radius[eb])
    delta = m.sphere_radius[si] + seg_r - dist
    v_closest = v3_add(va, v3_scale(t, v3_sub(vb, va)))
    rel = v3_sub(vp, v_closest)
    return _contact_force_soa(m, delta, rel, n), t


def accumulate_force(force: Vec3, kind: str, f: Vec3, t=None) -> Vec3:
    """One term of a sphere's contact force: ``force`` plus f ("add"),
    minus f ("sub"), minus (1 - t) f ("sub_rest"), minus t f ("sub_t")."""
    if kind == "add":
        return v3_add(force, f)
    if kind == "sub":
        return v3_sub(force, f)
    return v3_sub(force, v3_scale(1.0 - t if kind == "sub_rest" else t, f))


def contact_terms(m: SoaModel):
    """Per sphere, the terms its force sums in ``contact_forces_soa``'s
    order: (kind, pair kind, pair index) with the pair kinds "plane",
    "sphere", "segment"."""
    terms = [[] for _ in m.sphere_body]
    for i, (si, _) in enumerate(m.pair_sphere_plane):
        terms[si].append(("add", "plane", i))
    for i, (ai, bi) in enumerate(m.pair_sphere_sphere):
        terms[ai].append(("add", "sphere", i))
        terms[bi].append(("sub", "sphere", i))
    for i, (si, ea, eb) in enumerate(m.pair_sphere_segment):
        terms[si].append(("add", "segment", i))
        terms[ea].append(("sub_rest", "segment", i))
        terms[eb].append(("sub_t", "segment", i))
    return terms


def contact_forces_soa(m: SoaModel, pts, vels):
    """Returns a list of vec3 forces per sphere geom."""
    forces = [(0.0, 0.0, 0.0) for _ in pts]

    def add(s, kind, f, t=None):
        with sm.owner(("sphere", s)):
            forces[s] = accumulate_force(forces[s], kind, f, t)

    for i, (si, pi) in enumerate(m.pair_sphere_plane):
        with sm.owner(("pair", "plane", i)):
            f = plane_contact_soa(m, si, pi, pts[si], vels[si])
        add(si, "add", f)

    for i, (ai, bi) in enumerate(m.pair_sphere_sphere):
        with sm.owner(("pair", "sphere", i)):
            f = sphere_contact_soa(m, ai, bi, pts[ai], pts[bi], vels[ai],
                                   vels[bi])
        add(ai, "add", f)
        add(bi, "sub", f)

    for i, (si, ea, eb) in enumerate(m.pair_sphere_segment):
        with sm.owner(("pair", "segment", i)):
            f, t = segment_contact_soa(m, si, ea, eb, pts[ea], pts[eb],
                                       pts[si], vels[ea], vels[eb], vels[si])
        add(si, "add", f)
        add(ea, "sub_rest", f, t)
        add(eb, "sub_t", f, t)
    return forces


# ---- solve + dynamics -------------------------------------------------------

def gauss_jordan_step(aug, k: int):
    """Step k of ``solve_pd_scalar`` on the augmented rows ``aug``, in
    place: row k scaled by its pivot's reciprocal, every other row minus
    its factor times it."""
    inv_p = 1.0 / aug[k][k]
    row_k = [v * inv_p for v in aug[k]]
    for i in range(len(aug)):
        if i == k:
            continue
        f = aug[i][k]
        aug[i] = [aug[i][c] - f * row_k[c] for c in range(len(row_k))]
    aug[k] = row_k


def solve_pd_scalar(mass, rhs):
    """Gauss-Jordan on scalar lists (PD, no pivoting)."""
    n = len(rhs)
    aug = [list(mass[i]) + [rhs[i]] for i in range(n)]
    for k in range(n):
        gauss_jordan_step(aug, k)
    return tuple(aug[i][n] for i in range(n))


def world_inertia_soa(m: SoaModel, b: int, rot: Mat3) -> Mat3:
    """Body b's inertia in the world frame, ``R I R^T``."""
    return m3_mul(m3_mul(rot, m.inertia[b]), m3_T(rot))


def bias_wrench_soa(m: SoaModel, b: int, i_w: Mat3, omega: Vec3,
                    alpha: Vec3, a_c: Vec3):
    """Body b's gravity-minus-inertial force and its gyroscopic plus
    velocity-product torque, (f, n)."""
    f = v3_sub(v3_scale(m.mass[b], m.gravity), v3_scale(m.mass[b], a_c))
    n = v3_add(m3_vec(i_w, alpha), v3_cross(omega, m3_vec(i_w, omega)))
    return f, n


def contact_point_soa(m: SoaModel, s: int, rot: Mat3, pos: Vec3, v_o: Vec3,
                      omega: Vec3):
    """World position and velocity of sphere geom s on a body at (``rot``,
    ``pos``) moving at (``v_o``, ``omega``)."""
    p_s = v3_add(pos, m3_vec(rot, m.sphere_pos[s]))
    return p_s, v3_add(v_o, v3_cross(omega, v3_sub(p_s, pos)))


def contact_points_soa(m: SoaModel, rots, poss, v_o, omega):
    """World position and velocity of every sphere geom, and its body."""
    pts, pt_vels, pt_body = [], [], []
    for s, sb in enumerate(m.sphere_body):
        with sm.owner(("sphere", s)):
            p_s, v_s = contact_point_soa(m, s, rots[sb], poss[sb], v_o[sb],
                                         omega[sb])
        pts.append(p_s)
        pt_vels.append(v_s)
        pt_body.append(sb)
    return pts, pt_vels, pt_body


def passive_torque_soa(m: SoaModel, q, qd):
    out = []
    for j in range(m.nq):
        with sm.owner(("sum", j)):
            tau = -m.damping[j] * qd[j]
            if m.spring_k[j] != 0.0:
                tau = tau - m.spring_k[j] * (q[j] - m.spring_ref[j])
            if m.limit_k[j] != 0.0:
                lo, hi = m.q_limit[j]
                tau = tau - m.limit_k[j] * (sm.maximum(q[j] - hi, 0.0)
                                            + sm.minimum(q[j] - lo, 0.0))
        out.append(tau)
    return tuple(out)


def velocity_body_soa(m: SoaModel, b: int, qd_b, w_p: Vec3, vo_p: Vec3,
                      al_p: Vec3, ao_p: Vec3, o_p: Vec3, o_b: Vec3,
                      a_axis: Vec3, com: Vec3):
    """Body b's world (omega, v_origin, v_com, alpha, a_origin, a_com)
    with qdd = 0, from its parent's (omega, v_origin, alpha, a_origin,
    origin), its own origin, axis and com."""
    rel = v3_sub(o_b, o_p)
    if m.joint_types[b] == HINGE:
        w_b = v3_add(w_p, v3_scale(qd_b, a_axis))
        vo_b = v3_add(vo_p, v3_cross(w_p, rel))
        al_b = v3_add(al_p, v3_scale(qd_b, v3_cross(w_p, a_axis)))
        ao_b = v3_add(v3_add(ao_p, v3_cross(al_p, rel)),
                      v3_cross(w_p, v3_sub(vo_b, vo_p)))
    else:
        w_b = w_p
        vo_b = v3_add(v3_add(vo_p, v3_cross(w_p, rel)),
                      v3_scale(qd_b, a_axis))
        al_b = al_p
        ao_b = v3_add(
            v3_add(v3_add(ao_p, v3_cross(al_p, rel)),
                   v3_cross(w_p, v3_sub(vo_b, vo_p))),
            v3_scale(qd_b, v3_cross(w_p, a_axis)))
    c_rel = v3_sub(com, o_b)
    vc_b = v3_add(vo_b, v3_cross(w_b, c_rel))
    ac_b = v3_add(v3_add(ao_b, v3_cross(al_b, c_rel)),
                  v3_cross(w_b, v3_sub(vc_b, vo_b)))
    return w_b, vo_b, vc_b, al_b, ao_b, ac_b


def velocity_kinematics_soa(m: SoaModel, q, qd, rots, poss, axes, coms):
    """Per-body world (omega, v_origin, v_com, alpha, a_origin, a_com) with
    qdd = 0: the velocity-product (Coriolis/centrifugal) accelerations."""
    zero = (0.0, 0.0, 0.0)
    omega, v_o, v_c, alpha, a_o, a_c = [], [], [], [], [], []
    for b in range(m.nq):
        p = m.parents[b]
        w_p = omega[p] if p >= 0 else zero
        vo_p = v_o[p] if p >= 0 else zero
        al_p = alpha[p] if p >= 0 else zero
        ao_p = a_o[p] if p >= 0 else zero
        o_p = poss[p] if p >= 0 else zero
        with sm.owner(("body", b)):
            w_b, vo_b, vc_b, al_b, ao_b, ac_b = velocity_body_soa(
                m, b, qd[b], w_p, vo_p, al_p, ao_p, o_p, poss[b], axes[b],
                coms[b])
        omega.append(w_b)
        v_o.append(vo_b)
        v_c.append(vc_b)
        alpha.append(al_b)
        a_o.append(ao_b)
        a_c.append(ac_b)
    return omega, v_o, v_c, alpha, a_o, a_c


@dataclasses.dataclass(frozen=True)
class Assembly:
    """What ``assemble_soa`` computes for one substep: the mass matrix
    (nq x nq scalars, armature on the diagonal), the right-hand side, the
    mass matrix's diagonal, and the per-body and per-contact quantities
    the entries are summed from. ``jw[b][j]`` is ``axes[j]`` or None;
    ``iw_jw[b]`` maps each hinge ancestor j of body b to ``I_w jw[b][j]``;
    ``pt_body[s]`` is the body of contact sphere s."""

    mass: list
    rhs: tuple
    mdiag: tuple
    poss: list
    axes: list
    jv: list
    jw: list
    iw_jw: list
    f_bias: list
    n_bias: list
    pts: list
    pt_body: list
    forces: list


def assemble_soa(m: SoaModel, q, qd, tau) -> Assembly:
    """Everything of one substep before the solve.

    Closed-form Newton-Euler: one position FK, one velocity/acceleration
    pass, explicit Jacobian-transpose mapping of gravity, contact and bias
    wrenches. The warp layout of the rollout kernel computes the same
    values from the same helpers, spread over a warp's lanes
    (``warp_layout``)."""
    rots, poss, axes, coms = fk_soa(m, q)
    jv, jw = _jacobians(m, poss, axes, coms)

    # mass matrix (ancestor-sparse upper triangle); entry (k, l), k an
    # ancestor of l, sums a term of each body at or below l
    mass = [[0.0] * m.nq for _ in range(m.nq)]
    i_world, iw_jws = [], []
    for b in range(m.nq):
        with sm.owner(("body", b)):
            i_w = world_inertia_soa(m, b, rots[b])
            i_world.append(i_w)
            mb = m.mass[b]
            anc = sorted(m.ancestors[b])
            iw_jw = {j: m3_vec(i_w, jw[b][j]) for j in anc
                     if jw[b][j] is not None}
            iw_jws.append(iw_jw)
        for ii, k in enumerate(anc):
            for l in anc[ii:]:
                with sm.owner(("body", b)):
                    term = mb * v3_dot(jv[b][k], jv[b][l])
                    if jw[b][k] is not None and l in iw_jw:
                        term = term + v3_dot(jw[b][k], iw_jw[l])
                with sm.owner(("mass", l)):
                    mass[k][l] = mass[k][l] + term
    for k in range(m.nq):
        with sm.owner(("mass", k)):
            mass[k][k] = mass[k][k] + m.armature[k]
        for l in range(k):
            mass[k][l] = mass[l][k]

    omega, v_o, v_c, alpha, a_o, a_c = velocity_kinematics_soa(
        m, q, qd, rots, poss, axes, coms)

    pts, pt_vels, pt_body = contact_points_soa(m, rots, poss, v_o, omega)
    forces = contact_forces_soa(m, pts, pt_vels) if pts else []

    passive = passive_torque_soa(m, q, qd)
    f_bias, n_bias = [], []
    for b in range(m.nq):
        with sm.owner(("body", b)):
            f, n = bias_wrench_soa(m, b, i_world[b], omega[b], alpha[b],
                                   a_c[b])
        f_bias.append(f)
        n_bias.append(n)
    # rhs[j] sums a term of each body and contact sphere at or below joint j
    rhs = []
    for j in range(m.nq):
        with sm.owner(("sum", j)):
            t = tau[j] + passive[j]
        a_j, o_j = axes[j], poss[j]
        hinge = m.joint_types[j] == HINGE
        for b in range(m.nq):
            if j not in m.ancestors[b]:
                continue
            with sm.owner(("body", b)):
                term = v3_dot(jv[b][j], f_bias[b])
            with sm.owner(("sum", j)):
                t = t + term
            if jw[b][j] is not None:
                with sm.owner(("body", b)):
                    term = v3_dot(jw[b][j], n_bias[b])
                with sm.owner(("sum", j)):
                    t = t - term
        for s, sb in enumerate(pt_body):
            if j not in m.ancestors[sb]:
                continue
            with sm.owner(("sphere", s)):
                col = (v3_cross(a_j, v3_sub(pts[s], o_j)) if hinge else a_j)
                term = v3_dot(col, forces[s])
            with sm.owner(("sum", j)):
                t = t + term
        rhs.append(t)
    mdiag = tuple(mass[k][k] for k in range(m.nq))
    return Assembly(mass, tuple(rhs), mdiag, poss, axes, jv, jw, iw_jws,
                    f_bias, n_bias, pts, pt_body, forces)


def forward_dynamics_soa(m: SoaModel, q, qd, tau):
    """Scalar forward dynamics for one sample (or one (N,) lane vector):
    ``assemble_soa`` then ``solve_pd_scalar``. Returns (qdd, diagonal of
    the mass matrix)."""
    a = assemble_soa(m, q, qd, tau)
    return solve_pd_scalar(a.mass, a.rhs), a.mdiag


def integrate_soa(m: SoaModel, q, qd, qdd, mdiag, h: float):
    """The semi-implicit Euler step with the velocity-level Coulomb clip
    (exact stiction, cap ``friction_loss * h / M_jj``)."""
    qd2 = [qd[j] + h * qdd[j] for j in range(m.nq)]
    for j in range(m.nq):
        if m.friction_loss[j] > 0.0:
            cap = m.friction_loss[j] * h / mdiag[j]
            qd2[j] = qd2[j] - sm.clip(qd2[j], -cap, cap)
    qd2 = tuple(qd2)
    q2 = tuple(q[j] + h * qd2[j] for j in range(m.nq))
    return q2, qd2


def substep_soa(m: SoaModel, q, qd, tau, h: float):
    """One semi-implicit Euler substep: ``assemble_soa``,
    ``solve_pd_scalar``, ``integrate_soa``."""
    a = assemble_soa(m, q, qd, tau)
    qdd = solve_pd_scalar(a.mass, a.rhs)
    return integrate_soa(m, q, qd, qdd, a.mdiag, h)


def make_single_step_soa(model: ArticulatedModel, dt: float,
                         substeps: int = 1, dyn_body=None):
    """``(qpos (..., nq), qvel (..., nq), tau (..., nq)[, body_pos (3,)])
    -> (qpos, qvel)`` over any leading batch shape.

    The scalar path of the JAX ``make_single_step_soa``; the stacked
    variant for nq >= 10 is not ported. With ``dyn_body`` the step takes a
    trailing runtime offset for that body (the sampled scene placement)."""
    m = SoaModel(model)
    h = dt / substeps

    def one(qpos, qvel, tau, body_pos=None):
        mm = m
        if dyn_body is not None and body_pos is not None:
            mm = m.with_body_offset(dyn_body, body_pos.unbind(-1))
        q, qd = qpos.unbind(-1), qvel.unbind(-1)
        tu = tau.unbind(-1)
        for _ in range(substeps):
            q, qd = substep_soa(mm, q, qd, tu, h)
        return torch.stack(q, -1), torch.stack(qd, -1)

    return one


def geom_point_soa(m: SoaModel, rots, poss, s: int) -> Vec3:
    """World position of sphere geom ``s`` given fk_soa outputs."""
    sb = m.sphere_body[s]
    return v3_add(poss[sb], m3_vec(rots[sb], m.sphere_pos[s]))


def make_sites_soa(model: ArticulatedModel, dyn_body=None):
    """``qpos (..., nq)[, body_pos (3,)] -> (..., ns, 3)`` sphere-geom world
    positions (scalar inside, stacked at the end)."""
    m = SoaModel(model)

    def sites(qpos, body_pos=None):
        mm = m
        if dyn_body is not None and body_pos is not None:
            mm = m.with_body_offset(dyn_body, body_pos.unbind(-1))
        rots, poss, _, _ = fk_soa(mm, qpos.unbind(-1))
        pts = [stack_lanes(geom_point_soa(mm, rots, poss, s))
               for s in range(len(mm.sphere_body))]
        return torch.stack(pts, -2)

    return sites


def make_body_frames_soa(model: ArticulatedModel, dyn_body=None):
    """``qpos (..., nq)[, body_pos (..., 3)] -> (rot (..., nb, 3, 3), pos
    (..., nb, 3))``: each body's world rotation and joint origin, from
    ``fk_soa`` (the JAX function is unbatched; this one takes any leading
    batch shape). With ``dyn_body`` the frames take a trailing runtime
    offset for that body."""
    m = SoaModel(model)

    def frames(qpos, body_pos=None):
        mm = m
        if dyn_body is not None and body_pos is not None:
            mm = m.with_body_offset(dyn_body, body_pos.unbind(-1))
        rots, poss, _, _ = fk_soa(mm, qpos.unbind(-1))
        like = qpos[..., 0]
        rot = torch.stack([stack_lanes((like,) + tuple(r))[..., 1:]
                           for r in rots], -2)
        pos = torch.stack([stack_lanes((like,) + tuple(p))[..., 1:]
                           for p in poss], -2)
        return (rot.reshape(*rot.shape[:-1], 3, 3).to(qpos.dtype),
                pos.to(qpos.dtype))

    return frames


def stack_lanes(xs, dim: int = -1) -> torch.Tensor:
    """Stack scalars of the program into one tensor. Entries that stayed
    Python constants (a coordinate no joint moves) are broadcast to the
    lanes' shape."""
    ts = [x for x in xs if isinstance(x, torch.Tensor)]
    ts = torch.broadcast_tensors(*ts)
    like = ts[0]
    full = [x if isinstance(x, torch.Tensor) else torch.full_like(like, x)
            for x in xs]
    return torch.stack(torch.broadcast_tensors(*full), dim)
