"""Ball-in-a-cup on a 4-DoF WAM-class arm, as one scalar program.

Port of ``ppi_tpu/envs/ball_in_a_cup.py``. A PD-torque-controlled 4-DoF arm
swings a ball hung from its cup by a string and must land it in the cup:

  * the arm is a 4-DoF chain on the articulated engine under the
    reference's PD gains, driven to (q, qd) setpoints;
  * the string is a chain of point particles stepped with position-based
    dynamics: a Verlet prediction, then a Jacobi distance projection of a
    fixed number of sweeps (a rope: it resists stretching only), with
    particle 0 pinned to the cup's anchor;
  * the string's reaction acts on the arm through the anchor's Jacobian,
    ``J^T F``, written out per hinge (``axis_j x (anchor - origin_j)``)
    where the JAX package takes ``jax.vjp``; by default in the same step
    (a predictor pass with the previous step's reaction, then a corrector
    pass with this step's: ``same_step_coupling``), else lagged one step;
  * the ball meets the cup's capped-cylinder solid by position
    projection, and a ball too close to an arm link latches the violation
    flag that freezes the reward statistics;
  * three phases, stabilize -> trajectory -> cool-down, with the dipole
    reward's statistics streamed in the state.

The step is written once over ``scalar_math``, on a flat tuple of scalars
per lane (``StateLayout``), so that one program runs eagerly over (N,)
torch tensors (the plain version) and over symbols, from which
``envs/physics/bic_kernel.py`` generates the body of the ball-in-a-cup
kernel (``csrc/bic_rollout.cu``). The step is four generated functions
that the skeleton composes as ``step_soa`` does: ``arm_soa`` (PD torque,
``J^T F``, forward dynamics, semi-implicit Euler), ``string_soa`` (the PBD
pass and the reaction), again both with this step's reaction when
``same_step_coupling``, then ``commit_soa`` (the statistics).

Constants that the JAX package folds in float32 (the particles' inverse
masses, the gravity terms, ``linspace``) are folded here in float32 too,
so both programs round the same values.
"""

import dataclasses
import math

import numpy as np
import torch

from ppi_tpu_torch.envs.physics import scalar_math as sm
from ppi_tpu_torch.envs.physics.engine import HINGE, ModelBuilder, PhysicsState
from ppi_tpu_torch.envs.physics.engine_soa import (
    SoaModel, fk_soa, forward_dynamics_soa, m3_vec, stack_lanes, v3_add,
    v3_cross, v3_dot, v3_scale, v3_sub)

N_PARTICLES = 12          # string discretization (reference: 29 capsules)
STRING_LENGTH = 0.37      # metres, anchor to ball
BALL_MASS = 0.021         # kg (reference scene ball)
STRING_MASS = 0.024       # total string mass, split over the particles
PARTICLE_MASS = STRING_MASS / N_PARTICLES
BALL_RADIUS = 0.02
CUP_INNER_RADIUS = 0.069 / 2.0
CUP_DEPTH = 0.075

P_GAINS = (200.0, 300.0, 100.0, 100.0)
D_GAINS = (7.0, 15.0, 5.0, 2.5)

CUP_OFFSET = (0.35, 0.0, 0.0)    # cup centre in the wrist frame
FOREARM_END = (0.2, 0.0, 0.0)    # the forearm capsule's end, wrist frame
GRAVITY = -9.81


def _f32_mul(*xs) -> float:
    """The product of ``xs`` as float32 arithmetic rounds it, left to right
    (a constant the JAX program folds in float32)."""
    acc = np.float32(xs[0])
    for x in xs[1:]:
        acc = np.float32(acc * np.float32(x))
    return float(acc)


def _build_arm():
    """4-DoF WAM-class arm: yaw(z) -> shoulder pitch(y) -> roll(z) ->
    elbow pitch(y), the cup at the wrist."""
    b = ModelBuilder()
    b.add_body(parent=-1, joint_type=HINGE, axis=(0, 0, 1),
               offset_pos=(0, 0, 0.85), mass=5.0, com=(0, 0, 0.1),
               inertia=np.diag([0.1, 0.1, 0.05]), damping=1.0, armature=0.1)
    b.add_body(parent=0, joint_type=HINGE, axis=(0, 1, 0),
               offset_pos=(0, 0, 0.2), mass=4.0, com=(0, 0, 0.25),
               inertia=np.diag([0.15, 0.15, 0.02]), damping=1.0, armature=0.1)
    b.add_body(parent=1, joint_type=HINGE, axis=(0, 0, 1),
               offset_pos=(0, 0, 0.5), mass=2.0, com=(0, 0, 0.1),
               inertia=np.diag([0.03, 0.03, 0.01]), damping=0.5,
               armature=0.05)
    # the elbow's joint frame pre-rotated -90 deg about y, so that the
    # canonical start q3 = 1.5707 puts the forearm horizontal with the ball
    # hanging clear of the arm
    pre = np.array([[0.0, 0.0, -1.0], [0.0, 1.0, 0.0], [1.0, 0.0, 0.0]],
                   np.float32)
    b.add_body(parent=2, joint_type=HINGE, axis=(0, 1, 0),
               offset_pos=(0, 0, 0.2), offset_rot=pre, mass=1.5,
               com=(0.15, 0, 0), inertia=np.diag([0.02, 0.02, 0.02]),
               damping=0.5, armature=0.05)
    return b.finalize()


@dataclasses.dataclass(frozen=True)
class BicState:
    """One trajectory's state (or a batch of them, lanes leading)."""

    arm: PhysicsState
    particles: torch.Tensor        # (..., P+1, 3) string particles (world)
    particles_prev: torch.Tensor   # (..., P+1, 3) the previous positions
    string_force: torch.Tensor     # (..., 3) the string's reaction
    max_pot_m: torch.Tensor        # (...) -inf until a live step
    sum_vel_pen: torch.Tensor
    sum_pos_pen: torch.Tensor
    sum_ball_vel_pen: torch.Tensor
    n_steps: torch.Tensor
    q0: torch.Tensor               # (..., 4) the position penalty's pose
    violated: torch.Tensor         # (...) bool, the ball-robot latch
    t: torch.Tensor                # (...) int32


@dataclasses.dataclass(frozen=True)
class StateLayout:
    """Where each quantity of a ``BicState`` sits in the flat tuple of
    scalars the program steps (and in the kernel's per-lane state)."""

    n_particles: int

    @property
    def n_points(self) -> int:
        return self.n_particles + 1

    Q, QD, PARTICLES = 0, 4, 8

    @property
    def PREV(self) -> int:
        return self.PARTICLES + 3 * self.n_points

    @property
    def FORCE(self) -> int:
        return self.PREV + 3 * self.n_points

    @property
    def MAX_POT(self) -> int:
        return self.FORCE + 3

    @property
    def SUM_VEL(self) -> int:
        return self.MAX_POT + 1

    @property
    def SUM_POS(self) -> int:
        return self.MAX_POT + 2

    @property
    def SUM_BALL(self) -> int:
        return self.MAX_POT + 3

    @property
    def N_STEPS(self) -> int:
        return self.MAX_POT + 4

    @property
    def VIOLATED(self) -> int:
        return self.MAX_POT + 5

    @property
    def Q0(self) -> int:
        return self.MAX_POT + 6

    @property
    def size(self) -> int:
        return self.Q0 + 4

    # ``string_soa``'s outputs: the new particles, the reaction, the cup's
    # bottom and top at the new pose
    @property
    def STR_REACTION(self) -> int:
        return 3 * self.n_points

    @property
    def STR_BOTTOM(self) -> int:
        return self.STR_REACTION + 3

    @property
    def STR_TOP(self) -> int:
        return self.STR_REACTION + 6

    @property
    def str_size(self) -> int:
        return self.STR_REACTION + 9

    def point(self, s, base: int, i: int):
        return (s[base + 3 * i], s[base + 3 * i + 1], s[base + 3 * i + 2])


# ---- comparisons the program uses as numbers, beyond scalar_math's -------

def le(a, b):
    """``a <= b`` as a 0/1 float (0 where either is NaN)."""
    if isinstance(a, sm.Sym) or isinstance(b, sm.Sym):
        return sm._call("ppi_le", a, b)
    for t in (a, b):
        if isinstance(t, torch.Tensor):
            return (a <= b).to(t.dtype)
    return float(a <= b)


def ge(a, b):
    """``a >= b`` as a 0/1 float."""
    return le(b, a)


# the C definition behind ``le``
C_HELPERS = ("PPI_QUAL float ppi_le(float a, float b) "
             "{ return a <= b ? 1.0f : 0.0f; }\n")


def _norm(v):
    return sm.sqrt(v3_dot(v, v))


def _sum(xs):
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x
    return acc


@dataclasses.dataclass(frozen=True)
class BallInCupSim:
    """The simulation the episodic ``BallInACup`` env evaluates."""

    dt: float = 2e-3           # effective control step (reference: 5e-4 x 4)
    pbd_iterations: int = 15
    n_particles: int = N_PARTICLES
    same_step_coupling: bool = True  # predictor-corrector arm<->string step
    #   (False: the previous step's string reaction, lagged one step)
    stabilize_steps: int = 250
    cooldown_steps: int = 350
    dipole_eps: float = 1e-3
    dipole_beta: float = 1e-1
    min_weight: float = 0.5
    joint_vel_penalty: float = 3e-2
    joint_pos_penalty: float = 7.5e-2
    ball_vel_penalty: float = 0.0

    def __post_init__(self):
        model = _build_arm()
        object.__setattr__(self, "_model", model)
        object.__setattr__(self, "_soa", SoaModel(model))
        object.__setattr__(self, "layout", StateLayout(self.n_particles))

    @property
    def effective_dt(self) -> float:
        return self.dt

    @property
    def _effective_pbd_iterations(self) -> int:
        """Jacobi distance projection converges in O(segments^2) sweeps, so
        the iteration count scales quadratically with the string's
        resolution (12 and 24 particles then agree to millimetres)."""
        scale = (self.n_particles / float(N_PARTICLES)) ** 2
        return max(1, int(round(self.pbd_iterations * scale)))

    def _string_rest_lengths(self) -> float:
        return STRING_LENGTH / self.n_particles

    def _inverse_masses(self):
        """Each particle's inverse mass as float32 folds it (the anchor's
        is 0: it is pinned), and each segment's Jacobi denominator."""
        p = self.n_particles
        masses = [np.float32(STRING_MASS / p)] * p + [np.float32(BALL_MASS)]
        w = [np.float32(1.0) / mm for mm in masses]
        w[0] = np.float32(0.0)
        denom = [np.float32(np.float32(w[i] + w[i + 1]) + np.float32(1e-9))
                 for i in range(p)]
        return ([float(v) for v in w], [float(v) for v in masses],
                [float(v) for v in denom])

    # ---- the scalar program ---------------------------------------------

    def cup_frame_soa(self, q):
        """(bottom, top, up) of the cup at coordinates ``q``: the mouth
        points along the wrist's +z."""
        rots, poss, _, _ = fk_soa(self._soa, q)
        r, p = rots[3], poss[3]
        bottom = v3_add(p, m3_vec(r, CUP_OFFSET))
        up = (r[2], r[5], r[8])
        top = v3_add(bottom, v3_scale(CUP_DEPTH, up))
        return bottom, top, up

    def jacobian_t_soa(self, q, force):
        """``J(q)^T force`` with J the cup anchor's (the cup bottom's)
        Jacobian: for each hinge j, the column ``axis_j x (anchor -
        origin_j)``, ``engine_soa.jacobian_column``'s."""
        m = self._soa
        rots, poss, axes, _ = fk_soa(m, q)
        bottom = v3_add(poss[3], m3_vec(rots[3], CUP_OFFSET))
        tau = []
        for j in range(m.nq):
            col = v3_cross(axes[j], v3_sub(bottom, poss[j]))
            tau.append(v3_dot(col, force))
        return tuple(tau)

    def arm_soa(self, s, q_des, qd_des, reaction):
        """The arm's step from the lane state ``s`` under the PD torque
        toward (``q_des``, ``qd_des``) plus ``J(q)^T reaction``: (q_new,
        qd_new) as one 8-tuple."""
        L = self.layout
        q = tuple(s[L.Q + j] for j in range(4))
        qd = tuple(s[L.QD + j] for j in range(4))
        jt = self.jacobian_t_soa(q, reaction)
        tau = tuple(P_GAINS[j] * (q_des[j] - q[j])
                    + D_GAINS[j] * (qd_des[j] - qd[j]) + jt[j]
                    for j in range(4))
        qdd, _ = forward_dynamics_soa(self._soa, q, qd, tau)
        qd_new = tuple(qd[j] + self.dt * qdd[j] for j in range(4))
        q_new = tuple(q[j] + self.dt * qd_new[j] for j in range(4))
        return q_new + qd_new

    def predict_soa(self, p, prev):
        """The Verlet prediction of one particle (not the anchor: its
        prediction is the anchor itself) from its position ``p`` and its
        previous one, with a little damping."""
        dt = self.dt
        acc_z = _f32_mul(GRAVITY, dt, dt)
        vel = tuple((p[c] - prev[c]) / dt for c in range(3))
        q = tuple(p[c] + vel[c] * dt * 0.995 for c in range(3))
        return (q[0], q[1], q[2] + acc_z)

    def segment_soa(self, a, b, seg, w_a, w_b, denom, pinned=False):
        """One Jacobi correction of the segment from point ``a`` to point
        ``b`` (rest length ``seg``, inverse masses ``w_a``, ``w_b``,
        denominator ``denom``): (da, db), each endpoint's correction; da is
        None where ``a`` is ``pinned`` (the anchor)."""
        diff = v3_sub(b, a)
        dist = _norm(diff) + 1e-9
        stretch = sm.maximum(dist - seg, 0.0)
        corr = tuple(stretch * diff[c] / dist for c in range(3))
        da = None if pinned else tuple(corr[c] * w_a / denom
                                       for c in range(3))
        db = tuple(-corr[c] * w_b / denom for c in range(3))
        return da, db

    def correct_soa(self, p, da, db):
        """A point after a sweep: ``(p + da) + db``, with ``da`` its
        correction as a segment's first point (None for the ball) and
        ``db`` as the previous segment's second."""
        if da is not None:
            p = v3_add(p, da)
        return v3_add(p, db)

    def contact_soa(self, ball, frame):
        """The ball against the cup solid of ``frame`` = (bottom, top, up):
        the wall is an annulus [inner, wall_r] over the height band; its
        inner face holds a ball that came in through the mouth, its outer
        face repels one from the side (chosen by the wall's midline)."""
        bottom, _, up = frame
        rel = v3_sub(ball, bottom)
        h = v3_dot(rel, up)
        radial = v3_sub(rel, v3_scale(h, up))
        r_norm = _norm(radial) + 1e-9
        r_dir = tuple(radial[c] / r_norm for c in range(3))
        wall_r = CUP_INNER_RADIUS + 0.008
        mid_r = 0.5 * (CUP_INNER_RADIUS + wall_r)
        band = sm.logical_and(sm.gt(h, 0.0), sm.lt(h, CUP_DEPTH))
        cavity_r = CUP_INNER_RADIUS - BALL_RADIUS
        pen_in = r_norm - cavity_r
        inner = sm.logical_and(sm.logical_and(band, sm.lt(r_norm, mid_r)),
                               sm.gt(pen_in, 0.0))
        d_in = sm.where(inner, pen_in, 0.0)
        ball = tuple(ball[c] - d_in * r_dir[c] for c in range(3))
        pen_out = (wall_r + BALL_RADIUS) - r_norm
        outer = sm.logical_and(sm.logical_and(band, ge(r_norm, mid_r)),
                               sm.gt(pen_out, 0.0))
        d_out = sm.where(outer, pen_out, 0.0)
        ball = tuple(ball[c] + d_out * r_dir[c] for c in range(3))
        # just below the cup's base
        under = sm.logical_and(
            sm.logical_and(le(r_norm, wall_r + BALL_RADIUS), sm.lt(h, 0.0)),
            sm.gt(h, -BALL_RADIUS))
        d_under = sm.where(under, BALL_RADIUS + h, 0.0)
        ball = tuple(ball[c] - d_under * up[c] for c in range(3))
        # inside, resting on the floor
        inside = sm.logical_and(
            sm.logical_and(le(r_norm, CUP_INNER_RADIUS), ge(h, 0.0)),
            sm.lt(h, BALL_RADIUS))
        d_inside = sm.where(inside, BALL_RADIUS - h, 0.0)
        return tuple(ball[c] + d_inside * up[c] for c in range(3))

    def pbd_soa(self, particles, prev, anchor, frame):
        """One Verlet + distance-projection step of the particle chain
        (lists of points): particle 0 pinned to ``anchor``, the last the
        ball, projected against the cup solid of ``frame`` = (bottom, top,
        up). Returns the new particles. Each sweep's segments read the
        previous sweep's points only, so the warp layout of the kernel
        runs a segment a lane (``bic_kernel.generate_warp_header``)."""
        n = self.n_particles
        seg = self._string_rest_lengths()
        w, _, denom = self._inverse_masses()
        pred = [anchor] + [self.predict_soa(particles[i], prev[i])
                           for i in range(1, n + 1)]
        # Jacobi sweeps: both endpoint corrections of each segment, from the
        # same positions, added as (pred + da) + db; the anchor re-pinned
        for _ in range(self._effective_pbd_iterations):
            da, db = [None] * (n + 1), [None] * (n + 1)
            for i in range(n):
                da[i], db[i + 1] = self.segment_soa(
                    pred[i], pred[i + 1], seg, w[i], w[i + 1], denom[i],
                    pinned=i == 0)
            pred = [anchor] + [self.correct_soa(pred[i], da[i], db[i])
                               for i in range(1, n + 1)]
        pred[n] = self.contact_soa(pred[n], frame)
        return pred

    def reaction_term_soa(self, mass, new, part, prev):
        """A particle's term, in one coordinate, of the string's change of
        momentum over a step: its mass times its change of velocity."""
        dt = self.dt
        return mass * ((new - part) / dt - (part - prev) / dt)

    def reaction_soa(self, dp):
        """The string's reaction on the arm from ``dp`` (the change of its
        momentum over a step, over dt): F_anchor->string = dp/dt - m g,
        reaction = -F, clipped to +-30 N."""
        g_z = _f32_mul(GRAVITY, float(STRING_MASS + BALL_MASS))
        reaction = (-dp[0], -dp[1], -(dp[2] - g_z))
        return tuple(sm.clip(r, -30.0, 30.0) for r in reaction)

    def string_soa(self, s, arm):
        """The string's pass at the arm's new coordinates (``arm_soa``'s
        output): the new particles, the reaction on the anchor (clipped to
        +-30 N) and the cup's bottom and top there, as one tuple
        (``StateLayout.STR_*``)."""
        L, n, dt = self.layout, self.n_particles, self.dt
        q_new = tuple(arm[:4])
        frame = self.cup_frame_soa(q_new)
        parts = [L.point(s, L.PARTICLES, i) for i in range(n + 1)]
        prev = [L.point(s, L.PREV, i) for i in range(n + 1)]
        new = self.pbd_soa(parts, prev, frame[0], frame)
        # the string's reaction on the arm (Newton on the particles past the
        # anchor), the terms summed left to right
        _, masses, _ = self._inverse_masses()
        dp = []
        for c in range(3):
            terms = [self.reaction_term_soa(masses[i], new[i][c],
                                            parts[i][c], prev[i][c])
                     for i in range(1, n + 1)]
            dp.append(_sum(terms) / dt)
        reaction = self.reaction_soa(dp)
        flat = tuple(x for p in new for x in p)
        return flat + reaction + frame[0] + frame[1]

    def hits_robot_soa(self, q, ball):
        """0/1: the ball within 5 cm of an arm link (the segments between
        the joint origins, the forearm's stopping short of the cup mount so
        that a caught ball does not read as a collision)."""
        rots, pts, _, _ = fk_soa(self._soa, q)
        ends = [pts[1], pts[2], pts[3],
                v3_add(pts[3], m3_vec(rots[3], FOREARM_END))]
        hit = None
        for a, b in zip(pts, ends):
            ab = v3_sub(b, a)
            t = sm.clip(v3_dot(v3_sub(ball, a), ab) / (v3_dot(ab, ab) + 1e-9),
                        0.0, 1.0)
            closest = v3_add(a, v3_scale(t, ab))
            flag = sm.lt(_norm(v3_sub(ball, closest)), 0.05)
            hit = flag if hit is None else sm.maximum(hit, flag)
        return hit

    def stats_soa(self, s, q_new, qd_new, bottom, top, ball):
        """The reward statistics after a step of the lane state ``s`` to
        (``q_new``, ``qd_new``), the cup at (``bottom``, ``top``), the
        ball at ``ball``: (max_pot, sum_vel, sum_pos, sum_ball, n_steps,
        violated); a violated lane no longer accumulates them."""
        L, n, dt = self.layout, self.n_particles, self.dt
        axis = v3_sub(top, bottom)
        norm = _norm(axis) + 1e-9
        axis = tuple(axis[c] / norm for c in range(3))
        rm = v3_sub(ball, top)
        pot_m = v3_dot(rm, axis) / (v3_dot(rm, rm) + self.dipole_eps)
        violated = sm.maximum(s[L.VIOLATED], self.hits_robot_soa(q_new, ball))
        live = 1.0 - violated
        max_pot = sm.where(violated, s[L.MAX_POT],
                           sm.maximum(s[L.MAX_POT], pot_m))
        q0 = tuple(s[L.Q0 + j] for j in range(4))
        ball_prev = L.point(s, L.PARTICLES, n)
        return (
            max_pot,
            s[L.SUM_VEL] + live * _sum([v * v for v in qd_new]),
            s[L.SUM_POS] + live * _sum([(q_new[j] - q0[j]) * (q_new[j]
                                                              - q0[j])
                                        for j in range(4)]),
            s[L.SUM_BALL] + live * _sum([((ball[c] - ball_prev[c]) / dt)
                                         * ((ball[c] - ball_prev[c]) / dt)
                                         for c in range(3)]),
            s[L.N_STEPS] + live,
            violated)

    def commit_soa(self, s, arm, st):
        """The lane state after a step: the arm's new coordinates, the
        string's new particles (the old ones its previous positions) and
        reaction, and the reward statistics (``stats_soa``)."""
        L, n = self.layout, self.n_particles
        q_new, qd_new = tuple(arm[:4]), tuple(arm[4:8])
        bottom = tuple(st[L.STR_BOTTOM:L.STR_BOTTOM + 3])
        top = tuple(st[L.STR_TOP:L.STR_TOP + 3])
        ball = tuple(st[3 * n:3 * n + 3])
        stats = self.stats_soa(s, q_new, qd_new, bottom, top, ball)
        out = list(q_new + qd_new)
        out += list(st[:3 * (n + 1)])
        out += list(s[L.PARTICLES:L.PARTICLES + 3 * (n + 1)])
        out += list(st[L.STR_REACTION:L.STR_REACTION + 3])
        out += list(stats)
        out += [s[L.Q0 + j] for j in range(4)]
        return tuple(out)

    def step_soa(self, s, q_des, qd_des):
        """One control step of the lane state ``s`` toward the setpoint:
        the predictor (the arm under the previous step's reaction, the
        string at its new pose), with ``same_step_coupling`` the corrector
        (the arm again under this step's reaction, the string again), then
        the statistics. The kernel's skeleton composes the generated
        functions in this order."""
        L = self.layout
        arm = self.arm_soa(s, q_des, qd_des,
                           tuple(s[L.FORCE:L.FORCE + 3]))
        st = self.string_soa(s, arm)
        if self.same_step_coupling:
            arm = self.arm_soa(s, q_des, qd_des,
                               tuple(st[L.STR_REACTION:L.STR_REACTION + 3]))
            st = self.string_soa(s, arm)
        return self.commit_soa(s, arm, st)

    def hang_drops(self):
        """Each point's drop below the cup's bottom in the hanging string
        (``linspace`` over the string's length, folded in float32)."""
        n = self.n_particles
        step = np.float32(1.0) / np.float32(n)
        return [_f32_mul(1.0 if i == n else float(np.float32(i) * step),
                         -STRING_LENGTH) for i in range(n + 1)]

    def hang_soa(self, bottom, drop):
        """A point of the hanging string: ``drop`` below ``bottom``."""
        return (bottom[0], bottom[1], bottom[2] + drop)

    def reset_soa(self, q0):
        """The lane state at rest at ``q0``, the string hanging straight
        down from the cup's bottom, the statistics at 0 and ``max_pot_m``
        at -inf (a Python float: the kernel's skeleton writes it)."""
        bottom, _, _ = self.cup_frame_soa(q0)
        parts = []
        for drop in self.hang_drops():
            parts += list(self.hang_soa(bottom, drop))
        return (tuple(q0) + (0.0,) * 4 + tuple(parts) + tuple(parts)
                + (0.0,) * 3 + (-math.inf,) + (0.0,) * 5 + tuple(q0))

    def clear_soa(self, s):
        """After the stabilize phase (eagerly; the kernel's skeleton does
        the same): the statistics cleared and the position penalty's pose
        set to the arm's, since the reference scores only the trajectory
        and the cool-down."""
        L = self.layout
        out = list(s)
        out[L.MAX_POT] = torch.full_like(s[L.MAX_POT], -math.inf)
        for k in (L.SUM_VEL, L.SUM_POS, L.SUM_BALL, L.N_STEPS):
            out[k] = torch.zeros_like(s[k])
        for j in range(4):
            out[L.Q0 + j] = s[L.Q + j]
        return tuple(out)

    def score_soa(self, s):
        """(reward, success 0/1) of a final lane state: the dipole
        potential's state reward less the mean penalties (-1 more for a
        violated lane), and the ball inside the cup's cylinder."""
        L, n = self.layout, self.n_particles
        q = tuple(s[L.Q + j] for j in range(4))
        bottom, _, up = self.cup_frame_soa(q)
        ball = L.point(s, L.PARTICLES, n)
        rl = v3_sub(ball, bottom)
        pot_l = v3_dot(rl, up) / (v3_dot(rl, rl) + self.dipole_eps)
        state_reward = sm.exp(
            self.min_weight * self.dipole_beta * s[L.MAX_POT]
            + (1.0 - self.min_weight) * self.dipole_beta * pot_l)
        count = sm.maximum(s[L.N_STEPS], 1.0)
        reward = (state_reward
                  - self.joint_vel_penalty * s[L.SUM_VEL] / count
                  - self.joint_pos_penalty * s[L.SUM_POS] / count
                  - self.ball_vel_penalty * s[L.SUM_BALL] / count)
        violated = s[L.VIOLATED]
        reward = sm.where(violated, reward - 1.0, reward)
        h = v3_dot(rl, up)
        radial = _norm(v3_sub(rl, v3_scale(h, up)))
        success = sm.logical_and(
            sm.logical_and(sm.logical_and(le(radial, CUP_INNER_RADIUS),
                                          ge(h, 0.0)),
                           le(h, CUP_DEPTH)),
            1.0 - violated)
        return reward, success

    # ---- tensors <-> the program's scalars -------------------------------

    def scalars(self, state: BicState):
        """The lane state of ``state`` as the program's tuple of tensors."""
        n = self.n_particles + 1
        parts = state.particles.reshape(*state.particles.shape[:-2], 3 * n)
        prev = state.particles_prev.reshape(*parts.shape)
        f32 = torch.float32
        return (*state.arm.qpos.unbind(-1), *state.arm.qvel.unbind(-1),
                *parts.unbind(-1), *prev.unbind(-1),
                *state.string_force.unbind(-1), state.max_pot_m,
                state.sum_vel_pen, state.sum_pos_pen, state.sum_ball_vel_pen,
                state.n_steps, state.violated.to(f32), *state.q0.unbind(-1))

    def state_of(self, s, t) -> BicState:
        """The ``BicState`` of a tuple of the program's scalars (tensors,
        constants broadcast) at step count ``t``."""
        L, n = self.layout, self.n_particles + 1
        x = stack_lanes(s)
        lead = x.shape[:-1]

        def field(lo, size):
            return x[..., lo:lo + size]

        return BicState(
            arm=PhysicsState(qpos=field(L.Q, 4), qvel=field(L.QD, 4)),
            particles=field(L.PARTICLES, 3 * n).reshape(*lead, n, 3),
            particles_prev=field(L.PREV, 3 * n).reshape(*lead, n, 3),
            string_force=field(L.FORCE, 3), max_pot_m=x[..., L.MAX_POT],
            sum_vel_pen=x[..., L.SUM_VEL], sum_pos_pen=x[..., L.SUM_POS],
            sum_ball_vel_pen=x[..., L.SUM_BALL],
            n_steps=x[..., L.N_STEPS], q0=field(L.Q0, 4),
            violated=x[..., L.VIOLATED] != 0, t=t)

    # ---- the JAX package's interface, over tensors --------------------------

    def cup_frame(self, qpos):
        """(bottom, top, up) of the cup, each (..., 3)."""
        return tuple(stack_lanes((qpos[..., 0],) + v)[..., 1:]
                     for v in self.cup_frame_soa(tuple(qpos.unbind(-1))))

    def anchor_jacobian_t(self, qpos, force):
        """``J(qpos)^T force`` (..., 4): the torque the string's ``force``
        on the cup anchor puts on the joints."""
        tau = self.jacobian_t_soa(tuple(qpos.unbind(-1)),
                                  tuple(force.unbind(-1)))
        return stack_lanes((qpos[..., 0],) + tau)[..., 1:]

    def _pbd_step(self, particles, particles_prev, anchor, qpos):
        """One PBD step of (..., P+1, 3) particles: (new particles, the
        previous ones)."""
        frame = self.cup_frame_soa(tuple(qpos.unbind(-1)))
        new = self.pbd_soa([tuple(p.unbind(-1)) for p in
                            particles.unbind(-2)],
                           [tuple(p.unbind(-1)) for p in
                            particles_prev.unbind(-2)],
                           tuple(anchor.unbind(-1)), frame)
        like = particles[..., 0, 0]
        pts = torch.stack([stack_lanes((like,) + p)[..., 1:] for p in new],
                          -2)
        return pts, particles

    def _ball_hits_robot(self, qpos, ball):
        """(...) bool: the ball within 5 cm of an arm link."""
        hit = self.hits_robot_soa(tuple(qpos.unbind(-1)),
                                  tuple(ball.unbind(-1)))
        return hit != 0

    def step(self, state: BicState, q_des, qd_des) -> BicState:
        """One control step toward the setpoint (``q_des``, ``qd_des``)
        (..., 4)."""
        s = self.step_soa(self.scalars(state), tuple(q_des.unbind(-1)),
                          tuple(qd_des.unbind(-1)))
        return self.state_of(s, state.t + 1)

    def reset(self, q0) -> BicState:
        """The state at rest at ``q0`` (..., 4)."""
        s = self.reset_soa(tuple(q0.unbind(-1)))
        return self.state_of(s, torch.zeros(q0.shape[:-1], dtype=torch.int32,
                                            device=q0.device))

    def execute_trajectory(self, q0, qs, qds) -> BicState:
        """stabilize -> trajectory -> cool-down from ``q0`` (4,) through
        the setpoints ``qs``, ``qds`` (..., T, 4); returns the final state
        with the reward statistics of the last two phases. This is the
        plain version of the ball-in-a-cup kernel (``bic_kernel``)."""
        lead = qs.shape[:-2]
        state = self.reset(q0.expand(*lead, 4))
        t = state.t
        s = self.scalars(state)
        hold = tuple(q0.expand(*lead, 4).unbind(-1))
        still = tuple(torch.zeros_like(x) for x in hold)
        for _ in range(self.stabilize_steps):
            s = self.step_soa(s, hold, still)
        s = self.clear_soa(s)
        for k in range(qs.shape[-2]):
            s = self.step_soa(s, tuple(qs[..., k, :].unbind(-1)),
                              tuple(qds[..., k, :].unbind(-1)))
        last = tuple(qs[..., -1, :].unbind(-1))
        for _ in range(self.cooldown_steps):
            s = self.step_soa(s, last, still)
        steps = self.stabilize_steps + qs.shape[-2] + self.cooldown_steps
        return self.state_of(s, t + steps)

    def reward_and_success(self, state: BicState):
        """(reward (...), success (...) bool) of a final state."""
        reward, success = self.score_soa(self.scalars(state))
        return reward, success != 0
