"""In-hand pen reorientation (pen-v0) on the scalar physics program.

Port of ``ppi_tpu/envs/pen.py``: a free pen (three compliant slides plus
free yaw and pitch) held between two 2-DoF fingertips must be turned until
its long axis matches a goal axis sampled per episode (mj_envs pen-v0:
desired yaw and pitch ~ U(-1, 1) rad), without dropping it. The scene and
the reward shape are the JAX env's.

``step`` on a CUDA state is one launch of the env's rollout kernel (N
lanes, H=1; ``rollout_kernel.env_step``); on a CPU state it is
``plain_step``, the eager scalar program (``scalar_torque``, the SoA
substeps, ``scalar_reward``) over whatever batch shape the state has. The
goal axis is the reward's per-episode constants (``scalar_reward_consts``),
which the rollout kernel reads from a device pointer.
"""

import dataclasses

import numpy as np
import torch

from ppi_tpu_torch.envs.base import as_f32
from ppi_tpu_torch.envs.physics import rollout_kernel as rk
from ppi_tpu_torch.envs.physics import scalar_math as sm
from ppi_tpu_torch.envs.physics.engine import (
    HINGE, SLIDE, ModelBuilder, PhysicsState)
from ppi_tpu_torch.envs.physics.engine_soa import (
    SoaModel, fk_soa, geom_point_soa, make_sites_soa)

# dof order: pen x,y,z slides, yaw (about z), pitch (about y), then
# fingertip A (y, z) and fingertip B (y, z)
PEN_X, PEN_Y, PEN_Z, PEN_YAW, PEN_PITCH, A_Y, A_Z, B_Y, B_Z = range(9)

HOLD_POS = (0.45, 0.0, 0.90)   # nominal in-hand pen centre
PEN_HALF = 0.095               # rod half-length
TARGET_YAW, TARGET_PITCH = 0.4, -0.5   # fixed goal (fixed_goal=True)
GOAL_RANGE = 1.0               # desired yaw/pitch ~ U(-1, 1) rad


def axis_from_angles(yaw, pitch):
    """Rz(yaw) @ Ry(pitch) @ x_hat as a unit vector (f32 tensors)."""
    yaw = torch.as_tensor(yaw, dtype=torch.float32)
    pitch = torch.as_tensor(pitch, dtype=torch.float32)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    return torch.stack([cy * cp, sy * cp, -sp])


def target_axis():
    return axis_from_angles(TARGET_YAW, TARGET_PITCH)


def _build_model():
    b = ModelBuilder()
    # --- pen: 3 compliant slides (loose-grasp hold) + free yaw/pitch ---
    p = b.add_body(parent=-1, joint_type=SLIDE, axis=(1, 0, 0),
                   offset_pos=HOLD_POS, mass=1e-3, armature=1e-4,
                   damping=0.0, spring_k=50.0, spring_ref=0.0)
    p = b.add_body(parent=p, joint_type=SLIDE, axis=(0, 1, 0),
                   offset_pos=(0, 0, 0), mass=1e-3, armature=1e-4,
                   damping=0.5, spring_k=50.0, spring_ref=0.0)
    p = b.add_body(parent=p, joint_type=SLIDE, axis=(0, 0, 1),
                   offset_pos=(0, 0, 0), mass=1e-3, armature=1e-4,
                   damping=1.0, spring_k=50.0, spring_ref=0.0)
    # rotational damping: the viscosity of the loose grasp
    p = b.add_body(parent=p, joint_type=HINGE, axis=(0, 0, 1),
                   offset_pos=(0, 0, 0), mass=1e-3, armature=1e-3,
                   damping=0.05)
    b.add_body(parent=p, joint_type=HINGE, axis=(0, 1, 0),
               offset_pos=(0, 0, 0), mass=0.05,
               inertia=np.diag([1e-4, 3e-4, 3e-4]), armature=1e-3,
               damping=0.05)
    # --- fingertips: 2-DoF (y, z) planar manipulators near each pen end ---
    a = b.add_body(parent=-1, joint_type=SLIDE, axis=(0, 1, 0),
                   offset_pos=(HOLD_POS[0] + 0.06, 0.0, HOLD_POS[2]),
                   mass=0.05, armature=1e-3, damping=0.5,
                   q_limit=(-0.12, 0.12), limit_k=50.0)
    b.add_body(parent=a, joint_type=SLIDE, axis=(0, 0, 1),
               offset_pos=(0, 0, 0), mass=0.05, armature=1e-3, damping=0.5,
               q_limit=(-0.12, 0.12), limit_k=50.0)
    bb = b.add_body(parent=-1, joint_type=SLIDE, axis=(0, 1, 0),
                    offset_pos=(HOLD_POS[0] - 0.06, 0.0, HOLD_POS[2]),
                    mass=0.05, armature=1e-3, damping=0.5,
                    q_limit=(-0.12, 0.12), limit_k=50.0)
    b.add_body(parent=bb, joint_type=SLIDE, axis=(0, 0, 1),
               offset_pos=(0, 0, 0), mass=0.05, armature=1e-3, damping=0.5,
               q_limit=(-0.12, 0.12), limit_k=50.0)

    # geoms: pen end spheres define the rod segment; fingertip spheres
    end_a = b.add_sphere(PEN_PITCH, (PEN_HALF, 0, 0), 0.012)
    end_b = b.add_sphere(PEN_PITCH, (-PEN_HALF, 0, 0), 0.012)
    tip_a = b.add_sphere(A_Z, (0.0, 0.0, 0.0), 0.015)
    tip_b = b.add_sphere(B_Z, (0.0, 0.0, 0.0), 0.015)
    b.add_contact_sphere_segment(tip_a, end_a, end_b)
    b.add_contact_sphere_segment(tip_b, end_a, end_b)
    b.contact_stiffness = 2e3
    b.contact_damping = 5.0
    b.friction_mu = 0.8
    b.friction_vel_k = 30.0
    return b.finalize(), (end_a, end_b), (tip_a, tip_b)


def scalar_pen_pose(m, q, end_geoms):
    """Pen centre and normalized long axis from the two end-cap geoms."""
    rots, poss, _, _ = fk_soa(m, q)
    ea = geom_point_soa(m, rots, poss, end_geoms[0])
    eb = geom_point_soa(m, rots, poss, end_geoms[1])
    cx = 0.5 * (ea[0] + eb[0])
    cy = 0.5 * (ea[1] + eb[1])
    cz = 0.5 * (ea[2] + eb[2])
    dx, dy, dz = ea[0] - eb[0], ea[1] - eb[1], ea[2] - eb[2]
    norm = sm.sqrt(dx * dx + dy * dy + dz * dz) + 1e-9
    return (cx, cy, cz), (dx / norm, dy / norm, dz / norm)


@dataclasses.dataclass(frozen=True)
class PenState:
    physics: PhysicsState
    target_axis: torch.Tensor  # (3,) sampled goal orientation (unit)
    t: torch.Tensor            # () int32 step count


@dataclasses.dataclass(frozen=True)
class Pen:
    """pen-v0-class task; actions are PD position targets for the two
    fingertips' (y, z) slides."""

    action_dim: int = 4
    dt: float = 0.02
    substeps: int = 8
    kp: float = 8.0
    kd: float = 0.8
    fixed_goal: bool = False  # True: pin the fixed target

    name = "pen-v0"

    # the rollout kernel's split layout, its substep partitioned by the
    # body tree with the pen's chain cut into segments
    # (split_layout.plan_partition, "chain"): the pen's three slides and
    # yaw hinge with the solve, its pitch hinge, and each fingertip's two
    # slides each on a warp of its own; at the canonical N=96/H=15 on an
    # H100 (80GB HBM3, 700 W; chip_smoke.py phase 37) the main path's call
    # takes 0.336 ms against the lane layout's 0.390, the kernel alone
    # 0.329 against 0.382 (PERF.md section 6, row 1b)
    scalar_kernel_layout = "split"
    scalar_split_partition = "chain"

    def __post_init__(self):
        model, ends, tips = _build_model()
        object.__setattr__(self, "_model", model)
        object.__setattr__(self, "_soa", SoaModel(model))
        object.__setattr__(self, "_end_geoms", ends)
        object.__setattr__(self, "_tip_geoms", tips)
        object.__setattr__(self, "_sites_soa", make_sites_soa(model))

    @property
    def action_low(self):
        return torch.full((4,), -0.12)

    @property
    def action_high(self):
        return torch.full((4,), 0.12)

    def sample_goal(self, generator: torch.Generator, device):
        """Goal axis from yaw/pitch ~ U(-1, 1) rad."""
        if self.fixed_goal:
            return target_axis().to(device)
        u = torch.rand(2, generator=generator, device=device)
        yaw, pitch = ((2.0 * u - 1.0) * GOAL_RANGE).unbind()
        return axis_from_angles(yaw, pitch)

    def reset(self, generator: torch.Generator, device, goal=None):
        """Pen level in the hold, fingertips below/above the rod; ``goal``
        pins the goal axis instead of sampling it."""
        qpos = torch.zeros(9, device=device)
        qpos[A_Z], qpos[B_Z] = -0.05, 0.05
        if goal is None:
            goal = self.sample_goal(generator, device)
        return PenState(
            physics=PhysicsState(qpos=qpos, qvel=torch.zeros(9, device=device)),
            target_axis=as_f32(goal, device),
            t=torch.zeros((), dtype=torch.int32, device=device))

    # ---- the scalar contract (shared by step() and the rollout kernel) ----

    def scalar_torque(self, m, q, qd, act):
        tau = [sm.zeros_like(q[0])] * A_Y
        for j in range(self.action_dim):
            tgt = sm.clip(act[j], -0.12, 0.12)
            tau.append(self.kp * (tgt - q[A_Y + j]) - self.kd * qd[A_Y + j])
        return tuple(tau)

    def scalar_reward_consts(self, state):
        return state.target_axis

    def scalar_reward(self, m, q, qd, consts):
        # mj_envs pen-v0 reward shape: position hold + orientation
        # similarity + staged aligned bonuses + drop penalty
        tx, ty, tz = consts
        (cx, cy, cz), (ax, ay, az) = scalar_pen_pose(m, q, self._end_geoms)
        hx, hy, hz = HOLD_POS
        ex, ey, ez = cx - hx, cy - hy, cz - hz
        dist = sm.sqrt(ex * ex + ey * ey + ez * ez)
        similarity = ax * tx + ay * ty + az * tz
        dropped = sm.lt(cz, hz - 0.15)
        vel2 = sum(qd[j] * qd[j] for j in range(5))
        near = sm.lt(dist, 0.075)
        return (-1.0 * dist
                + similarity
                - 1e-3 * vel2
                + 10.0 * sm.logical_and(sm.gt(similarity, 0.90), near)
                + 50.0 * sm.logical_and(sm.gt(similarity, 0.95), near)
                - 5.0 * dropped)

    # ---- the env ---------------------------------------------------------

    def step(self, state: PenState, action):
        """(state, action (..., 4)) -> (next state, reward (...)): one
        launch of the rollout kernel on a CUDA state, the eager scalar
        program on a CPU state."""
        return rk.env_step(self, state, action)

    def plain_step(self, state: PenState, action):
        """The eager step, on any device."""
        return rk.env_step(self, state, action, plain=True)

    def _pen_pose(self, qpos):
        """(centre, unit axis) of the rod from the end-sphere sites."""
        pts = self._sites_soa(qpos)
        ea = pts[..., self._end_geoms[0], :]
        eb = pts[..., self._end_geoms[1], :]
        centre = 0.5 * (ea + eb)
        axis = (ea - eb) / (torch.linalg.norm(ea - eb, dim=-1,
                                              keepdim=True) + 1e-9)
        return centre, axis

    def observe(self, state: PenState):
        """Observation of a single (unbatched) state."""
        q, qd = state.physics.qpos, state.physics.qvel
        centre, axis = self._pen_pose(q)
        return torch.cat([q, qd, centre, axis, state.target_axis,
                          axis - state.target_axis, offset(centre, HOLD_POS)])

    def success(self, state: PenState):
        centre, axis = self._pen_pose(state.physics.qpos)
        dist = torch.linalg.norm(offset(centre, HOLD_POS), dim=-1)
        return ((axis * state.target_axis).sum(-1) > 0.95) & (dist < 0.075)


def offset(x, point):
    """``x - point`` for (..., 3) ``x`` and a constant point, with no copy
    of the point to the device."""
    return torch.stack([x[..., i] - point[i] for i in range(3)], -1)
