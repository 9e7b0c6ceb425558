"""Pick-and-carry with a free ball (relocate-v0) on the scalar physics program.

Port of ``ppi_tpu/envs/relocate.py``: a 4-DoF arm with a two-finger caging
gripper must grasp a free ball (three slides) resting on a table and carry
it to an in-air goal. Both the goal and the ball's start are sampled per
episode (the reachable subset of the mj_envs relocate-v0 distributions).
The scene and the reward shape are the JAX env's.

``step`` on a CUDA state is one launch of the env's rollout kernel (N
lanes, H=1; ``rollout_kernel.env_step``); on a CPU state it is
``plain_step``, the eager scalar program over whatever batch shape the
state has. The goal is the reward's per-episode constants
(``scalar_reward_consts``); the ball's start is part of ``qpos``.
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

YAW, SHOULDER, ELBOW, WRIST, FING_L, FING_R, BALL_X, BALL_Y, BALL_Z = range(9)

TABLE_Z = 0.60
BALL_RADIUS = 0.04
BALL_START = (0.58, 0.0)
TARGET = (0.60, 0.18, 0.88)   # fixed in-air goal (fixed_goal=True)
# per-episode goal box: the 4-DoF arm's reachable part of the mj_envs
# relocate target distribution
GOAL_X = (0.50, 0.68)
GOAL_Y = (-0.20, 0.20)
GOAL_Z = (TABLE_Z + 0.15, TABLE_Z + 0.30)
START_RANGE = 0.05            # ball start xy offset ~ U(-0.05, 0.05)
LIFT_Z = TABLE_Z + BALL_RADIUS + 0.015   # the ball counts as lifted above

_ACTION_LOW = (-1.5, -1.2, -2.0, -2.0, -1.1, -0.6)
_ACTION_HIGH = (1.5, 1.2, 2.0, 2.0, 0.6, 1.1)


def _build_model():
    b = ModelBuilder()
    # --- arm (the door arm's class) ---
    b.add_body(parent=-1, joint_type=HINGE, axis=(0, 0, 1),
               offset_pos=(0, 0, TABLE_Z + 0.35), mass=2.0, damping=2.0,
               armature=0.1, q_limit=(-1.5, 1.5), limit_k=50.0)
    b.add_body(parent=YAW, joint_type=HINGE, axis=(0, 1, 0),
               offset_pos=(0, 0, 0), mass=2.0, com=(0.17, 0, 0),
               damping=2.0, armature=0.1, q_limit=(-1.2, 1.2), limit_k=50.0)
    b.add_body(parent=SHOULDER, joint_type=HINGE, axis=(0, 1, 0),
               offset_pos=(0.35, 0, 0), mass=1.5, com=(0.17, 0, 0),
               damping=1.5, armature=0.08, q_limit=(-2.0, 2.0), limit_k=50.0)
    b.add_body(parent=ELBOW, joint_type=HINGE, axis=(0, 1, 0),
               offset_pos=(0.35, 0, 0), mass=0.8, com=(0.08, 0, 0),
               damping=1.0, armature=0.05, q_limit=(-2.0, 2.0), limit_k=50.0)
    # --- fingers: hinges about the hand axis, swinging under the ball ---
    b.add_body(parent=WRIST, joint_type=HINGE, axis=(1, 0, 0),
               offset_pos=(0.22, 0.065, 0.0), mass=0.15,
               com=(0.0, 0.0, -0.06), inertia=np.diag([1e-3, 1e-3, 1e-3]),
               damping=0.3, armature=0.02, q_limit=(-1.1, 0.6), limit_k=30.0)
    b.add_body(parent=WRIST, joint_type=HINGE, axis=(1, 0, 0),
               offset_pos=(0.22, -0.065, 0.0), mass=0.15,
               com=(0.0, 0.0, -0.06), inertia=np.diag([1e-3, 1e-3, 1e-3]),
               damping=0.3, armature=0.02, q_limit=(-0.6, 1.1), limit_k=30.0)
    # --- free ball: 3-slide chain, translational DoFs only ---
    bx = b.add_body(parent=-1, joint_type=SLIDE, axis=(1, 0, 0),
                    offset_pos=(BALL_START[0], BALL_START[1],
                                TABLE_Z + BALL_RADIUS),
                    mass=1e-3, armature=1e-4, damping=0.0)
    by = b.add_body(parent=bx, joint_type=SLIDE, axis=(0, 1, 0),
                    offset_pos=(0, 0, 0), mass=1e-3, armature=1e-4,
                    damping=0.0)
    b.add_body(parent=by, joint_type=SLIDE, axis=(0, 0, 1),
               offset_pos=(0, 0, 0), mass=0.10,
               inertia=np.diag([5e-4, 5e-4, 5e-4]), armature=1e-4,
               damping=0.05)

    # each finger is forked along the hand axis: four tips cage the ball
    # below its equator
    palm = b.add_sphere(WRIST, (0.22, 0.0, 0.0), 0.03)
    tips = [b.add_sphere(FING_L, (-0.035, 0.0, -0.095), 0.018),
            b.add_sphere(FING_L, (0.035, 0.0, -0.095), 0.018),
            b.add_sphere(FING_R, (-0.035, 0.0, -0.095), 0.018),
            b.add_sphere(FING_R, (0.035, 0.0, -0.095), 0.018)]
    ball = b.add_sphere(BALL_Z, (0.0, 0.0, 0.0), BALL_RADIUS)
    table = b.add_plane(normal=(0.0, 0.0, 1.0), offset=TABLE_Z)

    b.add_contact_sphere_sphere(ball, palm)
    for tip in tips:
        b.add_contact_sphere_sphere(ball, tip)
        b.add_contact_sphere_plane(tip, table)
    b.add_contact_sphere_plane(ball, table)
    b.add_contact_sphere_plane(palm, table)
    b.contact_stiffness = 2e3
    b.contact_damping = 8.0
    b.friction_mu = 1.2
    b.friction_vel_k = 30.0
    return b.finalize(), palm, tuple(tips), ball


def scalar_grasp_ball_sites(m, q, palm_geom, tip_geoms, ball_geom):
    """Grasp point (the midpoint of the palm and the tip centroid) and ball
    centre, as scalars."""
    rots, poss, _, _ = fk_soa(m, q)
    palm = geom_point_soa(m, rots, poss, palm_geom)
    tips = [geom_point_soa(m, rots, poss, g) for g in tip_geoms]
    n = float(len(tips))
    grasp = tuple(0.5 * (sum(t[i] for t in tips) / n + palm[i])
                  for i in range(3))
    ball = geom_point_soa(m, rots, poss, ball_geom)
    return grasp, ball


def _norm3(a, b):
    dx, dy, dz = a[0] - b[0], a[1] - b[1], a[2] - b[2]
    return sm.sqrt(dx * dx + dy * dy + dz * dz)


@dataclasses.dataclass(frozen=True)
class RelocateState:
    physics: PhysicsState
    target: torch.Tensor  # (3,) sampled in-air goal position
    t: torch.Tensor       # () int32 step count


@dataclasses.dataclass(frozen=True)
class Relocate:
    """relocate-v0-class task; actions are PD position targets for the 4
    arm joints and the 2 finger joints."""

    action_dim: int = 6
    dt: float = 0.02
    substeps: int = 8
    kp: float = 60.0
    kd: float = 6.0
    kp_finger: float = 3.0
    kd_finger: float = 0.3
    fixed_goal: bool = False  # True: pin the fixed goal and ball start

    name = "relocate-v0"
    # the rollout kernel's split layout, its substep partitioned by the
    # body tree (split_layout.plan_partition): the arm's chain, each finger
    # and the ball on warps of their own; faster than the lane and warp
    # layouts on the card at the canonical N=256/H=20 (PERF.md section 6,
    # row 1b)
    scalar_kernel_layout = "split"
    scalar_split_partition = "subtree"

    def __post_init__(self):
        model, palm, tips, ball = _build_model()
        object.__setattr__(self, "_model", model)
        object.__setattr__(self, "_soa", SoaModel(model))
        object.__setattr__(self, "_palm_geom", palm)
        object.__setattr__(self, "_tip_geoms", tips)
        object.__setattr__(self, "_ball_geom", ball)
        object.__setattr__(self, "_sites_soa", make_sites_soa(model))

    @property
    def action_low(self):
        return torch.tensor(_ACTION_LOW)

    @property
    def action_high(self):
        return torch.tensor(_ACTION_HIGH)

    def sample_goal(self, generator: torch.Generator, device):
        """In-air goal, uniform in the GOAL_X/Y/Z box."""
        if self.fixed_goal:
            return torch.tensor(TARGET, device=device)
        lo = torch.tensor([GOAL_X[0], GOAL_Y[0], GOAL_Z[0]], device=device)
        hi = torch.tensor([GOAL_X[1], GOAL_Y[1], GOAL_Z[1]], device=device)
        u = torch.rand(3, generator=generator, device=device)
        return lo + u * (hi - lo)

    def sample_start(self, generator: torch.Generator, device):
        """Ball-start xy offset about BALL_START, ~ U(-0.05, 0.05)."""
        if self.fixed_goal:
            return torch.zeros(2, device=device)
        u = torch.rand(2, generator=generator, device=device)
        return (2.0 * u - 1.0) * START_RANGE

    def reset(self, generator: torch.Generator, device, goal=None,
              start=None):
        """Open gripper hovering over the ball start; ``goal`` and ``start``
        pin the goal and the ball's xy offset instead of sampling them (the
        goal is drawn first, then the start)."""
        if goal is None:
            goal = self.sample_goal(generator, device)
        if start is None:
            start = self.sample_start(generator, device)
        start = as_f32(start, device)
        qpos = torch.cat([
            torch.tensor([0.0, -0.346, 1.83, -1.484, 0.5, -0.5],
                         device=device),
            start, torch.zeros(1, device=device)])
        return RelocateState(
            physics=PhysicsState(qpos=qpos, qvel=torch.zeros(9, device=device)),
            target=as_f32(goal, device),
            t=torch.zeros((), dtype=torch.int32, device=device))

    # ---- the scalar contract (shared by step() and the rollout kernel) ----

    def scalar_torque(self, m, q, qd, act):
        kps = [self.kp] * 4 + [self.kp_finger] * 2
        kds = [self.kd] * 4 + [self.kd_finger] * 2
        tau = [kps[j] * (sm.clip(act[j], _ACTION_LOW[j], _ACTION_HIGH[j])
                         - q[j]) - kds[j] * qd[j] for j in range(6)]
        tau += [sm.zeros_like(q[0])] * 3  # free ball
        return tuple(tau)

    def scalar_reward_consts(self, state):
        return state.target

    def scalar_reward(self, m, q, qd, consts):
        # mj_envs relocate-v0 reward shape: reach + lift gate + carry terms
        # + staged proximity bonuses
        grasp, ball = scalar_grasp_ball_sites(
            m, q, self._palm_geom, self._tip_geoms, self._ball_geom)
        reach = _norm3(grasp, ball)
        carry = _norm3(ball, consts)
        g2t = _norm3(grasp, consts)
        lifted = sm.gt(ball[2], LIFT_Z)
        vel2 = sum(qd[j] * qd[j] for j in range(6))
        return (-0.1 * reach
                + lifted * (1.0 - 0.5 * g2t - 0.5 * carry)
                - 1e-4 * vel2
                + 10.0 * sm.lt(carry, 0.1)
                + 20.0 * sm.lt(carry, 0.05))

    # ---- the env ---------------------------------------------------------

    def step(self, state: RelocateState, action):
        """(state, action (..., 6)) -> (next state, reward (...)): one
        launch of the rollout kernel on a CUDA state, the eager scalar
        program on a CPU state."""
        return rk.env_step(self, state, action)

    def plain_step(self, state: RelocateState, action):
        """The eager step, on any device."""
        return rk.env_step(self, state, action, plain=True)

    def _sites(self, qpos):
        pts = self._sites_soa(qpos)
        palm = pts[..., self._palm_geom, :]
        tips = sum(pts[..., g, :] for g in self._tip_geoms) \
            / len(self._tip_geoms)
        grasp = 0.5 * (tips + palm)
        ball = pts[..., self._ball_geom, :]
        return palm, grasp, ball

    def observe(self, state: RelocateState):
        """Observation of a single (unbatched) state."""
        q, qd = state.physics.qpos, state.physics.qvel
        palm, grasp, ball = self._sites(q)
        tgt = state.target
        return torch.cat([q[:6], qd[:6], palm, grasp, ball,
                          grasp - ball, ball - tgt, grasp - tgt])

    def success(self, state: RelocateState):
        _, _, ball = self._sites(state.physics.qpos)
        return torch.linalg.norm(ball - state.target, dim=-1) < 0.1
