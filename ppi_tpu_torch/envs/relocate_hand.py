"""Pick-and-carry with three articulated digits (relocate-v0-hand).

Port of ``ppi_tpu/envs/relocate_hand.py``: relocate-v0's 4-DoF arm carries
three two-hinge digits of ``envs.hand.add_digit``, index and middle on
the +y side at different reaches and an opposing thumb on the -y side, so
the free ball is held by an articulated grasp (MCP curl + PIP wrap, six
digit contacts and a palm stop). 10 actuated joints, 13 DoF. The ball, the
sampled goal and ball start, the reward shape and the success test are
relocate-v0's.

``step`` on a CUDA state is one launch of the env's rollout kernel
(``rollout_kernel.kernel_step``); on a CPU state it is the eager scalar
program. The goal is the reward's per-episode constants; the ball's start
is part of ``qpos``.

The scripted expert (``scripted_carry``) is the JAX module's: a basket
curl of the digits under the ball, then the arm through fixed joint-space
waypoints, each control step one rollout-kernel launch on the card.
"""

import dataclasses

import numpy as np
import torch

from ppi_tpu_torch.envs.base import as_f32
from ppi_tpu_torch.envs.hand import (
    add_digit, digit_spheres, expert_start, hold_target)
from ppi_tpu_torch.envs.physics import rollout_kernel as rk
from ppi_tpu_torch.envs.physics import scalar_math as sm
from ppi_tpu_torch.envs.physics.engine import (
    HINGE, SLIDE, ModelBuilder, PhysicsState)
from ppi_tpu_torch.envs.physics.engine_soa import SoaModel, make_sites_soa
from ppi_tpu_torch.envs.relocate import (
    BALL_RADIUS, BALL_START, LIFT_Z, TABLE_Z, Relocate, _norm3,
    scalar_grasp_ball_sites)

# dof order: arm, then index (mcp, pip), middle (mcp, pip), thumb (mcp,
# pip), then ball x, y, z slides
(YAW, SHOULDER, ELBOW, WRIST,
 IDX_MCP, IDX_PIP, MID_MCP, MID_PIP, TH_MCP, TH_PIP,
 BALL_X, BALL_Y, BALL_Z) = range(13)

N_ACT = 10
L1, L2 = 0.055, 0.05

# +y-side digits curl toward -y (negative mcp), the thumb opposes
_LOW = (-1.5, -1.2, -2.0, -2.0, -1.2, -1.4, -1.2, -1.4, -0.6, 0.0)
_HIGH = (1.5, 1.2, 2.0, 2.0, 0.6, 0.0, 0.6, 0.0, 1.2, 1.4)

_QPOS0_ARM = (0.0, -0.346, 1.83, -1.484, 0.5, 0.0, 0.5, 0.0, -0.5, 0.0)


def _build_model():
    b = ModelBuilder()
    # --- arm (relocate-v0's) ---
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
    # --- digits hanging from the wrist, hinging about the hand axis ---
    down = (0.0, 0.0, -1.0)
    cfg = dict(axis=(1, 0, 0), link1=L1, link2=L2, direction=down,
               damping1=0.3, damping2=0.25, limit_k=30.0)
    idx = add_digit(b, WRIST, (0.255, 0.065, 0.0),
                    mcp_limits=(_LOW[4], _HIGH[4]),
                    pip_limits=(_LOW[5], _HIGH[5]), **cfg)
    mid = add_digit(b, WRIST, (0.185, 0.065, 0.0),
                    mcp_limits=(_LOW[6], _HIGH[6]),
                    pip_limits=(_LOW[7], _HIGH[7]), **cfg)
    th = add_digit(b, WRIST, (0.22, -0.065, 0.0),
                   mcp_limits=(_LOW[8], _HIGH[8]),
                   pip_limits=(_LOW[9], _HIGH[9]), **cfg)
    # --- free ball: 3-slide chain (relocate-v0's) ---
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

    palm = b.add_sphere(WRIST, (0.22, 0.0, 0.0), 0.03)
    tip_geoms = []
    for ids in (idx, mid, th):
        prox, tip = digit_spheres(b, *ids, link1=L1, link2=L2,
                                  prox_radius=0.017, tip_radius=0.017,
                                  direction=down)
        tip_geoms += [prox, tip]
    ball = b.add_sphere(BALL_Z, (0.0, 0.0, 0.0), BALL_RADIUS)
    table = b.add_plane(normal=(0.0, 0.0, 1.0), offset=TABLE_Z)

    b.add_contact_sphere_sphere(ball, palm)
    for g in tip_geoms:
        b.add_contact_sphere_sphere(ball, g)
        b.add_contact_sphere_plane(g, table)
    b.add_contact_sphere_plane(ball, table)
    b.add_contact_sphere_plane(palm, table)
    # relocate-v0's contact material
    b.contact_stiffness = 2e3
    b.contact_damping = 8.0
    b.friction_mu = 1.2
    b.friction_vel_k = 30.0
    return b.finalize(), palm, tuple(tip_geoms), ball


@dataclasses.dataclass(frozen=True)
class RelocateHandState:
    physics: PhysicsState
    target: torch.Tensor  # (3,) sampled in-air goal position
    t: torch.Tensor       # () int32 step count


@dataclasses.dataclass(frozen=True)
class RelocateHand(Relocate):
    """relocate-v0-class task on the three-digit hand; actions are PD
    position targets for the 4 arm + 6 digit joints. The goal and start
    distributions, the sites and the success test are relocate-v0's."""

    action_dim: int = N_ACT
    kp_digit: float = 4.0
    kd_digit: float = 0.35
    kp_thumb: float = 8.0   # the thumb opposes two fingers (tripod grasp):
    kd_thumb: float = 0.7   # double gains keep the pinch balanced

    name = "relocate-v0-hand"
    # one thread's dependent chain bounds the lane layout here: the
    # rollout kernel runs one rollout a warp (rollout_kernel.kernel_layout)
    scalar_kernel_layout = "warp"

    _low, _high = _LOW, _HIGH
    _qpos0_act = _QPOS0_ARM   # the actuated joints' initial posture
    _build = staticmethod(_build_model)

    def __post_init__(self):
        model, palm, tips, ball = self._build()
        object.__setattr__(self, "_model", model)
        object.__setattr__(self, "_soa", SoaModel(model))
        object.__setattr__(self, "_palm_geom", palm)
        object.__setattr__(self, "_tip_geoms", tips)
        object.__setattr__(self, "_ball_geom", ball)
        object.__setattr__(self, "_sites_soa", make_sites_soa(model))

    @property
    def action_low(self):
        return torch.tensor(self._low)

    @property
    def action_high(self):
        return torch.tensor(self._high)

    def reset(self, generator: torch.Generator, device, goal=None,
              start=None):
        """The open hand hovering just above the nominal ball start, digits
        splayed; ``goal`` and ``start`` pin the goal and the ball's xy
        offset instead of sampling them (the goal is drawn first)."""
        if goal is None:
            goal = self.sample_goal(generator, device)
        if start is None:
            start = self.sample_start(generator, device)
        qpos = torch.cat([torch.tensor(self._qpos0_act, device=device),
                          as_f32(start, device),
                          torch.zeros(1, device=device)])
        return RelocateHandState(
            physics=PhysicsState(qpos=qpos,
                                 qvel=torch.zeros_like(qpos)),
            target=as_f32(goal, device),
            t=torch.zeros((), dtype=torch.int32, device=device))

    # ---- the scalar contract (shared by step() and the rollout kernel) ----

    def _gains(self):
        return ([self.kp] * 4 + [self.kp_digit] * 4 + [self.kp_thumb] * 2,
                [self.kd] * 4 + [self.kd_digit] * 4 + [self.kd_thumb] * 2)

    def scalar_torque(self, m, q, qd, act):
        kps, kds = self._gains()
        tau = [kps[j] * (sm.clip(act[j], self._low[j], self._high[j]) - q[j])
               - kds[j] * qd[j] for j in range(self.action_dim)]
        tau += [sm.zeros_like(q[0])] * 3  # free ball
        return tuple(tau)

    def scalar_reward(self, m, q, qd, consts):
        # relocate-v0's reward shape (mj_envs relocate-v0)
        grasp, ball = scalar_grasp_ball_sites(
            m, q, self._palm_geom, self._tip_geoms, self._ball_geom)
        reach = _norm3(grasp, ball)
        carry = _norm3(ball, consts)
        g2t = _norm3(grasp, consts)
        lifted = sm.gt(ball[2], LIFT_Z)
        vel2 = sum(qd[j] * qd[j] for j in range(self.action_dim))
        return (-0.1 * reach
                + lifted * (1.0 - 0.5 * g2t - 0.5 * carry)
                - 1e-4 * vel2
                + 10.0 * sm.lt(carry, 0.1)
                + 20.0 * sm.lt(carry, 0.05))

    # ---- the env ---------------------------------------------------------

    def step(self, state: RelocateHandState, action):
        """(state, action (..., 10)) -> (next state, reward (...)): one
        launch of the rollout kernel on a CUDA state, the eager scalar
        program on a CPU state."""
        return rk.env_step(self, state, action)

    def plain_step(self, state: RelocateHandState, action):
        """The eager step, on any device."""
        return rk.env_step(self, state, action, plain=True)

    def observe(self, state: RelocateHandState):
        """Observation of a single (unbatched) state."""
        q, qd = state.physics.qpos, state.physics.qvel
        palm, grasp, ball = self._sites(q)
        tgt = state.target
        n = self.action_dim
        return torch.cat([q[:n], qd[:n], palm, grasp, ball,
                          grasp - ball, ball - tgt, grasp - tgt])


# ---------------------------------------------------------------------------
# scripted expert (feasibility oracle)
# ---------------------------------------------------------------------------

# the gentle "basket" curl: an MCP-dominant swing puts the six digit
# spheres under the ball's lower hemisphere (a cradle held by normal
# forces); a deeper PIP wrap turns it into an equator pinch that ejects
# the ball
GRIP_FINGER = (-0.45, -0.05)
GRIP_THUMB = (0.45, 0.05)

# the wrist-level carry waypoints of the arm (yaw, shoulder, elbow, wrist)
CARRY_POSES = ((0.0, -0.45, 1.82, -1.40),
               (0.07, -0.60, 1.85, -1.28),
               (0.15, -0.75, 1.88, -1.15),
               (0.22, -0.87, 1.91, -1.05),
               (0.291, -1.20, 1.80, -0.75))


def scripted_carry(env, state0=None, frames=None, device="cuda"):
    """Hand-scripted grasp-and-carry to the fixed goal: curl the three
    digits into a basket under the ball (60 steps), then walk the arm
    through ``CARRY_POSES`` (40 steps each). Returns (final state, info).
    The waypoints end at the fixed TARGET: use ``fixed_goal=True``.
    ``frames`` (a list) collects each segment's qpos trajectory."""
    state = expert_start(env, state0, device)
    grip = state.physics.qpos[:N_ACT].clone()
    grip[IDX_MCP], grip[IDX_PIP] = GRIP_FINGER
    grip[MID_MCP], grip[MID_PIP] = GRIP_FINGER
    grip[TH_MCP], grip[TH_PIP] = GRIP_THUMB
    state = hold_target(env, state, grip, 60, frames)
    _, _, ball_grip = env._sites(state.physics.qpos)
    for p in CARRY_POSES:
        state = hold_target(env, state, torch.cat([grip.new_tensor(p),
                                                   grip[4:]]), 40, frames)
    _, _, ball = env._sites(state.physics.qpos)
    return state, {
        "ball_after_grip": ball_grip,
        "ball": ball,
        "dist": float(torch.linalg.norm(ball - state.target)),
        "success": bool(env.success(state)),
    }
