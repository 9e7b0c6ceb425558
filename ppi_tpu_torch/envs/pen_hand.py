"""In-hand pen reorientation with three articulated digits (pen-v0-hand).

Port of ``ppi_tpu/envs/pen_hand.py``: pen-v0's compliant free pen is
turned by three two-hinge digits of ``envs.hand.add_digit``, index and
ring mounted below the pen ends pointing up, an opposing thumb above
mid-rod pointing down, through sphere-segment penalty contacts. 6 actuated
joints, 11 DoF. Digits hinge about x, so each fingertip sweeps the local
y-z plane. The reward shape, the compliant hold, the sampled goal
(yaw/pitch ~ U(-1, 1) rad) and the success test are pen-v0's.

``step`` on a CUDA state is one launch of the env's rollout kernel
(``rollout_kernel.kernel_step``); on a CPU state it is the eager scalar
program. The goal axis is the reward's per-episode constants.

The scripted expert (``scripted_reorient``) is the JAX module's: a
closed-loop fingertip controller with a closed-form two-link IK a digit
(``_ik_up``), each control step one rollout-kernel launch on the card.
"""

import dataclasses

import numpy as np
import torch

from ppi_tpu_torch.envs.base import as_f32
from ppi_tpu_torch.envs.hand import add_digit, digit_spheres, expert_start
from ppi_tpu_torch.envs.pen import (
    GOAL_RANGE, HOLD_POS, PEN_HALF, axis_from_angles, offset,
    scalar_pen_pose, target_axis)
from ppi_tpu_torch.envs.physics import rollout_kernel as rk
from ppi_tpu_torch.envs.physics import scalar_math as sm
from ppi_tpu_torch.envs.physics.engine import (
    HINGE, SLIDE, ModelBuilder, PhysicsState)
from ppi_tpu_torch.envs.physics.engine_soa import SoaModel, make_sites_soa

# dof order: pen x,y,z slides, yaw, pitch; then digit A (mcp, pip) under
# the +x pen end, digit B under the -x end, thumb (mcp, pip) above mid-rod
(PEN_X, PEN_Y, PEN_Z, PEN_YAW, PEN_PITCH,
 A_MCP, A_PIP, B_MCP, B_PIP, TH_MCP, TH_PIP) = range(11)

N_ACT = 6
L1, L2 = 0.055, 0.05          # digit link lengths (reach 0.105)
DIGIT_DROP = 0.06             # finger mounts this far below the rod centre
THUMB_RISE = 0.07             # thumb mount this far above

_LOW = (-1.3, -2.2, -1.3, -2.2, -1.3, -2.2)
_HIGH = (1.3, 2.2, 1.3, 2.2, 1.3, 2.2)


def _build_model():
    b = ModelBuilder()
    # --- pen: pen-v0's compliant free body ---
    p = b.add_body(parent=-1, joint_type=SLIDE, axis=(1, 0, 0),
                   offset_pos=HOLD_POS, mass=1e-3, armature=1e-4,
                   damping=0.0, spring_k=50.0, spring_ref=0.0)
    p = b.add_body(parent=p, joint_type=SLIDE, axis=(0, 1, 0),
                   offset_pos=(0, 0, 0), mass=1e-3, armature=1e-4,
                   damping=0.5, spring_k=50.0, spring_ref=0.0)
    p = b.add_body(parent=p, joint_type=SLIDE, axis=(0, 0, 1),
                   offset_pos=(0, 0, 0), mass=1e-3, armature=1e-4,
                   damping=1.0, spring_k=50.0, spring_ref=0.0)
    p = b.add_body(parent=p, joint_type=HINGE, axis=(0, 0, 1),
                   offset_pos=(0, 0, 0), mass=1e-3, armature=1e-3,
                   damping=0.05)
    b.add_body(parent=p, joint_type=HINGE, axis=(0, 1, 0),
               offset_pos=(0, 0, 0), mass=0.05,
               inertia=np.diag([1e-4, 3e-4, 3e-4]), armature=1e-3,
               damping=0.05)
    # --- digits (world-mounted: the palm is the frozen forearm frame) ---
    digit_cfg = dict(axis=(1, 0, 0), link1=L1, link2=L2,
                     damping1=0.35, damping2=0.3)
    up, down = (0.0, 0.0, 1.0), (0.0, 0.0, -1.0)
    a_ids = add_digit(b, -1, (HOLD_POS[0] + 0.06, 0.0,
                              HOLD_POS[2] - DIGIT_DROP),
                      mcp_limits=(_LOW[0], _HIGH[0]),
                      pip_limits=(_LOW[1], _HIGH[1]),
                      direction=up, **digit_cfg)
    b_ids = add_digit(b, -1, (HOLD_POS[0] - 0.06, 0.0,
                              HOLD_POS[2] - DIGIT_DROP),
                      mcp_limits=(_LOW[2], _HIGH[2]),
                      pip_limits=(_LOW[3], _HIGH[3]),
                      direction=up, **digit_cfg)
    th_ids = add_digit(b, -1, (HOLD_POS[0], 0.0,
                               HOLD_POS[2] + THUMB_RISE),
                       mcp_limits=(_LOW[4], _HIGH[4]),
                       pip_limits=(_LOW[5], _HIGH[5]),
                       direction=down, **digit_cfg)

    # geoms: pen end spheres define the rod segment; digit prox+tip spheres
    end_a = b.add_sphere(PEN_PITCH, (PEN_HALF, 0, 0), 0.012)
    end_b = b.add_sphere(PEN_PITCH, (-PEN_HALF, 0, 0), 0.012)
    tip_geoms = []
    for ids, direction in ((a_ids, up), (b_ids, up), (th_ids, down)):
        prox, tip = digit_spheres(b, *ids, link1=L1, link2=L2,
                                  prox_radius=0.015, tip_radius=0.015,
                                  direction=direction)
        b.add_contact_sphere_segment(prox, end_a, end_b)
        b.add_contact_sphere_segment(tip, end_a, end_b)
        tip_geoms.append(tip)
    # pen-v0's contact material
    b.contact_stiffness = 2e3
    b.contact_damping = 5.0
    b.friction_mu = 0.8
    b.friction_vel_k = 30.0
    return b.finalize(), (end_a, end_b), tuple(tip_geoms)


@dataclasses.dataclass(frozen=True)
class PenHandState:
    physics: PhysicsState
    target_axis: torch.Tensor  # (3,) sampled goal orientation (unit)
    t: torch.Tensor            # () int32 step count


@dataclasses.dataclass(frozen=True)
class PenHand:
    """pen-v0-class task on the three-digit hand; actions are PD position
    targets for the 6 digit joints."""

    action_dim: int = N_ACT
    dt: float = 0.02
    substeps: int = 8
    kp: float = 3.0
    kd: float = 0.25
    fixed_goal: bool = False  # True: pin the fixed target

    name = "pen-v0-hand"
    # the rollout kernel's split layout, its substep partitioned by the
    # body tree (split_layout.plan_partition): the pen's chain and each
    # two-body digit on a warp of its own, the solve on the first digit's;
    # faster than the lane layout on the card at the canonical N=96/H=15
    # (PERF.md section 6, row 1b)
    scalar_kernel_layout = "split"
    scalar_split_partition = "subtree"

    _low, _high = _LOW, _HIGH
    # digits poised just clear of the rod (fingers slightly curled outward,
    # thumb lifted)
    _qpos0 = (0.0,) * A_MCP + (0.35, 0.0, -0.35, 0.0, 0.3, 0.0)
    _build = staticmethod(_build_model)

    def __post_init__(self):
        model, ends, tips = self._build()
        object.__setattr__(self, "_model", model)
        object.__setattr__(self, "_soa", SoaModel(model))
        object.__setattr__(self, "_end_geoms", ends)
        object.__setattr__(self, "_tip_geoms", tips)
        object.__setattr__(self, "_sites_soa", make_sites_soa(model))

    @property
    def action_low(self):
        return torch.tensor(self._low)

    @property
    def action_high(self):
        return torch.tensor(self._high)

    def sample_goal(self, generator: torch.Generator, device):
        """pen-v0's distribution: yaw/pitch ~ U(-1, 1) rad."""
        if self.fixed_goal:
            return target_axis().to(device)
        u = torch.rand(2, generator=generator, device=device)
        yaw, pitch = ((2.0 * u - 1.0) * GOAL_RANGE).unbind()
        return axis_from_angles(yaw, pitch)

    def reset(self, generator: torch.Generator, device, goal=None):
        """The pen level in the hold, the digits at their initial posture;
        ``goal`` pins the goal axis instead of sampling it."""
        nq = len(self._qpos0)
        if goal is None:
            goal = self.sample_goal(generator, device)
        return PenHandState(
            physics=PhysicsState(
                qpos=torch.tensor(self._qpos0, device=device),
                qvel=torch.zeros(nq, device=device)),
            target_axis=as_f32(goal, device),
            t=torch.zeros((), dtype=torch.int32, device=device))

    # ---- the scalar contract (shared by step() and the rollout kernel) ----

    def _gains(self):
        return [self.kp] * N_ACT, [self.kd] * N_ACT

    def scalar_torque(self, m, q, qd, act):
        # the pen's five coordinates come first, then the digit joints
        kps, kds = self._gains()
        tau = [sm.zeros_like(q[0]) for _ in range(A_MCP)]
        for j in range(self.action_dim):
            tgt = sm.clip(act[j], self._low[j], self._high[j])
            tau.append(kps[j] * (tgt - q[A_MCP + j])
                       - kds[j] * qd[A_MCP + j])
        return tuple(tau)

    def scalar_reward_consts(self, state):
        return state.target_axis

    def scalar_reward(self, m, q, qd, consts):
        # pen-v0's reward shape (mj_envs pen-v0 structure)
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

    def step(self, state: PenHandState, action):
        """(state, action (..., 6)) -> (next state, reward (...)): one
        launch of the rollout kernel on a CUDA state, the eager scalar
        program on a CPU state."""
        return rk.env_step(self, state, action)

    def plain_step(self, state: PenHandState, action):
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

    def observe(self, state: PenHandState):
        """Observation of a single (unbatched) state."""
        q, qd = state.physics.qpos, state.physics.qvel
        centre, axis = self._pen_pose(q)
        return torch.cat([q, qd, centre, axis, state.target_axis,
                          axis - state.target_axis, offset(centre, HOLD_POS)])

    def success(self, state: PenHandState):
        centre, axis = self._pen_pose(state.physics.qpos)
        dist = torch.linalg.norm(offset(centre, HOLD_POS), dim=-1)
        return ((axis * state.target_axis).sum(-1) > 0.95) & (dist < 0.075)


# ---------------------------------------------------------------------------
# scripted expert (feasibility oracle)
# ---------------------------------------------------------------------------

_R_MIN, _R_MAX = abs(L1 - L2) + 0.005, L1 + L2 - 0.003
_MZ = HOLD_POS[2] - DIGIT_DROP


def _ik_up(ty, tz):
    """Closed-form 2-link IK in the digit's y-z plane (an up-pointing digit
    rotating about +x; tip: y = -(l1 sin a + l2 sin(a+b)), z = mz + l1 cos
    a + l2 cos(a+b))."""
    ry, rz = ty, tz - _MZ
    r = torch.sqrt(ry * ry + rz * rz) + 1e-12
    rc = torch.clamp(r, _R_MIN, _R_MAX)
    ry, rz = ry * rc / r, rz * rc / r
    r2 = ry * ry + rz * rz
    cb = torch.clamp((r2 - L1 * L1 - L2 * L2) / (2 * L1 * L2), -1.0, 1.0)
    bb = torch.arccos(cb)
    theta = torch.atan2(-ry, rz)
    aa = theta - torch.atan2(L2 * torch.sin(bb), L1 + L2 * torch.cos(bb))
    return aa, bb


def _fk_up(a, b):
    y = -(L1 * torch.sin(a) + L2 * torch.sin(a + b))
    z = _MZ + L1 * torch.cos(a) + L2 * torch.cos(a + b)
    return y, z


def _digit_cmd(q, rod_yz, d_yz):
    """Joint targets for one digit: press the rod along +d from the -d
    side; when the tip sits on the wrong (+d) side, retract to a small
    radius and swing its bearing toward the approach point, so that the
    repositioning arc passes under the rod instead of through it."""
    mag = torch.linalg.norm(d_yz) + 1e-9
    dirv = d_yz / mag
    press = torch.clamp(2.0 * mag, 0.0, 0.006)
    standoff = torch.where(mag < 0.002, 0.033, 0.027 - press)
    des = rod_yz - dirv * standoff
    ty, tz = _fk_up(q[0], q[1])
    cur = torch.stack([ty, tz])
    wrong = torch.dot(cur - rod_yz, dirv) > 0.004
    mount = des.new_tensor([0.0, _MZ])
    des_bear = (des - mount) / (torch.linalg.norm(des - mount) + 1e-9)
    swing = mount + des_bear * (_R_MIN + 0.004)
    use = torch.where(wrong, swing, des)
    return torch.stack(_ik_up(use[0], use[1]))


def scripted_controller(env, target_axis):
    """Closed-loop proportional fingertip controller toward
    ``target_axis`` (3,): ``controller(state, pose=None) -> action (6,)``,
    ``pose`` the state's ``env._pen_pose`` where the caller has it. It
    reorients the pen substantially (the feasibility oracle); exact
    alignment past ~0.87 similarity is MPC's job."""
    tgt = target_axis

    def controller(s, pose=None):
        q = s.physics.qpos
        c, ax = env._pen_pose(q) if pose is None else pose
        delta = 0.5 * PEN_HALF * (tgt - ax)

        def parts(plane_dx):
            t = torch.clamp(plane_dx / (torch.abs(ax[0]) + 0.2),
                            -PEN_HALF, PEN_HALF)
            rod_yz = c[1:] + t * ax[1:]
            d_yz = (plane_dx / PEN_HALF) * delta[1:]
            return rod_yz, d_yz

        rod_a, d_a = parts(0.06)
        rod_b, d_b = parts(-0.06)
        cmd_a = _digit_cmd(q[A_MCP:A_MCP + 2], rod_a, d_a)
        cmd_b = _digit_cmd(q[B_MCP:B_MCP + 2], rod_b, d_b)
        return torch.cat([cmd_a, cmd_b, q.new_tensor([0.5, 0.0])])

    return controller


def scripted_reorient(env, state0=None, steps: int = 300, device="cuda"):
    """Run the scripted controller for ``steps`` control steps from
    ``state0`` (``hand.expert_start``'s reset on ``device`` if None);
    returns (final state, info) with the similarity trace (``steps``,),
    its maximum and last value, and whether the pen dropped."""
    state = expert_start(env, state0, device)
    ctrl = scripted_controller(env, state.target_axis)
    # a state's pose serves its similarity and the next command: the eager
    # site FK is most of a step's time on the card
    pose = env._pen_pose(state.physics.qpos)
    sims = []
    for _ in range(steps):
        s2, _ = env.step(state, ctrl(state, pose))
        pose = env._pen_pose(s2.physics.qpos)
        sims.append(torch.dot(pose[1], state.target_axis))
        state = s2
    sims = torch.stack(sims)
    centre = pose[0]
    return state, {
        "similarity": sims,
        "max_similarity": float(sims.max()),
        "final_similarity": float(sims[-1]),
        "dropped": bool(centre[2] < HOLD_POS[2] - 0.15),
    }
