"""Pick-and-carry with a five-digit Adroit-class hand (relocate-v0-adroit).

Port of ``ppi_tpu/envs/relocate_adroit.py``: relocate-v0's 4-DoF arm gains
a 2-DoF wrist (pronation, deviation) and carries five down-pointing
three-hinge digits of ``envs.hand.add_digit3``: four fingers on the +y side
spanning the ball and an opposing thumb on the -y side, each with an
abduction joint ahead of its MCP/PIP flexion chain. 21 actuated joints, 24
DoF with the free ball. The ball, the sampled goal and ball start, the
reward shape and the success test are relocate-v0's, so the env is
relocate-v0-hand's class with another scene and gains.

The JAX env's default engine is ``engine="stacked"``, XLA's assembly of
the same dynamics. The port runs the scalar program only: eagerly on the
CPU and, on the card, as the rollout kernel's generated body. ``step`` on a
CUDA state is one launch of that kernel.

The scripted expert (``scripted_carry``) is the JAX module's: a five-digit
basket curl, then an IK-derived, droop-compensated carry; its palm IK
(``_ik_palm``, 42 calls of 1,000 iterations) runs on a CUDA state as one
launch of the palm-IK kernel (``envs/physics/ik_kernel.py``) a call.
"""

import dataclasses

import numpy as np
import torch

from ppi_tpu_torch.envs.hand import add_digit3, expert_start, hold_target
from ppi_tpu_torch.envs.physics import ik_kernel
from ppi_tpu_torch.envs.physics.engine import HINGE, SLIDE, ModelBuilder
from ppi_tpu_torch.envs.relocate import BALL_RADIUS, BALL_START, TABLE_Z
from ppi_tpu_torch.envs.relocate_hand import RelocateHand, RelocateHandState

# dof order: arm, wrist, 5 x (ABD, MCP, PIP), then ball x, y, z slides
(YAW, SHOULDER, ELBOW, WRIST, PRON, DEV,
 FF_ABD, FF_MCP, FF_PIP,
 MF_ABD, MF_MCP, MF_PIP,
 RF_ABD, RF_MCP, RF_PIP,
 LF_ABD, LF_MCP, LF_PIP,
 TH_ABD, TH_MCP, TH_PIP,
 BALL_X, BALL_Y, BALL_Z) = range(24)

N_ACT = 21
L1, L2 = 0.055, 0.05

# +y-side fingers curl toward -y (negative MCP), the thumb opposes; the
# abduction splays a down-pointing digit along x (a rotation about y)
_FING = dict(abd=(-0.25, 0.25), mcp=(-1.2, 0.6), pip=(-1.4, 0.0))
_THUMB = dict(abd=(-0.35, 0.35), mcp=(-0.6, 1.2), pip=(0.0, 1.4))

# the elbow's range is +-2.4 (relocate-v0's is +-2.0): the level palm must
# reach both the grasp cap over the ball and the carry height over the goal
_LOW = ((-1.5, -1.2, -2.4, -2.0, -1.0, -0.6)
        + (_FING["abd"][0], _FING["mcp"][0], _FING["pip"][0]) * 4
        + (_THUMB["abd"][0], _THUMB["mcp"][0], _THUMB["pip"][0]))
_HIGH = ((1.5, 1.2, 2.4, 2.0, 1.0, 0.6)
         + (_FING["abd"][1], _FING["mcp"][1], _FING["pip"][1]) * 4
         + (_THUMB["abd"][1], _THUMB["mcp"][1], _THUMB["pip"][1]))

# finger knuckle x-positions on the palm (+y side); the thumb opposite
_FINGER_X = (0.285, 0.235, 0.185, 0.135)
_THUMB_X = 0.21


def _build_model():
    b = ModelBuilder()
    # --- arm (relocate-v0's links, the elbow's range widened) ---
    b.add_body(parent=-1, joint_type=HINGE, axis=(0, 0, 1),
               offset_pos=(0, 0, TABLE_Z + 0.35), mass=2.0, damping=2.0,
               armature=0.1, q_limit=(-1.5, 1.5), limit_k=50.0)
    b.add_body(parent=YAW, joint_type=HINGE, axis=(0, 1, 0),
               offset_pos=(0, 0, 0), mass=2.0, com=(0.17, 0, 0),
               damping=2.0, armature=0.1, q_limit=(-1.2, 1.2), limit_k=50.0)
    b.add_body(parent=SHOULDER, joint_type=HINGE, axis=(0, 1, 0),
               offset_pos=(0.35, 0, 0), mass=1.5, com=(0.17, 0, 0),
               damping=1.5, armature=0.08, q_limit=(-2.4, 2.4), limit_k=50.0)
    b.add_body(parent=ELBOW, joint_type=HINGE, axis=(0, 1, 0),
               offset_pos=(0.35, 0, 0), mass=0.6, com=(0.06, 0, 0),
               damping=1.0, armature=0.05, q_limit=(-2.0, 2.0), limit_k=50.0)
    # --- 2-DoF wrist: pronation about the forearm axis, then deviation
    # about the vertical; the deviation body is the palm plate ---
    b.add_body(parent=WRIST, joint_type=HINGE, axis=(1, 0, 0),
               offset_pos=(0.06, 0, 0), mass=0.05,
               inertia=np.diag([2e-5, 2e-5, 2e-5]), damping=0.5,
               armature=0.02, q_limit=(_LOW[PRON], _HIGH[PRON]),
               limit_k=30.0)
    b.add_body(parent=PRON, joint_type=HINGE, axis=(0, 0, 1),
               offset_pos=(0.02, 0, 0), mass=0.30, com=(0.12, 0, 0),
               inertia=np.diag([4e-4, 4e-4, 4e-4]), damping=0.5,
               armature=0.02, q_limit=(_LOW[DEV], _HIGH[DEV]), limit_k=30.0)
    # --- five down-pointing digits on the palm plate ---
    down = (0.0, 0.0, -1.0)
    cfg = dict(abd_axis=(0, 1, 0), curl_axis=(1, 0, 0), link1=L1, link2=L2,
               direction=down, damping1=0.3, damping2=0.25, limit_k=30.0)
    for x in _FINGER_X:
        add_digit3(b, DEV, (x, 0.065, 0.0), abd_limits=_FING["abd"],
                   mcp_limits=_FING["mcp"], pip_limits=_FING["pip"], **cfg)
    add_digit3(b, DEV, (_THUMB_X, -0.065, 0.0), abd_limits=_THUMB["abd"],
               mcp_limits=_THUMB["mcp"], pip_limits=_THUMB["pip"], **cfg)
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

    palm = b.add_sphere(DEV, (0.21, 0.0, 0.0), 0.03)
    tip_geoms = []
    for mcp, pip in ((FF_MCP, FF_PIP), (MF_MCP, MF_PIP), (RF_MCP, RF_PIP),
                     (LF_MCP, LF_PIP), (TH_MCP, TH_PIP)):
        prox = b.add_sphere(mcp, tuple(L1 * 0.6 * np.asarray(down)), 0.016)
        tip = b.add_sphere(pip, tuple(L2 * np.asarray(down)), 0.016)
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


# the state of relocate-v0-hand: physics, the sampled goal, the step count
RelocateAdroitState = RelocateHandState


@dataclasses.dataclass(frozen=True)
class RelocateAdroit(RelocateHand):
    """relocate-v0-class task on the five-digit Adroit-class hand; actions
    are PD position targets for the 4 arm + 2 wrist + 15 digit joints."""

    action_dim: int = N_ACT
    kp_wrist: float = 15.0
    kd_wrist: float = 1.2
    kp_abd: float = 3.0
    kd_abd: float = 0.3

    name = "relocate-v0-adroit"
    # the body is too large for one thread: the rollout kernel runs one
    # rollout a warp (rollout_kernel.kernel_layout)
    scalar_kernel_layout = "warp"

    _low, _high = _LOW, _HIGH
    # the level palm centred over the nominal ball start, its bottom 1 cm
    # above the ball's top; the digits open
    _qpos0_act = ((0.0, -0.3424, 2.0269, -1.6851, 0.0, 0.0)
                  + (0.0, 0.5, 0.0) * 4 + (0.0, -0.5, 0.0))
    _build = staticmethod(_build_model)

    def _gains(self):
        digit = ([self.kp_abd, self.kp_digit, self.kp_digit] * 4
                 + [self.kp_abd, self.kp_thumb, self.kp_thumb])
        digit_d = ([self.kd_abd, self.kd_digit, self.kd_digit] * 4
                   + [self.kd_abd, self.kd_thumb, self.kd_thumb])
        return ([self.kp] * 4 + [self.kp_wrist] * 2 + digit,
                [self.kd] * 4 + [self.kd_wrist] * 2 + digit_d)


# ---------------------------------------------------------------------------
# scripted expert (feasibility oracle + render demo)
# ---------------------------------------------------------------------------

# the gentle basket curl (relocate_hand's: an MCP-dominant swing cradles
# the ball under its lower hemisphere, a deep PIP wrap ejects it)
GRIP_FINGER = (0.0, -0.45, -0.05)
GRIP_THUMB = (0.0, 0.45, 0.05)


def _ik_palm(env, state, target_pt, qa_init, digits, iters=800, lr=0.04,
             level_weight=0.05):
    """Gradient IK for the palm over the 4 arm joints, the wrist held at
    zero and the ``digits`` (15,) held, with a palm-level penalty that
    keeps the basket upright. One palm-IK kernel launch on a CUDA state,
    the plain version on a CPU state. Returns the arm's 4 joints."""
    dev = qa_init.device
    q_rest = torch.cat([torch.zeros(2, device=dev), digits,
                        state.physics.qpos[env.action_dim:]])
    return ik_kernel.palm_ik(
        env, qa_init, q_rest, target_pt, env.action_low.to(dev)[:4],
        env.action_high.to(dev)[:4], iters, lr, level_weight=level_weight)


def scripted_carry(env, state0=None, frames=None, log=None, device="cuda"):
    """Hand-scripted grasp-and-carry: curl the five digits into a basket
    under the ball, then walk the level palm up a waypoint ladder and
    across to the goal with a droop-compensating servo: each waypoint's IK
    target is inflated by the measured palm error, three passes a
    waypoint (the PD arm droops ~15 cm under gravity at the carry's
    ceiling). Returns (final state, info)."""
    state = expert_start(env, state0, device)
    grip = state.physics.qpos[:N_ACT].clone()
    grip[6:] = grip.new_tensor(GRIP_FINGER * 4 + GRIP_THUMB)

    def run(s, tgt, n):
        return hold_target(env, s, tgt, n, frames)

    def note(msg):
        if log:
            log(msg)

    def pos(s):
        pts = env._sites_soa(s.physics.qpos)
        return (pts[env._palm_geom].cpu().numpy(),
                pts[env._ball_geom].cpu().numpy())

    # 1) basket curl, in one stage (a second tightening pass squirts the
    # ball out of the cage along +y)
    state = run(state, grip, 60)
    p, ball_grip = pos(state)
    note(f"gripped: ball={ball_grip.round(3)}")

    # 2) the waypoint ladder: a straight lift over the grasp point, then
    # across to above the goal, the palm kept level
    tgt = state.target.cpu().numpy()
    cruise = np.array([0.58, 0.0, 0.95])
    goal_palm = tgt + np.array([0.0, 0.0, p[2] - ball_grip[2]])
    ups = [np.array([0.58, 0.0, z]) for z in np.arange(0.74, 0.96, 0.03)]
    lats = [cruise + a * (goal_palm - cruise)
            for a in np.linspace(0.2, 1.0, 6)]
    qa = state.physics.qpos[:4]
    infl = np.zeros(3)  # the persistent droop compensation
    digits = grip[6:]
    cmd = grip
    wrist = torch.zeros(2, device=grip.device)
    for i, wp in enumerate(ups + lats):
        for _ in range(3):
            qa = _ik_palm(env, state, torch.tensor(
                wp + infl, dtype=torch.float32, device=grip.device), qa,
                digits, iters=1000, lr=0.05)
            cmd = torch.cat([qa, wrist, digits])
            state = run(state, cmd, 12)
            p, b = pos(state)
            infl = np.clip(infl + 0.8 * (wp - p), -0.25, 0.25)
        note(f"wp{i}: palm={p.round(3)} ball={b.round(3)}")
    state = run(state, cmd, 40)
    _, _, ball = env._sites(state.physics.qpos)
    return state, {
        "ball_after_grip": ball_grip,
        "ball": ball,
        "dist": float(torch.linalg.norm(ball - state.target)),
        "success": bool(env.success(state)),
    }
