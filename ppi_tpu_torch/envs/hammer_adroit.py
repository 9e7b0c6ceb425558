"""Hammer-a-nail with a five-digit Adroit-class hand (hammer-v0-adroit).

Port of ``ppi_tpu/envs/hammer_adroit.py``: hammer-v0-hand's arm gains a
2-DoF wrist (pronation, deviation) and five three-hinge digits of
``envs.hand.add_digit3``. The grasp is a power grip: the palm above the
handle, four fingers descending on the +y side and curling under the
handle's cross-section, the thumb opposing from -y, with the head swell as
the axial stop. 21 actuated joints, 25 DoF with the planar free hammer and
the friction-held nail. The bench, the board, the sampled board height,
the reward (with the knock-away cost) and the success test are
hammer-v0-hand's, so the env is that class with another scene and gains.

The JAX env's default engine is ``engine="stacked"``, XLA's assembly of
the same dynamics. The port runs the scalar program only: eagerly on the
CPU and, on the card, as the rollout kernel's generated body, with the
sampled board as the nail body's offset. ``step`` on a CUDA state is one
launch of that kernel.

The scripted expert (``scripted_hammer_adroit``) is the JAX module's: a
five-digit power wrap, a head-corrected two-stage carry and press-drive
cycles; its palm IK (``hammer_hand._ik_palm`` over the 4 arm joints) is
one palm-IK kernel launch on the card, its ``actions=`` log
expert-demonstration data.
"""

import dataclasses

import numpy as np
import torch

from ppi_tpu_torch.envs.hammer_hand import (
    BENCH_Z, BOARD_POS, GRIP_START, HEAD_LOCAL, NAIL_DEPTH, HammerHand,
    HammerHandState, _add, _ik_palm)
from ppi_tpu_torch.envs.hand import add_digit3, expert_start, hold_target
from ppi_tpu_torch.envs.physics.engine import HINGE, SLIDE, ModelBuilder

# dof order: arm, wrist, 5 x (ABD, MCP, PIP), the hammer's planar base
# (slide x, slide z, pitch), the nail
(YAW, SHOULDER, ELBOW, WRIST, PRON, DEV,
 FF_ABD, FF_MCP, FF_PIP,
 MF_ABD, MF_MCP, MF_PIP,
 RF_ABD, RF_MCP, RF_PIP,
 LF_ABD, LF_MCP, LF_PIP,
 TH_ABD, TH_MCP, TH_PIP,
 HAM_X, HAM_Z, HAM_P, NAIL) = range(25)

N_ACT = 21
# longer digits than the door and relocate hands: at full wrap (MCP -0.9,
# PIP -1.9) the crossbar passes 0.043 m under the palm plate, below the
# handle's centreline, so the digits cage the handle
L1, L2 = 0.07, 0.06

# the digits point down from the palm plate; the fingers on +y curl toward
# -y (negative MCP and PIP about +x), the thumb opposes
_FING = dict(abd=(-0.25, 0.25), mcp=(-1.6, 0.4), pip=(-2.0, 0.0))
_THUMB = dict(abd=(-0.35, 0.35), mcp=(-0.4, 1.6), pip=(0.0, 2.0))

_LOW = ((-1.5, -1.2, -2.0, -2.0, -1.0, -0.6)
        + (_FING["abd"][0], _FING["mcp"][0], _FING["pip"][0]) * 4
        + (_THUMB["abd"][0], _THUMB["mcp"][0], _THUMB["pip"][0]))
_HIGH = ((1.5, 1.2, 2.0, 2.0, 1.0, 0.6)
         + (_FING["abd"][1], _FING["mcp"][1], _FING["pip"][1]) * 4
         + (_THUMB["abd"][1], _THUMB["mcp"][1], _THUMB["pip"][1]))

# knuckle x-positions on the palm plate (the deviation body's frame; the
# wrist chain adds 0.08, so the finger rake spans 0.13-0.28 along the
# forearm, centred on the palm point at 0.20)
_FINGER_X = (0.20, 0.15, 0.10, 0.05)
_THUMB_X = 0.125
_KNUCKLE_Y = 0.045


def _build_model():
    b = ModelBuilder()
    # --- arm (hammer-v0-hand's links, so its reset posture carries over at
    # pronation = deviation = 0) ---
    b.add_body(parent=-1, joint_type=HINGE, axis=(0, 0, 1),
               offset_pos=(0, 0, 1.0), mass=2.0, damping=2.0, armature=0.1,
               q_limit=(-1.5, 1.5), limit_k=50.0)
    b.add_body(parent=YAW, joint_type=HINGE, axis=(0, 1, 0),
               offset_pos=(0, 0, 0), mass=2.0, com=(0.17, 0, 0),
               damping=2.0, armature=0.1, q_limit=(-1.2, 1.2), limit_k=50.0)
    b.add_body(parent=SHOULDER, joint_type=HINGE, axis=(0, 1, 0),
               offset_pos=(0.35, 0, 0), mass=1.5, com=(0.17, 0, 0),
               damping=1.5, armature=0.08, q_limit=(-2.0, 2.0), limit_k=50.0)
    b.add_body(parent=ELBOW, joint_type=HINGE, axis=(0, 1, 0),
               offset_pos=(0.35, 0, 0), mass=0.6, com=(0.06, 0, 0),
               damping=1.0, armature=0.05, q_limit=(-2.0, 2.0), limit_k=50.0)
    # --- 2-DoF wrist; the deviation body is the palm plate ---
    b.add_body(parent=WRIST, joint_type=HINGE, axis=(1, 0, 0),
               offset_pos=(0.06, 0, 0), mass=0.05,
               inertia=np.diag([2e-5, 2e-5, 2e-5]), damping=0.5,
               armature=0.02, q_limit=(_LOW[PRON], _HIGH[PRON]),
               limit_k=30.0)
    b.add_body(parent=PRON, joint_type=HINGE, axis=(0, 0, 1),
               offset_pos=(0.02, 0, 0), mass=0.30, com=(0.12, 0, 0),
               inertia=np.diag([4e-4, 4e-4, 4e-4]), damping=0.5,
               armature=0.02, q_limit=(_LOW[DEV], _HIGH[DEV]), limit_k=30.0)
    # --- five down-pointing digits on the palm plate, with a raised
    # reflected inertia (armature) that keeps the stiff grip servos stable
    # at the 50 Hz PD ---
    down = (0.0, 0.0, -1.0)
    cfg = dict(abd_axis=(0, 1, 0), curl_axis=(1, 0, 0), link1=L1, link2=L2,
               direction=down, damping1=0.35, damping2=0.3, limit_k=30.0,
               armature1=0.06, armature2=0.045)
    for x in _FINGER_X:
        add_digit3(b, DEV, (x, _KNUCKLE_Y, 0.0), abd_limits=_FING["abd"],
                   mcp_limits=_FING["mcp"], pip_limits=_FING["pip"], **cfg)
    add_digit3(b, DEV, (_THUMB_X, -_KNUCKLE_Y, 0.0),
               abd_limits=_THUMB["abd"], mcp_limits=_THUMB["mcp"],
               pip_limits=_THUMB["pip"], **cfg)
    # --- free hammer and nail (hammer-v0-hand's) ---
    base = b.add_planar_base(offset_pos=(GRIP_START[0], 0.0, GRIP_START[1]))
    if base != HAM_Z:
        raise AssertionError("the proxy slides must be HAM_X and HAM_Z")
    b.add_body(parent=base, joint_type=HINGE, axis=(0, 1, 0),
               offset_pos=(0, 0, 0), mass=0.45, com=(0.16, 0.0, 0.01),
               inertia=np.diag([2e-3, 3e-3, 3e-3]), damping=0.02,
               armature=1e-4)
    b.add_body(parent=-1, joint_type=SLIDE, axis=(0, 0, -1),
               offset_pos=BOARD_POS, mass=0.4, damping=10.0,
               armature=0.01, friction_loss=16.0,
               q_limit=(0.0, NAIL_DEPTH + 0.01), limit_k=8e3)

    # geoms
    palm = b.add_sphere(DEV, (0.12, 0.0, 0.0), 0.018)
    digit_geoms = []
    for mcp, pip in ((FF_MCP, FF_PIP), (MF_MCP, MF_PIP), (RF_MCP, RF_PIP),
                     (LF_MCP, LF_PIP), (TH_MCP, TH_PIP)):
        prox = b.add_sphere(mcp, tuple(L1 * 0.6 * np.asarray(down)), 0.016)
        # the knee, just past the PIP joint: at full wrap the lowest point
        # of the hook, which passes under the handle and carries it
        knee = b.add_sphere(pip, tuple(L2 * 0.2 * np.asarray(down)), 0.016)
        tip = b.add_sphere(pip, tuple(L2 * np.asarray(down)), 0.016)
        digit_geoms += [prox, knee, tip]
    grip_a = b.add_sphere(HAM_P, (-0.10, 0, 0), 0.020)
    grip_b = b.add_sphere(HAM_P, (0.08, 0, 0), 0.020)
    head = b.add_sphere(HAM_P, HEAD_LOCAL, 0.045)
    nail_a = b.add_sphere(NAIL, (0.0, 0, 0.060), 0.018)
    nail_b = b.add_sphere(NAIL, (0.0, 0, 0.020), 0.018)
    bench = b.add_plane(normal=(0.0, 0.0, 1.0), offset=BENCH_Z)

    # grasp contacts: the palm and all fifteen digit spheres against the
    # handle's grip capsule
    b.add_contact_sphere_segment(palm, grip_a, grip_b)
    for g in digit_geoms:
        b.add_contact_sphere_segment(g, grip_a, grip_b)
    # the head swell catches the palm and the index tip if the handle
    # recoils through the grip at impact
    b.add_contact_sphere_sphere(head, palm)
    b.add_contact_sphere_sphere(head, digit_geoms[2])
    # strike contact and resting contacts
    b.add_contact_sphere_segment(head, nail_a, nail_b)
    for s in (grip_a, grip_b, head, palm):
        b.add_contact_sphere_plane(s, bench)
    for g in digit_geoms:
        b.add_contact_sphere_plane(g, bench)
    b.contact_stiffness = 3e3
    b.contact_damping = 20.0
    b.friction_mu = 1.5
    b.friction_vel_k = 40.0
    return b.finalize(), palm, (grip_a, grip_b), head, (nail_a, nail_b)


# the state of hammer-v0-hand: physics, the sampled board, the step count
HammerAdroitState = HammerHandState


@dataclasses.dataclass(frozen=True)
class HammerAdroit(HammerHand):
    """hammer-v0-class task on the five-digit Adroit-class hand; actions
    are PD position targets for the 4 arm + 2 wrist + 15 digit joints."""

    action_dim: int = N_ACT
    kp_wrist: float = 20.0
    kd_wrist: float = 1.6
    # grip servos stiffer than the door and relocate digits: the power
    # wrap must hold the 0.45 kg hammer through carry and press-drive loads
    kp_digit: float = 12.0
    kd_digit: float = 1.0
    kp_thumb: float = 24.0  # the thumb opposes four fingers
    kd_thumb: float = 2.0
    kp_abd: float = 3.0
    kd_abd: float = 0.3

    name = "hammer-v0-adroit"
    # the body is too large for one thread: the rollout kernel runs one
    # rollout a warp (rollout_kernel.kernel_layout)
    scalar_kernel_layout = "warp"

    scalar_dyn_body = NAIL
    _ham_x, _ham_z = HAM_X, HAM_Z
    _low, _high = _LOW, _HIGH
    # hammer-v0-hand's arm hover (the palm 0.115 m above the handle top),
    # the wrist neutral, the digits open
    _qpos0_act = ((0.0, -0.381, 1.965, -1.583, 0.0, 0.0)
                  + (0.0, 0.4, 0.0) * 4 + (0.0, -0.4, 0.0))
    _build = staticmethod(_build_model)

    def _gains(self):
        digit = ([self.kp_abd, self.kp_digit, self.kp_digit] * 4
                 + [self.kp_abd, self.kp_thumb, self.kp_thumb])
        digit_d = ([self.kd_abd, self.kd_digit, self.kd_digit] * 4
                   + [self.kd_abd, self.kd_thumb, self.kd_thumb])
        return ([self.kp] * 4 + [self.kp_wrist] * 2 + digit,
                [self.kd] * 4 + [self.kd_wrist] * 2 + digit_d)


# ---------------------------------------------------------------------------
# scripted expert (feasibility oracle + render demo + demonstrations)
# ---------------------------------------------------------------------------

def _grip(cmd, mcp, pip=None):
    """A copy of ``cmd`` with all five digits set to a transverse
    power-wrap command: the MCP takes the first link down and across, the
    deeper PIP hooks the second under the handle and back up; the thumb
    opposes with the mirrored signs."""
    pip = mcp if pip is None else pip
    cmd = cmd.clone()
    for i in range(4):
        base = FF_ABD + 3 * i
        cmd[base + 1], cmd[base + 2] = -mcp, -pip
    cmd[TH_MCP], cmd[TH_PIP] = mcp, pip
    return cmd


def scripted_hammer_adroit(env, state0=None, log=None, max_swings=22,
                           frames=None, actions=None, device="cuda"):
    """Five-digit power-grip tool use: descend the palm onto the resting
    hammer handle, wrap the four fingers under the handle with the thumb
    opposing, lift, carry to the board (the IK target corrected by the
    measured palm-to-head offset, since the handle slides axially in the
    wrap), align the head over the nail, and drive it with press cycles
    (the nail's resistance is a dry-friction bound, so a sustained press
    drives it). Returns (final state, info).

    The feasibility oracle of the JAX env tests. ``actions`` (a list)
    collects the clipped PD target of each segment, repeated a step;
    ``frames`` the qpos trajectory; ``log`` a line a stage."""
    lo = env.action_low.to(device)
    hi = env.action_high.to(device)
    state = expert_start(env, state0, device)
    n_act = env.action_dim

    def clip(x):
        return torch.clamp(x, lo, hi)

    def run(s, tgt, n):
        tgt = clip(tgt)
        s = hold_target(env, s, tgt, n, frames)
        if actions is not None:
            actions.append(np.repeat(tgt.cpu().numpy()[None], n, axis=0))
        return s

    def servo(s, tgt, rounds=2, n=30):
        cmd = tgt
        for _ in range(rounds):
            s = run(s, cmd, n)
            cmd = cmd + (tgt - s.physics.qpos[:n_act])
        return s, cmd

    def note(msg):
        if log:
            log(msg)

    def qpos(s, k):
        return float(s.physics.qpos[k])

    def vec(*xs):
        return state.board.new_tensor(xs)

    def fmt(x):
        return np.round(x.cpu().numpy(), 3)

    # settle, then descend the palm to hover just above the handle top
    hold = state.physics.qpos[:n_act].clone()
    state = run(state, hold, 50)
    state, cmd = servo(state, _add(hold, {1: 0.30}))
    note(f"descended: ham_z={qpos(state, HAM_Z):.3f} "
         f"palm={fmt(env._sites(state.physics.qpos, state.board)[0])}")

    # power wrap: pre-shape half-curl, descend a little more, full wrap
    state = run(state, _grip(cmd, 0.5, 0.9), 40)
    closed = _add(_grip(cmd, 0.9, 1.9), {1: 0.08})
    state = run(state, closed, 60)
    note(f"caged: ff=({qpos(state, FF_MCP):.2f},{qpos(state, FF_PIP):.2f}) "
         f"th=({qpos(state, TH_MCP):.2f},{qpos(state, TH_PIP):.2f})")

    # gradual lift holding the wrap
    base = clip(closed)
    for dlt in np.linspace(0.0, -0.5, 12):
        state = run(state, _add(base, {1: float(dlt)}), 10)
    lift = _add(base, {1: -0.5})
    state = run(state, lift, 30)
    note(f"lifted: ham_z={qpos(state, HAM_Z):.3f}")

    def palm_target_for_head(s, head_target):
        """Where the palm must go for the head to reach ``head_target``,
        from the measured in-grip palm-to-head offset, clamped into the
        arm's workspace (after a drop the stale offset would send the
        digits through the bench)."""
        palm, _, head, _ = env._sites(s.physics.qpos, s.board)
        tgt = head_target - (head - palm)
        return torch.clamp(tgt, vec(0.30, -0.20, BENCH_Z + 0.08),
                           vec(0.85, 0.20, BENCH_Z + 0.55))

    # two-stage carry: a high waypoint above the nail, then the descent to
    # the strike hover
    high = _ik_palm(env, state,
                    palm_target_for_head(state, state.board
                                         + vec(0.0, 0.0, 0.32)), clip(lift))
    start = clip(lift)
    for alpha in np.linspace(0.0, 1.0, 18):
        state = run(state, start + float(alpha) * (high - start), 6)
    carry = _ik_palm(env, state,
                     palm_target_for_head(state, state.board
                                          + vec(0.0, 0.0, 0.20)), clip(high))
    for alpha in np.linspace(0.0, 1.0, 12):
        state = run(state, high + float(alpha) * (carry - high), 6)
    carry_cmd = carry
    state = run(state, carry_cmd, 30)
    note(f"carried: nail={qpos(state, NAIL):.4f} "
         f"ham_z={qpos(state, HAM_Z):.3f}")

    # press-drive cycles (wide arcs shed the wrap, which has no aft stop):
    # hover the head over the nail, press down to an overlapping target
    # (the arm's PD turns the position error into force), relieve, re-aim
    r_overlap = 0.045 + 0.018  # head + nail sphere contact distance

    def glide(s, frm, to, segs=10, n=5):
        """Interpolate the command: a step retarget jerks the arm and
        sheds the caged hammer."""
        for alpha in np.linspace(1.0 / segs, 1.0, segs):
            s = run(s, frm + float(alpha) * (to - frm), n)
        return s

    # the lateral alignment before any press: servo the head over the nail
    # at a safe hover height, an integral aim on the measured head error
    aim = torch.zeros(2, device=device)
    nail_top = 0.060
    prev = clip(carry_cmd)
    last_err = None
    for k in range(4):
        hover_tgt = torch.cat([aim, vec(nail_top + r_overlap + 0.02)])
        carry_cmd = _ik_palm(env, state,
                             palm_target_for_head(state,
                                                  state.board + hover_tgt),
                             prev, level_weight=0.005)
        state = glide(state, prev, clip(carry_cmd))
        prev = clip(carry_cmd)
        _, _, head_m, nail_m = env._sites(state.physics.qpos, state.board)
        err = (nail_m + vec(0.0, 0.0, r_overlap + 0.02) - head_m)[:2]
        note(f"align {k}: err={fmt(err)} ham_z={qpos(state, HAM_Z):.3f}")
        if last_err is not None and \
                float(torch.linalg.norm(err)) > 0.8 * last_err:
            # reach saturation: more wind-up drags the arm across its
            # envelope and sheds the hammer
            break
        last_err = float(torch.linalg.norm(err))
        aim = torch.clamp(aim + 0.7 * err, -0.3, 0.3)

    for k in range(max_swings):
        depth = qpos(state, NAIL)
        nail_top = 0.060 - depth
        press_tgt = torch.cat([aim, vec(nail_top + r_overlap - 0.015)])
        press = clip(_ik_palm(env, state,
                              palm_target_for_head(state,
                                                   state.board + press_tgt),
                              prev, level_weight=0.005))
        state = glide(state, prev, press, segs=8, n=4)
        state = run(state, press, 25)
        _, _, head_m, nail_m = env._sites(state.physics.qpos, state.board)
        aim = torch.clamp(aim + 0.5 * (nail_m - head_m)[:2], -0.3, 0.3)
        relief = _add(press, {2: -0.06})
        state = glide(state, press, relief, segs=4, n=4)
        prev = relief
        depth = qpos(state, NAIL)
        _, _, head, nail = env._sites(state.physics.qpos, state.board)
        note(f"press {k}: nail={depth:.4f} ham_z={qpos(state, HAM_Z):.3f} "
             f"head={fmt(head)} tgt={fmt(nail)}")
        if depth > 0.95 * NAIL_DEPTH:
            break
    return state, {
        "nail": qpos(state, NAIL),
        "success": bool(env.success(state)),
        "ham_z_final": qpos(state, HAM_Z),
        "hammer_x": qpos(state, HAM_X),
    }
