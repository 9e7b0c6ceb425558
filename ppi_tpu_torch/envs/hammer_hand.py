"""Hammer-a-nail with a grasped free hammer (hammer-v0-hand).

Port of ``ppi_tpu/envs/hammer_hand.py``: the hammer is a free body (a
planar slide-x / slide-z / pitch composition, ``add_planar_base``) that a
4-DoF arm must hold through contact, in a two-finger cradle (palm above
the handle, fore and aft fingertips beneath it, penalty-friction
contacts), lift off the bench and swing so that the head seats the
friction-held nail. 6 actuated joints, 10 DoF. The board height is sampled
per episode, upward from the bench, and reaches the dynamics as the nail
body's joint-origin offset. The reward keeps hammer-v0's structure plus a
cost on the grip point leaving the arm's reach. The scene and the reward
shape are the JAX env's.

The friction-held grasp makes this the most rounding-sensitive task of the
zoo: the port runs the scalar program only, the JAX env's certified path.
``step`` on a CUDA state is one launch of the env's rollout kernel
(``rollout_kernel.kernel_step``); on a CPU state it is the eager scalar
program.

The scripted expert (``scripted_hammer``) is the JAX module's: cage the
handle, lift, carry, and drive the nail with arc swings; its ``actions=``
log is expert-demonstration data. Its palm IK (``_ik_palm``) runs on a
CUDA state as one launch of the palm-IK kernel
(``envs/physics/ik_kernel.py``), on a CPU state as the plain version; each
control step is one rollout-kernel launch on the card.
"""

import dataclasses

import numpy as np
import torch

from ppi_tpu_torch.envs.base import as_f32
from ppi_tpu_torch.envs.hammer import sample_board_z
from ppi_tpu_torch.envs.hand import expert_start, hold_target
from ppi_tpu_torch.envs.physics import ik_kernel
from ppi_tpu_torch.envs.physics import rollout_kernel as rk
from ppi_tpu_torch.envs.physics import scalar_math as sm
from ppi_tpu_torch.envs.physics.engine import (
    HINGE, SLIDE, ModelBuilder, PhysicsState)
from ppi_tpu_torch.envs.physics.engine_soa import (
    SoaModel, fk_soa, geom_point_soa, make_sites_soa)

# dof indices
(YAW, SHOULDER, ELBOW, WRIST, FING_F, FING_A,
 HAM_X, HAM_Z, HAM_P, NAIL) = range(10)

N_ACT = 6
NAIL_DEPTH = 0.06
BENCH_Z = 0.60  # table height (relocate-v0's table: the arm's grasp
#                 workspace)
NAIL_X = 0.82
GRIP_START = (0.44, BENCH_Z + 0.045)  # hammer frame origin at rest; the
#                                       hand grips near the head
HEAD_LOCAL = (0.24, 0.0, 0.035)       # head centre in the hammer frame

_LOW = (-1.5, -1.2, -2.0, -2.0, -1.2, -0.55)
_HIGH = (1.5, 1.2, 2.0, 2.0, 0.55, 1.2)

# nominal nail-board position and the per-episode board-height span: the
# board sits on the bench, so the sampled offset is upward only
BOARD_POS = (NAIL_X, 0.0, BENCH_Z)
BOARD_Z_SPAN = 0.15

# the grip point's workspace (world x of the hammer frame origin =
# GRIP_START[0] + q[HAM_X]): beyond it the grip section is out of reach
WS_GRIP_X = (0.05, 0.80)

# reset arm posture: the palm 0.115 m above the handle top, wrist link
# level, fingers open at their limits
_RESET_ARM = (0.0, -0.381, 1.965, -1.583, -1.2, 1.2)


def _build_model():
    b = ModelBuilder()
    # --- arm (the door and hammer arm's class) ---
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
               offset_pos=(0.35, 0, 0), mass=0.8, com=(0.08, 0, 0),
               damping=1.0, armature=0.05, q_limit=(-2.0, 2.0), limit_k=50.0)
    # --- two-finger cradle: fore and aft fingers hinge about the wrist's
    # y axis below knuckles offset along the hand's x; closing swings the
    # tips under the handle from both sides ---
    b.add_body(parent=WRIST, joint_type=HINGE, axis=(0, 1, 0),
               offset_pos=(0.24, 0, 0), mass=0.12, com=(0.0, 0.0, -0.05),
               inertia=np.diag([8e-4, 8e-4, 8e-4]), damping=0.3,
               armature=0.02, q_limit=(_LOW[4], _HIGH[4]), limit_k=30.0)
    b.add_body(parent=WRIST, joint_type=HINGE, axis=(0, 1, 0),
               offset_pos=(0.16, 0, 0), mass=0.12, com=(0.0, 0.0, -0.05),
               inertia=np.diag([8e-4, 8e-4, 8e-4]), damping=0.3,
               armature=0.02, q_limit=(_LOW[5], _HIGH[5]), limit_k=30.0)
    # --- free hammer: planar base (slide-x, slide-z) + a pitch hinge with
    # the real mass; frame origin at the grip point, handle along +x ---
    base = b.add_planar_base(offset_pos=(GRIP_START[0], 0.0, GRIP_START[1]))
    if base != HAM_Z:
        raise AssertionError("the proxy slides must be HAM_X and HAM_Z")
    b.add_body(parent=base, joint_type=HINGE, axis=(0, 1, 0),
               offset_pos=(0, 0, 0), mass=0.45, com=(0.16, 0.0, 0.01),
               inertia=np.diag([2e-3, 3e-3, 3e-3]), damping=0.02,
               armature=1e-4)
    # --- nail: vertical slide held by dry friction (as hammer-v0), static
    # hold 4x the nail's weight; the offset is the nominal board,
    # overridden per episode by the sampled state.board ---
    b.add_body(parent=-1, joint_type=SLIDE, axis=(0, 0, -1),
               offset_pos=BOARD_POS, mass=0.4, damping=10.0,
               armature=0.01, friction_loss=16.0,
               q_limit=(0.0, NAIL_DEPTH + 0.01), limit_k=8e3)

    # geoms
    palm = b.add_sphere(WRIST, (0.20, 0, 0), 0.028)
    tip_f = b.add_sphere(FING_F, (0.0, 0, -0.085), 0.018)
    tip_a = b.add_sphere(FING_A, (0.0, 0, -0.085), 0.018)
    grip_a = b.add_sphere(HAM_P, (-0.10, 0, 0), 0.020)
    grip_b = b.add_sphere(HAM_P, (0.08, 0, 0), 0.020)
    head = b.add_sphere(HAM_P, HEAD_LOCAL, 0.045)
    nail_a = b.add_sphere(NAIL, (0.0, 0, 0.060), 0.018)
    nail_b = b.add_sphere(NAIL, (0.0, 0, 0.020), 0.018)
    bench = b.add_plane(normal=(0.0, 0.0, 1.0), offset=BENCH_Z)

    # grasp contacts: palm and both tips against the handle's grip capsule
    b.add_contact_sphere_segment(palm, grip_a, grip_b)
    b.add_contact_sphere_segment(tip_f, grip_a, grip_b)
    b.add_contact_sphere_segment(tip_a, grip_a, grip_b)
    # the head swell catches the fore tip and the palm if the handle
    # recoils backward through the grip at impact
    b.add_contact_sphere_sphere(head, tip_f)
    b.add_contact_sphere_sphere(head, palm)
    # strike contact and resting contacts
    b.add_contact_sphere_segment(head, nail_a, nail_b)
    for s in (grip_a, grip_b, head):
        b.add_contact_sphere_plane(s, bench)
    for s in (tip_f, tip_a, palm):
        b.add_contact_sphere_plane(s, bench)
    b.contact_stiffness = 3e3
    b.contact_damping = 20.0
    b.friction_mu = 1.5
    b.friction_vel_k = 40.0
    return b.finalize(), palm, (grip_a, grip_b), head, (nail_a, nail_b)


@dataclasses.dataclass(frozen=True)
class HammerHandState:
    physics: PhysicsState
    board: torch.Tensor  # (3,) sampled nail-board position (z randomized)
    t: torch.Tensor      # () int32 step count


def _dist(a, b):
    dx, dy, dz = a[0] - b[0], a[1] - b[1], a[2] - b[2]
    return sm.sqrt(dx * dx + dy * dy + dz * dz + 1e-12)


@dataclasses.dataclass(frozen=True)
class HammerHand:
    """hammer-v0-class task with a grasped free hammer; actions are PD
    position targets for the 4 arm + 2 finger joints."""

    action_dim: int = N_ACT
    dt: float = 0.02
    substeps: int = 8  # grasp and impact contacts need h = 2.5 ms
    kp: float = 90.0
    kd: float = 9.0
    kp_finger: float = 8.0
    kd_finger: float = 0.6
    fixed_scene: bool = False  # True: pin the board flush with the bench
    knockaway_penalty: float = 40.0  # per-step cost per metre the grip
    #                                  point strays outside WS_GRIP_X

    name = "hammer-v0-hand"
    # one thread's dependent chain bounds the lane layout here: the
    # rollout kernel runs one rollout a warp (rollout_kernel.kernel_layout)
    scalar_kernel_layout = "warp"

    # the sampled board overrides the nail body's joint-origin offset (a
    # runtime input of the rollout kernel)
    scalar_dyn_body = NAIL
    _ham_x, _ham_z = HAM_X, HAM_Z
    _low, _high = _LOW, _HIGH
    _qpos0_act = _RESET_ARM   # the actuated joints' initial posture
    _build = staticmethod(_build_model)

    def __post_init__(self):
        model, palm, grips, head, nails = self._build()
        object.__setattr__(self, "_model", model)
        object.__setattr__(self, "_soa", SoaModel(model))
        object.__setattr__(self, "_palm_geom", palm)
        object.__setattr__(self, "_grip_geoms", grips)
        object.__setattr__(self, "_head_geom", head)
        object.__setattr__(self, "_nail_geoms", nails)
        object.__setattr__(self, "_sites_soa", make_sites_soa(
            model, dyn_body=self.scalar_dyn_body))

    @property
    def action_low(self):
        return torch.tensor(self._low)

    @property
    def action_high(self):
        return torch.tensor(self._high)

    def sample_board(self, generator: torch.Generator, device):
        """Per-episode nail-board position: z = bench + U(0,
        BOARD_Z_SPAN)."""
        return sample_board_z(BOARD_POS, 0.0, BOARD_Z_SPAN, self.fixed_scene,
                              generator, device)

    def reset(self, generator: torch.Generator, device, board=None):
        """The gripper hovering over the grip point, fingers open, the free
        hammer resting on the bench; ``board`` pins the board instead of
        sampling it."""
        qpos = torch.zeros(self._model.nq, device=device)
        qpos[:self.action_dim] = torch.tensor(self._qpos0_act, device=device)
        qpos[self._ham_z] = -0.025
        if board is None:
            board = self.sample_board(generator, device)
        return HammerHandState(
            physics=PhysicsState(qpos=qpos, qvel=torch.zeros_like(qpos)),
            board=as_f32(board, device),
            t=torch.zeros((), dtype=torch.int32, device=device))

    # ---- the scalar contract (shared by step() and the rollout kernel) ----

    def scalar_dyn_consts(self, state):
        return state.board

    def _gains(self):
        return ([self.kp] * 4 + [self.kp_finger] * 2,
                [self.kd] * 4 + [self.kd_finger] * 2)

    def scalar_torque(self, m, q, qd, act):
        kps, kds = self._gains()
        n = self.action_dim
        tau = [kps[j] * (sm.clip(act[j], self._low[j], self._high[j]) - q[j])
               - kds[j] * qd[j] for j in range(n)]
        tau += [sm.zeros_like(q[0]) for _ in range(n, len(q))]
        return tuple(tau)

    def scalar_reward(self, m, q, qd):
        # mj_envs hammer-v0 reward shape: tool reach + head-to-nail approach
        # + insertion progress + seated bonuses + velocity regularization,
        # less the grip point's excursion outside its workspace
        rots, poss, _, _ = fk_soa(m, q)
        pt = lambda g: geom_point_soa(m, rots, poss, g)
        palm = pt(self._palm_geom)
        ga, gb = pt(self._grip_geoms[0]), pt(self._grip_geoms[1])
        grip = tuple(0.5 * (ga[i] + gb[i]) for i in range(3))
        head = pt(self._head_geom)
        nail = pt(self._nail_geoms[0])
        depth = q[self.scalar_dyn_body]
        vel2 = sum(qd[j] * qd[j] for j in range(self.action_dim))
        grip_x = GRIP_START[0] + q[self._ham_x]
        oob = (sm.maximum(grip_x - WS_GRIP_X[1], 0.0)
               + sm.maximum(WS_GRIP_X[0] - grip_x, 0.0))
        return (-0.5 * _dist(palm, grip)
                - 0.3 * _dist(head, nail)
                + 50.0 * depth
                - 1e-3 * vel2
                + 2.0 * sm.gt(depth, 0.5 * NAIL_DEPTH)
                + 10.0 * sm.gt(depth, 0.95 * NAIL_DEPTH)
                - self.knockaway_penalty * oob)

    # ---- the env ---------------------------------------------------------

    def step(self, state: HammerHandState, action):
        """(state, action (..., 6)) -> (next state, reward (...)): one
        launch of the rollout kernel on a CUDA state, the eager scalar
        program on a CPU state."""
        return rk.env_step(self, state, action)

    def plain_step(self, state: HammerHandState, action):
        """The eager step, on any device."""
        return rk.env_step(self, state, action, plain=True)

    def _sites(self, qpos, board):
        pts = self._sites_soa(qpos, board)
        palm = pts[..., self._palm_geom, :]
        grip = 0.5 * (pts[..., self._grip_geoms[0], :]
                      + pts[..., self._grip_geoms[1], :])
        return palm, grip, pts[..., self._head_geom, :], \
            pts[..., self._nail_geoms[0], :]

    def observe(self, state: HammerHandState):
        """Observation of a single (unbatched) state; the nail site carries
        the sampled board."""
        q, qd = state.physics.qpos, state.physics.qvel
        palm, grip, head, nail = self._sites(q, state.board)
        n, k = self.action_dim, self.scalar_dyn_body
        return torch.cat([q[:n], qd[:n], q[k:k + 1], qd[k:k + 1], palm,
                          grip, head, nail, palm - grip, head - nail])

    def success(self, state: HammerHandState):
        return state.physics.qpos[..., self.scalar_dyn_body] \
            > 0.95 * NAIL_DEPTH

    def lifted(self, state: HammerHandState):
        """The hammer held off the bench (the proof of the grasp)."""
        return state.physics.qpos[..., self._ham_z] > 0.03


# ---------------------------------------------------------------------------
# scripted expert (feasibility oracle + render demo + demonstrations)
# ---------------------------------------------------------------------------

def _ik_palm(env, state, target_pt, q_init, iters=500, lr=0.02,
             level_weight=0.05):
    """Gradient IK for the palm over the 4 arm joints, the rest of
    ``q_init`` held, with a wrist-tilt penalty that keeps the cradle level
    (FK through the episode's board). One palm-IK kernel launch on a CUDA
    state, the plain version on a CPU state. Returns the command
    (``q_init``'s length)."""
    n = env.action_dim
    dev = q_init.device
    qa = ik_kernel.palm_ik(
        env, q_init[:4], torch.cat([q_init[4:], state.physics.qpos[n:]]),
        target_pt, env.action_low.to(dev)[:4], env.action_high.to(dev)[:4],
        iters, lr, level_weight=level_weight, dyn=state.board)
    return torch.cat([qa, q_init[4:]])


def _add(cmd, adds):
    """A copy of ``cmd`` with ``adds`` ({index: value}) added to its
    entries (JAX's ``cmd.at[j].add(value)``)."""
    cmd = cmd.clone()
    for j, value in adds.items():
        cmd[j] += value
    return cmd


def scripted_hammer(env, state0=None, log=None, max_swings=22, frames=None,
                    actions=None, device="cuda"):
    """Hand-scripted tool use: descend onto the resting free hammer, cage
    the handle (the aft finger first, then the fore finger wedges it
    against the backstop), lift gradually, carry toward the nail in two
    stages, and drive the nail with arc swings until seated (on a stall
    the hover is re-solved lower by the driven depth). Returns (final
    state, info).

    The feasibility oracle of the JAX env tests. ``actions`` (a list)
    collects the clipped PD target held for each segment, repeated a
    step: the expert-demonstration record of the model-selection
    pipeline; ``frames`` the qpos trajectory; ``log`` a line a stage."""
    lo = env.action_low.to(device)
    hi = env.action_high.to(device)
    state = expert_start(env, state0, device)

    def clip(x):
        return torch.clamp(x, lo, hi)

    def run(s, tgt, n):
        s = hold_target(env, s, tgt, n, frames)
        if actions is not None:
            actions.append(np.repeat(clip(tgt).cpu().numpy()[None], n,
                                     axis=0))
        return s

    def servo(s, tgt, rounds=2, n=30):
        cmd = tgt
        for _ in range(rounds):
            s = run(s, clip(cmd), n)
            cmd = cmd + (tgt - s.physics.qpos[:env.action_dim])
        return s, cmd

    def note(msg):
        if log:
            log(msg)

    def qpos(s, k):
        return float(s.physics.qpos[k])

    board = state.board

    def above_board(dx, dz):
        return board + board.new_tensor([dx, 0.0, dz])

    # settle, then descend the palm onto the handle top
    hold = state.physics.qpos[:env.action_dim].clone()
    state = run(state, hold, 50)
    state, cmd = servo(state, _add(hold, {1: 0.30}))
    note(f"descended: ham_z={qpos(state, HAM_Z):.3f}")

    # cage: the aft backstop first, then the fore finger
    close_a = _add(cmd, {1: 0.10})
    close_a[5] = -0.25
    state = run(state, clip(close_a), 30)
    close = close_a.clone()
    close[4] = 0.25
    state = run(state, clip(close), 50)
    note(f"caged: fingers=({qpos(state, FING_F):.2f},"
         f"{qpos(state, FING_A):.2f})")

    # gradual lift
    base = clip(close)
    for dlt in np.linspace(0.0, -0.5, 12):
        state = run(state, _add(base, {1: float(dlt)}), 10)
    lift = _add(base, {1: -0.5})
    state = run(state, lift, 30)
    note(f"lifted: ham_z={qpos(state, HAM_Z):.3f}")

    # carry in two stages: a high waypoint well above the nail top, then a
    # vertical descent to the strike hover (a single interpolation drags
    # the head through a raised nail); the hover is the tuned offset from
    # the board
    high = _ik_palm(env, state, above_board(-0.18, 0.32), clip(lift))
    start = clip(lift)
    for alpha in np.linspace(0.0, 1.0, 18):
        state = run(state, clip(start + float(alpha) * (high - start)), 6)
    carry = _ik_palm(env, state, above_board(-0.18, 0.20), clip(high))
    for alpha in np.linspace(0.0, 1.0, 12):
        state = run(state, clip(high + float(alpha) * (carry - high)), 6)
    carry_cmd = carry
    state = run(state, clip(carry_cmd), 30)
    note(f"carried: nail={qpos(state, NAIL):.4f} "
         f"ham_z={qpos(state, HAM_Z):.3f}")

    # arc swings until the nail seats; on a stall the hover is re-solved
    # lower by the driven depth, so that the arc keeps reaching the head
    # of a driven nail
    last_depth = -1.0
    for k in range(max_swings):
        state = run(state, clip(_add(carry_cmd, {1: -0.18, 2: 0.12})), 22)
        state = run(state, clip(_add(carry_cmd, {1: 0.40, 2: -0.25})), 16)
        state = run(state, clip(carry_cmd), 20)
        depth = qpos(state, NAIL)
        note(f"swing {k}: nail={depth:.4f}")
        if depth > 0.95 * NAIL_DEPTH:
            break
        if depth <= last_depth + 1e-4:
            carry_cmd = _ik_palm(env, state, above_board(-0.18, 0.20 - depth),
                                 clip(carry_cmd))
            note(f"swing {k}: re-hover (depth {depth:.4f})")
        last_depth = depth
    return state, {
        "nail": qpos(state, NAIL),
        "success": bool(env.success(state)),
        "hammer_x": qpos(state, HAM_X),
    }
