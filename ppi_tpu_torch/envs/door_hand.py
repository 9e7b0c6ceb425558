"""Door-opening with a three-digit hand (door-v0-hand) on the scalar program.

Port of ``ppi_tpu/envs/door_hand.py``: the door-v0 arm carries a hand of
two fingers above the handle bar and an opposing thumb below, two hinges
each (10 actuated joints, 12 DoF with the door and latch), and works the
handle through multi-point grasp contact. The latch bolt is a kinematic
clamp applied after each control step's substeps (``scalar_project``):
while the latch is up and the door started the step within the bolt's
reach, the door cannot pass the bolt depth. The scene, the reward shape
and the per-episode door-frame sampling are the JAX env's.

``step`` on a CUDA state is one launch of the env's rollout kernel (N
lanes, H=1; ``rollout_kernel.kernel_step``), the build that the MPC
objective uses: the eager program is ~52k elementwise launches a step at
12 DoF. On a CPU state ``step`` is ``plain_step``, the eager scalar
program (torque, 4 substeps, the bolt clamp, the reward).

The scripted expert (``scripted_open``) is the JAX module's: press the
latch, let the door pop ajar, sweep it open with the palm. Its palm IK
(``_ik``) runs on a CUDA state as one launch of the palm-IK kernel
(``envs/physics/ik_kernel.py``), on a CPU state as the plain version
(``torch.autograd`` through ``_sites_soa``); each control step is one
rollout-kernel launch on the card.
"""

import dataclasses
import math

import numpy as np
import torch

from ppi_tpu_torch.envs.base import as_f32
from ppi_tpu_torch.envs.hand import add_digit, expert_start, hold_target
from ppi_tpu_torch.envs.physics import ik_kernel
from ppi_tpu_torch.envs.physics import scalar_math as sm
from ppi_tpu_torch.envs.physics.engine import HINGE, ModelBuilder, PhysicsState
from ppi_tpu_torch.envs.physics.engine_soa import (
    SoaModel, fk_soa, geom_point_soa, make_sites_soa)
from ppi_tpu_torch.envs.physics.rollout_kernel import env_step

# dof indices
(YAW, SHOULDER, ELBOW, WRIST,
 IDX_MCP, IDX_PIP, MID_MCP, MID_PIP, TH_MCP, TH_PIP,
 DOOR, LATCH) = range(12)

N_ACT = 10  # all arm + digit joints are position-servoed

_LOW = (-1.5, -1.6, -2.3, -2.0, -0.3, 0.0, -0.3, 0.0, -1.6, -1.8)
_HIGH = (1.5, 1.6, 2.3, 2.0, 1.6, 1.8, 1.6, 1.8, 0.3, 0.0)

# nominal door-frame origin of the hand scenes and the per-episode sampling
# half-ranges about it (mj_envs door-v0 randomizes the door body position)
FRAME = (0.50, 0.30, 1.0)
FRAME_RANGE = (0.05, 0.05, 0.075)


def add_door(b):
    """The door and its latch, as in door-v0 (the offset is the nominal
    frame, overridden per episode by the sampled one); returns the handle
    bar's and the panel edge's sphere pairs."""
    door = b.add_body(parent=-1, joint_type=HINGE, axis=(0, 0, 1),
                      offset_pos=FRAME, mass=3.0, com=(0.0, -0.25, 0.0),
                      inertia=np.diag([0.1, 0.02, 0.1]), damping=2.0,
                      armature=0.0, q_limit=(0.0, 1.8), limit_k=200.0)
    latch = b.add_body(parent=door, joint_type=HINGE, axis=(1, 0, 0),
                       offset_pos=(-0.05, -0.45, 0.0), mass=0.3,
                       com=(0.0, 0.08, 0.0),
                       inertia=np.diag([2e-3, 2e-3, 2e-3]), damping=0.8,
                       armature=0.01, spring_k=2.0, spring_ref=0.0,
                       q_limit=(-1.6, 0.1), limit_k=30.0)
    return door, latch


def add_door_geoms(b, door, latch):
    """(handle bar sphere pair, panel edge sphere pair)."""
    h_a = b.add_sphere(latch, (0.0, 0.02, 0.0), 0.02)
    h_b = b.add_sphere(latch, (0.0, 0.16, 0.0), 0.02)
    d_a = b.add_sphere(door, (0.0, -0.1, 0.0), 0.02)
    d_b = b.add_sphere(door, (0.0, -0.5, 0.0), 0.02)
    return (h_a, h_b), (d_a, d_b)


def add_arm(b, wrist_mass, wrist_com):
    """The 4-DoF arm of the hand scenes (a light wrist link: the hand
    carries the mass)."""
    b.add_body(parent=-1, joint_type=HINGE, axis=(0, 0, 1),
               offset_pos=(0, 0, 1.0), mass=2.0, com=(0.0, 0, 0),
               damping=2.0, armature=0.1, q_limit=(-1.5, 1.5), limit_k=50.0)
    b.add_body(parent=YAW, joint_type=HINGE, axis=(0, 1, 0),
               offset_pos=(0, 0, 0), mass=2.0, com=(0.17, 0, 0),
               damping=2.0, armature=0.1, q_limit=(-1.6, 1.6), limit_k=50.0)
    b.add_body(parent=SHOULDER, joint_type=HINGE, axis=(0, 1, 0),
               offset_pos=(0.35, 0, 0), mass=1.5, com=(0.17, 0, 0),
               damping=1.5, armature=0.08, q_limit=(-2.3, 2.3), limit_k=50.0)
    b.add_body(parent=ELBOW, joint_type=HINGE, axis=(0, 1, 0),
               offset_pos=(0.35, 0, 0), mass=wrist_mass, com=wrist_com,
               damping=1.0, armature=0.05, q_limit=(-2.0, 2.0), limit_k=50.0)


def finish_contacts(b, palm, digit_spheres, handle, panel, panel_tips):
    """Palm and every digit sphere against the handle bar, palm and two
    fingertips against the panel edge, and the hand scenes' contact
    constants."""
    b.add_contact_sphere_segment(palm, *handle)
    for s in digit_spheres:
        b.add_contact_sphere_segment(s, *handle)
    b.add_contact_sphere_segment(palm, *panel)
    for s in panel_tips:
        b.add_contact_sphere_segment(s, *panel)
    b.contact_stiffness = 1e3
    b.contact_damping = 30.0
    b.friction_mu = 1.0
    b.friction_vel_k = 50.0


def _build_model():
    b = ModelBuilder()
    add_arm(b, 0.5, (0.06, 0, 0))
    # hand: two fingers above the bar, thumb opposing from below
    for y, z, lo, hi in ((+0.05, +0.03, 4, 5), (-0.05, +0.03, 6, 7),
                         (0.0, -0.05, 8, 9)):
        add_digit(b, WRIST, (0.16 if z > 0 else 0.12, y, z), (0, 1, 0),
                  (_LOW[lo], _HIGH[lo]), (_LOW[hi], _HIGH[hi]))
    door, latch = add_door(b)

    palm = b.add_sphere(WRIST, (0.14, 0, 0), 0.04)
    spheres = []
    for mcp, pip in ((IDX_MCP, IDX_PIP), (MID_MCP, MID_PIP),
                     (TH_MCP, TH_PIP)):
        spheres += [b.add_sphere(mcp, (0.03, 0, 0), 0.016),
                    b.add_sphere(pip, (0.045, 0, 0), 0.014)]
    handle, panel = add_door_geoms(b, door, latch)
    finish_contacts(b, palm, spheres, handle, panel,
                    (spheres[1], spheres[5]))
    return b.finalize(), palm, handle


@dataclasses.dataclass(frozen=True)
class DoorHandState:
    physics: PhysicsState
    frame: torch.Tensor  # (3,) sampled door-frame origin
    t: torch.Tensor      # () int32 step count


@dataclasses.dataclass(frozen=True)
class DoorHand:
    """door-v0-class task with a three-digit hand; actions are PD position
    targets for the 10 arm + digit joints."""

    action_dim: int = N_ACT
    dt: float = 0.02
    substeps: int = 4  # light finger links need h = 5 ms against the bar
    kp: float = 60.0
    kd: float = 6.0
    kp_hand: float = 6.0
    kd_hand: float = 0.4
    latch_unlock_angle: float = -0.6  # handle travel that retracts the bolt
    bolt_depth: float = 0.03          # rad of door travel the bolt blocks
    seal_force: float = 2.5           # N m opening bias while nearly closed
    fixed_scene: bool = False         # True: pin the nominal frame

    name = "door-v0-hand"
    # one thread's dependent chain bounds the lane layout here: the
    # rollout kernel runs one rollout a warp (rollout_kernel.kernel_layout)
    scalar_kernel_layout = "warp"

    # the sampled door frame overrides the door body's joint-origin offset
    # (a runtime input of the rollout kernel)
    scalar_dyn_body = DOOR
    _latch = LATCH
    _low, _high = _LOW, _HIGH
    _qpos0 = (0.0, 0.6, -0.8, 0.2,            # arm
              0.3, 0.4, 0.3, 0.4, -0.3, -0.4,  # digits ajar
              0.0, 0.0)                        # door, latch
    _build = staticmethod(_build_model)

    def __post_init__(self):
        model, palm, handle = self._build()
        object.__setattr__(self, "_model", model)
        object.__setattr__(self, "_soa", SoaModel(model))
        object.__setattr__(self, "_palm_geom", palm)
        object.__setattr__(self, "_handle_geoms", handle)
        object.__setattr__(self, "_sites_soa", make_sites_soa(
            model, dyn_body=self.scalar_dyn_body))

    @property
    def action_low(self):
        return torch.tensor(self._low)

    @property
    def action_high(self):
        return torch.tensor(self._high)

    def sample_frame(self, generator: torch.Generator, device):
        """Per-episode door-frame origin (see FRAME_RANGE)."""
        frame = torch.tensor(FRAME, device=device)
        if self.fixed_scene:
            return frame
        rng = torch.tensor(FRAME_RANGE, device=device)
        u = torch.rand(3, generator=generator, device=device)
        return frame + (2.0 * u - 1.0) * rng

    def reset(self, generator: torch.Generator, device, frame=None):
        """Initial state; ``frame`` pins the door frame instead of sampling."""
        nq = len(self._qpos0)
        if frame is None:
            frame = self.sample_frame(generator, device)
        return DoorHandState(
            physics=PhysicsState(
                qpos=torch.tensor(self._qpos0, device=device),
                qvel=torch.zeros(nq, device=device)),
            frame=as_f32(frame, device),
            t=torch.zeros((), dtype=torch.int32, device=device))

    # ---- the scalar contract (shared by step() and the rollout kernel) ----

    def _gains(self):
        return ([self.kp] * 4 + [self.kp_hand] * 6,
                [self.kd] * 4 + [self.kd_hand] * 6)

    def scalar_dyn_consts(self, state):
        return state.frame

    def scalar_torque(self, m, q, qd, act):
        kps, kds = self._gains()
        tau = [kps[j] * (sm.clip(act[j], self._low[j], self._high[j]) - q[j])
               - kds[j] * qd[j] for j in range(self.action_dim)]
        # seal/strike-pin spring: a bounded opening bias near the closed
        # position, so an unlatched door pops ajar past the bolt depth
        door = q[self.scalar_dyn_body]
        tau.append(self.seal_force * sm.sigmoid((0.35 - door) / 0.1))
        tau.append(sm.zeros_like(q[self._latch]))
        return tuple(tau)

    def scalar_project(self, m, q_prev, q, qd):
        """The bolt as a kinematic clamp: with the latch not pressed past
        the unlock angle and the door within bolt reach at the step's start
        (``q_prev``), the door stops at the bolt depth and its opening
        velocity is zeroed. Comparisons are 0/1 flags, so one program
        drives the eager version and the kernel body."""
        del m
        door = self.scalar_dyn_body
        bolted = sm.gt(q[self._latch], self.latch_unlock_angle)
        inside = sm.lt(q_prev[door], self.bolt_depth + 1e-3)
        clamp = sm.logical_and(sm.logical_and(bolted, inside),
                               sm.gt(q[door], self.bolt_depth))
        q, qd = list(q), list(qd)
        q[door] = sm.where(clamp, self.bolt_depth, q[door])
        qd[door] = sm.where(clamp, sm.minimum(qd[door], 0.0), qd[door])
        return tuple(q), tuple(qd)

    def scalar_reward(self, m, q, qd):
        # door-v0's reward shape: approach + staged opening bonuses +
        # velocity regularization
        rots, poss, _, _ = fk_soa(m, q)
        palm = geom_point_soa(m, rots, poss, self._palm_geom)
        ha = geom_point_soa(m, rots, poss, self._handle_geoms[0])
        hb = geom_point_soa(m, rots, poss, self._handle_geoms[1])
        dx = palm[0] - 0.5 * (ha[0] + hb[0])
        dy = palm[1] - 0.5 * (ha[1] + hb[1])
        dz = palm[2] - 0.5 * (ha[2] + hb[2])
        dist = sm.sqrt(dx * dx + dy * dy + dz * dz)
        door = q[self.scalar_dyn_body]
        vel2 = sum(v * v for v in qd)
        return (-0.5 * dist
                + 2.0 * door
                - 1e-3 * vel2
                + 2.0 * sm.gt(door, 0.2)
                + 8.0 * sm.gt(door, 1.0)
                + 10.0 * sm.gt(door, 1.35))

    # ---- the env ---------------------------------------------------------

    def step(self, state: DoorHandState, action):
        """(state, action (..., d_a)) -> (next state, reward (...)): one
        launch of the rollout kernel on a CUDA state, ``plain_step`` on a
        CPU state."""
        return env_step(self, state, action)

    def plain_step(self, state: DoorHandState, action):
        """The eager scalar program over whatever batch shape the state
        has: torque, the substeps, the bolt clamp on the pre-step door
        angle, the reward."""
        return env_step(self, state, action, plain=True)

    def _sites(self, qpos, frame):
        pts = self._sites_soa(qpos, frame)
        palm = pts[..., self._palm_geom, :]
        handle = 0.5 * (pts[..., self._handle_geoms[0], :]
                        + pts[..., self._handle_geoms[1], :])
        return palm, handle

    def observe(self, state: DoorHandState):
        """Observation of a single (unbatched) state."""
        palm, handle = self._sites(state.physics.qpos, state.frame)
        q, n, door = state.physics.qpos, self.action_dim, self.scalar_dyn_body
        return torch.cat([
            q[:n], state.physics.qvel[:n], q[door:door + 1],
            q[self._latch:self._latch + 1], palm, handle, palm - handle,
            state.frame, 1.0 * (q[door:door + 1] > 1.0)])

    def success(self, state: DoorHandState):
        return state.physics.qpos[..., self.scalar_dyn_body] > 1.35


# ---------------------------------------------------------------------------
# scripted expert (feasibility oracle + render demo)
# ---------------------------------------------------------------------------

def _ik(env, state, target_pt, q_init, iters=300, lr=0.03):
    """Gradient IK for the palm over the actuated joints; the passive door
    and latch are frozen at the state's, the FK runs through the
    episode's frame. One palm-IK kernel launch on a CUDA state
    (``ik_kernel.palm_ik``), the plain version on a CPU state."""
    n = env.action_dim
    return ik_kernel.palm_ik(
        env, q_init, state.physics.qpos[n:], target_pt,
        env.action_low.to(q_init.device), env.action_high.to(q_init.device),
        iters, lr, dyn=state.frame)


def open_door(env, state0, log, frames, curl, neutral, sweeps, device):
    """The scripted door opening of ``door_hand`` and ``door_adroit``:
    servo to a pre-press posture above the handle bar (the digits set to
    ``curl``, the actuated tail), press the latch past the unlock angle,
    withdraw (the seal spring pops the bolt-free door ajar), withdraw to
    ``neutral``, then at most ``sweeps`` palm inserts behind the panel.
    Returns (final state, the door angle)."""
    n = env.action_dim
    door, latch = env.scalar_dyn_body, env._latch
    lo = env.action_low.to(device)
    hi = env.action_high.to(device)
    state = expert_start(env, state0, device)

    def run(s, tgt, steps):
        return hold_target(env, s, tgt, steps, frames)

    def servo(s, tgt, rounds=4, steps=50):
        cmd = tgt
        for _ in range(rounds):
            s = run(s, torch.clamp(cmd, lo, hi), steps)
            cmd = cmd + (tgt - s.physics.qpos[:n])
        return s, cmd

    def note(msg):
        if log:
            log(msg)

    def angle(s, k):
        return float(s.physics.qpos[k])

    # 1) pre-press: the palm above the handle bar, the digits curled clear
    # (the scene through the episode's frame)
    pts = env._sites_soa(state.physics.qpos, state.frame)
    handle = 0.5 * (pts[env._handle_geoms[0]] + pts[env._handle_geoms[1]])
    pre_pt = handle + handle.new_tensor([0.0, 0.0, 0.075])
    q = _ik(env, state, pre_pt, state.physics.qpos[:n], iters=1500)
    q = torch.cat([q[:n - len(curl)], q.new_tensor(curl)])
    state, cmd = servo(state, q)
    note(f"pre-press: latch={angle(state, latch):.3f}")

    # 2) press the latch past the unlock angle (fine-grained, so that the
    # press and pop events are not missed between command updates)
    press = cmd
    min_latch = 0.0
    for k in range(40):
        if (angle(state, latch) < env.latch_unlock_angle - 0.02
                or angle(state, door) > 0.12):
            break
        if k % 4 == 0:
            press = press.clone()
            press[1] += 0.2
        state = run(state, torch.clamp(press, lo, hi), 15)
        min_latch = min(min_latch, angle(state, latch))
    note(f"pressed: min latch={min_latch:.3f}")

    # 3) hold the press while the seal spring drives the door past the
    # bolt depth, then withdraw
    for _ in range(20):
        if angle(state, door) > 0.15:
            break
        state = run(state, torch.clamp(press, lo, hi), 15)
    back = press.clone()
    back[1] += -0.8
    state = run(state, torch.clamp(back, lo, hi), 200)
    note(f"ajar: door={angle(state, door):.3f}")

    # 4) withdraw to the neutral posture, then sweep with palm inserts
    # behind the panel; the push radius shrinks as the door swings, so
    # that every target stays inside the arm's reach (0.76 m from the
    # base)
    hinge = state.frame[:2].cpu().numpy()
    neutral = state.physics.qpos.new_tensor(neutral)
    state, _ = servo(state, neutral, rounds=2, steps=60)
    note(f"withdrawn: door={angle(state, door):.3f}")
    for _ in range(sweeps):
        a = angle(state, door)
        if a > 1.45:
            break
        r = 0.30
        while r > 0.16:
            pt = hinge + r * np.array([np.sin(a), -np.cos(a)])
            if np.linalg.norm(pt) <= 0.76:
                break
            r -= 0.02
        pt = state.frame[:2] + r * state.frame.new_tensor(
            [math.sin(a), -math.cos(a)])
        tan = state.frame.new_tensor([math.cos(a), math.sin(a)])
        behind = torch.stack([pt[0] - 0.07 * tan[0], pt[1] - 0.07 * tan[1],
                              state.frame[2]])
        q = _ik(env, state, behind, neutral, iters=800)
        state, _ = servo(state, q, rounds=3, steps=40)
        note(f"sweep: r={r:.2f} door={angle(state, door):.3f}")
    note(f"final: door={angle(state, door):.3f}")
    return state, angle(state, door)


def scripted_open(env, state0=None, log=None, frames=None, device="cuda"):
    """Hand-scripted door opening: servo to a pre-press posture above the
    handle bar, press the latch past the unlock angle, withdraw (the seal
    spring pops the bolt-free door ajar), then sweep the panel open with
    the palm. Returns (final state, info).

    The feasibility oracle of the JAX env tests (press, unlock, pop and
    sweep are all achievable within the actuation limits).
    ``frames=[]`` collects the qpos trajectory; ``log`` takes a line a
    stage; ``state0`` None starts from ``hand.expert_start``'s reset on
    ``device``."""
    state, door = open_door(
        env, state0, log, frames, curl=(1.4, 1.6, 1.4, 1.6, -1.2, -1.4),
        neutral=(0.0, 0.3, -0.6, 0.3, 1.4, 1.6, 1.4, 1.6, -1.2, -1.4),
        sweeps=6, device=device)
    return state, {
        "door": door,
        "latch_min_reached": True,
        "success": bool(env.success(state)),
    }
