"""Door-opening environment (door-v0) on the scalar physics program.

Port of ``ppi_tpu/envs/door.py``: a 4-joint arm with a palm sphere must
press a spring-loaded latch down and pull a hinged door open. The scene,
the reward shape and the per-episode door-frame sampling are the JAX env's.

The scalar program (``scalar_torque``, the SoA substeps, ``scalar_reward``)
runs eagerly over torch lanes as the kernel's plain version and, over
symbols, becomes the rollout kernel's body. ``step`` on a CUDA state is one
launch of that kernel (N lanes, H=1; ``rollout_kernel.env_step``); on a CPU
state it is ``plain_step``, the eager program over whatever batch shape the
state has.
"""

import dataclasses

import numpy as np
import torch

from ppi_tpu_torch.envs.physics import rollout_kernel as rk
from ppi_tpu_torch.envs.physics import scalar_math as sm
from ppi_tpu_torch.envs.physics.engine import HINGE, ModelBuilder, PhysicsState
from ppi_tpu_torch.envs.physics.engine_soa import (
    SoaModel, fk_soa, geom_point_soa, make_sites_soa)

# dof indices
YAW, SHOULDER, ELBOW, WRIST, DOOR, LATCH = range(6)

# nominal door-frame origin (hinge anchor) and the per-episode sampling
# half-ranges about it (mj_envs door-v0 randomizes the door body position)
FRAME = (0.55, 0.35, 1.0)
FRAME_RANGE = (0.05, 0.05, 0.075)


def _build_model():
    b = ModelBuilder()
    # --- arm ---
    b.add_body(parent=-1, joint_type=HINGE, axis=(0, 0, 1),
               offset_pos=(0, 0, 1.0), mass=2.0, com=(0.0, 0, 0),
               damping=2.0, armature=0.1, q_limit=(-1.5, 1.5), limit_k=50.0)
    b.add_body(parent=YAW, joint_type=HINGE, axis=(0, 1, 0),
               offset_pos=(0, 0, 0), mass=2.0, com=(0.17, 0, 0),
               damping=2.0, armature=0.1, q_limit=(-1.2, 1.2), limit_k=50.0)
    b.add_body(parent=SHOULDER, joint_type=HINGE, axis=(0, 1, 0),
               offset_pos=(0.35, 0, 0), mass=1.5, com=(0.17, 0, 0),
               damping=1.5, armature=0.08, q_limit=(-2.0, 2.0), limit_k=50.0)
    b.add_body(parent=ELBOW, joint_type=HINGE, axis=(0, 1, 0),
               offset_pos=(0.35, 0, 0), mass=0.8, com=(0.08, 0, 0),
               damping=1.0, armature=0.05, q_limit=(-2.0, 2.0), limit_k=50.0)
    # --- door (hinge at the frame edge, panel extends -y; the offset is the
    # NOMINAL frame, overridden per episode by the sampled state.frame) ---
    b.add_body(parent=-1, joint_type=HINGE, axis=(0, 0, 1),
               offset_pos=FRAME, mass=3.0, com=(0.0, -0.25, 0.0),
               inertia=np.diag([0.1, 0.02, 0.1]), damping=3.0, armature=0.0,
               q_limit=(0.0, 1.8), limit_k=200.0)
    # --- latch: handle bar on the door, rotates about the panel normal ---
    b.add_body(parent=DOOR, joint_type=HINGE, axis=(1, 0, 0),
               offset_pos=(-0.05, -0.45, 0.0), mass=0.3,
               com=(0.0, 0.08, 0.0), inertia=np.diag([2e-3, 2e-3, 2e-3]),
               damping=0.3, armature=0.01, spring_k=2.0, spring_ref=0.0,
               q_limit=(-1.6, 0.1), limit_k=30.0)

    palm = b.add_sphere(WRIST, (0.18, 0, 0), 0.05)
    # handle bar: two spheres spanning a capsule on the latch body
    h_a = b.add_sphere(LATCH, (0.0, 0.02, 0.0), 0.02)
    h_b = b.add_sphere(LATCH, (0.0, 0.16, 0.0), 0.02)
    # door panel edge capsule (for pushing/pulling the panel itself)
    d_a = b.add_sphere(DOOR, (0.0, -0.1, 0.0), 0.02)
    d_b = b.add_sphere(DOOR, (0.0, -0.5, 0.0), 0.02)

    b.add_contact_sphere_segment(palm, h_a, h_b)
    b.add_contact_sphere_segment(palm, d_a, d_b)
    b.contact_stiffness = 2e3
    b.contact_damping = 50.0
    b.friction_mu = 1.0
    b.friction_vel_k = 50.0
    return b.finalize(), palm, (h_a, h_b)


@dataclasses.dataclass(frozen=True)
class DoorState:
    physics: PhysicsState
    frame: torch.Tensor  # (3,) sampled door-frame origin
    t: torch.Tensor      # () int32 step count


@dataclasses.dataclass(frozen=True)
class Door:
    """door-v0-class task; actions are PD position targets for the 4 arm
    joints."""

    action_dim: int = 4
    dt: float = 0.02
    substeps: int = 2
    kp: float = 60.0
    kd: float = 6.0
    latch_unlock_angle: float = -0.8   # latch pressed this far -> door free
    lock_stiffness: float = 60.0
    fixed_scene: bool = False  # True: pin the nominal frame

    name = "door-v0"

    _ACTION_LOW = (-1.5, -1.2, -2.0, -2.0)
    _ACTION_HIGH = (1.5, 1.2, 2.0, 2.0)

    # the sampled door frame overrides the door body's joint-origin offset
    # (a runtime input of the rollout kernel)
    scalar_dyn_body = DOOR
    # the rollout kernel's split layout: each rollout's substep spread over
    # three warps of a block, faster than the lane layout on the card at
    # the shapes this body runs (PERF.md section 6, rows 1a and 1e)
    scalar_kernel_layout = "split"

    def __post_init__(self):
        model, palm, handle = _build_model()
        object.__setattr__(self, "_model", model)
        object.__setattr__(self, "_soa", SoaModel(model))
        object.__setattr__(self, "_palm_geom", palm)
        object.__setattr__(self, "_handle_geoms", handle)
        object.__setattr__(self, "_sites_soa",
                           make_sites_soa(model, dyn_body=DOOR))

    @property
    def action_low(self):
        return torch.tensor(self._ACTION_LOW)

    @property
    def action_high(self):
        return torch.tensor(self._ACTION_HIGH)

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
        qpos = torch.tensor([0.0, 0.6, -0.8, 0.2, 0.0, 0.0], device=device)
        if frame is None:
            frame = self.sample_frame(generator, device)
        return DoorState(
            physics=PhysicsState(qpos=qpos, qvel=torch.zeros(6, device=device)),
            frame=torch.as_tensor(frame, dtype=torch.float32, device=device),
            t=torch.zeros((), dtype=torch.int32, device=device))

    # ---- the scalar contract (shared by step() and the rollout kernel) ----

    def scalar_dyn_consts(self, state):
        return state.frame

    def scalar_torque(self, m, q, qd, act):
        tau = []
        for j in range(4):
            tgt = sm.clip(act[j], self._ACTION_LOW[j], self._ACTION_HIGH[j])
            tau.append(self.kp * (tgt - q[j]) - self.kd * qd[j])
        # smooth latch-gated lock: a strong spring holds the door closed until
        # the latch is pressed past the unlock angle; a bolt only blocks a
        # (nearly) closed door
        engaged = sm.sigmoid((q[LATCH] - self.latch_unlock_angle) / 0.05)
        closed = sm.sigmoid((0.08 - q[DOOR]) / 0.03)
        tau.append(-engaged * closed * self.lock_stiffness * q[DOOR])
        tau.append(sm.zeros_like(q[LATCH]))
        return tuple(tau)

    def scalar_reward(self, m, q, qd):
        # mj_envs door-v0 reward shape: approach + staged opening bonuses +
        # velocity regularization
        rots, poss, _, _ = fk_soa(m, q)
        palm = geom_point_soa(m, rots, poss, self._palm_geom)
        ha = geom_point_soa(m, rots, poss, self._handle_geoms[0])
        hb = geom_point_soa(m, rots, poss, self._handle_geoms[1])
        dx = palm[0] - 0.5 * (ha[0] + hb[0])
        dy = palm[1] - 0.5 * (ha[1] + hb[1])
        dz = palm[2] - 0.5 * (ha[2] + hb[2])
        dist = sm.sqrt(dx * dx + dy * dy + dz * dz)
        door = q[DOOR]
        vel2 = sum(qd[j] * qd[j] for j in range(6))
        return (-0.5 * dist
                + 2.0 * door
                - 1e-3 * vel2
                + 2.0 * sm.gt(door, 0.2)
                + 8.0 * sm.gt(door, 1.0)
                + 10.0 * sm.gt(door, 1.35))

    # ---- the env ---------------------------------------------------------

    def step(self, state: DoorState, action):
        """(state, action (..., 4)) -> (next state, reward (...)): one
        launch of the rollout kernel on a CUDA state, the eager scalar
        program on a CPU state."""
        return rk.env_step(self, state, action)

    def plain_step(self, state: DoorState, action):
        """The eager step, on any device."""
        return rk.env_step(self, state, action, plain=True)

    def _sites(self, qpos, frame):
        pts = self._sites_soa(qpos, frame)
        palm = pts[..., self._palm_geom, :]
        handle = 0.5 * (pts[..., self._handle_geoms[0], :]
                        + pts[..., self._handle_geoms[1], :])
        return palm, handle

    def observe(self, state: DoorState):
        """Observation of a single (unbatched) state."""
        palm, handle = self._sites(state.physics.qpos, state.frame)
        q = state.physics.qpos
        return torch.cat([
            q[:4], state.physics.qvel[:4],
            q[DOOR:DOOR + 1], q[LATCH:LATCH + 1],
            palm, handle, palm - handle, state.frame,
            1.0 * (q[DOOR:DOOR + 1] > 1.0)])

    def success(self, state: DoorState):
        return state.physics.qpos[..., DOOR] > 1.35
