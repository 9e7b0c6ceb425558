"""Tabletop push-to-target (fetch-push) on the scalar physics program.

Port of ``ppi_tpu/envs/push.py`` (``FetchPush``, the push variant of the
FetchPickAndPlace row of the reference's env zoo): a 4-joint arm with a
paddle must push a box across a table to a target. The box rides two
orthogonal slides with dry (Coulomb) friction, so it moves only under
contact. Both the box's start and the target are sampled per episode; the
target is the reward's constants, the start is part of ``qpos``. The
scene, the reset distribution and the reward are the JAX env's.

``step`` on a CUDA state is one launch of the env's rollout kernel (N
lanes, H=1; ``rollout_kernel.env_step``); on a CPU state it is
``plain_step``.
"""

import dataclasses

import torch

from ppi_tpu_torch.envs.base import as_f32, first_accept
from ppi_tpu_torch.envs.physics import rollout_kernel as rk
from ppi_tpu_torch.envs.physics import scalar_math as sm
from ppi_tpu_torch.envs.physics.engine import (
    HINGE, SLIDE, ModelBuilder, PhysicsState)
from ppi_tpu_torch.envs.physics.engine_soa import (
    SoaModel, fk_soa, geom_point_soa, make_sites_soa)

YAW, SHOULDER, ELBOW, WRIST, BOX_X, BOX_Y = range(6)
TABLE_Z = 0.75
BOX_START = (0.55, 0.1)
# the goal: box start + U(-0.15, 0.15)^2, resampled until 0.1 m from the
# box (gymnasium-robotics fetch push), as 8 draws with the first far
# enough taken
GOAL_RANGE = 0.15
GOAL_MIN_DIST = 0.1
N_DRAWS = 8
# the box start's xy offset about BOX_START, U(-0.05, 0.05)^2
START_RANGE = 0.05
ARM_POSE = (0.0, 0.7, -0.9, 0.3)

_LOW = (-1.5, -1.2, -2.0, -2.0)
_HIGH = (1.5, 1.2, 2.0, 2.0)


def _build_model():
    b = ModelBuilder()
    b.add_body(parent=-1, joint_type=HINGE, axis=(0, 0, 1),
               offset_pos=(0, 0, TABLE_Z + 0.25), mass=2.0, damping=2.0,
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
    # box on the table: planar slides with dry friction
    b.add_body(parent=-1, joint_type=SLIDE, axis=(1, 0, 0),
               offset_pos=(BOX_START[0], BOX_START[1], TABLE_Z), mass=0.5,
               damping=2.0, armature=0.01, friction_loss=2.5)
    b.add_body(parent=BOX_X, joint_type=SLIDE, axis=(0, 1, 0),
               offset_pos=(0, 0, 0), mass=0.5, damping=2.0, armature=0.01,
               friction_loss=2.5)

    palm = b.add_sphere(WRIST, (0.18, 0, 0), 0.05)
    box = b.add_sphere(BOX_Y, (0, 0, 0.04), 0.055)
    b.add_contact_sphere_sphere(palm, box)
    b.contact_stiffness = 3e3
    b.contact_damping = 60.0
    b.friction_mu = 0.8
    b.friction_vel_k = 60.0
    return b.finalize(), palm, box


@dataclasses.dataclass(frozen=True)
class PushState:
    physics: PhysicsState
    target: torch.Tensor  # (2,) sampled target of the box's xy
    t: torch.Tensor       # () int32 step count


@dataclasses.dataclass(frozen=True)
class FetchPush:
    """Fetch-push-class task; PD position targets for the 4 arm joints.
    Reward: -2 |box - target| - 0.25 |palm - box| + in-place bonus."""

    action_dim: int = 4
    dt: float = 0.02
    substeps: int = 2
    kp: float = 60.0
    kd: float = 6.0
    target: tuple = (0.72, -0.15)   # legacy fixed goal (fixed_goal=True)
    success_radius: float = 0.05
    fixed_goal: bool = False

    name = "fetch-push"

    # the rollout kernel's split layout, its substep partitioned by the
    # body tree with the arm's chain cut into segments
    # (split_layout.plan_partition, "chain"): the yaw, the shoulder and
    # elbow, and the wrist each on a warp of its own, the box's two slides
    # on the fourth; timed against the lane layout on the card at
    # the canonical N=256/H=20 (PERF.md section 6, row 1b)
    scalar_kernel_layout = "split"
    scalar_split_partition = "chain"

    def __post_init__(self):
        model, palm, box = _build_model()
        object.__setattr__(self, "_model", model)
        object.__setattr__(self, "_soa", SoaModel(model))
        object.__setattr__(self, "_palm_geom", palm)
        object.__setattr__(self, "_box_geom", box)
        object.__setattr__(self, "_sites_soa", make_sites_soa(model))

    @property
    def action_low(self):
        return torch.tensor(_LOW)

    @property
    def action_high(self):
        return torch.tensor(_HIGH)

    def sample_start(self, generator: torch.Generator, device):
        """The box start's xy offset about BOX_START, ~ U(-0.05, 0.05)."""
        if self.fixed_goal:
            return torch.zeros(2, device=device)
        u = torch.rand(2, generator=generator, device=device)
        return START_RANGE * (2.0 * u - 1.0)

    def sample_goal(self, generator: torch.Generator, device,
                    start_xy=None):
        """The box's (sampled) start plus an offset of U(-0.15, 0.15)^2
        with the first of 8 draws at least 0.1 m long; if none is, the
        first draw pushed out radially to 0.1 m."""
        if self.fixed_goal:
            return torch.tensor(self.target, device=device)
        if start_xy is None:
            start_xy = torch.tensor(BOX_START, device=device)
        offs = GOAL_RANGE * (2.0 * torch.rand(
            (N_DRAWS, 2), generator=generator, device=device) - 1.0)
        ok = torch.linalg.norm(offs, dim=1) >= GOAL_MIN_DIST
        off = first_accept(offs, ok)
        r = torch.linalg.norm(off) + 1e-9
        off = torch.where(ok.any(), off, off * (GOAL_MIN_DIST / r))
        return start_xy + off

    def reset(self, generator: torch.Generator, device, target=None,
              start=None):
        """The arm's pose, the box at its sampled start and a sampled
        target (the start drawn first); ``target`` and ``start`` pin them
        instead."""
        if start is None:
            start = self.sample_start(generator, device)
        start = as_f32(start, device)
        if target is None:
            target = self.sample_goal(
                generator, device,
                torch.tensor(BOX_START, device=device) + start)
        qpos = torch.cat([torch.tensor(ARM_POSE, device=device), start])
        return PushState(
            physics=PhysicsState(qpos=qpos, qvel=torch.zeros(6, device=device)),
            target=as_f32(target, device),
            t=torch.zeros((), dtype=torch.int32, device=device))

    # ---- the scalar contract (shared by step() and the rollout kernel) ----

    def scalar_torque(self, m, q, qd, act):
        tau = [self.kp * (sm.clip(act[j], _LOW[j], _HIGH[j]) - q[j])
               - self.kd * qd[j] for j in range(4)]
        tau += [sm.zeros_like(q[0])] * 2  # box slides
        return tuple(tau)

    def scalar_reward_consts(self, state):
        return state.target

    def scalar_reward(self, m, q, qd, consts):
        tx, ty = consts
        rots, poss, _, _ = fk_soa(m, q)
        palm = geom_point_soa(m, rots, poss, self._palm_geom)
        box = geom_point_soa(m, rots, poss, self._box_geom)
        bx = BOX_START[0] + q[BOX_X]
        by = BOX_START[1] + q[BOX_Y]
        dx, dy = bx - tx, by - ty
        d_target = sm.sqrt(dx * dx + dy * dy)
        rx, ry, rz = palm[0] - box[0], palm[1] - box[1], palm[2] - box[2]
        d_reach = sm.sqrt(rx * rx + ry * ry + rz * rz)
        vel2 = sum(qd[j] * qd[j] for j in range(6))
        return (-2.0 * d_target - 0.25 * d_reach
                + 5.0 * sm.lt(d_target, self.success_radius)
                - 1e-3 * vel2)

    # ---- the env ---------------------------------------------------------

    def step(self, state: PushState, action):
        """(state, action (..., 4)) -> (next state, reward (...)): one
        launch of the rollout kernel on a CUDA state, the eager scalar
        program on a CPU state."""
        return rk.env_step(self, state, action)

    def plain_step(self, state: PushState, action):
        """The eager step, on any device."""
        return rk.env_step(self, state, action, plain=True)

    def _positions(self, qpos):
        pts = self._sites_soa(qpos)
        return pts[..., self._palm_geom, :], pts[..., self._box_geom, :]

    def box_xy(self, state: PushState):
        q = state.physics.qpos
        return torch.stack([BOX_START[0] + q[..., BOX_X],
                            BOX_START[1] + q[..., BOX_Y]], -1)

    def observe(self, state: PushState):
        """Observation of a single (unbatched) state."""
        q, qd = state.physics.qpos, state.physics.qvel
        palm, _ = self._positions(q)
        box_xy = self.box_xy(state)
        return torch.cat([q[:4], qd[:4], box_xy, state.target, palm,
                          box_xy - state.target])

    def success(self, state: PushState):
        return torch.linalg.norm(self.box_xy(state) - state.target,
                                 dim=-1) < self.success_radius
