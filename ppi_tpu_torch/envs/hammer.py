"""Hammer-a-nail (hammer-v0) on the scalar physics program.

Port of ``ppi_tpu/envs/hammer.py``: a 4-joint arm with the hammer head as
its end effector must drive a vertical nail into a bench until it is
seated. The nail is a slide joint held by dry (Coulomb) friction, so
gravity cannot seat it: only impacts of the head on the nail's capsule
move it. The board height is sampled per episode (mj_envs hammer-v0
randomizes the board body's z) and reaches the dynamics as the nail body's
joint-origin offset. The scene and the reward shape are the JAX env's.

``step`` on a CUDA state is one launch of the env's rollout kernel (N
lanes, H=1; ``rollout_kernel.kernel_step``), the build that the MPC
objective uses. On a CPU state it is ``plain_step``, the eager scalar
program (torque, 4 substeps, the reward).
"""

import dataclasses

import torch

from ppi_tpu_torch.envs.base import as_f32
from ppi_tpu_torch.envs.physics import rollout_kernel as rk
from ppi_tpu_torch.envs.physics import scalar_math as sm
from ppi_tpu_torch.envs.physics.engine import (
    HINGE, SLIDE, ModelBuilder, PhysicsState)
from ppi_tpu_torch.envs.physics.engine_soa import (
    SoaModel, fk_soa, geom_point_soa, make_sites_soa)

YAW, SHOULDER, ELBOW, WRIST, NAIL = range(5)
NAIL_DEPTH = 0.06  # fully seated

# nominal nail-board position and the per-episode board-height half-range
NAIL_POS = (0.68, 0.0, 0.90)
NAIL_Z_RANGE = 0.075

_LOW = (-1.5, -1.2, -2.0, -2.0)
_HIGH = (1.5, 1.2, 2.0, 2.0)


def _build_model():
    b = ModelBuilder()
    # --- arm (the door arm's class) ---
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
               offset_pos=(0.35, 0, 0), mass=1.0, com=(0.1, 0, 0),
               damping=1.0, armature=0.05, q_limit=(-2.0, 2.0), limit_k=50.0)
    # --- nail: vertical, driven down into the bench at NAIL_POS (the
    # nominal board, overridden per episode by the sampled state.board);
    # the slide axis points down, so q > 0 means seated deeper ---
    b.add_body(parent=-1, joint_type=SLIDE, axis=(0, 0, -1),
               offset_pos=NAIL_POS, mass=0.4, damping=10.0,
               armature=0.01, spring_k=0.0, spring_ref=0.0,
               friction_loss=20.0,
               q_limit=(0.0, NAIL_DEPTH + 0.01), limit_k=8e3)

    head = b.add_sphere(WRIST, (0.22, 0, 0), 0.045)      # hammer head
    nail_a = b.add_sphere(NAIL, (0.0, 0, 0.060), 0.018)  # nail head (top)
    nail_b = b.add_sphere(NAIL, (0.0, 0, 0.020), 0.018)
    b.add_contact_sphere_segment(head, nail_a, nail_b)
    b.contact_stiffness = 4e3
    b.contact_damping = 60.0
    b.friction_mu = 0.8
    b.friction_vel_k = 60.0
    return b.finalize(), head, (nail_a, nail_b)


@dataclasses.dataclass(frozen=True)
class HammerState:
    physics: PhysicsState
    board: torch.Tensor  # (3,) sampled nail-board position (z randomized)
    t: torch.Tensor      # () int32 step count


def sample_board_z(nominal, lo: float, hi: float, fixed: bool, generator,
                   device):
    """``nominal`` with z moved by U(lo, hi), or ``nominal`` when ``fixed``:
    the per-episode board of the hammer scenes."""
    board = torch.tensor(nominal, device=device)
    if fixed:
        return board
    u = torch.rand((), generator=generator, device=device)
    up = torch.tensor([0.0, 0.0, 1.0], device=device)
    return board + up * (lo + (hi - lo) * u)


@dataclasses.dataclass(frozen=True)
class Hammer:
    """hammer-v0-class task; actions are PD position targets for the 4 arm
    joints. The nail's slide coordinate grows as it seats."""

    action_dim: int = 4
    dt: float = 0.02
    substeps: int = 4
    kp: float = 70.0
    kd: float = 7.0
    fixed_scene: bool = False  # True: pin the nominal board height

    name = "hammer-v0"

    # the sampled board overrides the nail body's joint-origin offset (a
    # runtime input of the rollout kernel)
    scalar_dyn_body = NAIL

    def __post_init__(self):
        model, head, nail = _build_model()
        object.__setattr__(self, "_model", model)
        object.__setattr__(self, "_soa", SoaModel(model))
        object.__setattr__(self, "_head_geom", head)
        object.__setattr__(self, "_nail_geoms", nail)
        object.__setattr__(self, "_sites_soa",
                           make_sites_soa(model, dyn_body=NAIL))

    @property
    def action_low(self):
        return torch.tensor(_LOW)

    @property
    def action_high(self):
        return torch.tensor(_HIGH)

    def sample_board(self, generator: torch.Generator, device):
        """Per-episode nail-board position: z ~ U(-NAIL_Z_RANGE,
        NAIL_Z_RANGE) about the nominal bench height."""
        return sample_board_z(NAIL_POS, -NAIL_Z_RANGE, NAIL_Z_RANGE,
                              self.fixed_scene, generator, device)

    def reset(self, generator: torch.Generator, device, board=None):
        """Initial state; ``board`` pins the board instead of sampling."""
        if board is None:
            board = self.sample_board(generator, device)
        return HammerState(
            physics=PhysicsState(
                qpos=torch.tensor([0.0, 0.3, -1.6, 0.9, 0.0], device=device),
                qvel=torch.zeros(5, device=device)),
            board=as_f32(board, device),
            t=torch.zeros((), dtype=torch.int32, device=device))

    # ---- the scalar contract (shared by step() and the rollout kernel) ----

    def scalar_dyn_consts(self, state):
        return state.board

    def scalar_torque(self, m, q, qd, act):
        tau = [self.kp * (sm.clip(act[j], _LOW[j], _HIGH[j]) - q[j])
               - self.kd * qd[j] for j in range(4)]
        tau.append(sm.zeros_like(q[0]))  # free nail slide
        return tuple(tau)

    def scalar_reward(self, m, q, qd):
        # mj_envs hammer-v0 reward shape: approach + insertion progress +
        # seated bonuses + velocity regularization
        rots, poss, _, _ = fk_soa(m, q)
        head = geom_point_soa(m, rots, poss, self._head_geom)
        nail = geom_point_soa(m, rots, poss, self._nail_geoms[0])
        dx, dy, dz = head[0] - nail[0], head[1] - nail[1], head[2] - nail[2]
        dist = sm.sqrt(dx * dx + dy * dy + dz * dz)
        depth = q[NAIL]
        vel2 = sum(qd[j] * qd[j] for j in range(5))
        return (-0.5 * dist
                + 50.0 * depth
                - 1e-3 * vel2
                + 2.0 * sm.gt(depth, 0.5 * NAIL_DEPTH)
                + 10.0 * sm.gt(depth, 0.95 * NAIL_DEPTH))

    # ---- the env ---------------------------------------------------------

    def step(self, state: HammerState, action):
        """(state, action (..., 4)) -> (next state, reward (...)): one
        launch of the rollout kernel on a CUDA state, the eager scalar
        program on a CPU state."""
        return rk.env_step(self, state, action)

    def plain_step(self, state: HammerState, action):
        """The eager step, on any device."""
        return rk.env_step(self, state, action, plain=True)

    def _sites(self, qpos, board):
        pts = self._sites_soa(qpos, board)
        return pts[..., self._head_geom, :], pts[..., self._nail_geoms[0], :]

    def observe(self, state: HammerState):
        """Observation of a single (unbatched) state; the nail site carries
        the sampled board."""
        q, qd = state.physics.qpos, state.physics.qvel
        head, nail = self._sites(q, state.board)
        return torch.cat([q[:4], qd[:4], q[NAIL:NAIL + 1],
                          qd[NAIL:NAIL + 1], head, nail, head - nail])

    def success(self, state: HammerState):
        return state.physics.qpos[..., NAIL] > 0.95 * NAIL_DEPTH
