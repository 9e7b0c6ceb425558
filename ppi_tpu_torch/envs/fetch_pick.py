"""FetchPickAndPlace-class task (fetch-pick) on the scalar physics program.

Port of ``ppi_tpu/envs/fetch_pick.py``: relocate-v0's arm, two-finger
caging gripper and free ball (``relocate._build_model``, reused as it is)
under the Fetch task's semantics:

  * the goal is the object's (sampled) start plus U(-0.12, 0.12) in xy, in
    the air (0.15-0.30 above the table) with probability 0.5, else on the
    table surface;
  * success is the ball within 5 cm of the goal (Fetch's
    ``distance_threshold``);
  * the dense reward keeps relocate's reach / lift / carry structure with
    Fetch's 5 cm bonus.

The goal is the reward's constants, the ball's start is part of ``qpos``.
``step`` on a CUDA state is one launch of the env's rollout kernel (N
lanes, H=1; ``rollout_kernel.env_step``); on a CPU state it is
``plain_step``.
"""

import dataclasses

import torch

from ppi_tpu_torch.envs.base import as_f32
from ppi_tpu_torch.envs.physics import rollout_kernel as rk
from ppi_tpu_torch.envs.physics import scalar_math as sm
from ppi_tpu_torch.envs.physics.engine import PhysicsState
from ppi_tpu_torch.envs.physics.engine_soa import SoaModel, make_sites_soa
from ppi_tpu_torch.envs.relocate import (
    BALL_RADIUS, BALL_START, LIFT_Z, TABLE_Z, _ACTION_HIGH, _ACTION_LOW,
    _build_model, _norm3, scalar_grasp_ball_sites)

GOAL_RANGE_XY = 0.12          # xy half-range about the object start
GOAL_AIR_Z = (0.15, 0.30)     # in-air goal height band above the table
SUCCESS_RADIUS = 0.05         # Fetch distance_threshold
START_RANGE = 0.05            # object start xy offset ~ U(-0.05, 0.05)
ARM_POSE = (0.0, -0.346, 1.83, -1.484, 0.5, -0.5)


@dataclasses.dataclass(frozen=True)
class FetchPickState:
    physics: PhysicsState
    target: torch.Tensor  # (3,) sampled goal
    t: torch.Tensor       # () int32 step count


@dataclasses.dataclass(frozen=True)
class FetchPickAndPlace:
    """Fetch pick-and-place on the relocate arm + caging gripper; actions
    are PD position targets for the 4 arm + 2 finger joints."""

    action_dim: int = 6
    dt: float = 0.02
    substeps: int = 8
    kp: float = 60.0
    kd: float = 6.0
    kp_finger: float = 3.0
    kd_finger: float = 0.3
    fixed_goal: bool = False

    name = "fetch-pick"
    # its lane build spills: the rollout kernel runs one rollout a warp
    # (rollout_kernel.kernel_layout)
    scalar_kernel_layout = "warp"

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

    @property
    def target(self):
        """The fixed goal of ``fixed_goal`` (in the air over the start)."""
        return (BALL_START[0] + 0.04, 0.16, TABLE_Z + BALL_RADIUS + 0.22)

    def sample_start(self, generator: torch.Generator, device):
        """The object start's xy offset about BALL_START, ~ U(-0.05,
        0.05)."""
        if self.fixed_goal:
            return torch.zeros(2, device=device)
        u = torch.rand(2, generator=generator, device=device)
        return START_RANGE * (2.0 * u - 1.0)

    def sample_goal(self, generator: torch.Generator, device,
                    start_xy=None):
        """xy about the (sampled) object start; in the air with probability
        0.5, else on the table surface."""
        if self.fixed_goal:
            return torch.tensor(self.target, device=device)
        if start_xy is None:
            start_xy = torch.tensor(BALL_START, device=device)
        u = torch.rand(4, generator=generator, device=device)
        xy = start_xy + GOAL_RANGE_XY * (2.0 * u[:2] - 1.0)
        z_air = TABLE_Z + GOAL_AIR_Z[0] \
            + (GOAL_AIR_Z[1] - GOAL_AIR_Z[0]) * u[3:]
        z = torch.where(u[2:3] < 0.5, z_air,
                        torch.full_like(z_air, TABLE_Z + BALL_RADIUS))
        return torch.cat([xy, z])

    def reset(self, generator: torch.Generator, device, target=None,
              start=None):
        """Open gripper hovering over the ball's sampled start, and a
        sampled goal (the start drawn first); ``target`` and ``start`` pin
        them instead."""
        if start is None:
            start = self.sample_start(generator, device)
        start = as_f32(start, device)
        if target is None:
            target = self.sample_goal(
                generator, device,
                torch.tensor(BALL_START, device=device) + start)
        qpos = torch.cat([torch.tensor(ARM_POSE, device=device), start,
                          torch.zeros(1, device=device)])
        return FetchPickState(
            physics=PhysicsState(qpos=qpos, qvel=torch.zeros(9, device=device)),
            target=as_f32(target, device),
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
        # dense shaping (relocate's structure) + Fetch's 5 cm bonus; table
        # goals need no lift, so the carry term is always on
        grasp, ball = scalar_grasp_ball_sites(
            m, q, self._palm_geom, self._tip_geoms, self._ball_geom)
        reach = _norm3(grasp, ball)
        carry = _norm3(ball, consts)
        g2t = _norm3(grasp, consts)
        lifted = sm.gt(ball[2], LIFT_Z)
        vel2 = sum(qd[j] * qd[j] for j in range(6))
        return (-0.1 * reach
                - 0.5 * carry
                + lifted * (0.5 - 0.5 * g2t)
                - 1e-4 * vel2
                + 10.0 * sm.lt(carry, 2 * SUCCESS_RADIUS)
                + 20.0 * sm.lt(carry, SUCCESS_RADIUS))

    # ---- the env ---------------------------------------------------------

    def step(self, state: FetchPickState, action):
        """(state, action (..., 6)) -> (next state, reward (...)): one
        launch of the rollout kernel on a CUDA state, the eager scalar
        program on a CPU state."""
        return rk.env_step(self, state, action)

    def plain_step(self, state: FetchPickState, action):
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

    def observe(self, state: FetchPickState):
        """Observation of a single (unbatched) state."""
        q, qd = state.physics.qpos, state.physics.qvel
        palm, grasp, ball = self._sites(q)
        tgt = state.target
        return torch.cat([q[:6], qd[:6], palm, grasp, ball,
                          grasp - ball, ball - tgt, grasp - tgt])

    def success(self, state: FetchPickState):
        _, _, ball = self._sites(state.physics.qpos)
        return torch.linalg.norm(ball - state.target, dim=-1) \
            < SUCCESS_RADIUS
