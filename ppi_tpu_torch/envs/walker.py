"""Planar biped walker on the scalar physics program: two bodies.

Port of ``ppi_tpu/envs/walker.py``: an upright planar torso (slide-x,
slide-z, pitch) with two 3-joint legs and five sphere-plane contacts.

  * ``Walker`` (walker2d, gym Walker2d-v2's shaping): forward velocity + an
    alive bonus gated on torso height and uprightness - a control cost;
  * ``WalkerWalk`` (walker~walk, dm_control's shaping): a stand term (torso
    height and uprightness tolerances) gated with a horizontal-speed
    tolerance, in [0, 1] a step. Its reward takes the action and ignores
    it, so both bodies share one kernel signature.

``step`` on a CUDA state is one launch of the env's rollout kernel (N
lanes, H=1; ``rollout_kernel.env_step``); on a CPU state it is
``plain_step``.
"""

import dataclasses
import math

import numpy as np
import torch

from ppi_tpu_torch.envs.hopper import healthy_reward, uniform_noise_reset
from ppi_tpu_torch.envs.physics import rollout_kernel as rk
from ppi_tpu_torch.envs.physics import scalar_math as sm
from ppi_tpu_torch.envs.physics.engine import (
    HINGE, SLIDE, ModelBuilder, PhysicsState)
from ppi_tpu_torch.envs.physics.engine_soa import SoaModel

NQ = 9
TORSO_Z0 = 1.25
POSE = (0.0, 0.0, 0.0, 0.1, -0.2, 0.0, -0.1, -0.1, 0.0)


def _leg(b, torso):
    thigh = b.add_body(parent=torso, joint_type=HINGE, axis=(0, 1, 0),
                       offset_pos=(0, 0, -0.2), mass=2.0, com=(0, 0, -0.2),
                       inertia=np.diag([0.02] * 3), damping=0.3,
                       armature=0.05, q_limit=(-1.0, 1.0), limit_k=60.0)
    shin = b.add_body(parent=thigh, joint_type=HINGE, axis=(0, 1, 0),
                      offset_pos=(0, 0, -0.4), mass=1.2, com=(0, 0, -0.2),
                      inertia=np.diag([0.01] * 3), damping=0.25,
                      armature=0.04, q_limit=(-1.5, 0.05), limit_k=60.0)
    foot = b.add_body(parent=shin, joint_type=HINGE, axis=(0, 1, 0),
                      offset_pos=(0, 0, -0.4), mass=0.6, com=(0.06, 0, -0.04),
                      inertia=np.diag([0.003] * 3), damping=0.2,
                      armature=0.03, q_limit=(-0.7, 0.7), limit_k=60.0)
    toe = b.add_sphere(foot, (0.14, 0, -0.05), 0.05)
    heel = b.add_sphere(foot, (-0.05, 0, -0.05), 0.05)
    return toe, heel


def _build_model():
    b = ModelBuilder()
    b.add_body(parent=-1, joint_type=SLIDE, axis=(1, 0, 0),
               offset_pos=(0, 0, TORSO_Z0), mass=1e-3, damping=0.0,
               armature=1e-4)
    b.add_body(parent=0, joint_type=SLIDE, axis=(0, 0, 1),
               offset_pos=(0, 0, 0), mass=1e-3, damping=0.0, armature=1e-4)
    torso = b.add_body(parent=1, joint_type=HINGE, axis=(0, 1, 0),
                       offset_pos=(0, 0, 0), mass=4.0, com=(0, 0, 0.15),
                       inertia=np.diag([0.06, 0.1, 0.06]), damping=0.05,
                       armature=0.01)
    left = _leg(b, torso)
    right = _leg(b, torso)
    plane = b.add_plane((0, 0, 1), 0.0)
    torso_geom = b.add_sphere(torso, (0, 0, 0.15), 0.12)
    for g in (*left, *right, torso_geom):
        b.add_contact_sphere_plane(g, plane)
    b.contact_stiffness = 1.5e4
    b.contact_damping = 150.0
    b.friction_mu = 1.2
    b.friction_vel_k = 150.0
    return b.finalize()


@dataclasses.dataclass(frozen=True)
class WalkerState:
    physics: PhysicsState
    t: torch.Tensor  # () int32 step count


@dataclasses.dataclass(frozen=True)
class Walker:
    action_dim: int = 6
    dt: float = 0.02
    substeps: int = 4
    max_torque: float = 35.0
    fixed_init: bool = False  # True: pin the zero-noise legacy start
    full_range_init: bool = False  # dm_control walker parity: pitch
    #   U(-pi, pi) and the leg hinges uniform over their full limit ranges

    name = "walker2d"

    # the control cost takes the step's action
    scalar_reward_takes_action = True
    # the rollout kernel's split layout, its substep partitioned by the
    # body tree (split_layout.plan_partition): the torso's chain and each
    # leg on a warp of its own; faster than the lane and warp layouts on
    # the card at the canonical N=256/H=30, and walker~walk, which inherits
    # it, than the lane layout at its N=128/H=25 (PERF.md section 6, row 1b)
    scalar_kernel_layout = "split"
    scalar_split_partition = "subtree"

    def __post_init__(self):
        model = _build_model()
        object.__setattr__(self, "_model", model)
        object.__setattr__(self, "_soa", SoaModel(model))

    @property
    def action_low(self):
        return torch.full((self.action_dim,), -self.max_torque)

    @property
    def action_high(self):
        return torch.full((self.action_dim,), self.max_torque)

    def reset(self, generator: torch.Generator, device):
        """gym Walker2d's reset (qpos, qvel += U(-5e-3, 5e-3)), or with
        ``full_range_init`` dm_control's: the pitch U(-pi, pi), the leg
        hinges uniform over their limits, slides and velocities at rest."""
        if not self.full_range_init:
            qpos, qvel = uniform_noise_reset(POSE, 5e-3, self.fixed_init,
                                             generator, device)
        else:
            u = torch.rand(NQ - 2, generator=generator, device=device)
            lim = torch.from_numpy(np.array(self._model.q_limit[3:])).to(
                device)
            legs = lim[:, 0] + u[1:] * (lim[:, 1] - lim[:, 0])
            qpos = torch.cat([torch.zeros(2, device=device),
                              math.pi * (2.0 * u[:1] - 1.0), legs])
            qvel = torch.zeros(NQ, device=device)
        return WalkerState(physics=PhysicsState(qpos=qpos, qvel=qvel),
                           t=torch.zeros((), dtype=torch.int32,
                                         device=device))

    # ---- the scalar contract (shared by step() and the rollout kernel) ----

    def scalar_torque(self, m, q, qd, act):
        lim = self.max_torque
        tau = [sm.zeros_like(q[0])] * 3
        tau += [sm.clip(act[j], -lim, lim) for j in range(self.action_dim)]
        return tuple(tau)

    def scalar_reward(self, m, q, qd, act):
        return healthy_reward(q, qd, act, self.max_torque, TORSO_Z0, 0.8,
                              0.8)

    # ---- the env ---------------------------------------------------------

    def step(self, state: WalkerState, action):
        """(state, action (..., 6)) -> (next state, reward (...)): one
        launch of the rollout kernel on a CUDA state, the eager scalar
        program on a CPU state."""
        return rk.env_step(self, state, action)

    def plain_step(self, state: WalkerState, action):
        """The eager step, on any device."""
        return rk.env_step(self, state, action, plain=True)

    def observe(self, state: WalkerState):
        """Observation of a single (unbatched) state: x position left out."""
        q, qd = state.physics.qpos, state.physics.qvel
        return torch.cat([q[1:], qd])


def _tolerance(x, lower: float, margin: float, value_at_margin=0.1):
    """dm_control's ``rewards.tolerance`` with the gaussian sigmoid and no
    upper bound: 1 at or above ``lower``, decaying to ``value_at_margin`` at
    ``margin`` below it. The JAX env's ``maximum(x - inf, 0)`` is 0 for
    every finite x and is folded here (a non-finite x comes from the state,
    whose lane the NaN latch poisons); ``scale`` is a Python float."""
    below = sm.maximum(lower - x, 0.0)
    d = (below + 0.0) / max(margin, 1e-9)
    scale = math.sqrt(-2.0 * math.log(value_at_margin))
    ds = d * scale
    return sm.exp(-0.5 * (ds * ds))


@dataclasses.dataclass(frozen=True)
class WalkerWalk(Walker):
    """dm_control's ``walker~walk`` reward on the same embodiment: the
    stand term (torso height and uprightness tolerances) gated with a
    horizontal-speed tolerance, in [0, 1] a step."""

    walk_speed: float = 1.0
    stand_height: float = 1.0

    name = "walker~walk"

    def scalar_reward(self, m, q, qd, act):
        # dm_control's shaping has no control cost: ``act`` keeps the
        # inherited signature and is unused
        del act
        z = q[1] + TORSO_Z0
        upright = sm.cos(q[2])
        standing = _tolerance(z, self.stand_height,
                              margin=self.stand_height / 2.0)
        stand_reward = standing * (1.0 + sm.maximum(upright, 0.0)) / 2.0
        move = _tolerance(qd[0], self.walk_speed,
                          margin=self.walk_speed / 2.0, value_at_margin=0.5)
        return stand_reward * (5.0 * move + 1.0) / 6.0
