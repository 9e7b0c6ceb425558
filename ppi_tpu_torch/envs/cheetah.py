"""Planar half-cheetah-class locomotion on the scalar physics program.

Port of ``ppi_tpu/envs/cheetah.py``: a planar torso on (slide-x, slide-z,
pitch) with two 3-joint legs, torque-actuated, with foot-ground penalty
contacts; rewarded for forward velocity minus the control cost (the gym
HalfCheetah shape). The scene and the reward are the JAX env's.

The reward takes the step's raw action (``scalar_reward_takes_action``):
its control cost clips it to the torque box, as the torque does. ``step``
on a CUDA state is one launch of the env's rollout kernel (N lanes, H=1;
``rollout_kernel.env_step``); on a CPU state it is ``plain_step``, the
eager scalar program. Both take the reward from ``scalar_reward``.
"""

import dataclasses

import numpy as np
import torch

from ppi_tpu_torch.envs.physics import rollout_kernel as rk
from ppi_tpu_torch.envs.physics import scalar_math as sm
from ppi_tpu_torch.envs.physics.engine import (
    HINGE, SLIDE, ModelBuilder, PhysicsState)
from ppi_tpu_torch.envs.physics.engine_soa import SoaModel

# dof order: 0 slide-x, 1 slide-z, 2 torso pitch, 3-5 back leg, 6-8 front leg
NQ = 9
TORSO_Z0 = 0.6
LEG_POSE = (0.0, 0.0, 0.0, 0.2, -0.3, 0.0, -0.2, 0.3, 0.0)


def _leg(b, torso, x_off, sign):
    thigh = b.add_body(parent=torso, joint_type=HINGE, axis=(0, 1, 0),
                       offset_pos=(x_off, 0, -0.05), mass=1.5,
                       com=(0, 0, -0.13), inertia=np.diag([0.01] * 3),
                       damping=0.3, armature=0.05,
                       q_limit=(-1.0, 1.0), limit_k=40.0)
    shin = b.add_body(parent=thigh, joint_type=HINGE, axis=(0, 1, 0),
                      offset_pos=(0, 0, -0.26), mass=1.0,
                      com=(0, 0, -0.12), inertia=np.diag([0.006] * 3),
                      damping=0.25, armature=0.04,
                      q_limit=(-1.2, 1.2), limit_k=40.0)
    foot = b.add_body(parent=shin, joint_type=HINGE, axis=(0, 1, 0),
                      offset_pos=(0, 0, -0.24), mass=0.5,
                      com=(0.06 * sign, 0, -0.04),
                      inertia=np.diag([0.003] * 3), damping=0.2,
                      armature=0.03, q_limit=(-0.9, 0.9), limit_k=40.0)
    toe = b.add_sphere(foot, (0.1 * sign, 0, -0.05), 0.045)
    heel = b.add_sphere(foot, (-0.04 * sign, 0, -0.05), 0.045)
    return toe, heel


def _build_model():
    b = ModelBuilder()
    # planar free joint decomposed into two slides + pitch hinge
    b.add_body(parent=-1, joint_type=SLIDE, axis=(1, 0, 0),
               offset_pos=(0, 0, TORSO_Z0), mass=1e-3, damping=0.0,
               armature=1e-4)
    b.add_body(parent=0, joint_type=SLIDE, axis=(0, 0, 1),
               offset_pos=(0, 0, 0), mass=1e-3, damping=0.0, armature=1e-4)
    torso = b.add_body(parent=1, joint_type=HINGE, axis=(0, 1, 0),
                       offset_pos=(0, 0, 0), mass=7.0, com=(0.0, 0, 0),
                       inertia=np.diag([0.1, 0.25, 0.3]), damping=0.05,
                       armature=0.01)
    back = _leg(b, torso, -0.35, -1)
    front = _leg(b, torso, 0.35, 1)
    plane = b.add_plane((0, 0, 1), 0.0)
    for geom in (*back, *front):
        b.add_contact_sphere_plane(geom, plane)
    # torso sphere so faceplants terminate softly instead of exploding
    torso_geom = b.add_sphere(torso, (0, 0, 0), 0.12)
    b.add_contact_sphere_plane(torso_geom, plane)
    b.contact_stiffness = 1.2e4
    b.contact_damping = 120.0
    b.friction_mu = 1.2
    b.friction_vel_k = 120.0
    return b.finalize()


@dataclasses.dataclass(frozen=True)
class CheetahState:
    physics: PhysicsState
    t: torch.Tensor  # () int32 step count


@dataclasses.dataclass(frozen=True)
class Cheetah:
    """Torque control on the 6 leg joints; reward = forward velocity
    - 0.1 mean((a / max_torque)^2) with a clipped to the torque box."""

    action_dim: int = 6
    dt: float = 0.02
    substeps: int = 4
    max_torque: float = 30.0
    fixed_init: bool = False  # True: pin the noise-free start

    name = "cheetah"

    # the reward's control cost takes the step's action
    scalar_reward_takes_action = True
    # the rollout kernel's split layout, its substep partitioned by the
    # body tree (split_layout.plan_partition): the torso's chain and each
    # leg on a warp of its own; faster than the lane and warp layouts on
    # the card at the canonical N=256/H=30 (PERF.md section 6, row 1b)
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
        """The leg pose plus the gym HalfCheetah reset noise: qpos +=
        U(-0.1, 0.1), qvel = N(0, 0.1^2) (qpos drawn first)."""
        qpos = torch.tensor(LEG_POSE, device=device)
        qvel = torch.zeros(NQ, device=device)
        if not self.fixed_init:
            u = torch.rand(NQ, generator=generator, device=device)
            qpos = qpos + (0.2 * u - 0.1)
            qvel = 0.1 * torch.randn(NQ, generator=generator, device=device)
        return CheetahState(physics=PhysicsState(qpos=qpos, qvel=qvel),
                            t=torch.zeros((), dtype=torch.int32,
                                          device=device))

    # ---- the scalar contract (shared by step() and the rollout kernel) ----

    def scalar_torque(self, m, q, qd, act):
        lim = self.max_torque
        tau = [sm.zeros_like(q[0])] * 3
        tau += [sm.clip(act[j], -lim, lim) for j in range(self.action_dim)]
        return tuple(tau)

    def scalar_reward(self, m, q, qd, act):
        lim = self.max_torque
        clipped = [sm.clip(act[j], -lim, lim) for j in range(self.action_dim)]
        ctrl = sum(c * c for c in clipped) / (self.action_dim * lim * lim)
        return qd[0] - 0.1 * ctrl

    # ---- the env ---------------------------------------------------------

    def step(self, state: CheetahState, action):
        """(state, action (..., 6)) -> (next state, reward (...)): one
        launch of the rollout kernel on a CUDA state, the eager scalar
        program on a CPU state."""
        return rk.env_step(self, state, action)

    def plain_step(self, state: CheetahState, action):
        """The eager step, on any device."""
        return rk.env_step(self, state, action, plain=True)

    def observe(self, state: CheetahState):
        """Observation of a single (unbatched) state: x position left out
        (translation invariant, gym style)."""
        q, qd = state.physics.qpos, state.physics.qvel
        return torch.cat([q[1:], qd])
