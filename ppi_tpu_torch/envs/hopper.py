"""Planar hopper on the scalar physics program.

Port of ``ppi_tpu/envs/hopper.py`` (the gym Hopper-v2 row of the
reference's env zoo): a planar one-legged body (torso on slide-x, slide-z
and pitch, then thigh, shin and foot hinges) with three sphere-plane
contacts must hop forward. Reward: forward velocity + an alive bonus gated
on torso height and uprightness - a control cost of the (clipped) action,
as the JAX env's.

``step`` on a CUDA state is one launch of the env's rollout kernel (N
lanes, H=1; ``rollout_kernel.env_step``); on a CPU state it is
``plain_step``.
"""

import dataclasses

import numpy as np
import torch

from ppi_tpu_torch.envs.physics import rollout_kernel as rk
from ppi_tpu_torch.envs.physics import scalar_math as sm
from ppi_tpu_torch.envs.physics.engine import (
    HINGE, SLIDE, ModelBuilder, PhysicsState)
from ppi_tpu_torch.envs.physics.engine_soa import SoaModel

NQ = 6
TORSO_Z0 = 1.05
POSE = (0.0, 0.0, 0.0, 0.2, -0.4, 0.2)


def _build_model():
    b = ModelBuilder()
    b.add_body(parent=-1, joint_type=SLIDE, axis=(1, 0, 0),
               offset_pos=(0, 0, TORSO_Z0), mass=1e-3, damping=0.0,
               armature=1e-4)
    b.add_body(parent=0, joint_type=SLIDE, axis=(0, 0, 1),
               offset_pos=(0, 0, 0), mass=1e-3, damping=0.0, armature=1e-4)
    torso = b.add_body(parent=1, joint_type=HINGE, axis=(0, 1, 0),
                       offset_pos=(0, 0, 0), mass=3.5, com=(0, 0, 0.1),
                       inertia=np.diag([0.05, 0.08, 0.05]), damping=0.05,
                       armature=0.01)
    thigh = b.add_body(parent=torso, joint_type=HINGE, axis=(0, 1, 0),
                       offset_pos=(0, 0, -0.05), mass=2.0, com=(0, 0, -0.2),
                       inertia=np.diag([0.02] * 3), damping=0.3,
                       armature=0.05, q_limit=(-0.6, 1.2), limit_k=60.0)
    shin = b.add_body(parent=thigh, joint_type=HINGE, axis=(0, 1, 0),
                      offset_pos=(0, 0, -0.4), mass=1.2, com=(0, 0, -0.2),
                      inertia=np.diag([0.01] * 3), damping=0.25,
                      armature=0.04, q_limit=(-1.5, 0.1), limit_k=60.0)
    foot = b.add_body(parent=shin, joint_type=HINGE, axis=(0, 1, 0),
                      offset_pos=(0, 0, -0.4), mass=0.7, com=(0.06, 0, -0.04),
                      inertia=np.diag([0.004] * 3), damping=0.2,
                      armature=0.03, q_limit=(-0.8, 0.8), limit_k=60.0)
    plane = b.add_plane((0, 0, 1), 0.0)
    toe = b.add_sphere(foot, (0.13, 0, -0.06), 0.05)
    heel = b.add_sphere(foot, (-0.06, 0, -0.06), 0.05)
    torso_geom = b.add_sphere(torso, (0, 0, 0.1), 0.12)
    for g in (toe, heel, torso_geom):
        b.add_contact_sphere_plane(g, plane)
    b.contact_stiffness = 1.5e4
    b.contact_damping = 150.0
    b.friction_mu = 1.5
    b.friction_vel_k = 150.0
    return b.finalize()


@dataclasses.dataclass(frozen=True)
class HopperState:
    physics: PhysicsState
    t: torch.Tensor  # () int32 step count


def uniform_noise_reset(pose, noise: float, fixed: bool, generator, device):
    """(qpos, qvel): ``pose`` + U(-noise, noise) and U(-noise, noise) per
    coordinate (gym's locomotion reset), or ``pose`` at rest when
    ``fixed``."""
    qpos = torch.tensor(pose, device=device)
    if fixed:
        return qpos, torch.zeros_like(qpos)
    u = torch.rand((2, qpos.shape[0]), generator=generator, device=device)
    return qpos + noise * (2.0 * u[0] - 1.0), noise * (2.0 * u[1] - 1.0)


def healthy_reward(q, qd, act, max_torque: float, torso_z0: float,
                   min_z: float, max_pitch: float):
    """gym's hopper/walker reward over the scalar program: forward velocity
    + 1 when healthy (torso above ``min_z``, |pitch| below ``max_pitch``),
    -2 when not, - 0.05 x the mean squared clipped action over the box."""
    lim = max_torque
    clipped = [sm.clip(a, -lim, lim) for a in act]
    ctrl = sum(c * c for c in clipped) / (len(act) * lim * lim)
    z = q[1] + torso_z0
    healthy = sm.logical_and(sm.gt(z, min_z), sm.lt(sm.abs(q[2]), max_pitch))
    return qd[0] + healthy - 2.0 * (1.0 - healthy) - 0.05 * ctrl


@dataclasses.dataclass(frozen=True)
class Hopper:
    action_dim: int = 3
    dt: float = 0.02
    substeps: int = 4
    max_torque: float = 40.0
    fixed_init: bool = False  # True: pin the zero-noise legacy start

    name = "hopper"

    # the control cost takes the step's action
    scalar_reward_takes_action = True
    # the rollout kernel's split layout, its substep partitioned by the
    # body tree with its one chain cut into segments
    # (split_layout.plan_partition, "chain"): the root's two slides, the
    # torso and thigh, the leg, and the foot each on a warp of its own, the
    # solve on the first; timed against the lane layout on the card at
    # the canonical N=256/H=30 (PERF.md section 6, row 1b)
    scalar_kernel_layout = "split"
    scalar_split_partition = "chain"

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
        """gym Hopper's reset: qpos, qvel += U(-5e-3, 5e-3)."""
        qpos, qvel = uniform_noise_reset(POSE, 5e-3, self.fixed_init,
                                         generator, device)
        return HopperState(physics=PhysicsState(qpos=qpos, qvel=qvel),
                           t=torch.zeros((), dtype=torch.int32,
                                         device=device))

    # ---- the scalar contract (shared by step() and the rollout kernel) ----

    def scalar_torque(self, m, q, qd, act):
        lim = self.max_torque
        tau = [sm.zeros_like(q[0])] * 3
        tau += [sm.clip(act[j], -lim, lim) for j in range(self.action_dim)]
        return tuple(tau)

    def scalar_reward(self, m, q, qd, act):
        return healthy_reward(q, qd, act, self.max_torque, TORSO_Z0, 0.7,
                              0.6)

    # ---- the env ---------------------------------------------------------

    def step(self, state: HopperState, action):
        """(state, action (..., 3)) -> (next state, reward (...)): one
        launch of the rollout kernel on a CUDA state, the eager scalar
        program on a CPU state."""
        return rk.env_step(self, state, action)

    def plain_step(self, state: HopperState, action):
        """The eager step, on any device."""
        return rk.env_step(self, state, action, plain=True)

    def observe(self, state: HopperState):
        """Observation of a single (unbatched) state: x position left out
        (translation invariant, gym style)."""
        q, qd = state.physics.qpos, state.physics.qvel
        return torch.cat([q[1:], qd])
