"""Planar humanoid-standup on the scalar physics program.

Port of ``ppi_tpu/envs/standup.py`` (the gym HumanoidStandup-v2 row of the
reference's env zoo): a planar 8-DoF figure (slide-x, slide-z and pitch of
the torso, then hip, knee, ankle, shoulder and elbow) with nine
sphere-plane contacts starts supine and is rewarded for raising its head:
head height / 0.3 - a control cost of the (clipped) action - a velocity
cost, as the JAX env's. The head height comes from the forward kinematics
of the scalar program (``fk_soa`` + ``geom_point_soa``).

``step`` on a CUDA state is one launch of the env's rollout kernel (N
lanes, H=1; ``rollout_kernel.env_step``); on a CPU state it is
``plain_step``.
"""

import dataclasses

import numpy as np
import torch

from ppi_tpu_torch.envs.hopper import uniform_noise_reset
from ppi_tpu_torch.envs.physics import rollout_kernel as rk
from ppi_tpu_torch.envs.physics import scalar_math as sm
from ppi_tpu_torch.envs.physics.engine import (
    HINGE, SLIDE, ModelBuilder, PhysicsState)
from ppi_tpu_torch.envs.physics.engine_soa import (
    SoaModel, fk_soa, geom_point_soa, make_sites_soa)

NQ = 8
X, Z, PITCH, HIP, KNEE, ANKLE, SHOULDER, ELBOW = range(NQ)
TORSO_Z0 = 0.22  # lying down
# supine: torso flat, legs slightly bent, arm alongside
POSE = (0.0, 0.0, 0.0, -0.3, 0.5, 0.0, 0.0, -0.2)


def _build_model():
    b = ModelBuilder()
    b.add_body(parent=-1, joint_type=SLIDE, axis=(1, 0, 0),
               offset_pos=(0, 0, TORSO_Z0), mass=1e-3, damping=0.0,
               armature=1e-4)
    b.add_body(parent=0, joint_type=SLIDE, axis=(0, 0, 1),
               offset_pos=(0, 0, 0), mass=1e-3, damping=0.0, armature=1e-4)
    # torso extends +x in its local frame (lying: local +x = world +x)
    torso = b.add_body(parent=1, joint_type=HINGE, axis=(0, 1, 0),
                       offset_pos=(0, 0, 0), mass=6.0, com=(0.25, 0, 0),
                       inertia=np.diag([0.1, 0.35, 0.35]), damping=0.1,
                       armature=0.02)
    hip = b.add_body(parent=torso, joint_type=HINGE, axis=(0, 1, 0),
                     offset_pos=(0.0, 0, 0), mass=3.0, com=(-0.18, 0, 0),
                     inertia=np.diag([0.03] * 3), damping=0.5, armature=0.08,
                     q_limit=(-2.6, 0.3), limit_k=80.0)
    knee = b.add_body(parent=hip, joint_type=HINGE, axis=(0, 1, 0),
                      offset_pos=(-0.36, 0, 0), mass=1.8, com=(-0.17, 0, 0),
                      inertia=np.diag([0.015] * 3), damping=0.4,
                      armature=0.06, q_limit=(-0.05, 2.4), limit_k=80.0)
    foot = b.add_body(parent=knee, joint_type=HINGE, axis=(0, 1, 0),
                      offset_pos=(-0.34, 0, 0), mass=0.8, com=(0.0, 0, -0.04),
                      inertia=np.diag([0.004] * 3), damping=0.3,
                      armature=0.04, q_limit=(-1.0, 1.0), limit_k=60.0)
    arm = b.add_body(parent=torso, joint_type=HINGE, axis=(0, 1, 0),
                     offset_pos=(0.42, 0, 0), mass=1.2, com=(-0.14, 0, 0),
                     inertia=np.diag([0.008] * 3), damping=0.3, armature=0.04,
                     q_limit=(-2.8, 2.8), limit_k=60.0)
    hand = b.add_body(parent=arm, joint_type=HINGE, axis=(0, 1, 0),
                      offset_pos=(-0.28, 0, 0), mass=0.6, com=(-0.12, 0, 0),
                      inertia=np.diag([0.004] * 3), damping=0.25,
                      armature=0.03, q_limit=(-2.4, 0.1), limit_k=60.0)

    plane = b.add_plane((0, 0, 1), 0.0)
    geoms = [
        b.add_sphere(torso, (0.0, 0, 0), 0.10),        # pelvis
        b.add_sphere(torso, (0.30, 0, 0), 0.10),       # chest
        b.add_sphere(torso, (0.52, 0, 0), 0.09),       # head
        b.add_sphere(hip, (-0.30, 0, 0), 0.06),        # thigh
        b.add_sphere(knee, (-0.30, 0, 0), 0.05),       # shin
        b.add_sphere(foot, (0.06, 0, -0.04), 0.045),   # toe
        b.add_sphere(foot, (-0.07, 0, -0.04), 0.045),  # heel
        b.add_sphere(arm, (-0.26, 0, 0), 0.05),        # forearm
        b.add_sphere(hand, (-0.22, 0, 0), 0.05),       # hand
    ]
    for g in geoms:
        b.add_contact_sphere_plane(g, plane)
    b.contact_stiffness = 1.2e4
    b.contact_damping = 150.0
    b.friction_mu = 1.0
    b.friction_vel_k = 150.0
    return b.finalize(), geoms[2]  # head geom index


@dataclasses.dataclass(frozen=True)
class StandupState:
    physics: PhysicsState
    t: torch.Tensor  # () int32 step count


@dataclasses.dataclass(frozen=True)
class HumanoidStandup:
    """Torque control on hip/knee/ankle/shoulder/elbow; reward = head height
    (the HumanoidStandup uph-cost shape) minus control cost."""

    action_dim: int = 5
    dt: float = 0.02
    substeps: int = 4
    max_torque: float = 60.0
    fixed_init: bool = False  # True: pin the zero-noise legacy start

    name = "humanoid-standup"

    # the control cost takes the step's action
    scalar_reward_takes_action = True
    # the rollout kernel's split layout, its substep partitioned by the
    # body tree (split_layout.plan_partition): the torso's chain, the leg
    # and the arm on a warp each; faster than the lane and warp layouts on
    # the card at the canonical N=256/H=30 (PERF.md section 6, row 1b)
    scalar_kernel_layout = "split"
    scalar_split_partition = "subtree"

    def __post_init__(self):
        model, head = _build_model()
        object.__setattr__(self, "_model", model)
        object.__setattr__(self, "_soa", SoaModel(model))
        object.__setattr__(self, "_head_geom", head)
        object.__setattr__(self, "_sites_soa", make_sites_soa(model))

    @property
    def action_low(self):
        return torch.full((self.action_dim,), -self.max_torque)

    @property
    def action_high(self):
        return torch.full((self.action_dim,), self.max_torque)

    def reset(self, generator: torch.Generator, device):
        """gym HumanoidStandup's reset: qpos, qvel += U(-0.01, 0.01)."""
        qpos, qvel = uniform_noise_reset(POSE, 0.01, self.fixed_init,
                                         generator, device)
        return StandupState(physics=PhysicsState(qpos=qpos, qvel=qvel),
                            t=torch.zeros((), dtype=torch.int32,
                                          device=device))

    # ---- the scalar contract (shared by step() and the rollout kernel) ----

    def scalar_torque(self, m, q, qd, act):
        lim = self.max_torque
        tau = [sm.zeros_like(q[0])] * HIP
        tau += [sm.clip(act[j], -lim, lim) for j in range(self.action_dim)]
        return tuple(tau)

    def scalar_reward(self, m, q, qd, act):
        rots, poss, _, _ = fk_soa(m, q)
        head_z = geom_point_soa(m, rots, poss, self._head_geom)[2]
        lim = self.max_torque
        clipped = [sm.clip(act[j], -lim, lim) for j in range(self.action_dim)]
        ctrl = sum(c * c for c in clipped) / (self.action_dim * lim * lim)
        vel2 = sum(qd[j] * qd[j] for j in range(NQ))
        return head_z / 0.3 - 0.1 * ctrl - 1e-3 * vel2

    # ---- the env ---------------------------------------------------------

    def step(self, state: StandupState, action):
        """(state, action (..., 5)) -> (next state, reward (...)): one
        launch of the rollout kernel on a CUDA state, the eager scalar
        program on a CPU state."""
        return rk.env_step(self, state, action)

    def plain_step(self, state: StandupState, action):
        """The eager step, on any device."""
        return rk.env_step(self, state, action, plain=True)

    def head_height(self, qpos):
        return self._sites_soa(qpos)[..., self._head_geom, 2]

    def observe(self, state: StandupState):
        """Observation of a single (unbatched) state."""
        q, qd = state.physics.qpos, state.physics.qvel
        return torch.cat([q[1:], qd, self.head_height(q)[None]])
