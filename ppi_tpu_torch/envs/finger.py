"""Finger-spin on the scalar physics program.

Port of ``ppi_tpu/envs/finger.py`` (``FingerSpin``, dm_control's
``finger~spin``): a 2-DoF planar finger must flick a free-spinning hinged
paddle and keep it rotating. One sphere-segment contact, the fingertip on
the paddle's pad. The reward is the paddle's clipped angular velocity less
a control cost of the (clipped) action, as the JAX env's.

``step`` on a CUDA state is one launch of the env's rollout kernel (N
lanes, H=1; ``rollout_kernel.env_step``); on a CPU state it is
``plain_step``.
"""

import dataclasses
import math

import numpy as np
import torch

from ppi_tpu_torch.envs.physics import rollout_kernel as rk
from ppi_tpu_torch.envs.physics import scalar_math as sm
from ppi_tpu_torch.envs.physics.engine import (
    HINGE, ModelBuilder, PhysicsState)
from ppi_tpu_torch.envs.physics.engine_soa import SoaModel

# dofs: 0 proximal, 1 distal (finger), 2 spinner hinge
SPINNER = 2
ENGAGE_POSE = (-0.2, -0.5, 0.0)
FINGER_NOISE = 0.2   # the bounded finger perturbation, U(-0.2, 0.2) rad


def _build_model():
    b = ModelBuilder()
    b.add_body(parent=-1, joint_type=HINGE, axis=(0, 1, 0),
               offset_pos=(0, 0, 0.6), mass=1.0, com=(0, 0, -0.17),
               inertia=np.diag([0.005] * 3), damping=0.3, armature=0.03,
               q_limit=(-2.0, 2.0), limit_k=30.0)
    b.add_body(parent=0, joint_type=HINGE, axis=(0, 1, 0),
               offset_pos=(0, 0, -0.34), mass=0.6, com=(0, 0, -0.13),
               inertia=np.diag([0.003] * 3), damping=0.2, armature=0.02,
               q_limit=(-2.2, 2.2), limit_k=30.0)
    # free-spinning paddle on a fixed stand in front of the finger
    b.add_body(parent=-1, joint_type=HINGE, axis=(0, 1, 0),
               offset_pos=(0.25, 0, 0.25), mass=0.4, com=(0.0, 0, 0.0),
               inertia=np.diag([0.002, 0.004, 0.002]), damping=0.02,
               armature=0.005)
    tip = b.add_sphere(1, (0, 0, -0.28), 0.035)
    pad_a = b.add_sphere(SPINNER, (0.0, 0, 0.13), 0.03)
    pad_b = b.add_sphere(SPINNER, (0.0, 0, -0.13), 0.03)
    b.add_contact_sphere_segment(tip, pad_a, pad_b)
    b.contact_stiffness = 4e3
    b.contact_damping = 60.0
    b.friction_mu = 1.0
    b.friction_vel_k = 60.0
    return b.finalize()


@dataclasses.dataclass(frozen=True)
class FingerState:
    physics: PhysicsState
    t: torch.Tensor  # () int32 step count


@dataclasses.dataclass(frozen=True)
class FingerSpin:
    """Torque control on the 2 finger joints; reward = spinner angular
    velocity (positive direction), saturated."""

    action_dim: int = 2
    dt: float = 0.02
    substeps: int = 2
    max_torque: float = 4.0
    fixed_init: bool = False  # True: pin the zero-noise legacy start
    full_range_init: bool = False  # dm_control parity: the finger joints
    #   uniform over their full limit ranges, not the bounded perturbation

    name = "finger~spin"

    # the control cost takes the step's action
    scalar_reward_takes_action = True
    # the rollout kernel's split layout, its bodies cut into a chain of
    # segments (split_layout.plan_partition, "chain"): each finger body and
    # the spinner on a warp of its own, the solve on the spinner's; at the
    # canonical N=128/H=20 on an H100 (80GB HBM3, 700 W) the kernel alone
    # takes 0.0652 ms against the lane layout's 0.0670
    # (studies/split_layout.py, warmed) and 0.0669 against 0.0681
    # (chip_smoke.py phase 37). The main path's call and the synced PPI
    # iteration did not separate the two layouts across two runs of phase
    # 37 (each ordered them differently), so the gain is not shown to reach
    # the main path (PERF.md section 6, row 1b)
    scalar_kernel_layout = "split"
    scalar_split_partition = "chain"

    def __post_init__(self):
        model = _build_model()
        object.__setattr__(self, "_model", model)
        object.__setattr__(self, "_soa", SoaModel(model))

    @property
    def action_low(self):
        return torch.full((2,), -self.max_torque)

    @property
    def action_high(self):
        return torch.full((2,), self.max_torque)

    def reset(self, generator: torch.Generator, device):
        """The engage pose; unless ``fixed_init``, the finger joints moved
        by U(-0.2, 0.2) (or drawn over their full limit ranges with
        ``full_range_init``) and the spinner angle U(-pi, pi)."""
        qpos = torch.tensor(ENGAGE_POSE, device=device)
        if not self.fixed_init:
            u = torch.rand(3, generator=generator, device=device)
            if self.full_range_init:
                lim = torch.from_numpy(np.array(self._model.q_limit[:2]))
                lo, hi = lim[:, 0].to(device), lim[:, 1].to(device)
                finger = lo + u[:2] * (hi - lo)
            else:
                finger = qpos[:2] + FINGER_NOISE * (2.0 * u[:2] - 1.0)
            spinner = math.pi * (2.0 * u[2:] - 1.0)
            qpos = torch.cat([finger, spinner])
        return FingerState(
            physics=PhysicsState(qpos=qpos,
                                 qvel=torch.zeros(3, device=device)),
            t=torch.zeros((), dtype=torch.int32, device=device))

    # ---- the scalar contract (shared by step() and the rollout kernel) ----

    def scalar_torque(self, m, q, qd, act):
        lim = self.max_torque
        return (sm.clip(act[0], -lim, lim), sm.clip(act[1], -lim, lim),
                sm.zeros_like(q[0]))

    def scalar_reward(self, m, q, qd, act):
        lim = self.max_torque
        clipped = [sm.clip(act[j], -lim, lim) for j in range(2)]
        ctrl = sum(c * c for c in clipped) / (lim * lim)
        return sm.clip(qd[SPINNER] / 5.0, -1.0, 1.0) - 0.01 * ctrl

    # ---- the env ---------------------------------------------------------

    def step(self, state: FingerState, action):
        """(state, action (..., 2)) -> (next state, reward (...)): one
        launch of the rollout kernel on a CUDA state, the eager scalar
        program on a CPU state."""
        return rk.env_step(self, state, action)

    def plain_step(self, state: FingerState, action):
        """The eager step, on any device."""
        return rk.env_step(self, state, action, plain=True)

    def observe(self, state: FingerState):
        """Observation of a single (unbatched) state."""
        q, qd = state.physics.qpos, state.physics.qvel
        return torch.cat([torch.sin(q), torch.cos(q), qd])
