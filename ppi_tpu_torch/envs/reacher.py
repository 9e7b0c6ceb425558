"""Two-link planar reacher on the scalar physics program.

Port of ``ppi_tpu/envs/reacher.py``: a 2-DoF arm driven by joint torques
must bring its fingertip to a target sampled per episode. No contact, no
gravity. The scene, the reset distribution and the reward are the JAX
env's.

The reward takes both the step's raw action (the control cost penalizes it
before the clip) and the per-episode reward constants (the target), in
that order: ``scalar_reward(m, q, qd, act, consts)``. ``step`` on a CUDA
state is one launch of the env's rollout kernel (N lanes, H=1;
``rollout_kernel.env_step``); on a CPU state it is ``plain_step``.
"""

import dataclasses

import numpy as np
import torch

from ppi_tpu_torch.envs.base import as_f32, first_accept
from ppi_tpu_torch.envs.physics import rollout_kernel as rk
from ppi_tpu_torch.envs.physics import scalar_math as sm
from ppi_tpu_torch.envs.physics.engine import (
    HINGE, ModelBuilder, PhysicsState)
from ppi_tpu_torch.envs.physics.engine_soa import SoaModel

LINK = 0.2          # both links' length, and the target disk's radius
N_DRAWS = 8         # the target's first-accept draws


def _build_model():
    b = ModelBuilder()
    b.add_body(parent=-1, joint_type=HINGE, axis=(0, 0, 1),
               offset_pos=(0, 0, 0), mass=1.0, com=(0.1, 0, 0),
               inertia=1e-3 * np.eye(3), damping=0.3, armature=0.02)
    b.add_body(parent=0, joint_type=HINGE, axis=(0, 0, 1),
               offset_pos=(0.2, 0, 0), mass=1.0, com=(0.1, 0, 0),
               inertia=1e-3 * np.eye(3), damping=0.3, armature=0.02)
    b.gravity = (0.0, 0.0, 0.0)  # planar
    return b.finalize()


@dataclasses.dataclass(frozen=True)
class ReacherState:
    physics: PhysicsState
    target: torch.Tensor  # (2,) sampled target position
    t: torch.Tensor       # () int32 step count


@dataclasses.dataclass(frozen=True)
class Reacher:
    action_dim: int = 2
    dt: float = 0.02
    substeps: int = 2
    max_torque: float = 1.0
    target: tuple = (0.15, 0.25)  # legacy pinned target (fixed_goal)
    fixed_goal: bool = False  # True: pin the legacy target + zero-noise init

    name = "reacher"

    # the control cost penalizes the raw action
    scalar_reward_takes_action = True
    # the rollout kernel's split layout, its one chain of two links cut in
    # two (split_layout.plan_partition, "chain"): each link on a warp of
    # its own, the solve on the second; at the canonical N=64/H=20 on an
    # H100 (80GB HBM3, 700 W; chip_smoke.py phase 37) the kernel alone
    # takes 0.034 ms against the lane layout's 0.052, but the main path's
    # call costs ~0.10 ms in either layout (its checks, copies and
    # allocations), so the synced PPI iteration and the real step do not
    # move yet (PERF.md section 6, row 1b)
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

    def sample_target(self, generator: torch.Generator, device):
        """gym Reacher's goal: uniform over the square, resampled until
        inside the 0.2 m disk, as 8 draws with the first inside taken; if
        none is, the first is pulled radially to 0.19 m."""
        draws = LINK * (2.0 * torch.rand((N_DRAWS, 2), generator=generator,
                                         device=device) - 1.0)
        norms = torch.linalg.norm(draws, dim=1)
        ok = norms < LINK
        cand = first_accept(draws, ok)
        fallback = cand * (0.19 / torch.clamp(torch.linalg.norm(cand),
                                              min=1e-9))
        return torch.where(ok.any(), cand, fallback)

    def reset(self, generator: torch.Generator, device, target=None):
        """gym Reacher's reset: qpos ~ U(-0.1, 0.1), qvel ~ U(-5e-3, 5e-3),
        a sampled target; ``target`` pins it instead."""
        if self.fixed_goal:
            qpos = torch.zeros(2, device=device)
            qvel = torch.zeros(2, device=device)
            target = self.target if target is None else target
        else:
            u = torch.rand(4, generator=generator, device=device)
            qpos = 0.2 * u[:2] - 0.1
            qvel = 1e-2 * u[2:] - 5e-3
            if target is None:
                target = self.sample_target(generator, device)
        return ReacherState(
            physics=PhysicsState(qpos=qpos, qvel=qvel),
            target=as_f32(target, device),
            t=torch.zeros((), dtype=torch.int32, device=device))

    # ---- the scalar contract (shared by step() and the rollout kernel) ----

    def scalar_torque(self, m, q, qd, act):
        lim = self.max_torque
        return tuple(sm.clip(act[j], -lim, lim) for j in range(2))

    def scalar_reward_consts(self, state):
        return state.target

    def scalar_reward(self, m, q, qd, act, consts):
        tx, ty = consts
        x = 0.2 * sm.cos(q[0]) + 0.2 * sm.cos(q[0] + q[1])
        y = 0.2 * sm.sin(q[0]) + 0.2 * sm.sin(q[0] + q[1])
        dx, dy = x - tx, y - ty
        dist = sm.sqrt(dx * dx + dy * dy)
        # the raw action, before the clip
        return -dist - 0.01 * (act[0] * act[0] + act[1] * act[1])

    # ---- the env ---------------------------------------------------------

    def step(self, state: ReacherState, action):
        """(state, action (..., 2)) -> (next state, reward (...)): one
        launch of the rollout kernel on a CUDA state, the eager scalar
        program on a CPU state."""
        return rk.env_step(self, state, action)

    def plain_step(self, state: ReacherState, action):
        """The eager step, on any device."""
        return rk.env_step(self, state, action, plain=True)

    def fingertip(self, qpos):
        q1, q2 = qpos[..., 0], qpos[..., 1]
        x = 0.2 * torch.cos(q1) + 0.2 * torch.cos(q1 + q2)
        y = 0.2 * torch.sin(q1) + 0.2 * torch.sin(q1 + q2)
        return torch.stack([x, y], -1)

    def observe(self, state: ReacherState):
        """Observation of a single (unbatched) state."""
        q = state.physics.qpos
        return torch.cat([torch.cos(q), torch.sin(q), state.physics.qvel,
                          state.target, self.fingertip(q)])
